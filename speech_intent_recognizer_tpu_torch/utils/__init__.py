"""Host-side helpers of the port: devices and GPU labels."""
