"""Host-side audio decode, native DSP shim and label maps (no JAX)."""
