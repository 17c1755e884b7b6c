"""Host-side helpers of the port: devices and GPU labels, tracing and
timing, diagnostics of the card."""

from speech_intent_recognizer_tpu_torch.utils.diagnostics import (
    device_smoke_test,
    print_device_info,
)
from speech_intent_recognizer_tpu_torch.utils.profiling import (
    device_memory_stats,
    trace,
    trace_annotation,
)

__all__ = [
    "device_memory_stats",
    "device_smoke_test",
    "print_device_info",
    "trace",
    "trace_annotation",
]
