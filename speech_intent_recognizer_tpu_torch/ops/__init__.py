"""Front-end and recurrence ops: plain PyTorch versions and the
hand-written CUDA kernels that replace the Pallas kernels; the resamplers
(``resample_np`` on the host, ``resample_torch`` on a device)."""

from speech_intent_recognizer_tpu_torch.ops.resample import (
    resample_np, resample_torch)

__all__ = ["resample_np", "resample_torch"]
