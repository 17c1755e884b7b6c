"""Front-end and recurrence ops: plain PyTorch versions and the
hand-written CUDA kernels that replace the Pallas kernels."""
