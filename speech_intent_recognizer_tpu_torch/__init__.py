"""speech_intent_recognizer_tpu_torch — the PyTorch / CUDA port of
``speech_intent_recognizer_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference.  This package mirrors its
layout (``ops/``, ``models/``, ``data/``, ``infer/``, ``convert/``, ``cli/``,
``evaluation/``, ``utils/``) so each module's counterpart is found by name.
Plain tensor work is PyTorch; every Pallas kernel of the reference becomes a
kernel written by hand for Hopper, with sources in ``csrc/`` built by
:mod:`._build` at first use.  Each kernel wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch version for CPU tensors.

Ported so far: batch inference from waveform to intent probabilities
(:class:`.infer.predict.Predictor`), through the fused front-end + conv1
kernel (``ops/frontend_kernels.py``) and the bidirectional GRU recurrence
kernel (``ops/gru.py``).

Importing this package or any of its modules imports neither JAX nor the
JAX package: the pure-Python host code it needs (config, audio I/O, the
NumPy golden front-end, resampling, label maps) is copied here, and
``tests/test_torch_host.py`` pins each copy to its original.
"""

__version__ = "0.1.0"
