"""speech_intent_recognizer_tpu_torch — the PyTorch / CUDA port of
``speech_intent_recognizer_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference.  This package mirrors its
layout (``ops/``, ``models/``, ``data/``, ``infer/``, ``convert/``, ``cli/``,
``evaluation/``, ``utils/``) so each module's counterpart is found by name.
Plain tensor work is PyTorch; every Pallas kernel of the reference becomes a
kernel written by hand for Hopper, with sources in ``csrc/`` built by
:mod:`._build` at first use.  Each kernel wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch version for CPU tensors.

Ported so far:

* batch inference from waveform to intent probabilities
  (:class:`.infer.predict.Predictor`), through the fused front-end + conv1
  kernel (K1, ``ops/frontend_kernels.py``) and the bidirectional GRU
  recurrence kernel (K2, ``ops/gru.py``), with conv2 + conv3 in one
  kernel (K5, ``ops/conv23.py``) where its shape contract holds, else
  cuDNN with torch's epilogues; off the reference geometry the front-end
  runs the dB-mel kernel (K4); the model's ``pool_impl="kernel"`` form
  runs the conv epilogue kernel after each raw convolution (K6,
  ``ops/pool_epilogue.py``);
* training from precomputed features: the precompute (``data/cache.py``,
  through the fused front-end kernel K3), the ``train.loop.Trainer`` (K2
  and its backward kernel under autograd), checkpoints, evaluation and the
  ``cli`` entry points;
* streaming sessions and the multi-session server (``infer/streaming.py``,
  ``infer/server.py``) and waveform-resident training (``cli/run_pipeline``);
* serving artifacts (``infer/export.py``, ``cli/export_model``): the batch
  path traced with ``torch.export``, each forward kernel one op of the
  ``sir`` namespace (``ops/library.py``).

Importing this package or any of its modules imports no JAX and nothing of
the JAX package.  The pure-Python host code it needs (the config schema and
reader, audio I/O, manifests, the NumPy golden front-end, resampling, label
maps, metrics) is copied here, and the
``tests/test_torch_*.py`` files pin each copy to its original.
"""

__version__ = "0.1.0"
