"""Model checkpoint loading: reference-layout ``.pt`` / ``.pth`` state
dicts and the JAX package's ``.msgpack`` exports, of either model family.

The reference publishes its model as a bare ``state_dict``
(``scripts/train.py:288``), sometimes wrapped as ``{'model_state_dict': ...}``
by an older trainer; both load here.  A ``.msgpack`` (``{params,
batch_stats}`` from the JAX trainer's ``save_best`` / ``save_model``) is
read by :mod:`.msgpack` and mapped to the same layout by
:func:`.jax_bridge.from_jax_variables`.  A wav2vec checkpoint (a ``.pt``
with ``wav2vec.*`` or ``wav2vec2.*`` backbone keys, a ``.msgpack`` whose
``params`` hold ``wav2vec2``) becomes the port's ``Wav2VecIntent`` state
dict (:mod:`.wav2vec_import`: the positional convolution's weight norm
folded, the backbone under ``wav2vec.``).
"""

from __future__ import annotations

from typing import Dict

import torch


def load_model_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference-layout state dict onto the CPU."""
    if path.endswith(".msgpack"):
        from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
            from_jax_variables)
        from speech_intent_recognizer_tpu_torch.convert.msgpack import (
            MsgpackError, read_variables)

        params, batch_stats = read_variables(path)
        if "wav2vec2" in params:
            from speech_intent_recognizer_tpu_torch.convert.wav2vec_import \
                import from_jax_params

            return from_jax_params(params)
        try:
            return from_jax_variables(params, batch_stats)
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            raise MsgpackError(f"{path}: not a CNNAudioGRU checkpoint "
                               f"({type(e).__name__}: {e})") from None
    if not path.endswith((".pt", ".pth")):
        raise ValueError(f"{path}: the torch port loads .pt / .pth state "
                         "dicts and .msgpack checkpoints")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model_state_dict" in state:
        state = state["model_state_dict"]
    from speech_intent_recognizer_tpu_torch.convert.wav2vec_import import (
        convert_wav2vec_intent_state_dict, is_wav2vec_state)

    if is_wav2vec_state(state):
        return convert_wav2vec_intent_state_dict(state)[0]
    return dict(state)
