"""Model checkpoint loading (reference-layout ``.pt`` / ``.pth``).

The reference publishes its model as a bare ``state_dict``
(``scripts/train.py:288``), sometimes wrapped as ``{'model_state_dict': ...}``
by an older trainer; both load here.  The reference package's native
``.msgpack`` checkpoints are not read yet.
"""

from __future__ import annotations

from typing import Dict

import torch


def load_model_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference-layout state dict onto the CPU."""
    if not path.endswith((".pt", ".pth")):
        raise ValueError(
            f"{path}: only .pt/.pth state dicts load in the torch port; "
            "convert a .msgpack checkpoint with the reference package's "
            "convert.torch_export.save_torch_checkpoint")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model_state_dict" in state:
        state = state["model_state_dict"]
    return dict(state)
