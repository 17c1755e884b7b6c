"""Flax variables -> reference-layout torch ``state_dict``.

The same mapping as ``speech_intent_recognizer_tpu/convert/torch_export.py``
(``export_torch_state_dict``), taking the Flax trees as numpy arrays (no JAX
import here) and returning torch tensors.  Handles every form of the model:
train form (``bn{i}`` + batch_stats), BN-folded (conv biases, no BN) and the
``conv1_external`` variant (no ``conv1``).

* ``conv{i}/kernel`` (kH, kW, I, O)  -> ``conv{i}.weight`` (O, I, kH, kW)
* ``bn{i}/scale,bias`` + stats       -> ``bn{i}.weight,bias,running_*``
* ``gru/l{L}_{fwd,bwd}_*``           -> ``gru.*_l{L}[_reverse]`` (as is)
* ``attention|fc/kernel`` (F, C)     -> ``.weight`` (C, F)
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def from_jax_variables(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    batch_stats = batch_stats or {}

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out: Dict[str, torch.Tensor] = {}
    convs = sorted((k for k in params if k.startswith("conv")),
                   key=lambda k: int(k[len("conv"):]))
    for name in convs:
        idx = name[len("conv"):]
        out[f"{name}.weight"] = t(np.transpose(
            np.asarray(params[name]["kernel"]), (3, 2, 0, 1)))
        if "bias" in params[name]:
            out[f"{name}.bias"] = t(params[name]["bias"])
        bn = params.get(f"bn{idx}")
        if bn is not None:
            stats = batch_stats[f"bn{idx}"]
            out[f"bn{idx}.weight"] = t(bn["scale"])
            out[f"bn{idx}.bias"] = t(bn["bias"])
            out[f"bn{idx}.running_mean"] = t(stats["mean"])
            out[f"bn{idx}.running_var"] = t(stats["var"])
            out[f"bn{idx}.num_batches_tracked"] = torch.tensor(0)

    gru = params["gru"]
    layers = sorted({int(k.split("_")[0][1:]) for k in gru})
    for layer in layers:
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            key = f"l{layer}_{direction}"
            for src, dst in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                out[f"gru.{dst}_l{layer}{suffix}"] = t(gru[f"{key}_{src}"])

    for head in ("attention", "fc"):
        out[f"{head}.weight"] = t(np.asarray(params[head]["kernel"]).T)
        out[f"{head}.bias"] = t(params[head]["bias"])
    return out
