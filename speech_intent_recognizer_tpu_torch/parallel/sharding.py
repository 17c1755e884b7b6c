"""How batches, replicas and random draws are laid out on a mesh.

Counterpart of ``speech_intent_recognizer_tpu/parallel/sharding.py`` for
the ``data`` axis.  In the JAX package one jitted program sees the global
batch, and GSPMD splits it and inserts the collectives, so a step on a
``data`` mesh computes what the one-device step computes on the global
batch.  Here each shard runs on its own rows, and that equality is kept
by hand:

* batches split on dim 0 (:func:`batch_sharding`, :func:`shard_batch`);
* models are replicated, one copy per distinct device (:func:`replicas`);
* every random draw of a data-parallel step is the global batch's
  (:func:`sharded_generator`, ``ops/global_batch.py``): each process draws
  at the global shape from the same generator and keeps its own rows, so
  it draws what the one-process step draws for those rows;
* what crosses rows goes through the mesh's group, passed explicitly:
  mixup's partners (``ops/global_batch.gather_rows``), BatchNorm's
  statistics (``CNNAudioGRU.set_sync_group``), the gradients
  (:func:`.distributed.all_reduce_gradients`).

The ``model`` axis's rules (GRU, attention and ``fc`` leaves split over
``model``; Megatron column / row splits of the wav2vec encoder) are not
ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch

from speech_intent_recognizer_tpu_torch.ops.global_batch import (
    ShardedGenerator)
from speech_intent_recognizer_tpu_torch.parallel.mesh import (
    Mesh, local_batch_size)


def batch_sharding(mesh: Mesh, global_batch: int) -> List[slice]:
    """The rows of each data shard of a ``global_batch``-row batch; raises
    when the batch does not divide by the data axis."""
    b = local_batch_size(global_batch, mesh)
    return [slice(i * b, (i + 1) * b) for i in range(mesh.spec.data)]


def shard_batch(mesh: Mesh, batch: "torch.Tensor | Sequence[torch.Tensor]"
                ) -> list:
    """Split a tensor (or a tuple of tensors) on dim 0 over the data axis.

    In a mesh in this process: one entry per shard, each on its device.
    Over processes: one entry, this process's rows, where they are."""
    tensors = (batch,) if isinstance(batch, torch.Tensor) else tuple(batch)
    rows = batch_sharding(mesh, int(tensors[0].shape[0]))
    if mesh.over_processes:
        shards = [(rows[mesh.rank], None)]
    else:
        shards = list(zip(rows, mesh.devices))
    out = []
    for sl, dev in shards:
        part = tuple(t[sl] if dev is None else t[sl].to(dev)
                     for t in tensors)
        out.append(part[0] if isinstance(batch, torch.Tensor) else part)
    return out


def check_in_process(mesh: Optional[Mesh]) -> None:
    """Serving and evaluation run every shard in this process."""
    if mesh is not None and mesh.over_processes:
        raise ValueError("a mesh over processes: serving and evaluation "
                         "take a mesh of devices in this process "
                         "(parallel.create_mesh(devices=...))")


def run_sharded(forward: Callable, mesh: Mesh, *batch: torch.Tensor
                ) -> torch.Tensor:
    """``forward(i, *shard_i)`` on each shard of ``batch`` (tensors of one
    row count) over an in-process mesh: the batch padded to a multiple of
    the data axis with copies of its last row, the outputs concatenated
    on the batch's device, the pad rows stripped."""
    b = int(batch[0].shape[0])
    pad = -b % mesh.spec.data
    if pad:
        batch = tuple(torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
                      for t in batch)
    outs = [forward(i, *shard) for i, shard in
            enumerate(shard_batch(mesh, batch))]
    return torch.cat([o.to(batch[0].device) for o in outs])[:b]


def replicas(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One replica of ``module`` per shard of an in-process mesh: the
    module itself on its own device, one copy on each other device (a
    device listed twice shares its copy)."""
    home = next(module.parameters()).device
    by_device = {home: module}
    for dev in mesh.devices:
        if dev not in by_device:
            by_device[dev] = copy.deepcopy(module).to(dev)
    return [by_device[dev] for dev in mesh.devices]


def sharded_generator(generator: Optional[torch.Generator],
                      mesh: Optional[Mesh]):
    """``generator`` as a :class:`ShardedGenerator` for this process's rows
    when ``mesh`` spans processes; else ``generator`` itself."""
    if (mesh is None or not mesh.over_processes or generator is None
            or isinstance(generator, ShardedGenerator)):
        return generator
    return ShardedGenerator(generator, mesh.rank, mesh.spec.data)
