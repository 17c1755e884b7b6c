"""How parameters, batches, replicas and random draws are laid out on a
mesh.

Counterpart of ``speech_intent_recognizer_tpu/parallel/sharding.py``.  In
the JAX package one jitted program sees the global batch and whole
leaves, and GSPMD splits them and inserts the collectives, so a step on a
``(data, model)`` mesh computes what the one-device step computes on the
global batch.  Here each process runs its own rows with its own parts of
the split leaves, and that equality is kept by hand.

The ``data`` axis:

* batches split on dim 0 (:func:`batch_sharding`, :func:`shard_batch`);
* models are replicated, one copy per distinct device (:func:`replicas`);
* every random draw of a data-parallel step is the global batch's
  (:func:`sharded_generator`, ``ops/global_batch.py``): each process draws
  at the global shape from the same generator and keeps its own rows, so
  it draws what the one-process step draws for those rows;
* what crosses rows goes through the mesh's data group, passed
  explicitly: mixup's partners (``ops/global_batch.gather_rows``),
  BatchNorm's statistics (``CNNAudioGRU.set_sync_group``), the gradients
  (:func:`.distributed.all_reduce_gradients`).

The ``model`` axis: :func:`spec_for_leaf` is JAX's ``_spec_for_leaf`` on
the port's ``state_dict`` names (torch layout: a JAX kernel's dim 0 is a
``weight``'s dim 1).  A leaf is split only where its dimension divides by
``model``; else it is replicated, as in JAX.

* CNN-GRU: every GRU weight and bias on dim 0 (the gate-stacked 3H),
  gathered whole before use (``ops/model_parallel.gather_on_use``: K2 and
  K2T read every row of W_hh at every step); ``attention.weight`` and
  ``fc.weight`` on their input dim (row-parallel: a partial product on
  this process's slice of the GRU outputs, summed over the model group,
  then the replicated bias); conv and BatchNorm leaves replicated.
* wav2vec, Megatron style: ``q_proj`` / ``k_proj`` / ``v_proj`` and
  ``intermediate_dense`` by output (column-parallel, their biases with
  them); ``out_proj``, ``output_dense`` and the head's ``attention`` and
  ``fc`` by input (row-parallel, the bias added once after the sum); the
  feature extractor, the positional conv, the norms and
  ``masked_spec_embed`` replicated.

:func:`place_params` cuts a model's split leaves to this process's part
and hands the model its model group; the optimizer then holds Adam
moments for those parts only.  :func:`full_state_dict` and
:func:`full_optimizer_state` gather them whole (a checkpoint in the
one-process format), :func:`sharded_state_dict` and
:func:`sharded_optimizer_state` cut a whole state again.
"""

from __future__ import annotations

import copy
import re
from typing import Callable, Dict, List, Optional, Sequence

import torch

from speech_intent_recognizer_tpu_torch.ops.global_batch import (
    ShardedGenerator)
from speech_intent_recognizer_tpu_torch.ops.model_parallel import (
    gather_parts)
from speech_intent_recognizer_tpu_torch.parallel.mesh import (
    Mesh, local_batch_size)

_GRU_LEAF = re.compile(r"(^|\.)gru\.(weight|bias)_(ih|hh)_l\d+(_reverse)?$")
_COLUMN = ("q_proj", "k_proj", "v_proj", "intermediate_dense")
_ROW = ("out_proj", "output_dense")
_HEAD = ("attention", "fc")
# the attribute place_params sets on a split parameter: its split dim
SPLIT_DIM = "model_split_dim"


def spec_for_leaf(name: str, shape: Sequence[int], model: int
                  ) -> Optional[int]:
    """The dim of the ``state_dict`` leaf ``name`` (of ``shape``) split
    over a model axis of ``model``, or None (replicated): JAX's
    ``_spec_for_leaf`` in the port's names and layout."""
    if model <= 1:
        return None
    parts = name.split(".")
    owner, kind = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if _GRU_LEAF.search(name):
        return 0 if shape and shape[0] % model == 0 else None
    if owner in _COLUMN:  # the output dim, the bias with it
        ndim = {"weight": 2, "bias": 1}.get(kind)
        return 0 if len(shape) == ndim and shape[0] % model == 0 else None
    if owner in _ROW:
        return (1 if kind == "weight" and len(shape) == 2
                and shape[1] % model == 0 else None)
    if owner in _HEAD and len(parts) == 2 and kind == "weight":
        return 1 if len(shape) == 2 and shape[1] % model == 0 else None
    return None


def shard_shape(name: str, shape: Sequence[int], model: int) -> tuple:
    """The shape of one process's part of the leaf ``name`` of ``shape``
    (JAX's ``NamedSharding.shard_shape``)."""
    shape = tuple(shape)
    d = spec_for_leaf(name, shape, model)
    if d is None:
        return shape
    return shape[:d] + (shape[d] // model,) + shape[d + 1:]


def param_shardings(module: torch.nn.Module, model: int
                    ) -> Dict[str, Optional[int]]:
    """{parameter name: its split dim or None} over a model axis of
    ``model`` (the whole shapes: before :func:`place_params`)."""
    return {name: spec_for_leaf(name, tuple(p.shape), model)
            for name, p in module.named_parameters()}


def split_dim(p: torch.Tensor) -> Optional[int]:
    """The dim a placed parameter is split on, or None (replicated)."""
    return getattr(p, SPLIT_DIM, None)


def _cut(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.spec.model
    return t.narrow(dim, mesh.model_index * n, n).clone()


def place_params(module: torch.nn.Module, mesh: Optional[Mesh]
                 ) -> torch.nn.Module:
    """Cut every leaf of ``module`` that the rules split over ``mesh``'s
    model axis to this process's part (the parameter object stays, its
    data is the part) and hand the module its model group
    (``set_model_group``).  A no-op without a mesh over processes, at
    ``model`` 1, and for a leaf already placed.  Build the optimizer
    after this, so that its moments have the parts' shapes."""
    if mesh is None or not mesh.over_processes or mesh.spec.model == 1:
        return module
    for name, d in param_shardings(module, mesh.spec.model).items():
        p = module.get_parameter(name)
        if d is None or split_dim(p) is not None:
            continue
        p.data = _cut(p.data, d, mesh)
        setattr(p, SPLIT_DIM, d)
    module.set_model_group(mesh.model_group)
    return module


def _splits(module: torch.nn.Module) -> Dict[str, int]:
    return {name: split_dim(p) for name, p in module.named_parameters()
            if split_dim(p) is not None}


def _tp(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.over_processes and mesh.spec.model > 1


def full_state_dict(module: torch.nn.Module, mesh: Optional[Mesh]
                    ) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every split leaf gathered whole over
    the model group, as CPU clones: the one-process layout.  Collective
    over each model group when the mesh splits leaves (every process
    calls it)."""
    splits = _splits(module) if _tp(mesh) else {}
    out = {}
    for name, t in module.state_dict().items():
        if name in splits:
            t = gather_parts(t, mesh.model_group, splits[name])
        out[name] = t.detach().cpu().clone()
    return out


def sharded_state_dict(state: Dict[str, torch.Tensor],
                       module: torch.nn.Module, mesh: Optional[Mesh]
                       ) -> Dict[str, torch.Tensor]:
    """A one-process ``state`` with each leaf that ``module`` holds split
    cut to this process's part (loads into a placed module)."""
    if not _tp(mesh):
        return state
    splits = _splits(module)
    return {k: _cut(v, splits[k], mesh) if k in splits else v
            for k, v in state.items()}


def _map_moments(opt_state: dict, params: list, fn) -> dict:
    """A copy of an optimizer's ``state_dict`` (``train/state.py``'s
    ``Optimizer`` or the wav2vec one: the torch optimizer's under
    ``adam`` / ``adamw``) with ``fn(param, moment)`` applied to each
    moment (a tensor of its parameter's rank; not the step count)."""
    key = "adam" if "adam" in opt_state else "adamw"
    inner = dict(opt_state[key])
    state = {}
    for i, entry in inner["state"].items():
        p = params[int(i)]
        state[i] = {k: (fn(p, v) if isinstance(v, torch.Tensor)
                        and v.dim() == p.dim() and v.dim() > 0 else v)
                    for k, v in entry.items()}
    inner["state"] = state
    return {**opt_state, key: inner}


def full_optimizer_state(optimizer, mesh: Optional[Mesh]) -> dict:
    """``optimizer.state_dict()`` with the Adam moments of every split
    leaf gathered whole over the model group (collective, as
    :func:`full_state_dict`)."""
    state = optimizer.state_dict()
    if not _tp(mesh):
        return state

    def whole(p, v):
        d = split_dim(p)
        return v if d is None else gather_parts(v, mesh.model_group, d)

    return _map_moments(state, optimizer.params, whole)


def sharded_optimizer_state(state: dict, optimizer, mesh: Optional[Mesh]
                            ) -> dict:
    """A one-process optimizer ``state`` with the moments of the leaves
    that ``optimizer`` holds split cut to this process's parts."""
    if not _tp(mesh):
        return state

    def part(p, v):
        d = split_dim(p)
        return v if d is None else _cut(v, d, mesh)

    return _map_moments(state, optimizer.params, part)


def local_bytes(module: torch.nn.Module, optimizer, mesh: Optional[Mesh]
                ) -> dict:
    """This process's bytes of parameters and of Adam moments, all of them
    and those of split leaves, each beside the whole model's (a split
    leaf's whole is its part times the model axis)."""
    model = mesh.spec.model if _tp(mesh) else 1
    out = dict.fromkeys(("params", "params_full", "split", "split_full",
                         "adam", "adam_full", "adam_split",
                         "adam_split_full"), 0)

    def add(key: str, t: torch.Tensor, split: bool) -> None:
        n = t.numel() * t.element_size()
        count = model if split else 1
        out[key] += n
        out[f"{key}_full"] += n * count
        if split:
            out[f"{key}_split" if key == "adam" else "split"] += n
            out[f"{key}_split_full" if key == "adam"
                else "split_full"] += n * count

    for p in module.parameters():
        add("params", p, split_dim(p) is not None)
    for p in optimizer.params:
        for v in optimizer.moments(p):
            add("adam", v, split_dim(p) is not None)
    return out


def batch_sharding(mesh: Mesh, global_batch: int) -> List[slice]:
    """The rows of each data shard of a ``global_batch``-row batch; raises
    when the batch does not divide by the data axis."""
    b = local_batch_size(global_batch, mesh)
    return [slice(i * b, (i + 1) * b) for i in range(mesh.spec.data)]


def shard_batch(mesh: Mesh, batch: "torch.Tensor | Sequence[torch.Tensor]"
                ) -> list:
    """Split a tensor (or a tuple of tensors) on dim 0 over the data axis.

    In a mesh in this process: one entry per data shard, each on its
    device.  Over processes: one entry, this process's rows (its data
    index's), where they are."""
    tensors = (batch,) if isinstance(batch, torch.Tensor) else tuple(batch)
    rows = batch_sharding(mesh, int(tensors[0].shape[0]))
    if mesh.over_processes:
        shards = [(rows[mesh.data_index], None)]
    else:
        shards = list(zip(rows, mesh.data_devices))
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
    """One replica of ``module`` per data shard of an in-process mesh: the
    module itself on its own device, one copy on each other device (a
    device listed twice shares its copy)."""
    home = next(module.parameters()).device
    by_device = {home: module}
    for dev in mesh.data_devices:
        if dev not in by_device:
            by_device[dev] = copy.deepcopy(module).to(dev)
    return [by_device[dev] for dev in mesh.data_devices]


def sharded_generator(generator: Optional[torch.Generator],
                      mesh: Optional[Mesh]):
    """``generator`` as a :class:`ShardedGenerator` for this process's rows
    when ``mesh`` spans processes; else ``generator`` itself."""
    if (mesh is None or not mesh.over_processes or generator is None
            or isinstance(generator, ShardedGenerator)):
        return generator
    return ShardedGenerator(generator, mesh.data_index, mesh.spec.data)
