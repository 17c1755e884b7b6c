"""The ``(data, model)`` mesh in PyTorch's terms.

Counterpart of ``speech_intent_recognizer_tpu/parallel/mesh.py``.  A JAX
mesh is one grid of devices that one program sees.  Here a mesh is one of
two things:

* **over processes** (``group`` set, ``devices`` None): one process per
  device, joined by ``torch.distributed``.  The processes form the JAX
  grid ``reshape(data, model)``: process ``r`` is data index ``r //
  model`` and model index ``r % model``.  A **data group** holds the
  processes of one model index (they run different rows of every batch
  and sum their gradients); a **model group** holds the processes of one
  data index (they run the same rows, each with its part of every leaf
  split over ``model``, ``parallel/sharding.py``).  The trainers take this
  form (``train/loop.py``, ``train/wav2vec_trainer.py``).
* **in one process** (``devices`` set): an ordered list of torch devices,
  ``data * model`` of them.  Serving and evaluation take this form
  (``infer/predict.py``, ``evaluation/evaluate.py``): a replica of the
  model on each data shard's device, ``devices[d * model]`` for shard
  ``d``, each shard run where it lives; the ``model`` axis is replicated,
  as the JAX package's ``shard_map(in_specs=P("data"))`` does.  The list
  may repeat a device: ``[cuda:0, cuda:0]`` is two shards on one card,
  the analog of XLA's forced host device count, which the CPU tests and
  the one-card checks use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from speech_intent_recognizer_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshSpec:
    data: int
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` shards, either one per device of ``devices``
    (in this process) or one per process of ``group``, with that
    process's data group and model group."""

    spec: MeshSpec
    devices: Optional[Tuple[torch.device, ...]] = None
    group: Any = None  # a torch.distributed process group: every process
    data_group: Any = None  # this process's; ``group`` when model is 1
    model_group: Any = None  # this process's; None when model is 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.spec.data, MODEL_AXIS: self.spec.model}

    @property
    def over_processes(self) -> bool:
        return self.group is not None

    @property
    def rank(self) -> int:
        """This process's rank in a mesh over processes."""
        return torch.distributed.get_rank(self.group)

    @property
    def data_index(self) -> int:
        """This process's data shard: the rows it runs."""
        return self.rank // self.spec.model

    @property
    def model_index(self) -> int:
        """This process's part of every leaf split over ``model``."""
        return self.rank % self.spec.model

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each data shard of an in-process mesh."""
        return self.devices[::self.spec.model]


def _local_devices() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _indexed(device: "str | torch.device") -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that one card has one name."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def create_mesh(
    data_axis: int = -1,
    model_axis: int = 1,
    devices: Optional[Sequence["str | torch.device"]] = None,
) -> Mesh:
    """Build a ``(data, model)`` mesh.

    ``devices`` given: a mesh in this process over that list (entries may
    repeat).  Else, in a process group (:func:`.distributed.
    initialize_distributed`): a mesh over its processes.  Else: a mesh in
    this process over every CUDA device, or the CPU when there is none.
    ``data_axis=-1`` takes all the shards that ``model_axis`` leaves; the
    checks are the JAX package's.  Over processes it creates the grid's
    data and model groups, so every process of the group must call it."""
    if devices is not None:
        devs = tuple(_indexed(d) for d in devices)
        n, group = len(devs), None
    elif distributed.is_initialized():
        devs, n = None, distributed.world_size()
        group = torch.distributed.group.WORLD
    else:
        devs = tuple(_local_devices())
        n, group = len(devs), None
    model = max(1, int(model_axis))
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model axis {model}")
    data = n // model if data_axis in (-1, None) else int(data_axis)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover {n} devices")
    if group is None:
        return Mesh(MeshSpec(data, model), devs)
    data_group, model_group = _grid_groups(data, model)
    return Mesh(MeshSpec(data, model), None, group, data_group, model_group)


def _grid_groups(data: int, model: int) -> tuple:
    """This process's (data group, model group) of the ``data`` x
    ``model`` grid of the default group's processes.  ``new_group`` is
    collective: every process creates every group, in the same order,
    with the default group's timeout."""
    world = torch.distributed.group.WORLD
    if model == 1:
        return world, None
    rank = distributed.rank()
    mine = {}
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = distributed.new_group(ranks)
        if rank in ranks:
            mine["data"] = g
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = world if data == 1 else distributed.new_group(ranks)
        if rank in ranks:
            mine["model"] = g
    return mine["data"], mine["model"]


def training_mesh(mesh: Optional[Mesh], what: str) -> Optional[Mesh]:
    """The mesh a trainer runs on: ``mesh`` when it spans processes, None
    for no mesh or one data shard in this process (the one-device
    trainer; an in-process ``model`` axis is replicated); several data
    shards in one process raise."""
    if mesh is None or mesh.over_processes:
        return mesh
    if mesh.spec.data > 1:
        raise ValueError(
            f"{what}(mesh=) over several devices of one process: train "
            "data-parallel with one process per device "
            "(parallel.initialize_distributed)")
    return None


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Per-data-shard batch size; validates divisibility up front."""
    n = mesh.shape[DATA_AXIS]
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {n}")
    return global_batch // n
