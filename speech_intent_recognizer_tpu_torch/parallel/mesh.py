"""The ``(data, model)`` mesh in PyTorch's terms.

Counterpart of ``speech_intent_recognizer_tpu/parallel/mesh.py``.  A JAX
mesh is one grid of devices that one program sees.  Here a mesh is one of
two things:

* **over processes** (``group`` set, ``devices`` None): one process per
  device, joined by ``torch.distributed``; the ``data`` axis is the
  group's world size and each process runs its own rows of every batch.
  The trainers take this form (``train/loop.py``,
  ``train/wav2vec_trainer.py``).
* **in one process** (``devices`` set): an ordered list of torch devices,
  one per shard of a batch.  Serving and evaluation take this form
  (``infer/predict.py``, ``evaluation/evaluate.py``): a replica of the
  model on each device, each shard run where it lives.  The list may
  repeat a device: ``[cuda:0, cuda:0]`` is two shards on one card, the
  analog of XLA's forced host device count, which the CPU tests and the
  one-card checks use.

The ``model`` axis (tensor parallelism) is not ported yet: ``create_mesh``
refuses ``model_axis > 1`` (ROADMAP.md, Queue 1).
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
    (in this process) or one per process of ``group``."""

    spec: MeshSpec
    devices: Optional[Tuple[torch.device, ...]] = None
    group: Any = None  # a torch.distributed process group

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.spec.data, MODEL_AXIS: self.spec.model}

    @property
    def over_processes(self) -> bool:
        return self.group is not None

    @property
    def rank(self) -> int:
        """This process's shard of a mesh over processes."""
        return torch.distributed.get_rank(self.group)


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
    checks are the JAX package's."""
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
    if model > 1:
        raise NotImplementedError(
            f"model_axis={model}: tensor parallelism is not ported yet "
            "(ROADMAP.md, Queue 1: the model axis)")
    return Mesh(MeshSpec(data, model), devs, group)


def training_mesh(mesh: Optional[Mesh], what: str) -> Optional[Mesh]:
    """The mesh a trainer runs data-parallel on: ``mesh`` when it spans
    processes, None for no mesh or one device in this process (the
    one-device trainer); several devices in one process raise."""
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
