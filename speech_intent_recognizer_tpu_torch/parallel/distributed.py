"""Multi-process launch over ``torch.distributed``.

Counterpart of ``speech_intent_recognizer_tpu/parallel/distributed.py``.
There, ``jax.distributed.initialize`` joins the hosts and GSPMD puts the
gradient reduction inside the jitted step.  Here each process drives one
device and joins one process group; the trainers reduce by hand
(:func:`all_reduce_gradients`, ``train/loop.py``).

:func:`initialize_distributed` keeps the JAX contract: a no-op without a
coordinator address.  Otherwise it joins the group or raises; it never
carries on as one process.  :func:`host_shard` and :func:`shard_list` are
the JAX package's pure functions, copied, with the index and count taken
from the process group.
"""

from __future__ import annotations

import datetime
import logging
from typing import Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0
# the timeout of the group initialize_distributed joined, for its subgroups
_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def _init_method(address: str) -> str:
    """``host:port`` (the JAX form) -> ``tcp://host:port``; ``tcp://`` and
    ``file://`` addresses are used as given."""
    if address.startswith(("tcp://", "file://")):
        return address
    return f"tcp://{address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: "str | torch.device" = "cuda",
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[torch.device]:
    """Join the process group of a multi-process run; a no-op (returns
    None) when ``coordinator_address`` is None.

    ``device``: ``"cuda"`` puts process ``p`` on ``cuda:{p % device_count}``
    (and raises without a card); ``"cpu"`` on the CPU.  ``backend``: NCCL on
    CUDA and gloo on the CPU by default; gloo on CUDA serves several
    processes on one card, which NCCL refuses.  Every collective of the
    group raises after ``timeout_s``.  Returns the process's device.
    Several processes without a coordinator raise: a run never carries on
    as one process when it was asked for more."""
    if coordinator_address is None:
        if (num_processes or 1) > 1:
            raise ValueError(f"num_processes={num_processes} needs a "
                             "coordinator_address")
        return None
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and "
                         "process_id")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, but "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    global _timeout
    _timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("distributed initialized: process %d/%d on %s, %s",
                rank(), world_size(), dev, backend)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's index in the default group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The default group's process count (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def new_group(ranks: Sequence[int]):
    """A subgroup of the default group (every process must create it, in
    the same order) whose collectives raise after the default group's
    timeout."""
    return dist.new_group(list(ranks), timeout=_timeout)


def barrier() -> None:
    """Wait for every process of the default group (a no-op without
    one)."""
    if is_initialized():
        dist.barrier()


def host_shard(n_items: int,
               process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> range:
    """The contiguous index range of the dataset this process owns."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = (n_items + pc - 1) // pc
    start = pi * per
    return range(start, min(start + per, n_items))


def shard_list(items: Sequence, process_index=None, process_count=None):
    return [items[i] for i in host_shard(len(items), process_index,
                                         process_count)]


@torch.no_grad()
def all_reduce_gradients(params, group, average: bool = False) -> None:
    """Sum (or average) the gradients of ``params`` over ``group`` (a
    mesh's data group) in one all-reduce of a flat fp32 buffer, as XLA's
    psum reduces them under a ``data`` mesh.  A leaf split over the
    ``model`` axis has its part here, and the processes of a data group
    hold the same part.  Parameters without a gradient are left out:
    every process runs the same graph, so every process leaves out the
    same ones."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    if average:
        flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


@torch.no_grad()
def model_sq_norm(grads: Sequence[torch.Tensor], split: Sequence[bool],
                  group) -> torch.Tensor:
    """The squared fp32 global norm of a model whose leaves ``split`` over
    ``group`` (a mesh's model group) are this process's parts: the parts'
    squared norms summed over the group, the replicated leaves' counted
    once; the same on every process of the group."""
    sq = [torch.linalg.vector_norm(g.float()).square() for g in grads]
    parts = [s for s, is_part in zip(sq, split) if is_part]
    whole = [s for s, is_part in zip(sq, split) if not is_part]
    total = torch.stack(parts).sum() if parts else sq[0].new_zeros(())
    dist.all_reduce(total, group=group)
    if whole:
        total = total + torch.stack(whole).sum()
    return total


def all_reduce_max(flag: bool, group, device) -> bool:
    """True on every process when ``flag`` is true on any."""
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())
