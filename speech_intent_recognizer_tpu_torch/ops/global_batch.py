"""One process's rows of a global batch: its random draws and its partners.

In a data-parallel step each process runs rows ``rank * b`` to
``(rank + 1) * b`` of a global batch of ``world * b`` rows.  For the step
to be the one-process step on the global batch, every random draw must be
the global batch's: a process draws at the global shape from the same
generator as every other process and keeps its rows
(:class:`ShardedGenerator`, :func:`rand_rows`, :func:`randn_rows`).  A
draw for the whole batch (mixup's permutation and weights, LayerDrop) is
made from the plain generator (:func:`base_generator`).  Every process then
advances its generator alike.  What reads other processes' rows takes
their process group explicitly (:func:`gather_rows`).

With a plain ``torch.Generator`` (or None) every helper is the ordinary
draw, so the one-device path is unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ShardedGenerator:
    """``generator`` drawing for rows ``rank * b`` to ``(rank + 1) * b`` of
    a global batch of ``world * b`` rows."""

    generator: torch.Generator
    rank: int
    world: int


def base_generator(generator) -> Optional[torch.Generator]:
    """The ``torch.Generator`` of a draw made for the whole batch."""
    if isinstance(generator, ShardedGenerator):
        return generator.generator
    return generator


def row_shard(generator) -> Tuple[int, int]:
    """(this process's index, the process count) of the rows; (0, 1)
    for a plain generator."""
    if isinstance(generator, ShardedGenerator):
        return generator.rank, generator.world
    return 0, 1


def _rows(draw, shape, generator, device, dim: int) -> torch.Tensor:
    if not isinstance(generator, ShardedGenerator):
        return draw(tuple(shape), generator=generator, device=device)
    shape = list(shape)
    n = shape[dim]
    shape[dim] = n * generator.world
    full = draw(tuple(shape), generator=generator.generator, device=device)
    return full.narrow(dim, generator.rank * n, n)


def rand_rows(shape, generator, device, dim: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` for this process's rows; ``shape[dim]`` is the
    batch dimension."""
    return _rows(torch.rand, shape, generator, device, dim)


def randn_rows(shape, generator, device, dim: int = 0) -> torch.Tensor:
    """``torch.randn(shape)`` for this process's rows."""
    return _rows(torch.randn, shape, generator, device, dim)


def gather_rows(x: torch.Tensor, generator, group: Any) -> torch.Tensor:
    """Every process's rows of the global batch, in rank order, on every
    process of ``group``: this process's rows at their place in a zero
    buffer, summed over the group (exact: each element is one value plus
    zeros).  An all-reduce, because gloo's all-gather does not take CUDA
    tensors reliably and its all-reduce does.  Raises when the rows are a
    part of the batch and no group was given."""
    rank, world = row_shard(generator)
    if world == 1:
        return x
    if group is None:
        raise ValueError("the other processes' rows need their process "
                         "group (group=)")
    n = x.shape[0]
    full = x.new_zeros((n * world,) + tuple(x.shape[1:]))
    full[rank * n:(rank + 1) * n] = x
    dist.all_reduce(full, group=group)
    return full
