"""The collectives of the ``model`` axis (tensor parallelism), as the
models call them.

In the JAX package GSPMD inserts these where a leaf is split over the
``model`` axis (``speech_intent_recognizer_tpu/parallel/sharding.py``).
Here each process of a model group holds its part of each split leaf, and
a layer that reads one calls one of these explicitly, with the group
passed in (the models import nothing of ``parallel/``, which builds the
groups):

* :func:`copy_to_model` (Megatron's *f*): identity forward, the gradient
  summed over the group backward.  It stands before a layer whose
  processes each read a part of its input (a column-parallel projection,
  a slice of a row-parallel one's input): each process's gradient then
  covers its part only, and the sum is the whole gradient.
* :func:`reduce_from_model` (Megatron's *g*): the partial products of a
  row-parallel layer summed forward, identity backward.
  ``torch.distributed.nn.functional.all_reduce`` is not this: it sums in
  its backward too, which would count the gradient ``count`` times.
* :func:`gather_on_use`: a split leaf (or activation) gathered whole
  forward; backward, this process's slice of the gradient.  Every process
  of the group computes the same whole gradient from the gathered value
  (the same rows, the same weights), so its part is its slice, not a sum
  over the group.

Every sum is an all-reduce, and a gather is the all-reduce of a
zero-filled buffer that holds this process's part at its place (exact:
each element is one value plus zeros): gloo's all-gather does not take
CUDA tensors reliably, its all-reduce does.  A process's index in a model
group is its rank there, so its part of a split dimension of ``n`` is
``index * n / count`` to ``(index + 1) * n / count``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist


def model_part(group: Any) -> Tuple[int, int]:
    """(this process's index, the process count) of a model group."""
    return dist.get_rank(group), dist.get_world_size(group)


def part_slice(n: int, group: Any) -> slice:
    """This process's part of a dimension of ``n`` split over ``group``."""
    index, count = model_part(group)
    k = n // count
    return slice(index * k, (index + 1) * k)


@torch.no_grad()
def gather_parts(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """Every process's part of ``x`` along ``dim``, in index order, on every
    process of ``group`` (no autograd)."""
    index, count = model_part(group)
    dim = dim % x.dim()
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * count
    full = x.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(x)
    dist.all_reduce(full, group=group)
    return full


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim % x.dim(), x.shape[dim]
        return gather_parts(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        index, _ = model_part(ctx.group)
        return dy.narrow(ctx.dim, index * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward; backward, the gradient summed over
    ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over ``group`` forward; backward, the
    gradient as it is."""
    return _ReduceFromModel.apply(x, group)


def gather_on_use(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """The whole of a split ``x`` along ``dim`` forward; backward, this
    process's slice of the (whole, the same on every process) gradient."""
    return _GatherOnUse.apply(x, group, dim)


def row_parallel(x: torch.Tensor, weight: torch.Tensor,
                 bias: "torch.Tensor | None", group: Any) -> torch.Tensor:
    """``F.linear(x_whole, weight_whole, bias)`` from this process's parts:
    ``x`` its slice of the input features, ``weight`` its columns; the
    partial products summed over ``group``, then the (replicated) bias
    added once.  In ``x``'s dtype when that is fp32; else the products of
    its rounded operands summed in fp32 and rounded once, as one GEMM of
    that dtype accumulates."""
    dt = x.dtype
    y = torch.nn.functional.linear(x.float(), weight.to(dt).float())
    y = reduce_from_model(y, group)
    if bias is not None:
        y = y + bias.to(dt).float()
    return y.to(dt)


def split_attention_pool(x: torch.Tensor, attention: torch.nn.Linear,
                         fc: torch.nn.Linear, group: Any,
                         score_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Attention pooling over time and a linear head with ``attention``
    and ``fc`` row-parallel (their weights this process's input columns):
    this process's slice of ``x``'s features behind *f* (the whole
    gradient of ``x`` is the sum of the slices'), the scores (in
    ``score_dtype``) and logits summed over ``group``, the biases added
    once; the softmax over time and the pooling in fp32.  The pooling
    weights feed every process's slice, so they pass *f* too.  ->
    (B, C) fp32 logits."""
    xs = copy_to_model(x, group)[..., part_slice(x.shape[-1], group)]
    scores = row_parallel(xs.to(score_dtype), attention.weight,
                          attention.bias, group)
    weights = copy_to_model(torch.softmax(scores.float(), dim=1), group)
    pooled = (xs.float() * weights).sum(dim=1)
    return row_parallel(pooled, fc.weight.float(), fc.bias.float(), group)
