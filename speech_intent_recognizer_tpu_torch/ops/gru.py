"""K2 and its backward: the bidirectional GRU recurrence kernels —
wrappers, plain versions, counters, and the autograd function joining them.

* K2, :func:`gru_layer`, replaces
  ``speech_intent_recognizer_tpu/ops/gru_pallas.py`` (``_gru_layer_kernel``,
  wrappers ``_gru_layer_call`` and ``gru_bidirectional_pallas``).  CUDA
  source ``csrc/gru_layer.cu``: one launch runs one layer, both directions,
  all T steps; h stays on chip in fp32.
* K2 on the input GEMM's layout, :func:`gru_layer_btc` (op
  ``sir::gru_layer_btc``), for calls autograd does not record: the same
  kernels read the (B, T, 6H) output of one GEMM over both directions and
  write the (B, T, 2H) the next layer reads, through strides
  (:func:`k2_strides`); :func:`btc_operands` builds that GEMM's weight and
  its bias with b_hh[r, z] folded in.  ``models/cnn_gru.TorchGRU`` takes
  it wherever autograd records nothing; counted on its own.
* K2 backward, :func:`gru_layer_backward`, replaces the custom-VJP backward
  ``_gru_layer_diff_bwd``: the exact adjoint recurrence in reversed time.
  CUDA source ``csrc/gru_layer_bwd.cu`` produces dgx and the fp32 gate
  adjoints dgh; dW and db_hn are one batched fp32 GEMM and a sum over them
  here, as the JAX package leaves its weight-gradient product to XLA.

:func:`gru_plan` says which kernel a call launches: the tensor-core
kernel (``"mma"``: bf16 operands at H = 256, W_hh resident on chip across a
cluster of four blocks; needs ``sm_90a`` clusters), the fp32 cluster kernel
(``"cluster"``, forward and backward: fp32 operands at H = 256, the parity
path, W_hh resident on chip across a cluster of eight blocks, fp32 FMAs on
CUDA cores), or the CUDA-core kernel (``"simt"``: every other H; W_hh
streams from L2 every step).

Under autograd :func:`gru_layer` runs through :class:`_GRULayer`, which
saves (gx, w, bn, ys) as ``_gru_layer_diff_fwd`` does.  The forward kernel
is the op ``sir::gru_layer`` (``ops/library.py``): for CUDA tensors the
forward calls it, and its ``CUDA`` implementation (:func:`_gru_layer_cuda`)
picks the plan on the card it runs on, launches and counts; the backward
is launched from :class:`_GRULayer` directly.  Each source's header
says what bounds it on the H100 and how the design answers that.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops import library
from speech_intent_recognizer_tpu_torch.utils.profiling import span


def _gru_layer_plain(gx: torch.Tensor, w: torch.Tensor,
                     bn: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: the same recurrence as a loop over time.  The
    recurrent product takes operands rounded to ``w.dtype`` and sums in
    fp32; h is carried in fp32; the output is rounded to ``gx.dtype``."""
    hidden = w.shape[1]
    wf = w.float()
    bnf = bn.float()
    h = torch.zeros((2, gx.shape[2], hidden), dtype=torch.float32,
                    device=gx.device)
    ys = []
    for t in range(gx.shape[1]):
        gh = torch.bmm(h.to(w.dtype).float(), wf)
        g = gx[:, t].float()
        r = torch.sigmoid(g[..., :hidden] + gh[..., :hidden])
        z = torch.sigmoid(g[..., hidden:2 * hidden]
                          + gh[..., hidden:2 * hidden])
        n = torch.tanh(g[..., 2 * hidden:] + r * (gh[..., 2 * hidden:] + bnf))
        h = (1.0 - z) * n + z * h
        ys.append(h.to(gx.dtype))
    return torch.stack(ys, dim=1)


# batch rows per block of the CUDA-core kernels (both sources)
TILE_ROWS = (4, 16)
# what the tensor-core kernels take: hidden size, blocks per cluster, and the
# batch rows per cluster that csrc/gru_layer.cu and csrc/gru_layer_bwd.cu
# instantiate
MMA_HIDDEN = 256
MMA_CLUSTER = 4
MMA_ROWS = tuple(range(16, 129, 16))
MMA_ROWS_BACKWARD = (16, 32)
# a step's fixed cost (barriers, exchange, gates' latency) in units of one
# batch row's cost, forward and backward: fitted to the kernels' times on an
# H100 at each height (bench_torch_gru_variants.py; PERF.md)
MMA_STEP_OVERHEAD = (26, 7)
# shared memory a block may use on sm_90
SMEM_LIMIT = 232448
# the fp32 cluster kernel (forward, H = MMA_HIDDEN): blocks per cluster,
# the batch rows per cluster csrc/gru_layer.cu instantiates, and the k-slices
# (warps) whose partial sums meet in shared memory
CLUSTER_SIZE = 8
CLUSTER_ROWS = (1, 2, 4, 8, 16, 32)
CLUSTER_SLICES = 8
# us per step of the fp32 cluster kernel, a fixed part and one per row of a
# tile (times the waves of clusters): a least-squares fit to its times on an
# H100 (every height at B = 1 / 16 / 256 / 2048, T = 25; PERF.md)
CLUSTER_STEP_US = (0.92, 0.214)
# the fp32 cluster backward (csrc/gru_layer_bwd.cu): the batch rows per
# cluster it instantiates, and its us per step as CLUSTER_STEP_US counts
# the forward's: a least-squares fit (relative errors) to its times on an
# H100 (every height at B = 16 / 64 / 256 / 1024, T = 25,
# bench_torch_gru_variants.py; PERF.md)
CLUSTER_ROWS_BACKWARD = (1, 2, 4, 8, 16)
CLUSTER_BWD_STEP_US = (1.78, 0.397)
# floats of a row of k of the backward's slice of W^T in shared memory: its
# 3 H / CLUSTER_SIZE columns and 4 of padding
CLUSTER_WT_STRIDE = 3 * (MMA_HIDDEN // CLUSTER_SIZE) + 4


class Plan(NamedTuple):
    """What a call launches: ``kernel`` is ``"mma"`` (tensor cores, W_hh on
    chip across a cluster), ``"cluster"`` (fp32 on CUDA cores, W_hh on chip
    across a cluster) or ``"simt"`` (CUDA cores, W_hh from L2); ``rows``
    the batch rows per cluster or block."""
    kernel: str
    rows: int


def tile_rows(batch: int, sm_count: int) -> int:
    """Rows per block of the CUDA-core kernels: 16 where that still puts a
    block on every SM (grid = 2 directions x batch tiles), else 4.  Taller
    tiles read W_hh from L2 fewer times; shorter ones keep small batches
    spread over the SMs."""
    return 16 if 2 * -(-batch // 16) >= sm_count else 4


def mma_smem_bytes(rows: int, backward: bool = False) -> int:
    """Dynamic shared memory of a tensor-core kernel with ``rows``-row
    tiles, as ``mma_smem_bytes`` / ``bwd_mma_smem_bytes`` in the sources
    count it.  Forward: two h tiles (rows x 512 B) and two gx stages (rows
    x 384 B).  Backward: the rank's slice of W (98,304 B), the inbox of
    partial sums (2 buffers x 4 ranks x rows x 256 B), dgh as bf16 hi | lo
    (rows x 768 B), the h_prev tile, the gx slice and the dys slice."""
    if backward:
        return (MMA_HIDDEN * 3 * (MMA_HIDDEN // MMA_CLUSTER) * 2
                + rows * (2 * 4 * 256 + 768 + 512 + 384 + 128))
    return rows * (2 * 512 + 2 * 384)


def cluster_smem_bytes(rows: int, backward: bool = False) -> int:
    """Dynamic shared memory of the fp32 cluster kernel with ``rows``-row
    tiles, as ``f32_smem_bytes`` / ``f32_bwd_smem_bytes`` in
    ``csrc/gru_mma.cuh`` count it: two h (h_prev) tiles (rows x 1,024 B)
    and the k-slices' partial sums (8 x rows x 3 x H / 8 floats); W_hh^T is
    in registers.  The backward adds the rank's slice of W^T by rows of k
    (H x ``CLUSTER_WT_STRIDE`` floats), the dgh tile (rows x 3 H / 8) and
    the inbox of partial sums of dh_prev (2 buffers x 8 ranks x rows x
    H / 8)."""
    units = MMA_HIDDEN // CLUSTER_SIZE
    floats = 2 * rows * MMA_HIDDEN + CLUSTER_SLICES * rows * 3 * units
    if backward:
        floats += (MMA_HIDDEN * CLUSTER_WT_STRIDE + rows * 3 * units
                   + 2 * CLUSTER_SIZE * rows * units)
    return 4 * floats


def _waves(batch: int, rows: int, clusters: int) -> int:
    """Rounds of ``clusters`` resident clusters that 2 x ceil(batch / rows)
    clusters take."""
    return -(-2 * -(-batch // rows) // clusters)


def gru_plan(batch: int, hidden: int, dtype: torch.dtype, sm_count: int,
             backward: bool = False, clusters: "int | None" = None) -> Plan:
    """The kernel and tile height a CUDA call of :func:`gru_layer` (or, with
    ``backward``, :func:`gru_layer_backward`) launches.

    ``clusters`` is how many clusters of the kernel the operands would take
    run at once (what ``cudaOccupancyMaxActiveClusters`` reports; one block
    fills an SM).  bf16 operands at ``hidden == MMA_HIDDEN`` take the
    tensor-core kernel: without ``clusters``, ``sm_count // MMA_CLUSTER``
    (30 on an H100 with 132 SMs, whose clusters may not span two GPCs); the
    2 x ceil(batch / rows) clusters of a launch run in waves, and a wave
    lasts T steps of about ``MMA_STEP_OVERHEAD + rows`` time units each.
    The height with the least waves x step cost wins, the shorter one on a
    tie.  fp32 at ``hidden == MMA_HIDDEN`` takes the cluster kernel at the
    height with the least waves (of ``clusters``, without it ``sm_count //
    CLUSTER_SIZE``) x the step cost (``CLUSTER_STEP_US``, backward
    ``CLUSTER_BWD_STEP_US``), the shorter on a tie.  Other hidden sizes
    take the CUDA-core kernel at :func:`tile_rows`.
    """
    simt = Plan("simt", tile_rows(batch, sm_count))
    if hidden != MMA_HIDDEN or dtype not in (torch.bfloat16, torch.float32):
        return simt
    if dtype == torch.float32:
        resident = max(clusters or sm_count // CLUSTER_SIZE, 1)
        fixed, per_row = CLUSTER_BWD_STEP_US if backward else CLUSTER_STEP_US

        def us(rows):
            return _waves(batch, rows, resident) * (fixed + per_row * rows)

        heights = CLUSTER_ROWS_BACKWARD if backward else CLUSTER_ROWS
        return Plan("cluster", min(heights, key=lambda r: (us(r), r)))
    if clusters is None:
        clusters = sm_count // MMA_CLUSTER
    clusters = max(clusters, 1)
    heights = MMA_ROWS_BACKWARD if backward else MMA_ROWS
    overhead = MMA_STEP_OVERHEAD[backward]

    def cost(rows):
        return _waves(batch, rows, clusters) * (overhead + rows)

    return Plan("mma", min(heights, key=lambda rows: (cost(rows), rows)))


def gru_layer(gx: torch.Tensor, w: torch.Tensor, bn: torch.Tensor,
              rows: "int | Plan | None" = None) -> torch.Tensor:
    """One bidirectional GRU layer over precomputed input projections.

    Args:
      gx: (2, T, B, 3H) ``x @ W_ih^T + b_ih + b_hh[r, z]``; index 0 in
        forward time, index 1 in reversed time.
      w: (2, H, 3H) transposed recurrent weights, ``gx.dtype``.
      bn: (2, 1, H) float32 n-gate recurrent bias.
      rows: None launches what :func:`gru_plan` picks for the card.  For
        checks and timing, an int of ``TILE_ROWS`` forces the CUDA-core
        kernel at that height and a :class:`Plan` forces that kernel and
        height (``Plan("mma", 64)``, ``Plan("cluster", 2)``).  Ignored on
        the CPU.

    Returns (2, T, B, H) hidden states in ``gx.dtype``, direction 1 in
    reversed time.  CPU tensors take the plain version; CUDA tensors
    (bfloat16 or float32) launch the kernel or raise.  Differentiable:
    under autograd the backward is :func:`gru_layer_backward`.
    """
    _check_operands(gx, w, bn)
    if _records_autograd(gx, w, bn):
        return _GRULayer.apply(gx, w, bn, rows)
    return _gru_layer_forward(gx, w, bn, rows)


gru_layer.launches = 0
# the same launches by kernel (a Plan's ``kernel``)
gru_layer.kernel_launches = {"simt": 0, "mma": 0, "cluster": 0}


def _check_operands(gx, w, bn) -> None:
    """K2's operands: gx (2, T, B, 3H) (or such a view), w, bn; their
    shapes, types and device."""
    two, steps, batch, three_h = gx.shape
    hidden = three_h // 3
    if (two != 2 or three_h != 3 * hidden
            or tuple(w.shape) != (2, hidden, three_h)
            or tuple(bn.shape) != (2, 1, hidden)):
        raise ValueError(f"bad GRU shapes gx {tuple(gx.shape)}, w "
                         f"{tuple(w.shape)}, bn {tuple(bn.shape)}")
    if gx.device.type == "cuda":
        if (gx.dtype not in (torch.bfloat16, torch.float32)
                or w.dtype != gx.dtype):
            raise ValueError(f"gx and w must both be bfloat16 or float32, "
                             f"got {gx.dtype} / {w.dtype}")
        if bn.dtype != torch.float32:
            raise ValueError("bn must be float32")
    elif gx.device.type != "cpu":
        raise ValueError(f"unsupported device {gx.device}")


def _records_autograd(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def btc_view(t: torch.Tensor) -> torch.Tensor:
    """A (B, T, 2C) tensor that holds direction d in columns [C d, C d + C),
    both directions in forward time, as the (2, T, B, C) view K2
    addresses (no copy)."""
    return t.unflatten(-1, (2, -1)).permute(2, 1, 0, 3)


def k2_strides(gx: torch.Tensor, ys: torch.Tensor,
               reverse: bool = False) -> tuple:
    """K2's addressing (``csrc/gru_mma.cuh`` ``Strides``) of (2, T, B, .)
    views ``gx`` and ``ys``: the direction, step and row strides of each in
    elements, then whether direction 1 runs from step T - 1 down to 0."""
    return (*gx.stride()[:3], *ys.stride()[:3], int(reverse))


def gru_layer_btc(gx: torch.Tensor, w: torch.Tensor,
                  bn: torch.Tensor) -> torch.Tensor:
    """One bidirectional GRU layer on the input GEMM's own layout, for
    calls that autograd does not record (serving, evaluation).

    K2 reads gx and writes ys through strides (:func:`k2_strides`), so no
    flip, stack or concatenation runs around it.

    Args:
      gx: (B, T, 6H) ``x @ W_ih^T + b_ih + [b_hh[r, z]; 0]`` of direction d
        in columns [3H d, 3H d + 3H), both directions in forward time: one
        GEMM over :func:`btc_operands`' stacked W_ih and fused bias.
      w, bn: as :func:`gru_layer`'s.

    Returns (B, T, 2H) in ``gx.dtype``: h of direction d at time t in
    columns [H d, H d + H), ``torch.nn.GRU``'s bidirectional output and the
    next layer's GEMM input.  CPU tensors take the plain version
    (:func:`gru_layer`'s on the same values); CUDA tensors launch the
    kernel :func:`gru_plan` picks for B, or raise.  Operands that autograd
    would record are refused: :func:`gru_layer` has the backward.
    """
    if gx.dim() != 3 or gx.shape[-1] % 6:
        raise ValueError(f"gx must be (B, T, 6H), got {tuple(gx.shape)}")
    g = btc_view(gx)
    _check_operands(g, w, bn)
    if _records_autograd(gx, w, bn):
        raise ValueError("gru_layer_btc has no backward: under autograd "
                         "call gru_layer")
    if gx.device.type == "cpu":
        return _gru_layer_btc_plain(gx, w, bn)
    _check_cuda(g, (gx, w, bn), None)
    return torch.ops.sir.gru_layer_btc(gx, w, bn)


gru_layer_btc.launches = 0
# the same launches by kernel (a Plan's ``kernel``)
gru_layer_btc.kernel_launches = {"simt": 0, "mma": 0, "cluster": 0}


def _gru_layer_btc_plain(gx, w, bn):
    """Plain :func:`gru_layer_btc`: :func:`_gru_layer_plain` on gx laid out
    as :func:`gru_layer` takes it, its output laid out back; the same
    bits."""
    g = btc_view(gx)
    ys = _gru_layer_plain(torch.stack([g[0], g[1].flip(0)]), w, bn)
    return torch.cat([ys[0], ys[1].flip(0)], dim=-1).transpose(0, 1) \
        .contiguous()


def btc_operands(w_ih, w_hh, b_ih, b_hh, dtype: torch.dtype) -> tuple:
    """One layer's operands of :func:`gru_layer_btc` and its GEMM, from the
    leaves in ``torch.nn.GRU``'s layout; each argument is the pair
    (forward, reverse).

    Returns W_ih of both directions as one (6H, F) matrix in ``dtype``; its
    bias (6H,), ``b_ih + [b_hh[r, z]; 0]`` of each direction summed in the
    leaves' type and rounded to ``dtype`` once, so the GEMM's epilogue adds
    b_hh[r, z]; W_hh^T (2, H, 3H) in ``dtype``; and b_hn (2, 1, H) float32
    from b_hh in ``dtype``, as :func:`gru_bidirectional` takes it (it stays
    inside K2's ``r * (h W_hn + b_hn)``).
    """
    hidden = w_hh[0].shape[1]
    # split, not indexing: a graph traced on fake CUDA tensors in a
    # CPU-only build cannot index them (tests/test_torch_export.py)
    rz, n = zip(*(bh.split([2 * hidden, hidden]) for bh in b_hh))
    bias = [bi + torch.cat([r, m.new_zeros(hidden)])
            for bi, r, m in zip(b_ih, rz, n)]
    w = torch.stack([m.to(dtype).t() for m in w_hh]).contiguous()
    bn = torch.stack([m.to(dtype) for m in n]).unsqueeze(1).float() \
        .contiguous()
    return (torch.cat(list(w_ih)).to(dtype).contiguous(),
            torch.cat(bias).to(dtype), w, bn)


def _check_cuda(gx, tensors, rows, backward=False) -> "Plan | None":
    """Validate CUDA operands of K2 / K2 backward and a forced plan; the
    plan, or None where :func:`picked_plan` picks it on the card."""
    hidden = gx.shape[-1] // 3
    if any(t.device != gx.device or not t.is_contiguous() for t in tensors):
        raise ValueError("GRU operands must be contiguous on one device")
    if hidden % 32 or hidden > 1024:
        raise ValueError(f"hidden size {hidden} must be a multiple of 32, "
                         "at most 1024")
    if rows is None:
        return None
    plan = rows if isinstance(rows, Plan) else Plan("simt", rows)
    if plan.kernel == "simt":
        if plan.rows not in TILE_ROWS:
            raise ValueError(f"rows must be one of {TILE_ROWS}, got "
                             f"{plan.rows}")
    elif plan.kernel == "mma":
        heights = MMA_ROWS_BACKWARD if backward else MMA_ROWS
        if plan.rows not in heights:
            raise ValueError(f"the tensor-core kernel takes rows of "
                             f"{heights}, got {plan.rows}")
        if gx.dtype != torch.bfloat16 or hidden != MMA_HIDDEN:
            raise ValueError(f"the tensor-core kernel takes bfloat16 at "
                             f"hidden {MMA_HIDDEN}, got {gx.dtype} at "
                             f"{hidden}")
    elif plan.kernel == "cluster":
        heights = CLUSTER_ROWS_BACKWARD if backward else CLUSTER_ROWS
        if plan.rows not in heights:
            raise ValueError(f"the fp32 cluster kernel"
                             f"{'s backward' if backward else ''} takes "
                             f"rows of {heights}, got {plan.rows}")
        if gx.dtype != torch.float32 or hidden != MMA_HIDDEN:
            raise ValueError(f"the fp32 cluster kernel takes float32 at "
                             f"hidden {MMA_HIDDEN}, got {gx.dtype} at "
                             f"{hidden}")
    else:
        raise ValueError(f"unknown kernel {plan.kernel!r}")
    return plan


def _cuda_plan(gx, tensors, rows, backward=False) -> Plan:
    """Validate CUDA operands of K2 / K2 backward; what to launch."""
    plan = _check_cuda(gx, tensors, rows, backward)
    if plan is None:
        return picked_plan(gx.shape[2], gx.shape[-1] // 3, gx.dtype,
                           gx.device, backward)
    return plan


_clusters: dict = {}


def _resident_clusters(device: torch.device, name: str) -> int:
    """Clusters of the cluster kernel ``name`` (a :func:`kernel_resources`
    family, at its tallest tile) that the card runs at once; asked once per
    device."""
    key = (torch.device(device).index or 0, name)
    if key not in _clusters:
        rows = {"gru_layer_mma": MMA_ROWS,
                "gru_layer_bwd_mma": MMA_ROWS_BACKWARD,
                "gru_layer_cluster": CLUSTER_ROWS,
                "gru_layer_bwd_cluster": CLUSTER_ROWS_BACKWARD}[name][-1]
        _clusters[key] = kernel_resources(device)[f"{name}_rows{rows}"][
            "clusters_per_card"]
    return _clusters[key]


def picked_plan(batch: int, hidden: int, dtype: torch.dtype,
                device: "str | torch.device", backward: bool = False) -> Plan:
    """:func:`gru_plan` for the card ``device``: its SM count and, for the
    cluster kernels, the clusters it runs at once."""
    name = None
    if hidden == MMA_HIDDEN and dtype == torch.bfloat16:
        name = "gru_layer_bwd_mma" if backward else "gru_layer_mma"
    elif hidden == MMA_HIDDEN and dtype == torch.float32:
        name = "gru_layer_bwd_cluster" if backward else "gru_layer_cluster"
    return gru_plan(batch, hidden, dtype,
                    torch.cuda.get_device_properties(
                        device).multi_processor_count, backward,
                    _resident_clusters(device, name) if name else None)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernels and the fp32 cluster backward copy 16 bytes
    at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _gru_layer_forward(gx, w, bn, rows):
    if gx.device.type == "cpu":
        return _gru_layer_plain(gx, w, bn)
    plan = _check_cuda(gx, (gx, w, bn), rows) or Plan("", 0)
    return torch.ops.sir.gru_layer(gx, w, bn, plan.kernel, plan.rows)


def _launch(entry, gx, w, bn, ys, plan: Plan, reverse: bool) -> None:
    """Launch the forward kernel ``plan`` on the (2, T, B, .) views ``gx``
    and ``ys`` (their strides, :func:`k2_strides`) and count it on
    ``entry`` (:func:`gru_layer` or :func:`gru_layer_btc`)."""
    _, steps, batch, three_h = gx.shape
    lib = _build.load()
    if plan.kernel == "mma":
        fn = lib.sir_gru_layer_mma
    elif plan.kernel == "cluster":
        fn = lib.sir_gru_layer_cluster
    else:
        fn = (lib.sir_gru_layer_bf16 if gx.dtype == torch.bfloat16
              else lib.sir_gru_layer_f32)
    with torch.cuda.device(gx.device):
        rc = fn(gx.data_ptr(), w.data_ptr(), bn.data_ptr(), ys.data_ptr(),
                steps, batch, three_h // 3, plan.rows,
                *k2_strides(gx, ys, reverse),
                torch.cuda.current_stream(gx.device).cuda_stream)
    _build.check(rc, entry.__name__)
    entry.launches += 1
    entry.kernel_launches[plan.kernel] += 1


def _gru_layer_cuda(gx, w, bn, kernel, rows):
    two, steps, batch, three_h = gx.shape
    hidden = three_h // 3
    plan = (Plan(kernel, rows) if kernel
            else picked_plan(batch, hidden, gx.dtype, gx.device))
    out = torch.empty((2, steps, batch, hidden), dtype=gx.dtype,
                      device=gx.device)
    if plan.kernel == "mma":
        gx, w = _aligned(gx), _aligned(w)
    _launch(gru_layer, gx, w, bn, out, plan, reverse=False)
    return out


def _gru_layer_cpu(gx, w, bn, kernel, rows):
    return _gru_layer_plain(gx, w, bn)


library.implement("gru_layer", _gru_layer_cuda, _gru_layer_cpu)


def _gru_layer_btc_cuda(gx, w, bn):
    batch, steps, six_h = gx.shape
    hidden = six_h // 6
    plan = picked_plan(batch, hidden, gx.dtype, gx.device)
    out = torch.empty((batch, steps, 2 * hidden), dtype=gx.dtype,
                      device=gx.device)
    if plan.kernel == "mma":
        gx, w = _aligned(gx), _aligned(w)
    _launch(gru_layer_btc, btc_view(gx), w, bn, btc_view(out), plan,
            reverse=True)
    return out


def _gru_layer_btc_cpu(gx, w, bn):
    return _gru_layer_btc_plain(gx, w, bn)


library.implement("gru_layer_btc", _gru_layer_btc_cuda, _gru_layer_btc_cpu)


def _gru_layer_backward_plain(gx: torch.Tensor, w: torch.Tensor,
                              bn: torch.Tensor, ys: torch.Tensor,
                              dys: torch.Tensor):
    """Plain PyTorch K2 backward: the adjoint loop of
    ``gru_pallas._gru_layer_diff_bwd`` transcribed.  h_prev is the stored
    ``ys`` shifted one step (zeros at t = 0); w and bn are upcast and all
    gate and adjoint math is fp32; dgx is rounded to ``gx.dtype``, dW to
    ``w.dtype``, dbn to ``bn.dtype``."""
    two, steps, batch, three_h = gx.shape
    hidden = three_h // 3
    f32 = torch.float32
    h_prev_seq = torch.cat([ys.new_zeros((two, 1, batch, hidden)),
                            ys[:, :-1]], dim=1)
    wf = w.to(f32)
    bnf = bn.to(f32)
    dh = gx.new_zeros((two, batch, hidden), dtype=f32)
    dw = gx.new_zeros((two, hidden, three_h), dtype=f32)
    dbn = gx.new_zeros((two, 1, hidden), dtype=f32)
    dgx = []
    for t in reversed(range(steps)):
        g = gx[:, t].to(f32)
        h_prev = h_prev_seq[:, t].to(f32)
        gh = torch.bmm(h_prev, wf)
        r = torch.sigmoid(g[..., :hidden] + gh[..., :hidden])
        z = torch.sigmoid(g[..., hidden:2 * hidden]
                          + gh[..., hidden:2 * hidden])
        ghn_b = gh[..., 2 * hidden:] + bnf
        n = torch.tanh(g[..., 2 * hidden:] + r * ghn_b)
        dh_tot = dh + dys[:, t].to(f32)
        dn = dh_tot * (1.0 - z)
        dz = dh_tot * (h_prev - n)
        da_n = dn * (1.0 - n * n)
        dr = da_n * ghn_b
        dghn = da_n * r
        da_r = dr * r * (1.0 - r)
        da_z = dz * z * (1.0 - z)
        dgx.append(torch.cat([da_r, da_z, da_n], dim=-1))
        dgh = torch.cat([da_r, da_z, dghn], dim=-1)
        dh = dh_tot * z + torch.bmm(dgh, wf.transpose(1, 2))
        dw = dw + torch.bmm(h_prev.transpose(1, 2), dgh)
        dbn = dbn + dghn.sum(dim=1, keepdim=True)
    dgx = torch.stack(dgx[::-1], dim=1).to(gx.dtype)
    return dgx, dw.to(w.dtype), dbn.to(bn.dtype)


def gru_layer_backward(gx: torch.Tensor, w: torch.Tensor, bn: torch.Tensor,
                       ys: torch.Tensor, dys: torch.Tensor,
                       rows: "int | Plan | None" = None):
    """The adjoint of :func:`gru_layer`: -> (dgx, dw, dbn).

    Args: :func:`gru_layer`'s ``gx``, ``w``, ``bn`` and ``rows``, its output
    ``ys`` and the cotangent ``dys`` (2, T, B, H).  CPU tensors take the
    plain version; CUDA tensors (bfloat16 or float32 operands) launch the
    kernel, then form dW = sum h_prev^T dgh with one batched fp32 GEMM and
    dbn = sum dgh_n, or raise.  ``rows``: as :func:`gru_layer`'s, with the
    backward's heights (``MMA_ROWS_BACKWARD``, ``CLUSTER_ROWS_BACKWARD``).
    """
    if gx.device.type == "cpu":
        return _gru_layer_backward_plain(gx, w, bn, ys, dys)
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    two, steps, batch, three_h = gx.shape
    hidden = three_h // 3
    if tuple(ys.shape) != (2, steps, batch, hidden) or ys.shape != dys.shape:
        raise ValueError(f"bad GRU backward shapes ys {tuple(ys.shape)}, dys "
                         f"{tuple(dys.shape)} for gx {tuple(gx.shape)}")
    if w.dtype != gx.dtype or ys.dtype != gx.dtype:
        raise ValueError("gx, w and ys must share one operand type")
    dys = dys.to(gx.dtype).contiguous()
    plan = _cuda_plan(gx, (gx, w, bn, ys, dys), rows, backward=True)
    dgx = torch.empty_like(gx)
    dgh = torch.empty(gx.shape, dtype=torch.float32, device=gx.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    with torch.cuda.device(gx.device):
        if plan.kernel in ("mma", "cluster"):  # read w in both orientations
            gx, w, ys, dys = (_aligned(t) for t in (gx, w, ys, dys))
            fn = (lib.sir_gru_layer_bwd_mma if plan.kernel == "mma"
                  else lib.sir_gru_layer_bwd_cluster)
            rc = fn(gx.data_ptr(), w.data_ptr(), bn.data_ptr(),
                    ys.data_ptr(), dys.data_ptr(), dgx.data_ptr(),
                    dgh.data_ptr(), steps, batch, hidden, plan.rows, stream)
        else:  # one thread per unit: W^T too, for coalesced reads
            wt = w.transpose(1, 2).contiguous()
            fn = (lib.sir_gru_layer_bwd_bf16 if gx.dtype == torch.bfloat16
                  else lib.sir_gru_layer_bwd_f32)
            rc = fn(gx.data_ptr(), w.data_ptr(), wt.data_ptr(),
                    bn.data_ptr(), ys.data_ptr(), dys.data_ptr(),
                    dgx.data_ptr(), dgh.data_ptr(), steps, batch, hidden,
                    plan.rows, stream)
    _build.check(rc, "gru_layer_backward")
    gru_layer_backward.launches += 1
    gru_layer_backward.kernel_launches[plan.kernel] += 1
    h_prev = torch.cat([ys.new_zeros((2, 1, batch, hidden)), ys[:, :-1]],
                       dim=1).float().reshape(2, steps * batch, hidden)
    dgh = dgh.reshape(2, steps * batch, three_h)
    dw = torch.bmm(h_prev.transpose(1, 2), dgh)
    dbn = dgh[..., 2 * hidden:].sum(dim=1, keepdim=True)
    return dgx, dw.to(w.dtype), dbn.to(bn.dtype)


gru_layer_backward.launches = 0
# the same launches by kernel (a Plan's ``kernel``)
gru_layer_backward.kernel_launches = {"simt": 0, "mma": 0, "cluster": 0}


def kernel_resources(dev: "str | torch.device") -> dict:
    """What the built cluster kernels (tensor-core K2 and K2T, fp32 K2 and
    K2T) take on the card ``dev``, per tile height: registers per thread,
    local (spilled) bytes per thread, shared memory per block, threads per
    block, resident blocks per SM, blocks per cluster, and clusters
    resident on the card at once."""
    import ctypes

    lib = _build.load()
    keys = ("registers", "local_bytes", "shared_bytes", "threads",
            "blocks_per_sm", "cluster", "clusters_per_card")
    found = {}
    with torch.cuda.device(dev):
        for name, fn, heights in (
                ("gru_layer_mma", lib.sir_gru_layer_mma_info, MMA_ROWS),
                ("gru_layer_bwd_mma", lib.sir_gru_layer_bwd_mma_info,
                 MMA_ROWS_BACKWARD),
                ("gru_layer_cluster", lib.sir_gru_layer_cluster_info,
                 CLUSTER_ROWS),
                ("gru_layer_bwd_cluster", lib.sir_gru_layer_bwd_cluster_info,
                 CLUSTER_ROWS_BACKWARD)):
            for rows in heights:
                out = (ctypes.c_int * len(keys))()
                _build.check(fn(rows, ctypes.addressof(out)),
                             "kernel_resources")
                found[f"{name}_rows{rows}"] = dict(zip(keys, out))
    return found


class _GRULayer(torch.autograd.Function):
    """K2 forward, K2 backward; residuals (gx, w, bn, ys) as the JAX
    custom VJP keeps them."""

    @staticmethod
    def forward(ctx, gx, w, bn, rows):
        ys = _gru_layer_forward(gx, w, bn, rows)
        ctx.save_for_backward(gx, w, bn, ys)
        ctx.rows = rows
        return ys

    @staticmethod
    def backward(ctx, dys):
        gx, w, bn, ys = ctx.saved_tensors
        with span("sir.gru.backward"):
            dgx, dw, dbn = gru_layer_backward(gx, w, bn, ys, dys, ctx.rows)
        return dgx, dw, dbn, None


def gru_bidirectional(gx_fwd, gx_bwd, w_hh_fwd, w_hh_bwd, b_hh_fwd,
                      b_hh_bwd):
    """Both directions of one layer through :func:`gru_layer`.

    Args/returns match the reference's ``gru_bidirectional_pallas``:
    ``gx_*`` (T, B, 3H) = ``x @ W_ih^T + b_ih``; ``w_hh_*`` (3H, H) and
    ``b_hh_*`` (3H,) in PyTorch layout.  Returns (ys_fwd, ys_bwd), each
    (T, B, H) in forward time order.
    """
    hidden = w_hh_fwd.shape[1]
    # only the r/z parts of b_hh fold into gx; b_hn stays inside.  Split
    # and unbind, not indexing: a graph traced on fake CUDA tensors in a
    # CPU-only build cannot index them (tests/test_torch_export.py)
    (rz_f, bn_f), (rz_b, bn_b) = (b.split([2 * hidden, hidden])
                                  for b in (b_hh_fwd, b_hh_bwd))
    gx = torch.stack([gx_fwd + torch.cat([rz_f, bn_f.new_zeros(hidden)]),
                      gx_bwd.flip(0) + torch.cat([rz_b,
                                                  bn_b.new_zeros(hidden)])])
    w = torch.stack([w_hh_fwd.t(), w_hh_bwd.t()]).contiguous()
    bn = torch.stack([bn_f, bn_b]).unsqueeze(1).float().contiguous()
    ys_f, ys_b = gru_layer(gx, w, bn).unbind(0)
    return ys_f, ys_b.flip(0)
