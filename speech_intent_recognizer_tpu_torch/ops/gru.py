"""K2: the bidirectional GRU recurrence kernel — wrapper, plain version,
counter.

Replaces ``speech_intent_recognizer_tpu/ops/gru_pallas.py``
(``_gru_layer_kernel``, wrappers ``_gru_layer_call`` and
``gru_bidirectional_pallas``).  The CUDA source is ``csrc/gru_layer.cu``:
one launch runs one layer, both directions, all T steps; h stays on chip in
fp32, W_hh streams from L2 every step.  Its header says what bounds it on
the H100 and how the design answers that.

Inference only: the wrapper refuses CUDA inputs that require grad (the
``torch.autograd.Function`` with a backward kernel comes with training).
"""

from __future__ import annotations

import torch

from speech_intent_recognizer_tpu_torch import _build


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


# batch rows per block that csrc/gru_layer.cu instantiates
TILE_ROWS = (4, 16)


def tile_rows(batch: int, sm_count: int) -> int:
    """Rows per block: 16 where that still puts a block on every SM (grid
    = 2 directions x batch tiles), else 4.  Taller tiles read W_hh from L2
    fewer times; shorter ones keep small batches spread over the SMs."""
    return 16 if 2 * -(-batch // 16) >= sm_count else 4


def gru_layer(gx: torch.Tensor, w: torch.Tensor, bn: torch.Tensor,
              rows: int | None = None) -> torch.Tensor:
    """One bidirectional GRU layer over precomputed input projections.

    Args:
      gx: (2, T, B, 3H) ``x @ W_ih^T + b_ih + b_hh[r, z]``; index 0 in
        forward time, index 1 in reversed time.
      w: (2, H, 3H) transposed recurrent weights, ``gx.dtype``.
      bn: (2, 1, H) float32 n-gate recurrent bias.
      rows: batch rows per block, one of ``TILE_ROWS``; None picks
        :func:`tile_rows` for the card.  Ignored on the CPU.

    Returns (2, T, B, H) hidden states in ``gx.dtype``, direction 1 in
    reversed time.  CPU tensors take the plain version; CUDA tensors
    (bfloat16 or float32) launch the kernel or raise.
    """
    two, steps, batch, three_h = gx.shape
    hidden = three_h // 3
    if (two != 2 or three_h != 3 * hidden
            or tuple(w.shape) != (2, hidden, three_h)
            or tuple(bn.shape) != (2, 1, hidden)):
        raise ValueError(f"bad GRU shapes gx {tuple(gx.shape)}, w "
                         f"{tuple(w.shape)}, bn {tuple(bn.shape)}")
    if gx.device.type == "cpu":
        return _gru_layer_plain(gx, w, bn)
    if gx.device.type != "cuda":
        raise ValueError(f"unsupported device {gx.device}")
    if gx.dtype not in (torch.bfloat16, torch.float32) or w.dtype != gx.dtype:
        raise ValueError(f"gx and w must both be bfloat16 or float32, got "
                         f"{gx.dtype} / {w.dtype}")
    if bn.dtype != torch.float32:
        raise ValueError("bn must be float32")
    if any(t.requires_grad for t in (gx, w, bn)):
        raise RuntimeError("the GRU kernel is inference only (no backward "
                           "yet); call it under torch.no_grad()")
    if any(t.device != gx.device or not t.is_contiguous()
           for t in (gx, w, bn)):
        raise ValueError("gx, w and bn must be contiguous on one device")
    if hidden % 32 or hidden > 1024:
        raise ValueError(f"hidden size {hidden} must be a multiple of 32, "
                         "at most 1024")
    if rows is None:
        rows = tile_rows(batch, torch.cuda.get_device_properties(
            gx.device).multi_processor_count)
    if rows not in TILE_ROWS:
        raise ValueError(f"rows must be one of {TILE_ROWS}, got {rows}")
    out = torch.empty((2, steps, batch, hidden), dtype=gx.dtype,
                      device=gx.device)
    lib = _build.load()
    fn = (lib.sir_gru_layer_bf16 if gx.dtype == torch.bfloat16
          else lib.sir_gru_layer_f32)
    with torch.cuda.device(gx.device):
        rc = fn(gx.data_ptr(), w.data_ptr(), bn.data_ptr(), out.data_ptr(),
                steps, batch, hidden, rows,
                torch.cuda.current_stream(gx.device).cuda_stream)
    _build.check(rc, "gru_layer")
    gru_layer.launches += 1
    return out


gru_layer.launches = 0


def gru_bidirectional(gx_fwd, gx_bwd, w_hh_fwd, w_hh_bwd, b_hh_fwd,
                      b_hh_bwd):
    """Both directions of one layer through :func:`gru_layer`.

    Args/returns match the reference's ``gru_bidirectional_pallas``:
    ``gx_*`` (T, B, 3H) = ``x @ W_ih^T + b_ih``; ``w_hh_*`` (3H, H) and
    ``b_hh_*`` (3H,) in PyTorch layout.  Returns (ys_fwd, ys_bwd), each
    (T, B, H) in forward time order.
    """
    hidden = w_hh_fwd.shape[1]

    def rz(b):  # only the r/z parts of b_hh fold into gx; b_hn stays inside
        return torch.cat([b[:2 * hidden], b.new_zeros(hidden)])

    gx = torch.stack([gx_fwd + rz(b_hh_fwd), gx_bwd.flip(0) + rz(b_hh_bwd)])
    w = torch.stack([w_hh_fwd.t(), w_hh_bwd.t()]).contiguous()
    bn = torch.stack([b_hh_fwd[2 * hidden:], b_hh_bwd[2 * hidden:]])[
        :, None, :].float().contiguous()
    ys = gru_layer(gx, w, bn)
    return ys[0], ys[1].flip(0)
