"""The decomposition and the index maps of the cluster GRU kernels
(``speech_intent_recognizer_tpu_torch/csrc/gru_mma.cuh``, ``gru_layer.cu``,
``gru_layer_bwd.cu``), modelled in NumPy where no card is present.

The model below is the kernels' decomposition thread by thread: a cluster
of C ranks owns one tile of batch rows; rank c holds the r, z and n columns
of hidden units [c H / C, (c + 1) H / C) as ``mma.sync.m16n8k16`` B
fragments, eight units a warp; a step's product reads the h tile through
``ldmatrix`` at the kernel's swizzled addresses and leaves r, z and n of one
unit in one lane's accumulators; the gates run there; the rank's slab of the
new h goes to every rank's other tile.  The backward model adds the slice of
W by rows in shared memory, dgh as bf16 hi | lo halves, the partial sums of
dh_prev and their inbox.  Shared memory starts as NaN and a tile that was
read is set to NaN again, so a read of an address nobody wrote shows.  The
fp32 cluster kernel's model holds each thread's part of W_hh^T (in its
registers), the k-slices' partial sums, the gated pairs and the exchange of
h_t over eight ranks, and counts every write into each rank's h tile; the
fp32 backward's model adds the slice of W^T by rows of k in shared
memory, the dgh tile, the partial sums of dh_prev and their inbox over
eight ranks (and, for the bench's other option, the shuffle
transpose-reduction over the register slice).  The models are held
against ``_gru_layer_plain`` / ``_gru_layer_backward_plain``; the kernels
themselves are held against them on the card (``tests/test_torch_cuda.py``)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops import gru as gru_ops
from speech_intent_recognizer_tpu_torch.ops.gru import (
    CLUSTER_BWD_STEP_US, CLUSTER_ROWS, CLUSTER_ROWS_BACKWARD, CLUSTER_SIZE,
    CLUSTER_SLICES, CLUSTER_STEP_US, CLUSTER_WT_STRIDE, MMA_CLUSTER,
    MMA_HIDDEN, MMA_ROWS, MMA_ROWS_BACKWARD, SMEM_LIMIT,
    TILE_ROWS, Plan, _gru_layer_backward_plain, _gru_layer_btc_plain,
    _gru_layer_plain, btc_view, cluster_smem_bytes, gru_plan, k2_strides,
    mma_smem_bytes, tile_rows)

H, H3 = 256, 768
K_TILES = H // 16
LANES = np.arange(32)
LG, LQ = LANES >> 2, LANES & 3            # g and q of gru_mma.cuh::mma_bf16
# the card tests' bars for an fp32 gradient (rtol, atol)
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
CSRC = os.path.join(os.path.dirname(_build.__file__), "csrc")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16(x):
    """Round to bfloat16 (nearest even) and back, as the card does."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16() \
        .float().numpy()


def source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---- gru_mma.cuh: addresses ----

def chunk_offset(row, chunk, row_chunks):
    """``gru_mma::chunk_offset`` in bytes: chunk c of row r lies at
    c ^ (r & 7)."""
    return (row * row_chunks + (chunk ^ (row & 7))) * 16


def h_offset(rows, slab, row, chunk, cluster=MMA_CLUSTER):
    """``gru_mma::h_offset``: an h tile is one slab a rank, each rows x
    H / C units (128 bytes a row at C = 4)."""
    slab_chunks = H // cluster // 8
    return slab * rows * slab_chunks * 16 + chunk_offset(row, chunk,
                                                         slab_chunks)


def inbox_offset(row, granule):
    """``inbox_offset`` of gru_layer_bwd.cu: 8-byte granules of a 256-byte
    row of fp32 partial sums."""
    return row * 256 + (granule ^ ((row & 7) << 2)) * 8


class Tile:
    """A region of one block's shared memory holding 2- or 4-byte values,
    addressed in bytes; NaN until written."""

    def __init__(self, nbytes, width):
        self.width = width
        self.v = np.full(nbytes // width, np.nan, np.float32)

    def put(self, offset, values):
        """Store ``values`` (..., n) at byte ``offset`` (...)."""
        offset, values = np.asarray(offset), np.asarray(values, np.float32)
        assert (offset % (self.width * values.shape[-1]) == 0).all()
        idx = offset[..., None] // self.width + np.arange(values.shape[-1])
        assert idx.min() >= 0 and idx.max() < len(self.v)
        self.v[idx] = values

    def get(self, offset, n):
        offset = np.asarray(offset)
        assert (offset % (self.width * n) == 0).all()
        idx = offset[..., None] // self.width + np.arange(n)
        assert idx.min() >= 0 and idx.max() < len(self.v)
        return self.v[idx]


# ---- gru_mma.cuh: Strides, K2's addressing of gx and ys ----

class Layout:
    """Where the forward kernels read gx and write ys (``gru_mma::Strides``,
    as ``ops/gru.k2_strides`` makes them), over flat buffers that count
    every read and write.  ``"contract"``: the JAX contract's contiguous
    (2, T, B, 3H) -> (2, T, B, H), direction 1 stored in reversed time;
    ``"btc"``: the input GEMM's (B, T, 6H) -> (B, T, 2H), direction d at
    column 3H d / H d, both in forward time, direction 1 stepping from
    T - 1 down.  ``gx`` (2, T, B, 3H) holds the contract's values; the btc
    buffer holds the same values at their forward times."""

    def __init__(self, name, gx):
        _, steps, batch, three_h = gx.shape
        self.name, self.steps, self.batch, self.h3 = name, steps, batch, three_h
        if name == "contract":
            g, y = torch.empty(gx.shape), torch.empty((2, steps, batch, H))
            self.strides = k2_strides(g, y)
            self.gx = gx.ravel().copy()
        else:
            g = torch.empty((batch, steps, 2 * three_h))
            y = torch.empty((batch, steps, 2 * H))
            self.strides = k2_strides(btc_view(g), btc_view(y), True)
            buf = np.empty((batch, steps, 2 * three_h), np.float32)
            buf[:, :, :three_h] = gx[0].transpose(1, 0, 2)
            buf[:, ::-1, three_h:] = gx[1].transpose(1, 0, 2)
            self.gx = buf.ravel()
        self.ys = np.full(2 * steps * batch * H, np.nan, np.float32)
        self.reads = np.zeros(self.gx.size, np.int64)
        self.writes = np.zeros(self.ys.size, np.int64)

    def time(self, d, t):
        """``Strides::time``: the step's place in time."""
        return self.steps - 1 - t if self.strides[6] and d else t

    def read(self, d, t, row, col):
        """gx of direction d, step t, batch rows ``row``, columns ``col``
        (broadcast); counted."""
        gd, gs, gr = self.strides[:3]
        idx = d * gd + self.time(d, t) * gs + np.asarray(row) * gr + col
        np.add.at(self.reads, idx, 1)
        return self.gx[idx]

    def write(self, d, t, row, col, values):
        od, os_, orow = self.strides[3:6]
        idx = d * od + self.time(d, t) * os_ + np.asarray(row) * orow + col
        np.add.at(self.writes, idx, 1)
        self.ys[idx] = values

    def ys_contract(self):
        """ys as the contract lays it out, (2, T, B, H)."""
        if self.name == "contract":
            return self.ys.reshape(2, self.steps, self.batch, H)
        out = self.ys.reshape(self.batch, self.steps, 2 * H)
        return np.stack([out[:, :, :H], out[:, ::-1, H:]]).transpose(0, 2, 1,
                                                                     3)


# ---- gru_mma.cuh: tensor cores ----

def ldmatrix_x4(tile, addr):
    """``ldmatrix.sync.aligned.m8n8.x4.b16``: lane 8 i + r gives the address
    of row r (16 bytes) of matrix i; every lane receives from each matrix
    the two values at (row g, columns 2q, 2q + 1).  -> (32, 4, 2)."""
    mats = tile.get(addr, 8).reshape(4, 8, 8)
    return mats[:, LG[:, None], 2 * LQ[:, None] + np.arange(2)] \
        .transpose(1, 0, 2)


def mma_bf16(d, a, b0, b1):
    """``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` on the
    per-lane fragments: d (32, 4) += A (16 x 16) @ B (16 x 8)."""
    am, bm = np.empty((16, 16), np.float32), np.empty((16, 8), np.float32)
    for e in range(2):
        am[LG, 2 * LQ + e] = a[:, 0, e]
        am[LG + 8, 2 * LQ + e] = a[:, 1, e]
        am[LG, 2 * LQ + 8 + e] = a[:, 2, e]
        am[LG + 8, 2 * LQ + 8 + e] = a[:, 3, e]
        bm[2 * LQ + e, LG] = b0[:, e]
        bm[2 * LQ + 8 + e, LG] = b1[:, e]
    dm = am @ bm
    for e in range(2):
        d[:, e] += dm[LG, 2 * LQ + e]
        d[:, 2 + e] += dm[LG + 8, 2 * LQ + e]


def load_w_fragments(wd, unit0):
    """``gru_mma::load_w_fragments``: wf[kt][gate] = (b0, b1), each (32, 2),
    of the columns gate * H + unit0 + (0..7) of one direction's (H, 3H)."""
    wf = []
    for kt in range(K_TILES):
        k = kt * 16 + 2 * LQ
        wf.append([])
        for gate in range(3):
            col = gate * H + unit0 + LG
            wf[kt].append((np.stack([wd[k, col], wd[k + 1, col]], 1),
                           np.stack([wd[k + 8, col], wd[k + 9, col]], 1)))
    return wf


def recurrent_product(acc, wf, tile, rows, mt0, cluster):
    """``gru_mma::recurrent_product``: acc[i][gate] (32, 4) += 16-row tile
    mt0 + i of the h tile times the warp's W fragments."""
    slab_chunks = H // cluster // 8
    lrow = (LANES & 7) + ((LANES >> 3) & 1) * 8
    lchunk = LANES >> 4
    for kt in range(K_TILES):
        slab, chunk = divmod(2 * kt, slab_chunks)
        if cluster == 4:  # the kernel's literal expressions
            assert (slab, chunk) == (kt >> 2, (kt & 3) * 2)
        for i in range(len(acc)):
            a = ldmatrix_x4(tile, h_offset(rows, slab, (mt0 + i) * 16 + lrow,
                                           chunk + lchunk, cluster))
            for gate in range(3):
                mma_bf16(acc[i][gate], a, *wf[kt][gate])


def load_gx_slice(tile, layout, d, t, rows, row0, rank, cluster):
    """``gru_mma::load_gx_slice`` at the step base and row stride the
    kernel passes (``layout``): rank's r, z, n columns of one step's gx
    rows into a rows x 3 x (H / C) tile; rows past the batch are zeros."""
    units = H // cluster
    sc = units // 8
    for i in range(rows * 3 * sc):
        row, c = divmod(i, 3 * sc)
        gate, chunk = divmod(c, sc)
        col = gate * H + rank * units + chunk * 8
        values = (layout.read(d, t, row0 + row, col + np.arange(8))
                  if row0 + row < layout.batch else np.zeros(8))
        tile.put(chunk_offset(row, gate * sc + chunk, 3 * sc), values)


def sigmoid(v):
    return (1.0 / (1.0 + np.exp(-v.astype(np.float64)))).astype(np.float32)


# ---- gru_layer.cu: the tensor-core kernel ----

def forward_model(gx, w, bn, rows, cluster=MMA_CLUSTER, layout="contract"):
    """``gru_layer_mma_kernel<rows / 16>`` for every cluster of the launch,
    reading gx and writing ys in ``layout`` (:class:`Layout`).  gx (2, T,
    B, 3H), w (2, H, 3H) hold bf16 values; -> the :class:`Layout`, whose
    ``ys_contract()`` is ys (2, T, B, H)."""
    steps, batch = gx.shape[1:3]
    mem = Layout(layout, gx)
    units = H // cluster
    warps = units // 8
    tiles16 = rows // 16
    group = min(tiles16, 2)
    for d in range(2):
        for row0 in range(0, batch, rows):
            h_tiles = [[Tile(rows * 2 * H, 2) for _ in range(2)]
                       for _ in range(cluster)]
            for rank in range(cluster):
                h_tiles[rank][0].v[:] = 0.0       # h_{-1} = 0
            h = np.zeros((cluster, warps, tiles16, 32, 4), np.float32)
            wf = [[load_w_fragments(w[d], rank * units + 8 * warp)
                   for warp in range(warps)] for rank in range(cluster)]
            for t in range(steps):
                cur, nxt = t & 1, (t & 1) ^ 1
                for rank in range(cluster):
                    gx_tile = Tile(rows * 3 * units * 2, 2)
                    load_gx_slice(gx_tile, mem, d, t, rows, row0, rank,
                                  cluster)
                    for warp in range(warps):
                        unit0 = rank * units + 8 * warp
                        b_n = bn[d, 0, unit0 + 2 * LQ[:, None] + np.arange(2)]
                        for mt0 in range(0, tiles16, group):
                            # an odd count of 16-row tiles ends on one
                            n_tiles = min(group, tiles16 - mt0)
                            acc = np.zeros((n_tiles, 3, 32, 4), np.float32)
                            recurrent_product(acc, wf[rank][warp],
                                              h_tiles[rank][cur], rows, mt0,
                                              cluster)
                            for i in range(n_tiles):
                                for half in range(2):
                                    row = (mt0 + i) * 16 + LG + 8 * half
                                    x = [gx_tile.get(
                                        chunk_offset(row, gate * warps + warp,
                                                     3 * warps) + 4 * LQ, 2)
                                        for gate in range(3)]
                                    a = acc[i][:, :, 2 * half:2 * half + 2]
                                    r = sigmoid(x[0] + a[0])
                                    z = sigmoid(x[1] + a[1])
                                    n = np.tanh(x[2] + r * (a[2] + b_n))
                                    old = h[rank, warp, mt0 + i, :,
                                            2 * half:2 * half + 2]
                                    new = ((1.0 - z) * n + z * old).astype(
                                        np.float32)
                                    h[rank, warp, mt0 + i, :,
                                      2 * half:2 * half + 2] = new
                                    h_tiles[rank][nxt].put(
                                        h_offset(rows, rank, row, warp,
                                                 cluster) + 4 * LQ, bf16(new))
                # every rank has read tile `cur`: nobody may read it again
                # before it is rewritten
                for rank in range(cluster):
                    h_tiles[rank][cur].v[:] = np.nan
                # the slab goes to the other ranks and, as ys[t], to memory
                for rank in range(cluster):
                    for i in range(rows * warps):
                        row = i // warps
                        chunk = (i % warps) ^ (row & 7)
                        off = rank * rows * units * 2 + i * 16
                        v = h_tiles[rank][nxt].get(off, 8)
                        for other in range(1, cluster):
                            h_tiles[(rank + other) % cluster][nxt].put(off, v)
                        if row0 + row < batch:
                            mem.write(d, t, row0 + row,
                                      rank * units + chunk * 8
                                      + np.arange(8), v)
    return mem


# ---- gru_layer_bwd.cu: the tensor-core kernel (C = 4) ----

SLICE_CHUNKS = 3 * (H // MMA_CLUSTER) // 8      # kSliceChunks


def backward_model(gx, w, bn, ys, dys, rows, lo_half=True):
    """``gru_layer_bwd_mma_kernel<rows / 16>`` for every cluster of the
    launch -> (dgx (2, T, B, 3H) bf16 values, dgh (2, T, B, 3H) fp32)."""
    cluster, units, warps = MMA_CLUSTER, H // MMA_CLUSTER, 8
    steps, batch = gx.shape[1:3]
    tiles16 = rows // 16
    mem = Layout("contract", gx)      # the backward's gx is contiguous
    dgx = np.full(gx.shape, np.nan, np.float32)
    dgh = np.full(gx.shape, np.nan, np.float32)
    for d in range(2):
        for row0 in range(0, batch, rows):
            wt, wf = [], []
            for rank in range(cluster):
                # the slice by rows: row j, chunk 3 o + gate = the eight
                # units of warp o in gate `gate`
                wt.append(Tile(H * SLICE_CHUNKS * 16, 2))
                for i in range(H * SLICE_CHUNKS):
                    j, c = divmod(i, SLICE_CHUNKS)
                    col = (c % 3) * H + rank * units + (c // 3) * 8
                    wt[rank].put(chunk_offset(j, c, SLICE_CHUNKS),
                                 w[d, j, col:col + 8])
                wf.append([load_w_fragments(w[d], rank * units + 8 * warp)
                           for warp in range(warps)])
            inbox = [Tile(2 * 4 * rows * 256, 4) for _ in range(cluster)]
            dhz = np.zeros((cluster, warps, tiles16, 32, 4), np.float32)
            for t in reversed(range(steps)):
                last = t == steps - 1
                dg = [Tile(rows * 768, 2) for _ in range(cluster)]
                for rank in range(cluster):
                    # load_step(t): h_prev tile, gx slice, dys slice
                    hp = Tile(rows * 512, 2)
                    for i in range(rows * 32):
                        row, c = divmod(i, 32)
                        valid = t > 0 and row0 + row < batch
                        hp.put(h_offset(rows, c >> 3, row, c & 7),
                               ys[d, t - 1, row0 + row, c * 8:c * 8 + 8]
                               if valid else np.zeros(8))
                    gxs = Tile(rows * 384, 2)
                    load_gx_slice(gxs, mem, d, t, rows, row0, rank, cluster)
                    dyt = Tile(rows * 128, 2)
                    for i in range(rows * 8):
                        row, c = divmod(i, 8)
                        col = rank * units + c * 8
                        dyt.put(chunk_offset(row, c, 8),
                                dys[d, t, row0 + row, col:col + 8]
                                if row0 + row < batch else np.zeros(8))
                    for warp in range(warps):
                        unit0 = rank * units + 8 * warp
                        b_n = bn[d, 0, unit0 + 2 * LQ[:, None] + np.arange(2)]
                        acc = np.zeros((tiles16, 3, 32, 4), np.float32)
                        recurrent_product(acc, wf[rank][warp], hp, rows, 0,
                                          cluster)
                        for mt in range(tiles16):
                            for half in range(2):
                                row = mt * 16 + LG + 8 * half
                                x = [gxs.get(chunk_offset(row, 8 * gate + warp,
                                                          24) + 4 * LQ, 2)
                                     for gate in range(3)]
                                hpv = hp.get(h_offset(rows, rank, row, warp)
                                             + 4 * LQ, 2)
                                dy = dyt.get(chunk_offset(row, warp, 8)
                                             + 4 * LQ, 2)
                                total = np.zeros((32, 2), np.float32)
                                if not last:
                                    for src in range(cluster):
                                        total += inbox[rank].get(
                                            (((t + 1) & 1) * 4 + src) * rows
                                            * 256 + inbox_offset(
                                                row, 4 * warp + LQ), 2)
                                a = acc[mt][:, :, 2 * half:2 * half + 2]
                                r = sigmoid(x[0] + a[0])
                                z = sigmoid(x[1] + a[1])
                                ghn_b = a[2] + b_n
                                n = np.tanh(x[2] + r * ghn_b)
                                carried = dhz[rank, warp, mt, :,
                                              2 * half:2 * half + 2]
                                dh_tot = carried + total + dy
                                dan = dh_tot * (1 - z) * (1 - n * n)
                                dar = dan * ghn_b * r * (1 - r)
                                daz = dh_tot * (hpv - n) * z * (1 - z)
                                dgn = dan * r
                                dhz[rank, warp, mt, :,
                                    2 * half:2 * half + 2] = dh_tot * z
                                for gate, (v, vx) in enumerate(
                                        ((dar, dar), (daz, daz), (dgn, dan))):
                                    hi = bf16(v)
                                    dg[rank].put(chunk_offset(
                                        row, 3 * warp + gate, 48) + 4 * LQ, hi)
                                    dg[rank].put(chunk_offset(
                                        row, SLICE_CHUNKS + 3 * warp + gate,
                                        48) + 4 * LQ,
                                        bf16(v - hi) if lo_half
                                        else np.zeros_like(hi))
                                    for lane in range(32):
                                        if row0 + row[lane] >= batch:
                                            continue
                                        o = gate * H + unit0 + 2 * LQ[lane]
                                        dgx[d, t, row0 + row[lane],
                                            o:o + 2] = bf16(vx[lane])
                                        dgh[d, t, row0 + row[lane],
                                            o:o + 2] = v[lane]
                # the inbox buffer read in this step may be rewritten only
                # after the next barrier: nobody reads it again before that
                for rank in range(cluster):
                    half_box = 4 * rows * 256 // 4
                    read = ((t + 1) & 1) * half_box
                    inbox[rank].v[read:read + half_box] = np.nan
                if t == 0:
                    break
                # partial dh_prev over each rank's columns, sent to the owners
                brow = (LANES & 7) + 8 * (LANES >> 4)
                bchunk = (LANES >> 3) & 1
                arow = (LANES & 7) + 8 * ((LANES >> 3) & 1)
                achunk = LANES >> 4
                for rank in range(cluster):
                    for warp in range(warps):
                        acc2 = np.zeros((tiles16, 4, 32, 4), np.float32)
                        for kt in range(SLICE_CHUNKS // 2):
                            b = [ldmatrix_x4(wt[rank], chunk_offset(
                                32 * warp + brow + 16 * pair, 2 * kt + bchunk,
                                SLICE_CHUNKS)) for pair in range(2)]
                            for mt in range(tiles16):
                                hi = ldmatrix_x4(dg[rank], chunk_offset(
                                    mt * 16 + arow, 2 * kt + achunk, 48))
                                lo = ldmatrix_x4(dg[rank], chunk_offset(
                                    mt * 16 + arow,
                                    SLICE_CHUNKS + 2 * kt + achunk, 48))
                                for nt in range(4):
                                    frag = b[nt >> 1][:, 2 * (nt & 1):][:, :2]
                                    mma_bf16(acc2[mt][nt], hi, frag[:, 0],
                                             frag[:, 1])
                                    mma_bf16(acc2[mt][nt], lo, frag[:, 0],
                                             frag[:, 1])
                        owner = warp >> 1   # units [32 warp, 32 warp + 32)
                        base = ((t & 1) * 4 + rank) * rows * 256
                        for mt in range(tiles16):
                            for nt in range(4):
                                for half in range(2):
                                    inbox[owner].put(base + inbox_offset(
                                        mt * 16 + LG + 8 * half,
                                        (warp & 1) * 16 + 4 * nt + LQ),
                                        acc2[mt][nt][:, 2 * half:][:, :2])
    return dgx, dgh


def weight_gradients(ys, dgh):
    """What ``gru_layer_backward`` forms from the kernel's workspace."""
    two, steps, batch, _ = ys.shape
    h_prev = np.concatenate([np.zeros_like(ys[:, :1]), ys[:, :-1]], 1)
    dw = np.einsum("dtbh,dtbg->dhg", h_prev, dgh)
    dbn = dgh[..., 2 * H:].sum((1, 2))[:, None, :]
    return dw, dbn


def operands(batch, steps, seed):
    r = np.random.default_rng(seed)
    gx = bf16(r.standard_normal((2, steps, batch, H3)))
    w = bf16(0.05 * r.standard_normal((2, H, H3)))
    bn = (0.1 * r.standard_normal((2, 1, H))).astype(np.float32)
    dys = bf16(r.standard_normal((2, steps, batch, H)))
    return gx, w, bn, dys


def as_bf16(*arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


# ---- the column order and its split over ranks ----

def staged_columns(cluster):
    """Column of W (H, 3H) at position p of the staged order: rank, then
    warp (8 units), then gate, then unit: r, z, n of one unit share a lane."""
    units = H // cluster
    return np.array([gate * H + rank * units + 8 * warp + u
                     for rank in range(cluster) for warp in range(units // 8)
                     for gate in range(3) for u in range(8)])


@pytest.mark.parametrize("cluster", [2, 4])
def test_staged_columns_are_a_permutation_split_by_unit(cluster):
    """Every column of W exactly once; un-permuting gives W back; rank c
    holds 3 H / C columns, the r, z and n columns of its H / C units and of
    no other; 393,216 / C bytes in bf16."""
    perm = staged_columns(cluster)
    assert sorted(perm) == list(range(H3))
    w = np.random.default_rng(0).standard_normal((H, H3)).astype(np.float32)
    staged = w[:, perm]
    back = np.empty_like(w)
    back[:, perm] = staged
    np.testing.assert_array_equal(back, w)
    per_rank = perm.reshape(cluster, -1)
    units = H // cluster
    assert per_rank.shape[1] * H * 2 == 393216 // cluster
    for rank, cols in enumerate(per_rank):
        assert sorted(set(cols % H)) == list(range(rank * units,
                                                   (rank + 1) * units))
        assert sorted(cols // H) == sorted([0, 1, 2] * units)
        # inside a warp's 24 columns: gate-major groups of the same 8 units
        groups = cols.reshape(-1, 3, 8)
        assert (groups % H == groups[:, :1] % H).all()
        assert (groups // H == np.arange(3)[None, :, None]).all()


@pytest.mark.parametrize("cluster", [2, 4])
def test_w_fragments_hold_the_ranks_slice_once(cluster):
    """The B fragments of all lanes, warps and ranks hold every element of
    W exactly once (C x 96 registers x 32 lanes x H / (8 C) warps x 2 values
    = H x 3H), and a lane's three accumulators of one MMA column are r, z
    and n of one unit."""
    w = np.arange(H * H3, dtype=np.float32).reshape(H, H3)
    seen = []
    units = H // cluster
    for rank in range(cluster):
        for warp in range(units // 8):
            wf = load_w_fragments(w, rank * units + 8 * warp)
            assert len(wf) * 3 * 2 == 96          # registers a thread
            for kt in range(K_TILES):
                cols = [np.concatenate(wf[kt][gate]) % H3 for gate in range(3)]
                # b0 / b1 of lane (g, q): column g of each gate's tile
                assert (cols[1] - cols[0] == H).all()
                assert (cols[2] - cols[0] == 2 * H).all()
                seen += [v for gate in range(3) for v in wf[kt][gate]]
    seen = np.concatenate([v.ravel() for v in seen])
    assert sorted(seen) == list(range(H * H3))


def test_mma_model_is_the_matrix_product():
    """The fragment layouts of the model (ldmatrix rows by lane, A / B / D
    by g and q) put together give D = A @ B, with A read through the
    swizzled h tile and B through ``load_w_fragments``."""
    r = np.random.default_rng(1)
    rows = 32
    hmat = bf16(r.standard_normal((rows, H)))
    w = bf16(r.standard_normal((H, H3)))
    tile = Tile(rows * 2 * H, 2)
    for row in range(rows):
        for c in range(32):
            tile.put(h_offset(rows, c >> 3, row, c & 7), hmat[row, 8 * c:][:8])
    unit0 = 64 * 2 + 8 * 5
    acc = np.zeros((2, 3, 32, 4), np.float32)
    recurrent_product(acc, load_w_fragments(w, unit0), tile, rows, 0, 4)
    want = hmat.astype(np.float64) @ w.astype(np.float64)
    for i in range(2):
        for gate in range(3):
            for e in range(4):
                row = 16 * i + LG + 8 * (e >> 1)
                col = gate * H + unit0 + 2 * LQ + (e & 1)
                np.testing.assert_allclose(acc[i, gate, :, e], want[row, col],
                                           rtol=0, atol=1e-4)


@pytest.mark.parametrize("row_chunks,rows", [(8, 128), (24, 256), (48, 32)])
def test_swizzle_is_a_bijection_that_spreads_eight_rows(row_chunks, rows):
    """chunk ^ (row & 7) keeps every chunk in its row and maps the chunks
    of a tile one to one; the eight row addresses of one ldmatrix matrix
    (eight consecutive rows, one logical chunk) cover all 32 banks."""
    offs = np.array([[chunk_offset(r, c, row_chunks)
                      for c in range(row_chunks)] for r in range(rows)])
    assert sorted(offs.ravel()) == list(range(0, rows * row_chunks * 16, 16))
    assert (offs // (row_chunks * 16) == np.arange(rows)[:, None]).all()
    for r0 in range(0, rows, 8):
        for c in range(row_chunks):
            banks = {(o // 4 + k) % 32 for o in offs[r0:r0 + 8, c]
                     for k in range(4)}
            assert len(banks) == 32, (r0, c)


def test_inbox_granules_are_a_bijection_without_conflicts():
    """The fp32 partial sums of a row: 32 granules of 8 bytes mapped one to
    one; a warp's store (rows g, granules q of one nt) and a warp's read
    (granule 4 warp + q of rows g) touch every bank at most twice, the least
    for 32 lanes x 8 bytes."""
    for row in range(16):
        offs = [inbox_offset(row, gr) for gr in range(32)]
        assert sorted(offs) == list(range(row * 256, (row + 1) * 256, 8))
    for base in range(0, 32, 4):
        offs = inbox_offset(LG, base + LQ)
        banks = np.concatenate([(offs // 4) % 32, (offs // 4 + 1) % 32])
        assert np.bincount(banks, minlength=32).max() <= 2


# ---- the kernels' decomposition against the plain versions ----

@pytest.mark.parametrize("cluster,rows,batch,steps", [
    (4, 16, 21, 3), (4, 32, 37, 3), (4, 48, 40, 2), (4, 80, 70, 2),
    (4, 128, 120, 2),
    (2, 16, 21, 3), (2, 32, 37, 2), (4, 16, 1, 2)])
def test_forward_model_matches_plain(cluster, rows, batch, steps):
    """Per-rank product + gates + exchange over C ranks reproduce the full
    recurrence on full and ragged tiles: within one bf16 step of |h| < 1
    (2**-8) of ``_gru_layer_plain``; only the fp32 summation order differs.
    Every output element is written (none is left NaN), and no lane reads a
    shared-memory address that was not written for that step."""
    gx, w, bn, _ = operands(batch, steps, seed=rows + batch)
    mem = forward_model(gx, w, bn, rows, cluster)
    got = mem.ys_contract()
    want = _gru_layer_plain(*as_bf16(gx, w), torch.from_numpy(bn))
    assert (mem.reads == 1).all() and (mem.writes == 1).all()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, bf16(got))
    np.testing.assert_allclose(got, want.float().numpy(), rtol=0,
                               atol=2.0 ** -8)


@pytest.mark.parametrize("layout", ["contract", "btc"])
def test_k2_strides_read_gx_and_write_ys_once(layout):
    """``Strides`` as the wrappers pass them: over every (direction, step,
    row, column) a launch visits, each element of gx is read once and each
    element of ys written once; step t of direction d reads the contract's
    gx[d, t] (in the GEMM's layout direction 1 runs from time T - 1 down),
    and the (B, T, 2H) output holds direction d at columns [H d, H d + H)
    and at its forward time."""
    steps, batch = 3, 5
    gx = np.arange(2 * steps * batch * H3, dtype=np.float32).reshape(
        2, steps, batch, H3)
    mem = Layout(layout, gx)
    rows, cols = np.arange(batch)[:, None], np.arange(H3)[None, :]
    for d in range(2):
        for t in range(steps):
            np.testing.assert_array_equal(mem.read(d, t, rows, cols),
                                          gx[d, t])
            mem.write(d, t, rows, np.arange(H)[None, :],
                      gx[d, t, :, :H] + 0.5)
    assert (mem.reads == 1).all() and (mem.writes == 1).all()
    np.testing.assert_array_equal(mem.ys_contract(), gx[..., :H] + 0.5)
    if layout == "btc":
        assert mem.strides == (3 * H, 6 * H, steps * 6 * H, H, 2 * H,
                               steps * 2 * H, 1)
        out = mem.ys.reshape(batch, steps, 2 * H)
        for t in range(steps):   # direction 1's step t is time T - 1 - t
            np.testing.assert_array_equal(out[:, t, :H], gx[0, t, :, :H] + .5)
            np.testing.assert_array_equal(out[:, steps - 1 - t, H:],
                                          gx[1, t, :, :H] + 0.5)
    else:
        assert mem.strides == (steps * batch * H3, batch * H3, H3,
                               steps * batch * H, batch * H, H, 0)


def _btc(gx):
    """The contract's gx (2, T, B, 3H) as the GEMM lays it out, (B, T,
    6H), both directions in forward time."""
    return torch.cat([gx[0], gx[1].flip(0)], -1).transpose(0, 1) \
        .contiguous()


@pytest.mark.parametrize("rows,batch,steps", [(32, 37, 2)])
def test_forward_model_in_the_served_layout(rows, batch, steps):
    """The tensor-core kernel reading the GEMM's (B, T, 6H) and writing
    (B, T, 2H) (``gru_layer_btc``): every gx element read once, every
    output element written once, within one bf16 step of the plain
    version, whose (B, T, 2H) output is the contract's laid out as
    ``torch.nn.GRU`` gives it."""
    gx, w, bn, _ = operands(batch, steps, seed=rows + batch + 1)
    mem = forward_model(gx, w, bn, rows, layout="btc")
    assert (mem.reads == 1).all() and (mem.writes == 1).all()
    g, wt = as_bf16(gx, w)
    want = _gru_layer_btc_plain(_btc(g), wt, torch.from_numpy(bn))
    plain = _gru_layer_plain(g, wt, torch.from_numpy(bn))
    assert torch.equal(want, torch.cat([plain[0], plain[1].flip(0)], -1)
                       .transpose(0, 1))
    np.testing.assert_allclose(mem.ys.reshape(batch, steps, 2 * H),
                               want.float().numpy(), rtol=0, atol=2.0 ** -8)


@pytest.mark.parametrize("rows,batch,steps", [(16, 21, 3), (32, 30, 3),
                                              (16, 1, 2)])
def test_backward_model_matches_plain(rows, batch, steps):
    """The recomputed gates, the hi + lo dgh, the per-rank partial sums and
    their exchange reproduce the adjoint recurrence: dgx and dW within one
    bf16 step (2**-7 relative) plus the fp32 bar of scale, db_hn within the
    fp32 bar of scale, as the card holds the kernel to its plain version."""
    gx, w, bn, dys = operands(batch, steps, seed=rows + batch)
    t_gx, t_w, t_dys = as_bf16(gx, w, dys)
    t_bn = torch.from_numpy(bn)
    ys = _gru_layer_plain(t_gx, t_w, t_bn)
    dgx, dgh = backward_model(gx, w, bn, ys.float().numpy(), dys, rows)
    assert np.isfinite(dgx).all() and np.isfinite(dgh).all()
    dw, dbn = weight_gradients(ys.float().numpy(), dgh)
    want = _gru_layer_backward_plain(t_gx, t_w, t_bn, ys, t_dys)
    for name, got, ref in zip(("dgx", "dW", "db_hn"), (dgx, bf16(dw), dbn),
                              want):
        ref = ref.float().numpy()
        bar = GRAD_ATOL + GRAD_RTOL * np.abs(ref).max()
        if name != "db_hn":
            bar = bar + 2.0 ** -7 * np.abs(ref)
        assert (np.abs(got - ref) <= bar).all(), name


def test_backward_model_needs_the_lo_half():
    """The model's dgh workspace against the fp32 adjoint: with hi + lo
    halves the step-0 values (which saw T - 1 products) hold the fp32 bar
    per element relative to the tensor's scale; with dgh rounded once to
    bf16 they miss it."""
    rows, batch, steps = 16, 16, 4
    gx, w, bn, dys = operands(batch, steps, seed=5)
    t_gx, t_w, t_dys = as_bf16(gx, w, dys)
    t_bn = torch.from_numpy(bn)
    ys = _gru_layer_plain(t_gx, t_w, t_bn)
    # fp32 reference of the workspace: dgx of fp32 operands holding the
    # same values is not rounded
    ref = _gru_layer_backward_plain(t_gx.float(), t_w.float(), t_bn,
                                    ys.float(), t_dys.float())[0].numpy()
    errs = []
    for lo_half in (True, False):
        dgh = backward_model(gx, w, bn, ys.float().numpy(), dys, rows,
                             lo_half)[1]
        # the r and z thirds of dgh are dgx's; compare those at t = 0
        got, want = dgh[:, 0, :, :2 * H], ref[:, 0, :, :2 * H]
        errs.append(np.abs(got - want).max()
                    / (GRAD_ATOL + GRAD_RTOL * np.abs(want).max()))
    assert errs[0] <= 1.0 < errs[1], errs


def test_hi_lo_split_reconstructs_and_holds_the_fp32_bar():
    """hi = bf16(v), lo = bf16(v - hi): v is rebuilt within 2**-16
    relative, and dgh @ W^T from the two halves holds the fp32 gradient bar
    per element where one rounding does not."""
    r = np.random.default_rng(7)
    v = (r.standard_normal(1 << 16)
         * 10.0 ** r.uniform(-20, 4, 1 << 16)).astype(np.float32)
    hi = bf16(v)
    lo = bf16(v - hi)
    assert (np.abs(hi.astype(np.float64) + lo - v)
            <= 2.0 ** -16 * np.abs(v)).all()
    dgh = r.standard_normal((64, H3)).astype(np.float32)
    w = bf16(0.05 * r.standard_normal((H, H3))).astype(np.float64)
    want = dgh.astype(np.float64) @ w.T
    hi = bf16(dgh)
    lo = bf16(dgh - hi)
    two = (hi.astype(np.float64) + lo) @ w.T
    one = hi.astype(np.float64) @ w.T
    bar = GRAD_ATOL + GRAD_RTOL * np.abs(want)
    assert (np.abs(two - want) <= bar).all()
    assert not (np.abs(one - want) <= bar).all()


@pytest.mark.parametrize("cluster", [2, 4])
def test_partial_sums_over_ranks_give_the_adjoint_product(cluster):
    """dh_prev = dgh @ W^T sums over all 3H columns; each rank's product of
    ITS columns of dgh with its slice, added in rank order, is that sum."""
    r = np.random.default_rng(3)
    dgh = r.standard_normal((16, H3))
    w = r.standard_normal((H, H3))
    per_rank = staged_columns(cluster).reshape(cluster, -1)
    total = np.zeros((16, H))
    for cols in per_rank:
        total += dgh[:, cols] @ w[:, cols].T
    np.testing.assert_allclose(total, dgh @ w.T, rtol=0, atol=1e-10)


# ---- gru_layer.cu: the fp32 cluster kernel (gru_mma.cuh's fp32 maps) ----

SLICE_K = H // CLUSTER_SLICES                  # kF32SliceK
THREADS = 32 * CLUSTER_SLICES                  # kThreads
UNITS = H // CLUSTER_SIZE                      # kF32Units


def f32_partial_index(rows, slice_, row, gate, unit):
    """``gru_mma::f32_partial_index``: [slice][row][gate][unit] floats."""
    return ((slice_ * rows + row) * 3 + gate) * UNITS + unit


def thread_w(wt, rank, warp, lane):
    """The float4s thread (warp, lane) of rank ``rank`` multiplies by, as
    the register load of ``gru_layer_cluster_kernel`` reads them from W^T
    (H, 3H): (SLICE_K / 4, 3 gates, U / 32 units, 4 k)."""
    k = SLICE_K * warp + 4 * np.arange(SLICE_K // 4)[:, None, None, None] \
        + np.arange(4)
    col = (np.arange(3)[None, :, None, None] * H + rank * UNITS + lane
           + 32 * np.arange(UNITS // 32)[None, None, :, None])
    return wt[k, col]


def cluster_forward_model(gx, w, bn, rows, layout="contract"):
    """``gru_layer_cluster_kernel<rows>`` for every cluster of the
    launch, reading gx and writing ys in ``layout`` (:class:`Layout`):
    fp32 gx (2, T, B, 3H), w (2, H, 3H), bn (2, 1, H) -> the
    :class:`Layout`, whose ``ys_contract()`` is ys (2, T, B, H).  Each
    rank's two h tiles start NaN (tile 0 zeroed);
    after a step's products every rank's tile ``cur`` is set to NaN again;
    the exchange is the gating lanes' own: a quad of lanes (four units of
    one row) gathers its float4 of h_t and lane 4 q + e stores it into
    ranks e, e + 4, ...; the writes into each rank's tile ``nxt`` are
    counted and each (row, unit) must be written exactly once a step."""
    steps, batch = gx.shape[1:3]
    cluster, units = CLUSTER_SIZE, UNITS
    pairs = -(-rows * units // THREADS)
    p = np.arange(THREADS)[None, :] + THREADS * np.arange(pairs)[:, None]
    prow, punit = p // units, p % units          # the pairs thread p gates
    assert (punit == np.arange(THREADS) % units).all()
    live = prow < rows
    mem = Layout(layout, gx)
    for d in range(2):
        held = [[[thread_w(w[d], rank, warp, lane)
                  for lane in range(32)] for warp in range(CLUSTER_SLICES)]
                for rank in range(cluster)]
        for row0 in range(0, batch, rows):
            tiles = np.full((cluster, 2, rows, H), np.nan, np.float32)
            tiles[:, 0] = 0.0                    # h_{-1} = 0
            h = np.zeros((cluster, pairs, THREADS), np.float32)
            for t in range(steps):
                cur, nxt = t & 1, (t & 1) ^ 1
                assert cur != nxt
                writes = np.zeros((cluster, rows, H), np.int64)
                for rank in range(cluster):
                    unit0 = rank * units
                    hc = tiles[rank, cur]
                    assert np.isfinite(hc).all(), "read of an unwritten h"
                    part = np.full(CLUSTER_SLICES * rows * 3 * units, np.nan,
                                   np.float32)
                    for warp in range(CLUSTER_SLICES):
                        hk = hc[:, SLICE_K * warp:SLICE_K * (warp + 1)]
                        for lane in range(32):
                            wv = held[rank][warp][lane]   # (kq, 3, UPL, 4)
                            wk = wv.transpose(0, 3, 1, 2).reshape(SLICE_K, -1)
                            acc = (hk @ wk).reshape(rows, 3, units // 32)
                            for i in range(units // 32):
                                for gate in range(3):
                                    idx = f32_partial_index(
                                        rows, warp, np.arange(rows),
                                        gate, lane + 32 * i)
                                    assert np.isnan(part[idx]).all()
                                    part[idx] = acc[:, gate, i]
                    r_, u_ = prow[live], punit[live]
                    s = [part[f32_partial_index(rows, 0, r_, gate, u_)]
                         for gate in range(3)]
                    for sl in range(1, CLUSTER_SLICES):   # in slice order
                        for gate in range(3):
                            s[gate] = s[gate] + part[f32_partial_index(
                                rows, sl, r_, gate, u_)]
                    valid = row0 + r_ < batch
                    gxr = np.zeros((3, len(r_)), np.float32)
                    for gate in range(3):
                        gxr[gate, valid] = mem.read(
                            d, t, row0 + r_[valid],
                            gate * H + unit0 + u_[valid])
                    r = sigmoid(gxr[0] + s[0])
                    z = sigmoid(gxr[1] + s[1])
                    n = np.tanh(gxr[2] + r * (s[2] + bn[d, 0, unit0 + u_]))
                    new = ((1.0 - z) * n + z * h[rank][live]).astype(
                        np.float32)
                    h[rank][live] = new
                    mem.write(d, t, row0 + r_[valid], unit0 + u_[valid],
                              new[valid])
                    if t + 1 < steps:
                        hnew = np.full((rows, units), np.nan, np.float32)
                        hnew[r_, u_] = new
                        for row, unit in zip(r_, u_):
                            lane, q0 = unit % 32, unit & ~3
                            quad = hnew[row, q0:q0 + 4]   # the shuffles
                            assert np.isfinite(quad).all()
                            for dst in range(lane & 3, cluster, 4):
                                col = unit0 + q0
                                tiles[dst, nxt, row, col:col + 4] = quad
                                writes[dst, row, col:col + 4] += 1
                # every rank has read tile `cur`: nobody may read it again
                # before it is rewritten
                tiles[:, cur] = np.nan
                if t + 1 < steps:
                    assert (writes == 1).all(), "each unit once into each rank"
    return mem


def test_cluster_kernel_holds_each_w_element_once():
    """The threads of a cluster of eight hold every element of W^T (H x
    3H) exactly once; rank c holds the r, z and n columns of its units
    [U c, U c + U) and no other; a thread holds 96 floats (its registers),
    all of its own k-slice, and its three gates of a float4 are r, z and n
    of one unit."""
    wt = np.arange(H * H3, dtype=np.float64).reshape(H, H3)
    seen = []
    for rank in range(CLUSTER_SIZE):
        cols = set()
        for warp in range(CLUSTER_SLICES):
            for lane in range(32):
                held = thread_w(wt, rank, warp, lane)
                assert held.size == 96
                c = held % H3
                assert (c[:, 1] - c[:, 0] == H).all()
                assert (c[:, 2] - c[:, 0] == 2 * H).all()
                assert (held // H3 >= SLICE_K * warp).all()
                assert (held // H3 < SLICE_K * (warp + 1)).all()
                seen.append(held.ravel())
                cols |= set((c % H).ravel())
        assert cols == set(range(rank * UNITS, (rank + 1) * UNITS))
    seen = np.concatenate(seen)
    assert len(seen) == H * H3 and len(set(seen)) == H * H3


@pytest.mark.parametrize("rows", CLUSTER_ROWS)
def test_cluster_partial_sums_are_a_bijection_without_conflicts(rows):
    """The partial sums of a tile: every (slice, row, gate, unit) at its own
    float; a warp's store (one slice, row and gate; lanes over units) and a
    gating warp's read (one row; lanes over units) touch 32 consecutive
    floats, one a bank."""
    idx = f32_partial_index(rows,
                            np.arange(CLUSTER_SLICES)[:, None, None, None],
                            np.arange(rows)[None, :, None, None],
                            np.arange(3)[None, None, :, None],
                            np.arange(UNITS)[None, None, None, :])
    assert sorted(idx.ravel()) == list(range(CLUSTER_SLICES * rows * 3 * UNITS))
    for sl in range(CLUSTER_SLICES):
        for row in range(rows):
            for gate in range(3):
                a = f32_partial_index(rows, sl, row, gate, LANES)
                assert sorted(a % 32) == list(range(32))


@pytest.mark.parametrize("rows,batch,steps", [
    (1, 1, 3), (2, 3, 2), (4, 7, 2), (8, 8, 2), (16, 17, 2), (32, 33, 2),
    (1, 2, 4), (4, 5, 3)])
def test_cluster_forward_model_matches_plain(rows, batch, steps):
    """Products over eight k-slices, partial sums added in slice order,
    gates, and the exchange over eight ranks reproduce the fp32 recurrence
    on full and ragged tiles within the fp32 bar (1e-5) of
    ``_gru_layer_plain``: every output element is written, no read finds an
    unwritten h, every rank's next tile receives each unit of h_t exactly
    once, and no step writes the tile it reads."""
    r = np.random.default_rng(rows + batch)
    gx = r.standard_normal((2, steps, batch, H3)).astype(np.float32)
    w = (0.05 * r.standard_normal((2, H, H3))).astype(np.float32)
    bn = (0.1 * r.standard_normal((2, 1, H))).astype(np.float32)
    mem = cluster_forward_model(gx, w, bn, rows)
    assert (mem.reads == 1).all() and (mem.writes == 1).all()
    got = mem.ys_contract()
    want = _gru_layer_plain(*(torch.from_numpy(a) for a in (gx, w, bn)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows,batch,steps", [(2, 3, 2), (4, 5, 3)])
def test_cluster_forward_model_in_the_served_layout(rows, batch, steps):
    """The fp32 cluster kernel (the streaming finalize's) reading the
    GEMM's (B, T, 6H) and writing (B, T, 2H): every gx element read once,
    every output element written once, within 1e-5 of the plain
    ``gru_layer_btc``."""
    r = np.random.default_rng(rows + batch + 1)
    gx = r.standard_normal((2, steps, batch, H3)).astype(np.float32)
    w = (0.05 * r.standard_normal((2, H, H3))).astype(np.float32)
    bn = (0.1 * r.standard_normal((2, 1, H))).astype(np.float32)
    mem = cluster_forward_model(gx, w, bn, rows, layout="btc")
    assert (mem.reads == 1).all() and (mem.writes == 1).all()
    want = _gru_layer_btc_plain(_btc(torch.from_numpy(gx)),
                                torch.from_numpy(w), torch.from_numpy(bn))
    np.testing.assert_allclose(mem.ys.reshape(batch, steps, 2 * H),
                               want.numpy(), rtol=0, atol=1e-5)


# ---- gru_layer_bwd.cu: the fp32 cluster backward (gru_mma.cuh's maps) ----

C3 = 3 * UNITS                                 # the rank's columns of W^T


def f32_inbox_index(rows, buf, src, row, unit):
    """``gru_mma::f32_inbox_index``: [buffer][source rank][row][unit]."""
    return ((buf * CLUSTER_SIZE + src) * rows + row) * UNITS + unit


def slice_by_rows(wd, rank):
    """The rank's slice of W^T (H, 3H) as the kernel's cp.async loop fills
    it: chunk c (16 bytes) of row k <- the columns of gate c / 8, units
    4 (c % 8) .. + 3, at row stride ``CLUSTER_WT_STRIDE``; every chunk is
    written once, the padding never."""
    wts = np.full(H * CLUSTER_WT_STRIDE, np.nan, np.float32)
    i = np.arange(H * C3 // 4)
    k, c = i // (C3 // 4), i % (C3 // 4)
    for e in range(4):
        dst = k * CLUSTER_WT_STRIDE + 4 * c + e
        assert np.isnan(wts[dst]).all()
        wts[dst] = wd[k, (c >> 3) * H + rank * UNITS + 4 * (c & 7) + e]
    return wts


def register_slice(wd, rank):
    """The forward's register slice (``thread_w``) of every thread of the
    rank as (warp, k of its slice, gate, lane)."""
    return np.stack([np.stack([
        thread_w(wd, rank, warp, lane)[:, :, 0, :].transpose(0, 2, 1)
        .reshape(SLICE_K, 3) for lane in range(32)], -1)
        for warp in range(CLUSTER_SLICES)])


def shuffle_transpose_reduce(x):
    """The bench's other option for dh_prev: ``x`` (32 lanes, 32 values)
    through the warp's xor shuffles, offsets 16 .. 1, each lane keeping the
    half its bit selects -> lane l holds sum over lanes of x[:, l]."""
    x = x.copy()
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        up = (lane & o) != 0
        nxt = np.empty((32, o), x.dtype)
        for i in range(o):
            send = np.where(up, x[:, i], x[:, i + o])
            keep = np.where(up, x[:, i + o], x[:, i])
            nxt[:, i] = keep + send[lane ^ o]
        x = nxt
    return x[:, 0]


def cluster_backward_model(gx, w, bn, ys, dys, rows):
    """``gru_layer_bwd_cluster_kernel<rows>`` for every cluster of the
    launch: fp32 gx (2, T, B, 3H), w (2, H, 3H), bn (2, 1, H), ys, dys
    (2, T, B, H) -> (dgx, dgh) (2, T, B, 3H).  Each rank's shared memory
    starts NaN: the h_prev tiles (each read step poisoned again after it),
    the k-slices' partial sums and the dgh tile (poisoned every step), the
    inbox (a buffer poisoned once its owner has read it, and each partial
    sum stored only where it has been read)."""
    steps, batch = gx.shape[1:3]
    cluster = CLUSTER_SIZE
    pairs = -(-rows * UNITS // THREADS)
    p = np.arange(THREADS)[None, :] + THREADS * np.arange(pairs)[:, None]
    prow, punit = p // UNITS, p % UNITS
    assert (punit == np.arange(THREADS) % 32).all()    # unit = lane
    live = prow < rows
    r_, u_ = prow[live], punit[live]
    dgx = np.full(gx.shape, np.nan, np.float32)
    dgh = np.full(gx.shape, np.nan, np.float32)
    for d in range(2):
        regs = [register_slice(w[d], rank) for rank in range(cluster)]
        wts = [slice_by_rows(w[d], rank).reshape(H, CLUSTER_WT_STRIDE)
               for rank in range(cluster)]
        for row0 in range(0, batch, rows):
            hp = np.full((cluster, 2, rows, H), np.nan, np.float32)
            inbox = np.full((cluster, 2 * cluster * rows * UNITS), np.nan,
                            np.float32)
            dhz = np.zeros((cluster, len(r_)), np.float32)
            valid = row0 + r_ < batch
            for t in reversed(range(steps)):
                last = t == steps - 1
                for rank in range(cluster):     # load_h(t), a step ahead
                    tile = np.zeros((rows, H), np.float32)
                    ok = row0 + np.arange(rows) < batch
                    if t > 0:
                        tile[ok] = ys[d, t - 1, row0 + np.arange(rows)[ok]]
                    assert np.isnan(hp[rank, t & 1]).all(), "tile in use"
                    hp[rank, t & 1] = tile
                writes = np.zeros((cluster, rows, UNITS), np.int64)
                for rank in range(cluster):
                    unit0 = rank * UNITS
                    hc = hp[rank, t & 1]
                    assert np.isfinite(hc).all(), "read of an unwritten h"
                    part = np.full(CLUSTER_SLICES * rows * C3, np.nan,
                                   np.float32)
                    for warp in range(CLUSTER_SLICES):
                        hk = hc[:, SLICE_K * warp:SLICE_K * (warp + 1)]
                        acc = np.einsum("rk,kgl->rgl", hk, regs[rank][warp])
                        for gate in range(3):
                            idx = f32_partial_index(
                                rows, warp, np.arange(rows)[:, None], gate,
                                LANES[None, :])
                            assert np.isnan(part[idx]).all()
                            part[idx] = acc[:, gate]
                    s = [part[f32_partial_index(rows, 0, r_, gate, u_)]
                         for gate in range(3)]
                    for sl in range(1, CLUSTER_SLICES):   # in slice order
                        for gate in range(3):
                            s[gate] = s[gate] + part[f32_partial_index(
                                rows, sl, r_, gate, u_)]
                    din = np.zeros(len(r_), np.float32)
                    if not last:
                        for src in range(cluster):        # in rank order
                            idx = f32_inbox_index(rows, (t + 1) & 1, src,
                                                  r_, u_)
                            assert np.isfinite(inbox[rank, idx]).all()
                            din = din + inbox[rank, idx]
                    g = np.zeros((3, len(r_)), np.float32)
                    dy = np.zeros(len(r_), np.float32)
                    for gate in range(3):
                        g[gate, valid] = gx[d, t, row0 + r_[valid],
                                            gate * H + unit0 + u_[valid]]
                    dy[valid] = dys[d, t, row0 + r_[valid], unit0 + u_[valid]]
                    rg = sigmoid(g[0] + s[0])
                    zg = sigmoid(g[1] + s[1])
                    ghn_b = s[2] + bn[d, 0, unit0 + u_]
                    ng = np.tanh(g[2] + rg * ghn_b)
                    dh_tot = dhz[rank] + din + dy
                    dan = dh_tot * (1.0 - zg) * (1.0 - ng * ng)
                    dar = dan * ghn_b * rg * (1.0 - rg)
                    daz = dh_tot * (hc[r_, unit0 + u_] - ng) * zg * (1.0 - zg)
                    dgn = dan * rg
                    dhz[rank] = dh_tot * zg
                    rv, uv = row0 + r_[valid], unit0 + u_[valid]
                    for gate, a, b in ((0, dar, dar), (1, daz, daz),
                                       (2, dan, dgn)):
                        dgx[d, t, rv, gate * H + uv] = a[valid]
                        dgh[d, t, rv, gate * H + uv] = b[valid]
                    dg = np.full((rows, C3), np.nan, np.float32)
                    for gate, b in ((0, dar), (1, daz), (2, dgn)):
                        dg[r_, gate * UNITS + u_] = np.where(valid, b, 0.0)
                    if t > 0:
                        assert np.isfinite(dg).all(), "dgh tile incomplete"
                        # thread k: row k of the slice times the dgh tile
                        wk = wts[rank][:, :C3]
                        assert np.isfinite(wk).all()
                        acc = dg @ wk.T                   # (rows, k)
                        for warp in range(CLUSTER_SLICES):   # owner rank
                            for r in range(rows):
                                idx = f32_inbox_index(rows, t & 1, rank, r,
                                                      LANES)
                                assert np.isnan(inbox[warp, idx]).all(), \
                                    "a partial sum stored over an unread one"
                                inbox[warp, idx] = acc[r, 32 * warp + LANES]
                                writes[warp, r] += 1
                    hp[rank, t & 1] = np.nan
                if not last:
                    for rank in range(cluster):   # read: free to rewrite
                        inbox[rank, f32_inbox_index(rows, (t + 1) & 1, 0, 0,
                                                    0):f32_inbox_index(
                            rows, (t + 1) & 1, cluster, 0, 0)] = np.nan
                if t > 0:
                    assert (writes == cluster).all(), "each source once"
    return dgx, dgh


def test_cluster_backward_holds_the_slice_once_in_each_copy():
    """Rank c of the backward holds the r, z and n columns of its units
    [U c, U c + U) twice, once a copy: in registers (the forward's map) and
    in shared memory by rows of k; across the cluster each copy holds every
    element of W^T exactly once, and no padding float is written."""
    wt = np.arange(H * H3, dtype=np.float64).reshape(H, H3)
    regs, rows_ = [], []
    for rank in range(CLUSTER_SIZE):
        reg = register_slice(wt, rank)
        by_rows = slice_by_rows(wt.astype(np.float32), rank).reshape(
            H, CLUSTER_WT_STRIDE)
        assert np.isnan(by_rows[:, C3:]).all()
        cols = by_rows[:, :C3].astype(np.int64) % H3
        assert set(np.unique(cols % H)) == set(range(rank * UNITS,
                                                     (rank + 1) * UNITS))
        assert (by_rows[:, :C3].astype(np.int64) // H3
                == np.arange(H)[:, None]).all()
        assert sorted(reg.ravel()) == sorted(by_rows[:, :C3].ravel())
        regs.append(reg.ravel())
        rows_.append(by_rows[:, :C3].ravel())
    for held in (regs, rows_):
        held = np.concatenate(held)
        assert len(held) == H * H3 and len(set(held)) == H * H3


@pytest.mark.parametrize("rows", CLUSTER_ROWS_BACKWARD)
def test_cluster_inbox_is_a_bijection_without_conflicts(rows):
    """Every (buffer, source, row, unit) of the inbox at its own float;
    warp s's store (one row; lanes over the units of rank s) and a gating
    warp's read (one source and row; lanes over units) touch 32
    consecutive floats, one a bank; the dgh tile's writes likewise."""
    idx = f32_inbox_index(rows, np.arange(2)[:, None, None, None],
                          np.arange(CLUSTER_SIZE)[None, :, None, None],
                          np.arange(rows)[None, None, :, None],
                          np.arange(UNITS)[None, None, None, :])
    assert sorted(idx.ravel()) == list(range(2 * CLUSTER_SIZE * rows * UNITS))
    for buf in range(2):
        for src in range(CLUSTER_SIZE):
            for row in range(rows):
                a = f32_inbox_index(rows, buf, src, row, LANES)
                assert sorted(a % 32) == list(range(32))
    for row in range(rows):
        for gate in range(3):
            assert sorted((row * C3 + gate * UNITS + LANES) % 32) \
                == list(range(32))


def test_cluster_slice_by_rows_reads_without_conflicts():
    """dh_prev's read of the slice: lane l of warp s reads the float4 at
    row k = 32 s + l, column c; each quarter warp (one 128-byte wavefront
    of a 16-byte load) covers all 32 banks once, at every column; without
    the padding it would hit four."""
    for c in range(0, C3, 4):
        for quarter in range(4):
            k = 8 * quarter + np.arange(8)
            for stride, spread in ((CLUSTER_WT_STRIDE, 32), (C3, 4)):
                words = (k[:, None] * stride + c + np.arange(4)) % 32
                assert len(set(words.ravel())) == spread


def test_cluster_dh_product_is_the_matrix_product():
    """Each rank's partial sums of dh_prev, by either option, added over
    the ranks in rank order, are dgh @ W^T: (i) thread k's row of the
    slice by rows times the dgh tile; (ii) the register slice's 32
    products a lane, summed over the warp's lanes by the shuffle
    transpose-reduction."""
    r = np.random.default_rng(11)
    rows = 3
    wd = r.standard_normal((H, H3)).astype(np.float32)
    dgh = r.standard_normal((rows, H3)).astype(np.float32)
    want = dgh.astype(np.float64) @ wd.T.astype(np.float64)
    total = {"rows": np.zeros((rows, H)), "shuffle": np.zeros((rows, H))}
    for rank in range(CLUSTER_SIZE):
        cols = (np.arange(3)[:, None] * H + rank * UNITS
                + np.arange(UNITS)).ravel()           # gate * 32 + unit
        dg = dgh[:, cols]
        wk = slice_by_rows(wd, rank).reshape(H, CLUSTER_WT_STRIDE)[:, :C3]
        total["rows"] += dg @ wk.T
        reg = register_slice(wd, rank)                # (warp, k, gate, lane)
        for warp in range(CLUSTER_SLICES):
            for row in range(rows):
                d = dg[row].reshape(3, UNITS)         # (gate, lane)
                x = np.einsum("gl,kgl->lk", d, reg[warp])
                total["shuffle"][row, 32 * warp:32 * warp + 32] += \
                    shuffle_transpose_reduce(x)
    for got in total.values():
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("rows,batch,steps", [
    (1, 1, 3), (1, 2, 2), (2, 3, 2), (4, 7, 3), (8, 9, 2), (16, 17, 2),
    (16, 5, 1)])
def test_cluster_backward_model_matches_plain(rows, batch, steps):
    """Products over eight k-slices, the gates' adjoints, the dh_prev
    partial sums and their exchange over eight ranks reproduce the fp32
    adjoint recurrence on full and ragged tiles: dgx within the fp32 bar
    per element, dW and db_hn (formed from the dgh workspace as the
    wrapper forms them) within it relative to their scale, of
    ``_gru_layer_backward_plain``; every output is written, no read finds
    an unwritten tile, each owner receives each source's partial sums
    exactly once a step, and none lands on one not yet read."""
    r = np.random.default_rng(rows + 10 * batch + steps)
    gx = r.standard_normal((2, steps, batch, H3)).astype(np.float32)
    w = (0.05 * r.standard_normal((2, H, H3))).astype(np.float32)
    bn = (0.1 * r.standard_normal((2, 1, H))).astype(np.float32)
    dys = r.standard_normal((2, steps, batch, H)).astype(np.float32)
    t_gx, t_w, t_bn, t_dys = (torch.from_numpy(a) for a in (gx, w, bn, dys))
    ys = _gru_layer_plain(t_gx, t_w, t_bn)
    dgx, dgh = cluster_backward_model(gx, w, bn, ys.numpy(), dys, rows)
    assert np.isfinite(dgx).all() and np.isfinite(dgh).all()
    dw, dbn = weight_gradients(ys.numpy(), dgh)
    want = _gru_layer_backward_plain(t_gx, t_w, t_bn, ys, t_dys)
    np.testing.assert_allclose(dgx, want[0].numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for got, ref in ((dw, want[1]), (dbn, want[2])):
        ref = ref.numpy()
        assert np.abs(got - ref).max() <= (GRAD_ATOL
                                           + GRAD_RTOL * np.abs(ref).max())


# ---- shared memory and the dispatcher ----

def _eval_constexpr(src, name, **values):
    body = re.search(name + r"\(int mt\) \{\s*return (.*?);", src,
                     re.S).group(1)
    return eval(body, {"kSliceBytes": 98304, **values})  # noqa: S307


@pytest.mark.parametrize("backward", [False, True])
def test_shared_memory_of_every_tile_height_fits(backward):
    """Every (C = 4, rows) the dispatcher can pick needs at most 232,448
    bytes, ``mma_smem_bytes`` counts what the source's constexpr counts, and
    the model's regions add up to it."""
    src = source("gru_layer_bwd.cu" if backward else "gru_layer.cu")
    fn = "bwd_mma_smem_bytes" if backward else "mma_smem_bytes"
    for rows in (MMA_ROWS_BACKWARD if backward else MMA_ROWS):
        need = mma_smem_bytes(rows, backward)
        assert need <= SMEM_LIMIT
        assert need == _eval_constexpr(src, fn, mt=rows // 16)
        if backward:
            regions = (H * SLICE_CHUNKS * 16 + 2 * 4 * rows * 256 + rows * 768
                       + rows * 512 + rows * 384 + rows * 128)
        else:
            regions = 2 * rows * 2 * H + 2 * rows * 3 * (H // MMA_CLUSTER) * 2
        assert regions == need
    # the next height up does not fit (backward) / is not built (forward)
    if backward:
        assert mma_smem_bytes(2 * MMA_ROWS_BACKWARD[-1], True) > SMEM_LIMIT
    else:
        assert mma_smem_bytes(2 * MMA_ROWS[-1]) > SMEM_LIMIT


def _f32_smem_of_the_source(rows):
    """``gru_mma::f32_smem_bytes`` evaluated from its text."""
    head = source("gru_mma.cuh")
    body = re.search(r"int f32_smem_bytes\(.*?\{\s*return (.*?);", head,
                     re.S).group(1)
    return eval(body.replace("/", "//"), {  # noqa: S307
        "f32_h_floats": lambda r: 2 * r * H, "kF32Slices": CLUSTER_SLICES,
        "kF32Units": UNITS, "rows": rows})


@pytest.mark.parametrize("rows", CLUSTER_ROWS)
def test_cluster_kernel_shared_memory_fits(rows):
    """Every height of the fp32 cluster kernel needs at most 232,448
    bytes: two h tiles and the eight k-slices' partial sums, as the
    source's ``f32_smem_bytes`` counts them (W^T is in registers); the
    next height up, 64 rows, does not fit."""
    need = cluster_smem_bytes(rows)
    assert need <= SMEM_LIMIT
    assert need == _f32_smem_of_the_source(rows)
    assert need == 4 * (2 * rows * H + CLUSTER_SLICES * rows * 3 * UNITS)
    assert cluster_smem_bytes(2 * CLUSTER_ROWS[-1]) > SMEM_LIMIT


def _f32_bwd_smem_of_the_source(rows):
    """``gru_mma::f32_bwd_smem_bytes`` evaluated from its text."""
    head = source("gru_mma.cuh")
    body = re.search(r"int f32_bwd_smem_bytes\(.*?\{\s*return (.*?);", head,
                     re.S).group(1)
    return eval(body, {  # noqa: S307
        "f32_h_floats": lambda r: 2 * r * H, "kF32Slices": CLUSTER_SLICES,
        "kF32Units": UNITS, "kF32Cluster": CLUSTER_SIZE, "kHidden": H,
        "kF32WtStride": CLUSTER_WT_STRIDE, "rows": rows})


@pytest.mark.parametrize("rows", CLUSTER_ROWS_BACKWARD)
def test_cluster_backward_shared_memory_fits(rows):
    """Every height of the fp32 backward needs at most 232,448 bytes: the
    slice by rows of k (H x 100 floats), two h_prev tiles, the k-slices'
    partial sums, the dgh tile and the inbox, as the source's
    ``f32_bwd_smem_bytes`` counts them; the next height up, 32 rows, does
    not fit."""
    need = cluster_smem_bytes(rows, backward=True)
    assert need <= SMEM_LIMIT
    assert need == _f32_bwd_smem_of_the_source(rows)
    assert need == 4 * (H * CLUSTER_WT_STRIDE + 2 * rows * H
                        + CLUSTER_SLICES * rows * C3 + rows * C3
                        + 2 * CLUSTER_SIZE * rows * UNITS)
    assert cluster_smem_bytes(2 * CLUSTER_ROWS_BACKWARD[-1], True) \
        > SMEM_LIMIT


def test_python_constants_are_the_sources():
    head = source("gru_mma.cuh")
    assert int(re.search(r"kHidden = (\d+);", head).group(1)) == MMA_HIDDEN
    assert int(re.search(r"kCluster = (\d+);", head).group(1)) == MMA_CLUSTER
    for name, heights in (("gru_layer.cu", MMA_ROWS),
                          ("gru_layer_bwd.cu", MMA_ROWS_BACKWARD)):
        body = source(name).split("int dispatch_mma(")[1].split("\n}\n")[0]
        cases = re.findall(r"case (\d+):\s*return launch_mma<(\d+)>", body)
        assert tuple(int(r) for r, _ in cases) == heights
        assert all(int(r) == 16 * int(mt) for r, mt in cases)
    assert SMEM_LIMIT == 232448
    assert int(re.search(r"constexpr int kF32Cluster = (\d+);", head)
               .group(1)) == CLUSTER_SIZE
    assert "kF32Units = kHidden / kF32Cluster" in head
    body = source("gru_layer.cu")
    dispatch = body.split("int dispatch_cluster(")[1].split("\n}\n")[0]
    cases = re.findall(r"case (\d+):\s*return launch_cluster<(\d+)>",
                       dispatch)
    assert tuple(int(r) for r, _ in cases) == CLUSTER_ROWS
    assert all(r == m for r, m in cases)
    assert "kF32Slices = kThreads / 32" in head
    assert int(re.search(r"kThreads = (\d+);", head).group(1)) // 32 \
        == CLUSTER_SLICES
    assert "kF32WtStride = 3 * kF32Units + 4;" in head
    assert CLUSTER_WT_STRIDE == 3 * UNITS + 4
    dispatch = source("gru_layer_bwd.cu").split(
        "int dispatch_cluster(")[1].split("\n}\n")[0]
    cases = re.findall(r"case (\d+):\s*return launch_cluster<(\d+)>",
                       dispatch)
    assert tuple(int(r) for r, _ in cases) == CLUSTER_ROWS_BACKWARD
    assert all(r == m for r, m in cases)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sms,clusters", [(132, 30), (132, None), (108, 27),
                                          (8, 2), (264, 66)])
def test_gru_plan_over_a_grid(backward, sms, clusters):
    """bf16 at H = 256: always the tensor-core kernel at a built height
    whose waves x (overhead + rows) is the least (the shorter on a tie); a
    batch that fits one wave at the shortest height takes it unless a taller
    one also fits one wave more cheaply; never more rows than the batch
    needs once a shorter tile is as cheap."""
    heights = MMA_ROWS_BACKWARD if backward else MMA_ROWS
    overhead = gru_ops.MMA_STEP_OVERHEAD[backward]
    resident = clusters if clusters is not None else sms // MMA_CLUSTER

    def cost(batch, rows):
        return -(-2 * -(-batch // rows) // resident) * (overhead + rows)

    for batch in (1, 3, 16, 17, 64, 255, 256, 257, 512, 1024, 1030, 2048,
                  4096, 10000):
        plan = gru_plan(batch, 256, torch.bfloat16, sms, backward, clusters)
        assert plan.kernel == "mma" and plan.rows in heights
        best = min(cost(batch, r) for r in heights)
        assert cost(batch, plan.rows) == best
        assert all(cost(batch, r) > best for r in heights if r < plan.rows)
        assert mma_smem_bytes(plan.rows, backward) <= SMEM_LIMIT
    assert gru_plan(1, 256, torch.bfloat16, sms, backward,
                    clusters).rows == heights[0]


@pytest.mark.parametrize("batch,backward,rows", [
    (1, False, 16), (64, False, 16), (256, False, 32), (257, False, 32),
    (512, False, 48), (1030, False, 80), (2048, False, 80),
    (4096, False, 96), (1, True, 16), (256, True, 32), (1024, True, 16),
    (1030, True, 16), (2048, True, 32)])
def test_gru_plan_on_an_h100(batch, backward, rows):
    """The picks on the card the step costs were fitted on (132 SMs, 30
    resident clusters of four)."""
    assert gru_plan(batch, 256, torch.bfloat16, 132, backward, 30) == Plan(
        "mma", rows)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("hidden,dtype", [
    (256, torch.float32), (128, torch.bfloat16), (512, torch.bfloat16),
    (128, torch.float32)])
def test_gru_plan_keeps_the_cuda_core_kernel(hidden, dtype, backward):
    """Any H other than 256 takes the CUDA-core kernel at ``tile_rows``'
    height, by rule and not by failure; fp32 at H = 256 takes the cluster
    kernel, forward and backward, at the height of least fitted cost at
    every batch."""
    for batch, sms in ((1, 132), (256, 132), (2048, 132), (64, 8)):
        plan = gru_plan(batch, hidden, dtype, sms, backward, 30)
        if dtype == torch.float32 and hidden == 256:
            heights = CLUSTER_ROWS_BACKWARD if backward else CLUSTER_ROWS
            assert plan == Plan("cluster", min(heights, key=lambda r: (
                _cluster_us(batch, r, 30, backward), r)))
            continue
        assert plan == Plan("simt", tile_rows(batch, sms))
        assert plan.rows in TILE_ROWS


def _cluster_us(batch, rows, resident, backward=False):
    fixed, per_row = CLUSTER_BWD_STEP_US if backward else CLUSTER_STEP_US
    return -(-2 * -(-batch // rows) // resident) * (fixed + per_row * rows)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sms,clusters", [(132, 15), (132, None), (108, 12),
                                          (16, 2), (264, 30)])
def test_cluster_plan_over_a_grid(sms, clusters, backward):
    """fp32 at H = 256, forward and backward: always the cluster kernel, at
    the built height whose waves x (fixed + per-row cost) is the least (the
    shorter on a tie); every pick fits shared memory."""
    resident = clusters if clusters is not None else sms // CLUSTER_SIZE
    heights = CLUSTER_ROWS_BACKWARD if backward else CLUSTER_ROWS
    for batch in (1, 2, 3, 15, 16, 17, 64, 255, 256, 257, 1024, 2048, 4096,
                  10000):
        plan = gru_plan(batch, 256, torch.float32, sms, backward, clusters)
        cost = [_cluster_us(batch, r, resident, backward) for r in heights]
        assert plan.kernel == "cluster" and plan.rows in heights
        assert _cluster_us(batch, plan.rows, resident, backward) == min(cost)
        assert all(c > min(cost) for r, c in zip(heights, cost)
                   if r < plan.rows)
        assert cluster_smem_bytes(plan.rows, backward) <= SMEM_LIMIT


@pytest.mark.parametrize("batch,rows", [(1, 1), (2, 1), (16, 4), (17, 4),
                                        (64, 16), (256, 16), (2048, 32)])
def test_cluster_plan_on_an_h100(batch, rows):
    """The picks on the card the step costs were fitted on (132 SMs, 15
    resident clusters of eight): the cluster kernel at B = 1 and 16 (the
    streaming finalize) and at 256 / 2048 (evaluation), at each of which it
    measured faster than the CUDA-core kernel; the fp32 backward takes the
    cluster backward (``test_cluster_backward_plan_on_an_h100``)."""
    assert gru_plan(batch, 256, torch.float32, 132, False, 15) == Plan(
        "cluster", rows)
    assert gru_plan(batch, 256, torch.float32, 132, True, 15).kernel \
        == "cluster"


@pytest.mark.parametrize("batch,rows", [(1, 1), (3, 1), (8, 2), (16, 4),
                                        (64, 16), (256, 16), (1024, 16),
                                        (2048, 16)])
def test_cluster_backward_plan_on_an_h100(batch, rows):
    """The fp32 backward's picks on the card its step costs were fitted on
    (132 SMs, 15 resident clusters of eight): the cluster backward at
    every batch; at B = 16 / 64 / 1024 the height that measured fastest
    there, at B = 256 16 rows, 2.7 % behind the 8-row tile, which the
    linear step cost does not tell apart (bench_torch_gru_variants.py;
    PERF.md)."""
    assert gru_plan(batch, 256, torch.float32, 132, True, 15) == Plan(
        "cluster", rows)


# ---- entry points ----

def test_gru_entry_points_match_their_ctypes_signatures():
    """The GRU sources' ``extern "C"`` entry points are in
    ``_build._SIGNATURES`` with a pointer type exactly where the C parameter
    is a pointer; the tensor-core backward takes no transposed W (one
    pointer fewer than the CUDA-core one); every forward entry takes K2's
    seven numbers of addressing (``k2_strides``) before the stream."""
    found = {}
    for name in ("gru_layer.cu", "gru_layer_bwd.cu"):
        for entry, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                      source(name)):
            found[entry] = ["*" in a for a in args.split(",")]
    assert set(found) == {
        "sir_gru_layer_bf16", "sir_gru_layer_f32", "sir_gru_layer_mma",
        "sir_gru_layer_mma_info", "sir_gru_layer_bwd_bf16",
        "sir_gru_layer_bwd_f32", "sir_gru_layer_bwd_mma",
        "sir_gru_layer_bwd_mma_info", "sir_gru_layer_cluster",
        "sir_gru_layer_cluster_info", "sir_gru_layer_bwd_cluster",
        "sir_gru_layer_bwd_cluster_info"}
    for entry, pointers in found.items():
        assert [t is _build._P for t in _build._SIGNATURES[entry]] \
            == pointers, entry
    assert (sum(found["sir_gru_layer_bwd_bf16"])
            == sum(found["sir_gru_layer_bwd_mma"]) + 1)
    assert found["sir_gru_layer_mma"] == found["sir_gru_layer_bf16"]
    assert found["sir_gru_layer_cluster"] == found["sir_gru_layer_f32"]
    assert (found["sir_gru_layer_cluster_info"]
            == found["sir_gru_layer_mma_info"]
            == found["sir_gru_layer_bwd_cluster_info"])
    assert found["sir_gru_layer_bwd_cluster"] == found["sir_gru_layer_bwd_mma"]
    assert found["sir_gru_layer_mma"] == [True] * 4 + [False] * 11 + [True]
    assert _build._SIGNATURES["sir_gru_layer_mma"][8:15] == [
        _build._L] * 6 + [_build._I]


def _python(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_gru_variants_bench_edits_match_the_sources(tmp_path):
    """``bench_torch_gru_variants.py`` builds its variants by replacing
    lines of the kernels' sources: every replacement still matches exactly
    once and changes them, and importing the script loads no JAX and
    nothing of the JAX package."""
    code = f"""
import filecmp, os, shutil, sys
import bench_torch_gru_variants as b
changed = 0
for i, name in enumerate(b.VARIANTS):
    src = os.path.join({str(tmp_path)!r}, f'v{{i}}')
    shutil.copytree(b.CSRC, src)
    b.apply_edits(name, src)
    same = filecmp.dircmp(b.CSRC, src)
    assert bool(same.diff_files) == bool(b.VARIANTS[name][1]), name
    changed += bool(same.diff_files)
assert changed >= 11, changed
bad = sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'optax', 'speech_intent_recognizer_tpu'))
assert not bad, bad
"""
    r = _python(["-c", code], REPO)
    assert r.returncode == 0, r.stdout + r.stderr


def test_gru_variants_bench_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the host without one")
    r = _python([os.path.join(REPO, "bench_torch_gru_variants.py")], REPO)
    assert r.returncode != 0 and " ms" not in r.stdout


@pytest.mark.parametrize("batch,rows", [(1, 1), (16, 4)])
def test_gru_plan_of_the_streaming_path(batch, rows):
    """The streaming finalize and partial result run the fp32 model at
    B = 1 (one session) and up to 16 (a batched flush), T = 25: on an H100
    (132 SMs, 15 resident clusters of eight) the forward takes the fp32
    cluster kernel, and so does the backward build, at ``rows``."""
    assert gru_plan(batch, 256, torch.float32, 132, False, 15).kernel \
        == "cluster"
    assert gru_plan(batch, 256, torch.float32, 132, True, 15) == Plan(
        "cluster", rows)
