#!/usr/bin/env python
"""Where the time of the port's cluster GRU kernels goes: builds variants
of ``speech_intent_recognizer_tpu_torch/csrc/gru_layer.cu`` and
``gru_layer_bwd.cu`` with parts cut out and times the kernels alone (the
C entry points, without the wrappers' PyTorch work) side by side on one
NVIDIA GPU, in one process, with CUDA events.

Each variant is a copy of the sources with a few lines replaced (a
replacement that no longer matches the source fails), compiled by its own
``nvcc`` with ``-Xptxas -v`` and loaded with ctypes.  A variant with a part
cut out computes wrong values; only its time is read:

* K2 (``sir_gru_layer_mma``) at every tile height, B=256 and 2048, T=25:
  as committed; without the cluster barrier; without the stores into the
  other ranks' shared memory; with the gates' exponentials and divisions
  replaced by one multiply-add; without the tensor-core product; without
  the ys stores; with the ys stores placed before the arrive at the cluster
  barrier at every tile height, and after it at every height;
* K2T (``sir_gru_layer_bwd_mma``) at every tile height, B=256 and 1024:
  as committed; without the lo half of dgh (one bf16 rounding); without the
  dh product; without the gh product; without the dgx / dgh stores; without
  the exchange of partial sums and its barrier;
* the fp32 K2 (``sir_gru_layer_cluster``) at B = 1 / 16 / 256 / 2048, T=25,
  at every tile height its shared memory allows: as committed (clusters of
  8, W in registers); clusters of 4 (W in shared memory); clusters of 8
  with W in shared memory; without the cluster barrier; without the
  exchange of h_t; with W read from L2 at every step; without the product;
* the fp32 K2T (``sir_gru_layer_bwd_cluster``) at B = 16 / 64 / 256 /
  1024, T=25, at every tile height, and at B = 16 and 1024 with its parts
  cut out: as committed (the slice of W^T by rows of k in shared memory
  for dh_prev); the register slice with a shuffle transpose-reduction in
  its place; without the cluster barrier; without the exchange (the
  partial sums stored into the rank's own inbox); with the gh product
  after the wait for the partial sums; without the products;
* the CUDA-core kernels of both sources at their tile heights, for scale
  (the fp32 K2's and K2T's in fp32 operands, as the plan weighs them);
* the served GRU at the b2048 cell's shape (B = 2048, T = 25, bf16, the
  first layer's 1,024 inputs; :func:`time_layouts`, the package's own
  build): a layer on K2's entry on the input GEMM's layout with its one
  GEMM (``gru_layer_btc``, operands built once) against the contract
  entry with its glue (two GEMMs, the leaves' casts, the ``b_hh`` add,
  ``flip``, ``stack`` and ``cat``), both layers of each, and K2 alone
  (the C entry point) on either layout's strides.

Prints the card's name and power limit, each cluster kernel's
registers and spills as ptxas reports them, and least / median / most of
five timed blocks in ms.  Needs one card and nvcc; imports nothing of JAX.

    python3 bench_torch_gru_variants.py             # everything, ~4 min
    python3 bench_torch_gru_variants.py --layouts   # the served layer alone
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

from bench_torch_fft_variants import CSRC, blocks_ms, replace_once
from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops.gru import (
    CLUSTER_ROWS, CLUSTER_ROWS_BACKWARD, MMA_ROWS, MMA_ROWS_BACKWARD,
    SMEM_LIMIT, TILE_ROWS, btc_view, gru_layer_btc, k2_strides, picked_plan)
from speech_intent_recognizer_tpu_torch.utils.device import (
    gpu_label, require_cuda)

FWD, BWD, HEAD = "gru_layer.cu", "gru_layer_bwd.cu", "gru_mma.cuh"


def no_barrier(unit):
    return [(unit, "    if (t > 0) cluster_wait();\n" if unit == FWD
             else "    if (!last) cluster_wait();\n", ""),
            (unit, "    cluster_arrive();\n", ""),
            # one barrier stays, so that no rank leaves while another may
            # still write into it
            (unit, "  if (steps > 0) cluster_wait();\n",
             "  cluster_arrive();\n  cluster_wait();\n")]


NO_REMOTE_H = (FWD, "          st_cluster_16(map_to_rank(mine, (rank + r) % "
               "kCluster), v);", "          ;")
CHEAP_GATES = [("gru_mma.cuh", "  return __fdividef(1.f, 1.f + __expf(-v));",
                "  return 0.5f + 0.25f * v;"),
               ("gru_mma.cuh",
                "  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));",
                "  return 0.5f * v;")]
NO_PRODUCT = (FWD, "      recurrent_product<G>(acc, wf, h_cur, M, mt0, lane, "
              "n);", "")
NO_YS = (FWD, re.compile(r"        if \(row0 \+ row < batch\)\n"
                         r"          \*reinterpret_cast<uint4\*>\(\n.*?"
                         r"i \* 16\);\n", re.S), "")
YS_SWITCH = "  constexpr bool kYsAfterArrive = MT >= 3;"
YS_BEFORE_ARRIVE = (FWD, YS_SWITCH, YS_SWITCH.replace("MT >= 3", "false"))
YS_AFTER_ARRIVE = (FWD, YS_SWITCH, YS_SWITCH.replace("MT >= 3", "true"))
NO_LO_HALF = (BWD, re.compile(r"            mma_bf16\(acc2\[mt\]\[nt\], lo, .*?"
                              r"\);\n", re.S), "")
NO_DH_PRODUCT = (BWD, re.compile(r"      const int brow = .*?(?=      // units "
                                 r"\[32 warp)", re.S), "")
NO_GH_PRODUCT = (BWD, "    recurrent_product<MT>(acc, wf, smem_addr(hp), M, 0, "
                 "lane);", "")
NO_GRAD_STORES = (BWD, re.compile(
    r"        if \(row0 \+ row < batch\) \{\n          const size_t o = .*?\n"
    r"        \}\n", re.S), "")
NO_PARTIAL_SUMS = (BWD, re.compile(r"            st_cluster_8\(box_out.*?\);\n",
                                   re.S), "            ;\n")

F32_WAIT = ("    if (t > 0) cluster_wait();  // every rank's slab of h_{t-1} "
            "is in tile cur\n")
F32_ARRIVE = "    cluster_arrive();  // h_t is on its way to every rank\n"
F32_LAST = "  if (steps > 0) cluster_wait();  // the last step's arrive\n"
F32_NO_BARRIER = [(FWD, F32_WAIT, ""), (FWD, F32_ARRIVE, ""),
                  (FWD, F32_LAST, "  cluster_arrive();\n  cluster_wait();\n")]
F32_NO_EXCHANGE = (FWD, "            st_cluster_16(map_to_rank(at, r), bits);",
                   "            ;")
F32_C4 = (HEAD, "constexpr int kF32Cluster = 8;",
          "constexpr int kF32Cluster = 4;")
# the rank's slice of W^T in shared memory ([kq][gate][unit][4] floats,
# after the partial sums) in place of registers: the load, the reads and
# the launch's shared-memory size
F32_W_SHARED = [
    (FWD, re.compile(r"  float4 wr\[KQ\]\[3\]\[UPL\];\n.*?"
                     r"p\[3 \* kGates\]\);\n      }\n", re.S), """\
  float* const w_s = part + kF32Slices * M * 3 * U;
  for (int e = tid; e < kHidden * 3 * U; e += kThreads) {
    const int unit = e % U, gate = (e / U) % 3, k = e / (3 * U);
    w_s[(((k >> 2) * 3 + gate) * U + unit) * 4 + (k & 3)] =
        wd[static_cast<size_t>(k) * kGates + gate * kHidden + unit0 + unit];
  }
"""),
    (FWD, "            const float4 wv = wr[kq][gate][i];\n", """\
            const float4 wv = *reinterpret_cast<const float4*>(
                w_s + (((KQ * warp + kq) * 3 + gate) * U + lane + 32 * i) * 4);
"""),
    (FWD, "  const int smem = f32_smem_bytes(M);\n",
     "  const int smem = f32_smem_bytes(M) + 4 * kHidden * 3 * kF32Units;\n")]
F32_W_FROM_L2 = (FWD, "            const float4 wv = wr[kq][gate][i];\n", """\
            const float* wg = wd +
                static_cast<size_t>(kF32SliceK * warp + 4 * kq) * kGates +
                gate * kHidden + unit0 + lane + 32 * i;
            const float4 wv = make_float4(__ldg(wg), __ldg(wg + kGates),
                                          __ldg(wg + 2 * kGates),
                                          __ldg(wg + 3 * kGates));
""")
F32_NO_PRODUCT = (FWD, re.compile(
    r"              acc\[rb\]\[gate\]\[i\] = fmaf\(hv\[rb\]\.w.*?\)\)\)\);\n",
    re.S), "              ;\n")

F32B_WAIT = ("    if (!last) cluster_wait();  // every rank's partial sums of "
             "step t + 1\n")
F32B_NO_BARRIER = [
    (BWD, F32B_WAIT, ""),
    (BWD, "    cluster_arrive();  // the partial sums are on their way to "
     "their owners\n", ""),
    (BWD, "  if (steps > 0) cluster_wait();  // the last step's arrive\n",
     "  cluster_arrive();\n  cluster_wait();\n")]
F32B_OWN_INBOX = (BWD, "      for (int r = 0; r < M; ++r) "
                  "st_cluster_4(box_out + 4 * U * r, acc[r]);", """\
      for (int r = 0; r < M; ++r)
        inbox[f32_inbox_index(M, t & 1, rank, r, lane)] = acc[r];""")
# dh_prev from the register slice: thread (s, l) forms the 32 products of
# its k-slice for unit l, then the warp sums them over its lanes so that
# lane l holds k = 32 s + l (31 shuffles a row); no slice by rows is loaded
F32B_W_REGISTERS = [
    (BWD, re.compile(r"  for \(int i = tid; i < kHidden \* C3 / 4; .*?"
                     r"true\);\n  }\n", re.S), ""),
    (BWD, re.compile(r"      float acc\[M\];\n#pragma unroll\n      for "
                     r"\(int r = 0; r < M; \+\+r\) acc\[r\] = 0\.f;\n"
                     r"      const float\* wk = .*?"
                     r"(?=      // k = 32 warp \+ lane)", re.S), """\
      float acc[M];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const float d0 = dg[r * C3 + lane], d1 = dg[r * C3 + U + lane],
                    d2 = dg[r * C3 + 2 * U + lane];
        float x[kF32SliceK];
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
          const float4 a = wr[kq][0], b = wr[kq][1], c = wr[kq][2];
          x[4 * kq] = fmaf(d2, c.x, fmaf(d1, b.x, d0 * a.x));
          x[4 * kq + 1] = fmaf(d2, c.y, fmaf(d1, b.y, d0 * a.y));
          x[4 * kq + 2] = fmaf(d2, c.z, fmaf(d1, b.z, d0 * a.z));
          x[4 * kq + 3] = fmaf(d2, c.w, fmaf(d1, b.w, d0 * a.w));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const bool up = lane & o;
#pragma unroll
          for (int i = 0; i < o; ++i) {
            const float send = up ? x[i] : x[i + o];
            x[i] = (up ? x[i + o] : x[i]) +
                   __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
        acc[r] = x[0];
      }
""")]
F32B_GH_AFTER_WAIT = [
    (BWD, F32B_WAIT, ""),
    (BWD, "    // gh = h_prev W over this warp's k-slice: waits for no other "
     "rank\n", "    if (t != steps - 1) cluster_wait();\n")]
F32B_NO_PRODUCTS = [
    (BWD, re.compile(r"            acc\[rb\]\[gate\] = fmaf\(hv\[rb\]\.w.*?"
                     r"acc\[rb\]\[gate\]\)\)\)\);\n", re.S),
     "            ;\n"),
    (BWD, re.compile(r"          acc\[r\] = fmaf\(d\.w, wv\.w, .*?"
                     r"acc\[r\]\)\)\)\);\n", re.S), "          ;\n")]

# name -> (the .cu to build, edits)
VARIANTS = {
    "K2 as committed": (FWD, []),
    "K2 without the cluster barrier": (FWD, no_barrier(FWD)),
    "K2 without the stores into the other ranks": (FWD, [NO_REMOTE_H]),
    "K2 with one multiply-add for each gate function": (FWD, CHEAP_GATES),
    "K2 without the tensor-core product": (FWD, [NO_PRODUCT]),
    "K2 without the ys stores": (FWD, [NO_YS]),
    "K2 with the ys stores before the arrive": (FWD, [YS_BEFORE_ARRIVE]),
    "K2 with the ys stores after the arrive": (FWD, [YS_AFTER_ARRIVE]),
    "K2T as committed": (BWD, []),
    "K2T without the lo half of dgh": (BWD, [NO_LO_HALF]),
    "K2T without the dh product": (BWD, [NO_DH_PRODUCT]),
    "K2T without the gh product": (BWD, [NO_GH_PRODUCT]),
    "K2T without the dgx and dgh stores": (BWD, [NO_GRAD_STORES]),
    "K2T without the exchange of partial sums and its barrier": (
        BWD, [NO_PARTIAL_SUMS, *no_barrier(BWD)]),
    "K2T with one multiply-add for each gate function": (BWD, CHEAP_GATES),
    "fp32 K2 in clusters of 4, W in shared memory": (
        FWD, [F32_C4, *F32_W_SHARED]),
    "fp32 K2 in clusters of 8, W in shared memory": (FWD, F32_W_SHARED),
    "fp32 K2 without the cluster barrier": (FWD, F32_NO_BARRIER),
    "fp32 K2 without the exchange of h_t": (FWD, [F32_NO_EXCHANGE]),
    "fp32 K2 with W read from L2 at every step": (FWD, [F32_W_FROM_L2]),
    "fp32 K2 without the product": (FWD, [F32_NO_PRODUCT]),
    "fp32 K2T with the register slice and a shuffle reduction for dh_prev": (
        BWD, F32B_W_REGISTERS),
    "fp32 K2T without the cluster barrier": (BWD, F32B_NO_BARRIER),
    "fp32 K2T without the exchange (own inbox)": (BWD, [F32B_OWN_INBOX]),
    "fp32 K2T with the gh product after the wait": (BWD, F32B_GH_AFTER_WAIT),
    "fp32 K2T without the products": (BWD, F32B_NO_PRODUCTS),
}


def f32_smem_bytes(rows: int, cluster: int, w_shared: bool) -> int:
    """Shared memory of an fp32 K2 build: ``cluster_smem_bytes``' h tiles
    and partial sums at ``cluster`` blocks a cluster, and the rank's slice
    of W^T where it sits in shared memory."""
    units = 256 // cluster
    return 4 * (2 * rows * 256 + 8 * rows * 3 * units
                + (256 * 3 * units if w_shared else 0))


def f32_heights(name: str) -> tuple:
    """The fp32 K2 tile heights a variant's shared memory allows."""
    cluster = 4 if "clusters of 4" in name else 8
    shared = "shared memory" in name
    return tuple(r for r in CLUSTER_ROWS
                 if f32_smem_bytes(r, cluster, shared) <= SMEM_LIMIT)


def apply_edits(name: str, src: str) -> None:
    replace_once(VARIANTS[name][1], src, name)


def build_all(root: str) -> dict:
    """Copy, edit and compile every variant (all nvcc at once); returns
    name -> (ctypes library, ptxas lines of the tensor-core kernels)."""
    procs = {}
    for i, (name, (unit, _)) in enumerate(VARIANTS.items()):
        src = os.path.join(root, f"v{i}")
        shutil.copytree(CSRC, src)
        apply_edits(name, src)
        so = os.path.join(src, "variant.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", so, os.path.join(src, unit)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{err[-3000:]}")
        lines = err.splitlines()
        used = [f"{m.group(1)}: "
                f"{lines[k + 2].split(': ', 1)[-1]}; {lines[k + 1].strip()}"
                for k, line in enumerate(lines) if (m := re.search(
                    r"Function properties for \S*?(gru_layer(?:_bwd)?_mma_"
                    r"kernelILi\d+E|gru_layer(?:_bwd)?_cluster_kernelILi\d+E)",
                    line))]
        lib = ctypes.CDLL(so)
        for entry, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, used)
    return libs


def time_layouts(dev, stream, checked) -> None:
    """The served GRU at B = 2048, T = 25 (bf16, layer 0 takes 1,024
    inputs): each path's layer 0 and both layers, and K2 alone on each
    layout, through the package's build."""
    import torch.nn.functional as F

    from speech_intent_recognizer_tpu_torch.models.cnn_gru import TorchGRU

    batch, steps, feat, hidden = 2048, 25, 1024, 256
    gru = TorchGRU(feat, hidden, 2, compute_dtype=torch.bfloat16)
    gru.reset_parameters(torch.Generator().manual_seed(0))
    gru = gru.to(dev).eval()
    x = torch.randn((batch, steps, feat), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).bfloat16()
    with torch.inference_mode():
        ops = gru.inference_operands()[0]
        old = gru._recorded_layer(x, 0)
        new = gru_layer_btc(F.linear(x, ops[0], ops[1]), ops[2], ops[3])
        print(f"served layer 0, max |new - contract| "
              f"{float((new.float() - old.float()).abs().max()):.3e}",
              flush=True)

        def contract_gru():
            y = x
            for layer in range(2):
                y = gru._recorded_layer(y, layer)
            return y

        for name, fn in (
                ("layer 0, contract entry with its glue",
                 lambda: gru._recorded_layer(x, 0)),
                ("layer 0, GEMM-layout entry with its GEMM",
                 lambda: gru_layer_btc(F.linear(x, ops[0], ops[1]), ops[2],
                                       ops[3])),
                ("both layers, contract entry with its glue", contract_gru),
                ("both layers, GEMM-layout entry (TorchGRU, operands kept)",
                 lambda: gru(x))):
            print(f"served GRU, B={batch}, {name}: {blocks_ms(fn, 10)} ms",
                  flush=True)
    lib = _build.load()
    rows = picked_plan(batch, hidden, torch.bfloat16, dev).rows
    g = torch.Generator(device=dev).manual_seed(batch)
    gx = torch.randn((2, steps, batch, 3 * hidden), device=dev,
                     generator=g).bfloat16()
    w = (0.05 * torch.randn((2, hidden, 3 * hidden), device=dev,
                            generator=g)).bfloat16()
    bn = 0.1 * torch.randn((2, 1, hidden), device=dev, generator=g)
    ys = torch.empty((2, steps, batch, hidden), device=dev,
                     dtype=torch.bfloat16)
    gx6 = torch.cat([gx[0], gx[1].flip(0)], -1).transpose(0, 1).contiguous()
    ys6 = torch.empty((batch, steps, 2 * hidden), device=dev,
                      dtype=torch.bfloat16)
    for name, a, b, strides in (
            ("(2, T, B, 3H) -> (2, T, B, H)", gx, ys, k2_strides(gx, ys)),
            ("(B, T, 6H) -> (B, T, 2H)", gx6, ys6,
             k2_strides(btc_view(gx6), btc_view(ys6), True))):
        print(f"K2 alone, B={batch}, {rows}-row tiles, {name}: " + blocks_ms(
            lambda: checked("K2", lib.sir_gru_layer_mma(
                a.data_ptr(), w.data_ptr(), bn.data_ptr(), b.data_ptr(),
                steps, batch, hidden, rows, *strides, stream)), 10) + " ms",
            flush=True)
    assert torch.equal(ys6, torch.cat([ys[0], ys[1].flip(0)], -1)
                       .transpose(0, 1))


def main(argv=None) -> int:
    layouts_only = "--layouts" in (sys.argv[1:] if argv is None else argv)
    dev = require_cuda()
    print(gpu_label(), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = torch.bfloat16
    steps, hidden = 25, 256

    def checked(name, rc):
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    time_layouts(dev, stream, checked)
    if layouts_only:
        return 0
    with tempfile.TemporaryDirectory() as root:
        libs = build_all(root)
        for name, (_, used) in libs.items():
            for line in used:
                print(f"ptxas, {name}: {line}", flush=True)
        for batch in (256, 2048, 1024):
            g = torch.Generator(device=dev).manual_seed(batch)
            gx = torch.randn((2, steps, batch, 3 * hidden), device=dev,
                             generator=g).to(bf16)
            w = (0.05 * torch.randn((2, hidden, 3 * hidden), device=dev,
                                    generator=g)).to(bf16)
            wt = w.transpose(1, 2).contiguous()
            bn = 0.1 * torch.randn((2, 1, hidden), device=dev, generator=g)
            ys = torch.empty((2, steps, batch, hidden), device=dev, dtype=bf16)
            dys = torch.randn((2, steps, batch, hidden), device=dev,
                              generator=g).to(bf16)
            dgx = torch.empty_like(gx)
            dgh = torch.empty(gx.shape, device=dev)
            strides = k2_strides(gx, ys)
            checked("K2", libs["K2 as committed"][0].sir_gru_layer_mma(
                gx.data_ptr(), w.data_ptr(), bn.data_ptr(), ys.data_ptr(),
                steps, batch, hidden, 32, *strides, stream))
            for name, (lib, _) in libs.items():
                if name.startswith("fp32 "):
                    continue
                forward = name.startswith("K2 ")
                if forward and batch != 1024:
                    for rows in MMA_ROWS:
                        print(f"{name}, B={batch}, {rows}-row tiles: " + blocks_ms(
                            lambda: checked(name, lib.sir_gru_layer_mma(
                                gx.data_ptr(), w.data_ptr(), bn.data_ptr(),
                                ys.data_ptr(), steps, batch, hidden, rows,
                                *strides, stream)), 10) + " ms", flush=True)
                elif not forward and batch != 2048:
                    for rows in MMA_ROWS_BACKWARD:
                        print(f"{name}, B={batch}, {rows}-row tiles: " + blocks_ms(
                            lambda: checked(name, lib.sir_gru_layer_bwd_mma(
                                gx.data_ptr(), w.data_ptr(), bn.data_ptr(),
                                ys.data_ptr(), dys.data_ptr(), dgx.data_ptr(),
                                dgh.data_ptr(), steps, batch, hidden, rows,
                                stream)), 10) + " ms", flush=True)
            for rows in TILE_ROWS:
                if batch != 1024:
                    lib = libs["K2 as committed"][0]
                    print(f"K2 CUDA-core kernel, B={batch}, {rows}-row tiles: "
                          + blocks_ms(lambda: checked(
                              "K2", lib.sir_gru_layer_bf16(
                                  gx.data_ptr(), w.data_ptr(), bn.data_ptr(),
                                  ys.data_ptr(), steps, batch, hidden, rows,
                                  *strides, stream)), 10) + " ms", flush=True)
                if batch != 2048:
                    lib = libs["K2T as committed"][0]
                    print(f"K2T CUDA-core kernel, B={batch}, {rows}-row tiles: "
                          + blocks_ms(lambda: checked(
                              "K2T", lib.sir_gru_layer_bwd_bf16(
                                  gx.data_ptr(), w.data_ptr(), wt.data_ptr(),
                                  bn.data_ptr(), ys.data_ptr(), dys.data_ptr(),
                                  dgx.data_ptr(), dgh.data_ptr(), steps, batch,
                                  hidden, rows, stream)), 10) + " ms",
                          flush=True)
        for batch in (1, 16, 256, 2048):
            g = torch.Generator(device=dev).manual_seed(batch)
            gx = torch.randn((2, steps, batch, 3 * hidden), device=dev,
                             generator=g)
            w = 0.05 * torch.randn((2, hidden, 3 * hidden), device=dev,
                                   generator=g)
            bn = 0.1 * torch.randn((2, 1, hidden), device=dev, generator=g)
            ys = torch.empty((2, steps, batch, hidden), device=dev)
            strides = k2_strides(gx, ys)
            iters = 50 if batch <= 16 else 20 if batch <= 256 else 5
            fp32 = [("fp32 K2 as committed", libs["K2 as committed"][0])] + [
                (name, lib) for name, (lib, _) in libs.items()
                if name.startswith("fp32 K2 ")]
            for name, lib in fp32:
                for rows in f32_heights(name):
                    if batch >= 256 and rows < 4:
                        continue   # a hundred waves and more
                    print(f"{name}, B={batch}, {rows}-row tiles: " + blocks_ms(
                        lambda: checked(name, lib.sir_gru_layer_cluster(
                            gx.data_ptr(), w.data_ptr(), bn.data_ptr(),
                            ys.data_ptr(), steps, batch, hidden, rows,
                            *strides, stream)), iters) + " ms", flush=True)
            lib = libs["K2 as committed"][0]
            for rows in TILE_ROWS:
                print(f"fp32 K2 CUDA-core kernel, B={batch}, {rows}-row tiles: "
                      + blocks_ms(lambda: checked("K2", lib.sir_gru_layer_f32(
                          gx.data_ptr(), w.data_ptr(), bn.data_ptr(),
                          ys.data_ptr(), steps, batch, hidden, rows,
                          *strides, stream)), iters) + " ms", flush=True)
        time_fp32_backward(libs, dev, stream, steps, hidden, checked)
    return 0


def time_fp32_backward(libs, dev, stream, steps, hidden, checked) -> None:
    """The fp32 K2T: as committed at every height and B = 16 / 64 / 256 /
    1024, its variants at B = 16 and 1024, the CUDA-core kernel beside."""
    variants = [("fp32 K2T as committed", libs["K2T as committed"][0])] + [
        (name, lib) for name, (lib, _) in libs.items()
        if name.startswith("fp32 K2T ")]
    for batch in (16, 64, 256, 1024):
        g = torch.Generator(device=dev).manual_seed(batch)
        gx = torch.randn((2, steps, batch, 3 * hidden), device=dev,
                         generator=g)
        w = 0.05 * torch.randn((2, hidden, 3 * hidden), device=dev,
                               generator=g)
        wt = w.transpose(1, 2).contiguous()
        bn = 0.1 * torch.randn((2, 1, hidden), device=dev, generator=g)
        ys = torch.randn((2, steps, batch, hidden), device=dev, generator=g)
        dys = torch.randn((2, steps, batch, hidden), device=dev, generator=g)
        dgx, dgh = torch.empty_like(gx), torch.empty_like(gx)
        iters = 20 if batch <= 64 else 10 if batch <= 256 else 5
        for name, lib in (variants if batch in (16, 1024) else variants[:1]):
            for rows in CLUSTER_ROWS_BACKWARD:
                print(f"{name}, B={batch}, {rows}-row tiles: " + blocks_ms(
                    lambda: checked(name, lib.sir_gru_layer_bwd_cluster(
                        gx.data_ptr(), w.data_ptr(), bn.data_ptr(),
                        ys.data_ptr(), dys.data_ptr(), dgx.data_ptr(),
                        dgh.data_ptr(), steps, batch, hidden, rows,
                        stream)), iters) + " ms", flush=True)
        lib = variants[0][1]
        for rows in TILE_ROWS:
            print(f"fp32 K2T CUDA-core kernel, B={batch}, {rows}-row tiles: "
                  + blocks_ms(lambda: checked("K2T", lib.sir_gru_layer_bwd_f32(
                      gx.data_ptr(), w.data_ptr(), wt.data_ptr(),
                      bn.data_ptr(), ys.data_ptr(), dys.data_ptr(),
                      dgx.data_ptr(), dgh.data_ptr(), steps, batch, hidden,
                      rows, stream)), iters) + " ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
