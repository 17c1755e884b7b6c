#!/usr/bin/env python
"""Where the time of the port's front-end kernels goes, and what the
choices compiled into them are worth: builds variants of
``speech_intent_recognizer_tpu_torch/csrc`` and times them side by side on
one NVIDIA GPU, in one process, with CUDA events.

Each variant is a copy of the sources with a few lines replaced (the
replacements are below; a replacement that no longer matches the source
fails), compiled by its own ``nvcc`` with ``-Xptxas -v``, loaded with
ctypes and timed on the same inputs as the unchanged build:

* K4 (``mel_db.cu``) at n_fft 1024, 512 and 2048 on 2,048 x 313 frames'
  worth of bytes: the next frame's prefetch off; registers capped for a
  third or fourth resident block; 128- and 512-thread blocks; at 2048
  points one block of unbounded registers;
* K4 at 1024 points with parts cut out (the results are then wrong; only
  the time is read): the mel sums, then also the untangle, then also FFT
  passes 2 and 3; and with the mel sums of a lane's narrow and wide
  triangle taken together, four predicated terms a step;
* K3 (``frontend.cu``) at B=2048 and 256 with one 512-thread block an SM.

Prints the card's name and power limit, each variant's registers and
spills as ptxas reports them, and least / median / most of five timed
blocks in ms.  Needs one card and nvcc; imports nothing of JAX.

    python3 bench_torch_fft_variants.py
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    make_frontend_params, padded_samples)
from speech_intent_recognizer_tpu_torch.utils.device import (
    gpu_label, require_cuda)

CSRC = os.path.join(os.path.dirname(os.path.abspath(_build.__file__)), "csrc")

THREADS = ("mel_db.cu", "constexpr int kThreads = 256;",
           "constexpr int kThreads = {};")
NO_PREFETCH = ("mel_db.cu", "constexpr bool kPrefetch = LOG2N <= 10;",
               "constexpr bool kPrefetch = false;")
MIN_BLOCKS = ("mel_db.cu", "constexpr int kMinBlocks = LOG2N == 11 ? 2 : 1;",
              "constexpr int kMinBlocks = {};")
K3_ONE_BLOCK = [("frontend_core.cuh", "constexpr int kThreads = 256;",
                 "constexpr int kThreads = 512;"),
                ("frontend_core.cuh", "constexpr int kBlocksPerSm = 2;",
                 "constexpr int kBlocksPerSm = 1;")]
NO_MEL = ("warp_rfft.cuh",
          "    for (int o = o0; o < o1; ++o) acc = fmaf(fb[o], p[o], acc);",
          "    acc = fb[o0] * p[o0] + (o1 - o0);")
NO_UNTANGLE = ("warp_rfft.cuh", re.compile(
    r"#pragma unroll\n  for \(int r = 0; r < P::kV; \+\+r\) \{\n"
    r"    const float2 mine.*?pw\[lane \+ 32 \* r\] = xr \* xr \+ xi \* xi;"
    r"\n  \}\n", re.S),
    "#pragma unroll\n  for (int r = 0; r < P::kV; ++r)\n"
    "    pw[lane + 32 * r] = v[r].x * v[r].x + v[r].y * v[r].y;\n")
NO_PASS23 = ("warp_rfft.cuh", re.compile(
    r"  // pass 2: radix 8 over n2.*?(?=  __syncwarp\(\);  // the buffer is "
    r"free)", re.S), "")
PAIRED_MEL = ("warp_rfft.cuh", re.compile(
    r"  for \(int m = lane; m < n_mels; m \+= 32\) \{\n.*?\n  \}\n\}", re.S),
    """  for (int j = 0; j < (n_mels + 31) >> 5; j += 2) {
    const int ma = 32 * j + lane, mb = 32 * j + 63 - lane;
    const bool has_a = ma < n_mels, has_b = mb < n_mels;
    int oa = 0, ea = 0, ob = 0, eb = 0;
    const float *pa = pw, *pb = pw;
    if (has_a) { oa = fb_off[ma]; ea = fb_off[ma + 1]; pa = pw + fb_lo[ma] - oa; }
    if (has_b) { ob = fb_off[mb]; eb = fb_off[mb + 1]; pb = pw + fb_lo[mb] - ob; }
    float acc_a = 0.f, acc_b = 0.f;
    while (oa < ea || ob < eb) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (oa + u < ea) acc_a = fmaf(fb[oa + u], pa[oa + u], acc_a);
        if (ob + u < eb) acc_b = fmaf(fb[ob + u], pb[ob + u], acc_b);
      }
      oa += 4;
      ob += 4;
    }
    if (has_a) store(ma, 10.f * log10f(fmaxf(acc_a, 1e-10f)));
    if (has_b) store(mb, 10.f * log10f(fmaxf(acc_b, 1e-10f)));
  }
}""")


def fmt(edit, value):
    return (edit[0], edit[1], edit[2].format(value))


# name -> (the .cu to build, edits)
VARIANTS = {
    "K4 as committed": ("mel_db.cu", []),
    "K4 no prefetch": ("mel_db.cu", [NO_PREFETCH]),
    "K4 3 blocks an SM (<= 85 registers)": ("mel_db.cu", [fmt(MIN_BLOCKS, 3)]),
    "K4 no prefetch, 3 blocks an SM": ("mel_db.cu",
                                       [NO_PREFETCH, fmt(MIN_BLOCKS, 3)]),
    "K4 no prefetch, 4 blocks an SM (<= 64 registers)": (
        "mel_db.cu", [NO_PREFETCH, fmt(MIN_BLOCKS, 4)]),
    "K4 128-thread blocks": ("mel_db.cu", [fmt(THREADS, 128)]),
    "K4 512-thread blocks": ("mel_db.cu", [fmt(THREADS, 512),
                                           fmt(MIN_BLOCKS, 1)]),
    "K4 registers unbounded at 2048 points": ("mel_db.cu",
                                              [fmt(MIN_BLOCKS, 1)]),
    "K4 without the mel sums": ("mel_db.cu", [NO_MEL]),
    "K4 without the mel sums and the untangle": ("mel_db.cu",
                                                 [NO_MEL, NO_UNTANGLE]),
    "K4 without the mel sums, the untangle and passes 2-3": (
        "mel_db.cu", [NO_MEL, NO_UNTANGLE, NO_PASS23]),
    "K4 mel sums of a lane's pair together, 4 predicated terms a step": (
        "mel_db.cu", [PAIRED_MEL]),
    "K3 as committed": ("frontend.cu", []),
    "K3 one 512-thread block an SM": ("frontend.cu", K3_ONE_BLOCK),
}


def replace_once(edits, src: str, name: str) -> None:
    """Apply (file, old, new) replacements to the copy of the sources in
    ``src``; each must match exactly once."""
    for fname, old, new in edits:
        path = os.path.join(src, fname)
        with open(path) as f:
            text = f.read()
        if isinstance(old, str):
            found = text.count(old)
            text = text.replace(old, new)
        else:
            text, found = old.subn(lambda _m: new, text)
        if found != 1:
            what = old if isinstance(old, str) else old.pattern
            raise RuntimeError(f"{name}: {what!r} matches {found} times in "
                               f"{fname}, not once")
        with open(path, "w") as f:
            f.write(text)


def apply_edits(name: str, src: str) -> None:
    """Apply the variant's replacements to the copy of the sources in
    ``src``."""
    replace_once(VARIANTS[name][1], src, name)


def build_all(root: str) -> dict:
    """Copy, edit and compile every variant (all nvcc at once); returns
    name -> (ctypes library, ptxas lines of the timed kernels)."""
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
                    r"Function properties for \S*?(mel_db_warp_kernelILi\d+E|"
                    r"frontend_kernelIfE)", line))]
        lib = ctypes.CDLL(so)
        for entry, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, used)
    return libs


def blocks_ms(fn, iters: int) -> str:
    for _ in range(5):
        fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    return f"{times[0]:.4f} / {times[2]:.4f} / {times[4]:.4f}"


def main() -> int:
    dev = require_cuda()
    print(gpu_label(), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as root:
        libs = build_all(root)
        for name, (_, used) in libs.items():
            for line in used:
                print(f"ptxas, {name}: {line}", flush=True)
        for batch in (2048, 256):
            for n_fft in (1024, 512, 2048):
                fe = make_frontend_params(AudioConfig(
                    n_fft=n_fft, hop_length=n_fft // 4), dev)
                n = batch * 313 * 1024 // n_fft
                frames = torch.randn((n, n_fft), device=dev)
                out = torch.empty((n, fe.n_mels), device=dev)
                for name, (lib, _) in libs.items():
                    cut = "without" in name or "pair" in name
                    if not name.startswith("K4") or (cut and (
                            n_fft, batch) != (1024, 2048)):
                        continue

                    def run():
                        rc = lib.sir_mel_db(
                            frames.data_ptr(), n, n_fft, fe.n_mels,
                            fe.window.data_ptr(), fe.twiddle.data_ptr(),
                            fe.fb_packed.data_ptr(), fe.fb_off.data_ptr(),
                            fe.fb_lo.data_ptr(), fe.fb_packed.numel(),
                            out.data_ptr(), stream)
                        if rc:
                            raise RuntimeError(f"{name}: CUDA error {rc}")

                    print(f"{name}, n_fft={n_fft}, N={n}: "
                          f"{blocks_ms(run, 5)} ms", flush=True)
                del frames, out
        fe = make_frontend_params(device=dev)
        width = padded_samples(80000)
        rng = np.random.default_rng(0)
        for batch in (2048, 256):
            lengths = rng.integers(1, 80001, batch)
            wav = 0.1 * torch.randn((batch, width), device=dev)
            wav *= (torch.arange(width, device=dev)[None, :]
                    < torch.as_tensor(lengths, device=dev)[:, None])
            ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
            out = torch.empty((batch, 64, 200), device=dev)
            for name, (lib, _) in libs.items():
                if not name.startswith("K3"):
                    continue

                def run():
                    rc = lib.sir_frontend_f32(
                        wav.data_ptr(), ln.data_ptr(), batch, width,
                        fe.window.data_ptr(), fe.twiddle.data_ptr(),
                        fe.fb_packed.data_ptr(), fe.fb_off.data_ptr(),
                        fe.fb_lo.data_ptr(), fe.fb_packed.numel(),
                        out.data_ptr(), 1, float(fe.norm_eps), stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                print(f"{name}, B={batch}: {blocks_ms(run, 10)} ms",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
