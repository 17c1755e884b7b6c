#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA H100.

Drives the port's main path — ``Predictor.from_checkpoint`` ->
``predict_waveform_batch``, batch inference from waveform to intent
probabilities at the full width of the reference model (3.26 M-param
CNNAudioGRU, seeded random weights) — through the two hand-written CUDA
kernels, and checks everything it measures:

1. build the kernels from ``speech_intent_recognizer_tpu_torch/csrc``;
2. K1 (front-end + conv1) against its plain PyTorch version;
3. K2 (GRU recurrence) against its plain version, bf16 and fp32;
4. end to end: the main path once at B=256 with the launch counters reset
   just before and read just after (K1 must launch once, K2 twice), then
   the parity gates of the reference ``bench.py``: plain front-end vs the
   fp64 golden (< 0.05), fused probabilities vs golden features through the
   plain unfused folded model (< 0.02, equal argmax), and the main run's
   rows vs the same predictor on the CPU (plain versions);
5. the ``test_model`` CLI on a WAV file;
6. timings with CUDA events, each next to the card's name and power limit,
   K2 at every tile height it is built for;
7. with ``--profile`` only: step-time percentiles and the per-kernel
   breakdown of device time (``utils/profiling.py``) at B=256 and 2048.

Every failed check raises.  Needs one card; exits non-zero without CUDA.
The last line of standard output is the JSON device record.

    python3 chip_smoke.py [--profile]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config.schema import AudioConfig
from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
from speech_intent_recognizer_tpu_torch.data.labelmap import save_label_map
from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
    CNNAudioGRU, fold_batchnorm)
from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_frontend, make_frontend_params, padded_samples)
from speech_intent_recognizer_tpu_torch.ops.gru import (
    TILE_ROWS, _gru_layer_plain, gru_layer, tile_rows)
from speech_intent_recognizer_tpu_torch.utils.device import (
    gpu_label, require_cuda)

CHECK_LENGTHS = [8000, 16000, 39999, 40000, 52117, 79999, 80000, 1025, 512, 2]
GATE_LENGTHS = [8000, 16000, 39999, 40000, 52117, 79999, 80000, 1025]
K1_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/frontend_conv1.cu"
K1_REPLACES = "speech_intent_recognizer_tpu/ops/frontend_pallas.py:651"
K2_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/gru_layer.cu"
K2_REPLACES = "speech_intent_recognizer_tpu/ops/gru_pallas.py:55"
MAIN_BATCH = 256
TIMING_BATCHES = (256, 2048)
E2E_BATCH = TIMING_BATCHES[-1]
# K1 and its plain version round the same fp32 values to bf16: outputs more
# than one bf16 step apart come only from summation-order ties
K1_FAR_SHARE = 1e-4
# bench.py's gate on probabilities, and a tighter bar on log-probabilities
# (logits up to a per-row constant): the seeded model's probabilities are
# near uniform, so a probability bar alone barely sees a wrong logit
PROB_GATE = 0.02
LOGP_BAR = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def speech_like(rng, n):
    """bench.py's test signal: a 220 Hz tone plus noise."""
    t = np.arange(n) / 16000.0
    return (0.25 * np.sin(2 * np.pi * 220.0 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def batch(lengths, width, seed):
    buf = np.zeros((len(lengths), width), np.float32)
    for i, n in enumerate(lengths):
        buf[i, :n] = speech_like(np.random.default_rng(seed + i), n)
    return buf, np.asarray(lengths, np.int32)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"ok: {what}")


def check_probs(got: np.ndarray, want: np.ndarray, what: str) -> None:
    err = float(np.abs(got - want).max())
    logp_err = float(np.abs(np.log(np.maximum(got, 1e-30))
                            - np.log(np.maximum(want, 1e-30))).max())
    argmax_ok = bool((got.argmax(-1) == want.argmax(-1)).all())
    check(err < PROB_GATE and argmax_ok and logp_err <= LOGP_BAR,
          f"{what}: prob err {err:.3e} < {PROB_GATE}, argmax equal, "
          f"log-prob err {logp_err:.3e} <= {LOGP_BAR}")


def k2_inputs(b: int, dtype, dev, seed: int):
    r = np.random.default_rng(seed)
    gx = torch.from_numpy(r.standard_normal((2, 25, b, 768))
                          .astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((r.standard_normal((2, 256, 768)) * 0.05)
                         .astype(np.float32)).to(dev, dtype)
    bn = torch.from_numpy((r.standard_normal((2, 1, 256)) * 0.1)
                          .astype(np.float32)).to(dev)
    return gx, w, bn


def seeded_checkpoint(directory: str) -> tuple:
    """Full-width reference-layout model from torch.Generator seed 0, with
    non-trivial BatchNorm statistics so folding is exercised."""
    g = torch.Generator().manual_seed(0)
    model = CNNAudioGRU(num_classes=31)
    model.reset_parameters(g)
    with torch.no_grad():
        for i in (1, 2, 3):
            bn = getattr(model, f"bn{i}")
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.uniform_(-0.1, 0.1, generator=g)
            bn.running_mean.uniform_(-0.1, 0.1, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
    model_path = os.path.join(directory, "best_model.pt")
    torch.save(model.state_dict(), model_path)
    label_path = os.path.join(directory, "label_map.json")
    save_label_map({f"intent_{i:02d}": i for i in range(31)}, label_path)
    return model_path, label_path, model.state_dict()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print step-time percentiles and the "
                         "per-kernel device-time breakdown")
    args = ap.parse_args(argv)
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = gpu_label()
    log(f"device: {torch.cuda.get_device_name(dev)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | {label}")
    cfg = AudioConfig()
    width = padded_samples(cfg.max_samples, cfg.hop_length)
    fe = make_frontend_params(cfg, dev)

    # ---- 1. build ----
    t0 = time.perf_counter()
    _build.build(ptxas_verbose=True)
    _build.load()
    log(f"built {_build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 2. K1 vs plain (check lengths, then the main path's B=256) ----
    rng = np.random.default_rng(0)
    main_lengths = CHECK_LENGTHS + list(
        rng.integers(1, cfg.max_samples + 1, MAIN_BATCH - len(CHECK_LENGTHS)))
    main_buf, main_ln = batch(main_lengths, width, seed=100)
    c1w = torch.from_numpy((rng.standard_normal((32, 1, 3, 3)) / 3.0)
                           .astype(np.float32)).to(dev)
    c1b = torch.from_numpy((0.1 * rng.standard_normal(32))
                           .astype(np.float32)).to(dev)
    k1_err = 0.0
    for name, (buf, ln) in (("check lengths", batch(CHECK_LENGTHS, width, 1)),
                            (f"B={MAIN_BATCH}", (main_buf, main_ln))):
        wf = torch.from_numpy(buf).to(dev)
        lt = torch.from_numpy(ln).to(dev)
        got = fk.frontend_conv1(wf, lt, fe, c1w, c1b).float()
        want = fk._frontend_conv1_plain(wf, lt, fe, c1w, c1b).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        frac = float(((got - want).abs() > 2.0 ** -7 * want.abs()
                      .clamp(min=1.0)).float().mean())
        check(bool(torch.isfinite(got).all()) and err <= 0.05 * scale
              and frac < K1_FAR_SHARE,
              f"K1 vs plain, {name}: max |err| {err:.3e} <= 0.05 * scale "
              f"{scale:.3f}; share beyond one bf16 step {frac:.2e} < "
              f"{K1_FAR_SHARE}")
        k1_err = max(k1_err, err)

    # ---- 3. K2 vs plain: the heights the card picks (rows=None) at the
    # main path's batch and the timed one, then every built height on a
    # full and a ragged last tile ----
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k2_cases = [(b, dtype, None) for b in (64, MAIN_BATCH, 2048)
                for dtype in (torch.float32, torch.bfloat16)]
    k2_cases += [(b, dtype, rows) for rows in TILE_ROWS for b in (1030, 2048)
                 for dtype in (torch.float32, torch.bfloat16)]
    k2_err = 0.0
    for b, dtype, rows in k2_cases:
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        gx, w, bn = k2_inputs(b, dtype, dev, seed=b)
        got = gru_layer(gx, w, bn, rows=rows).float()
        want = _gru_layer_plain(gx, w, bn).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        picked = tile_rows(b, sms) if rows is None else rows
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"K2 vs plain, B={b} {dtype} {picked}-row tiles"
              f"{' (picked)' if rows is None else ''}: max |err| "
              f"{err:.3e} <= {tol}")
        if dtype == torch.bfloat16 and b == MAIN_BATCH and rows is None:
            k2_err = err

    # ---- 4. end to end ----
    with tempfile.TemporaryDirectory() as tmp:
        model_path, label_path, state = seeded_checkpoint(tmp)
        pred = Predictor.from_checkpoint(model_path, label_path, device=dev)
        check(pred._conv1 is not None, "fused conv1 path enabled")
        wf_main = torch.from_numpy(main_buf).to(dev)
        torch.cuda.synchronize()
        fk.frontend_conv1.launches = 0
        gru_layer.launches = 0
        probs = pred.predict_waveform_batch(wf_main, main_ln)
        k1_launches = fk.frontend_conv1.launches
        k2_launches = gru_layer.launches
        check(k1_launches == 1 and k2_launches == 2,
              f"main path launched K1 {k1_launches}x (want 1), K2 "
              f"{k2_launches}x (want 2)")
        check(probs.shape == (MAIN_BATCH, 31)
              and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1).max()) < 1e-4,
              f"B={MAIN_BATCH} probabilities finite, (B, 31), rows sum to 1")

        cpu_pred = Predictor.from_checkpoint(model_path, label_path,
                                             device="cpu")
        check_probs(probs[:16], cpu_pred.predict_waveform_batch(
            main_buf[:16], main_ln[:16]),
            "main run vs the CPU predictor (plain versions), 16 rows")

        gate_buf, gate_ln = batch(GATE_LENGTHS, width, seed=1)
        feats = log_mel_frontend(torch.from_numpy(gate_buf).to(dev),
                                 torch.from_numpy(gate_ln).to(dev),
                                 fe).cpu().numpy()
        golden_feats = np.stack([
            golden.pad_or_trim_np(golden.log_mel_spectrogram_np(
                gate_buf[i, :n]), cfg.mel_spec_length).astype(np.float32)
            for i, n in enumerate(GATE_LENGTHS)])
        feat_err = float(np.abs(feats - golden_feats).max())
        check(feat_err < 0.05,
              f"plain front-end vs golden: feature err {feat_err:.3e} < 0.05")
        gate_probs = pred.predict_waveform_batch(gate_buf, gate_ln)
        ref_model = CNNAudioGRU(num_classes=31, fold_bn=True)
        ref_model.load_state_dict(fold_batchnorm(state))
        with torch.no_grad():
            want_probs = torch.softmax(ref_model.eval()(
                torch.from_numpy(golden_feats)), -1).numpy()
        check_probs(gate_probs, want_probs, "fused path vs golden features "
                    "-> unfused folded model")

        # ---- 5. CLI ----
        from speech_intent_recognizer_tpu_torch.cli.test_model import (
            main as cli_main)

        wav = os.path.join(tmp, "utterance.wav")
        save_wav(wav, speech_like(np.random.default_rng(9), 24000), 16000)
        result = cli_main(["--model", model_path, "--label_map", label_path,
                           "--audio", wav, "--device", str(dev)])
        check(result is not None and result["predicted_label"]
              in pred.label_map, f"CLI predicted {result['predicted_label']}")

        # ---- 6. timing (CUDA events; card and power limit beside) ----
        # the timed batch is checked first: 32 rows sampled across its tiles
        e2e_buf, e2e_ln = batch(list(rng.integers(
            1, cfg.max_samples + 1, E2E_BATCH)), width, seed=2000)
        e2e_wf = torch.from_numpy(e2e_buf).to(dev)
        e2e_probs = pred.predict_waveform_batch(e2e_wf, e2e_ln)
        sample = np.sort(rng.choice(E2E_BATCH, 32, replace=False))
        check(e2e_probs.shape == (E2E_BATCH, 31)
              and bool(np.isfinite(e2e_probs).all()),
              f"B={E2E_BATCH} probabilities finite, (B, 31)")
        check_probs(e2e_probs[sample], cpu_pred.predict_waveform_batch(
            e2e_buf[sample], e2e_ln[sample]),
            f"timed B={E2E_BATCH} run vs the CPU predictor, 32 sampled rows")

        timings = {}
        for b in TIMING_BATCHES:
            buf, ln = batch(list(rng.integers(1, cfg.max_samples + 1, b)),
                            width, seed=1000)
            wf = torch.from_numpy(buf).to(dev)
            lt = torch.from_numpy(ln).to(dev)
            iters = 20 if b <= 256 else 5
            timings[f"k1_b{b}"] = cuda_ms(
                lambda: fk.frontend_conv1(wf, lt, fe, c1w, c1b), iters)
            timings[f"k1_plain_b{b}"] = cuda_ms(
                lambda: fk._frontend_conv1_plain(wf, lt, fe, c1w, c1b), iters)
            del wf, buf
            gx, w, bn = k2_inputs(b, torch.bfloat16, dev, seed=b)
            timings[f"k2_b{b}"] = cuda_ms(lambda: gru_layer(gx, w, bn), 20)
            log(f"K2 at B={b} picks {tile_rows(b, sms)}-row tiles ({sms} SMs)")
            for rows in TILE_ROWS:
                timings[f"k2_b{b}_rows{rows}"] = cuda_ms(
                    lambda: gru_layer(gx, w, bn, rows=rows), 20)
            timings[f"k2_plain_b{b}"] = cuda_ms(
                lambda: _gru_layer_plain(gx, w, bn), 5)
            cudnn = torch.nn.GRU(1024, 256, num_layers=1, batch_first=True,
                                 bidirectional=True, device=dev,
                                 dtype=torch.bfloat16)
            x = torch.randn((b, 25, 1024), device=dev, dtype=torch.bfloat16)
            with torch.inference_mode():
                timings[f"cudnn_gru_layer_b{b}"] = cuda_ms(
                    lambda: cudnn(x), 20)

        iters = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            pred.predict_waveform_batch(e2e_wf, e2e_ln)
        e2e_dev = E2E_BATCH * iters / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(3):
            pred.predict_waveform_batch(e2e_buf, e2e_ln)
        e2e_host = E2E_BATCH * 3 / (time.perf_counter() - t0)

        # ---- 7. profile (--profile only) ----
        if args.profile:
            from speech_intent_recognizer_tpu_torch.utils.profiling import (
                kernel_breakdown, step_times)

            for b in TIMING_BATCHES:
                wf = e2e_wf[:b].contiguous()
                ln = e2e_ln[:b]
                step = lambda: pred.predict_waveform_batch(wf, ln)  # noqa: E731
                q = step_times(step, steps=30)
                wall, kernels = kernel_breakdown(step, steps=5)
                busy = sum(k[1] for k in kernels)
                log(f"profile B={b} on {label}: step ms median {q['median']:.3f}"
                    f" (p25 {q['p25']:.3f} / p75 {q['p75']:.3f} / p90 "
                    f"{q['p90']:.3f}), 30 steps; {b / q['median'] * 1e3:.0f} "
                    f"utt/s at the median; kernel time {busy:.3f} ms, idle "
                    f"share {1 - busy / q['median']:.3f} (profiled step "
                    f"{wall:.3f} ms)")
                for name, ms, count in kernels:
                    log(f"  {ms:8.4f} ms  x{count:<3d} {name[:110]}")

    log(f"timing on {label} (CUDA events, ms per call):")
    for k, v in timings.items():
        log(f"  {k}: {v:.4f}")
    log(f"  e2e predict_waveform_batch B={E2E_BATCH}, device-resident input: "
        f"{e2e_dev:.1f} utt/s; from a host NumPy buffer: {e2e_host:.1f} "
        f"utt/s")
    print(json.dumps({"kernels": [
        {"name": "frontend_conv1", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": k1_launches,
         "max_abs_err": k1_err, "ms": timings[f"k1_b{MAIN_BATCH}"],
         "plain_ms": timings[f"k1_plain_b{MAIN_BATCH}"]},
        {"name": "gru_layer", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": k2_launches,
         "max_abs_err": k2_err, "ms": timings[f"k2_b{MAIN_BATCH}"],
         "plain_ms": timings[f"k2_plain_b{MAIN_BATCH}"]},
    ]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
