"""Device diagnostics on the card.

Counterpart of ``speech_intent_recognizer_tpu/utils/diagnostics.py`` (the
reference's GPU scratch checks ``scripts/utils/{testing_cuda,
minimal_gpu_test,looking_for_gpu}.py``): device discovery, a matmul smoke
test, a sustained-matmul probe of the card's rate, a seeded optimizer
walkthrough and the host audio-decode benchmark.  The matmuls are a probe
of the card, not a port of a kernel: ``torch.matmul`` (cuBLAS) is what they
measure.  Run as a module::

    python -m speech_intent_recognizer_tpu_torch.utils.diagnostics
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from speech_intent_recognizer_tpu_torch.utils.profiling import (
    device_memory_stats)


def _device(device: "str | torch.device | None") -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def print_device_info() -> None:
    """torch and CUDA versions, each card's name, capability, SMs, memory
    in use, and the name and power limit as nvidia-smi reports them."""
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"devices ({n}):")
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"  cuda:{i} {p.name} (sm_{p.major}{p.minor}, "
              f"{p.multi_processor_count} SMs)")
    if n:
        from speech_intent_recognizer_tpu_torch.utils.device import (
            gpu_label)

        print(f"  nvidia-smi name, power.limit: {gpu_label()}")
    for name, stats in device_memory_stats().items():
        gb = stats["bytes_in_use"] / 2**30
        lim = stats["bytes_limit"] / 2**30
        print(f"  {name}: {gb:.2f} / {lim:.2f} GiB in use")


def device_smoke_test(size: int = 1024, device=None) -> bool:
    """A bf16 ``a @ a`` of ones on the device: every element must be
    ``size`` within 1e-2 (the reference's CUDA smoke test,
    ``train.py:324-332``)."""
    dev = _device(device)
    x = torch.ones((size, size), dtype=torch.bfloat16, device=dev)
    y = x @ x
    expected = float(size)
    got = float(y[0, 0])
    err = float((y.float() - expected).abs().max()) / expected
    ok = err < 1e-2
    print(f"smoke test on {dev}: {size}x{size} matmul -> {got} "
          f"(expect {expected}) {'OK' if ok else 'FAIL'}")
    return ok


def stress_test(seconds: float = 5.0, size: int = 4096,
                device=None) -> Dict[str, float]:
    """Sustained bf16 ``a @ a`` (``size`` square) for about ``seconds``; the
    card's time from CUDA events (host clock elsewhere).  Returns the matmuls, seconds and
    achieved TFLOP/s."""
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((size, size), generator=g, device=dev).to(torch.bfloat16)
    out = a @ a  # warm-up (cuBLAS picks its kernel); then written in place
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            torch.matmul(a, a, out=out)
        n += 50
        if cuda:
            torch.cuda.synchronize(dev)  # keep the queue short
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3
    else:
        dt = time.perf_counter() - t0
    tflops = 2 * size ** 3 * n / dt / 1e12
    print(f"stress: {n} matmuls of {size}^2 in {dt:.2f}s -> "
          f"{tflops:.1f} TFLOP/s")
    return {"matmuls": n, "seconds": dt, "tflops": tflops}


def optimizer_walkthrough(steps: int = 20, seed: int = 42,
                          device=None) -> Dict[str, float]:
    """Seeded, step-numbered optimizer sanity check (the reference's
    ``scripts/utils/debug_optimizer.py`` analog): Adam (lr 0.1) on a tiny
    regression must bring the last loss below 0.1x the first; reruns are
    bit-reproducible."""
    dev = _device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    w_true = torch.randn((16, 4), generator=g)
    x = torch.randn((64, 16), generator=g)
    y = x @ w_true
    w = (torch.randn((16, 4), generator=g) * 0.1).to(dev).requires_grad_()
    x, y = x.to(dev), y.to(dev)
    opt = torch.optim.Adam([w], lr=1e-1)
    losses = []
    for i in range(steps):
        loss = torch.mean(torch.square(x @ w - y))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        print(f"step {i + 1:2d}: loss {losses[-1]:.6f}")
    ok = losses[-1] < losses[0] * 0.1
    print(f"optimizer walkthrough: {'OK' if ok else 'FAIL'} "
          f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    return {"first_loss": losses[0], "last_loss": losses[-1], "ok": ok}


def audio_loading_benchmark(paths, sample_rate: int = 16000
                            ) -> Dict[str, float]:
    """Time host audio decode + resample over real files (the reference's
    ``scripts/utils/test_audio_loading.py`` analog)."""
    from speech_intent_recognizer_tpu_torch.data import native
    from speech_intent_recognizer_tpu_torch.data.audio_io import load_audio

    t0 = time.perf_counter()
    total_seconds = 0.0
    for p in paths:
        x, _ = load_audio(p, target_sample_rate=sample_rate)
        total_seconds += len(x) / sample_rate
    dt = time.perf_counter() - t0
    rtf = total_seconds / dt if dt else 0.0
    print(f"decoded {len(paths)} files ({total_seconds:.1f}s audio) in "
          f"{dt:.2f}s -> {rtf:.0f}x realtime "
          f"(native={'yes' if native.available() else 'no'})")
    return {"files": len(paths), "audio_seconds": total_seconds,
            "wall_seconds": dt, "realtime_factor": rtf}


def main() -> int:
    print_device_info()
    ok = device_smoke_test()
    stress_test()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
