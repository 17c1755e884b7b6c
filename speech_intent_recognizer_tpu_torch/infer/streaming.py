"""Streaming batch-1 inference: chunked incremental log-mel + classifier.

Counterpart of ``speech_intent_recognizer_tpu/infer/streaming.py``.  The
reference's live demo records a whole utterance, then runs the full
feature + forward pipeline on it (``scripts/testing.py:104-130``), paying
the whole feature cost at end-of-speech.  Here the front-end is
incremental: as audio chunks arrive, every newly complete STFT frame goes
through the same window -> DFT -> mel -> dB math as the offline front-end.
At end-of-utterance only the tail frames, the per-utterance normalization
and the 25-step classifier remain: the end-of-speech latency.

On the predictor's device the finalize is one pass over device tensors
(:func:`fused_finalize`): the tail frames through the dB-mel kernel K4
(``ops/frontend_kernels.mel_db``), the rows scattered into the mel buffer,
the masked normalization, and the predictor's fp32 model, whose GRU runs
the recurrence kernel K2 once per layer.  :class:`BatchFinalizer` runs the
same pass once for every utterance that ended in one server tick.  Results
come back through :class:`PendingResult`: a non-blocking copy into pinned
host memory and a CUDA event that says when it has landed.

``partial_result()`` classifies the frames seen so far (normalized with
the host statistics), giving early hypotheses mid-utterance.

A recognizer runs its finalize and classifier through two modules,
:class:`StreamFinalize` and :class:`StreamClassify`, which it asks the
predictor for (``_stream_calls``) and builds over the predictor's model
when the predictor has none: an exported streaming artifact
(``infer/export.StreamingArtifactPredictor``) brings its own, the two
modules traced by ``infer/export.export_streaming``.
"""

from __future__ import annotations

import itertools
import logging
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.evaluation.metrics import (
    top_k_predictions)
from speech_intent_recognizer_tpu_torch.infer.vad import EnergyVAD
from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    FrontendModule, FrontendParams, make_frontend_params)
from speech_intent_recognizer_tpu_torch.utils.profiling import span, stamp

logger = logging.getLogger(__name__)

_BLOCK = 16  # frames per device call of the featurizer's "device" mode


def golden_hann(n_fft: int, audio_cfg: AudioConfig) -> np.ndarray:
    """The (possibly centre-padded) fp64 hann window of the front-end: the
    construction of ``make_frontend_params``, whose ``window`` is this
    array in float32."""
    window = golden.hann_window(audio_cfg.win_length)
    if audio_cfg.win_length < n_fft:
        lpad = (n_fft - audio_cfg.win_length) // 2
        window = np.pad(window,
                        (lpad, n_fft - audio_cfg.win_length - lpad))
    return window


class StreamingFeaturizer:
    """Incremental torchaudio-semantics log-mel over a growing signal.

    ``mode`` selects where the per-chunk frame math runs:

    * ``"host"`` (default): NumPy rFFT of the windowed frames, then the mel
      projection.  A chunk brings about two frames, microseconds of host
      work, and the device sees no traffic until end-of-utterance.
    * ``"device"``: blocks of up to 16 frames through the dB-mel kernel K4
      on the device that ``params`` live on (its plain version on the CPU).
    * ``"native"``: the C++ loop of ``native/sirdsp.cpp`` (window, rFFT,
      mel, dB per frame, state in shared NumPy buffers).  Falls back to
      ``"host"`` when the library is not built.
    * ``"auto"``: ``"native"`` when available, else ``"host"``.

    ``params`` default to the front-end of ``audio_cfg`` on ``device``
    (``"device"`` mode) or on the CPU (the host modes).  All modes produce
    the same features (tested).
    """

    def __init__(self, params: Optional[FrontendParams] = None,
                 audio_cfg: Optional[AudioConfig] = None,
                 mode: str = "host", host_dtype=np.float32,
                 device: "str | torch.device" = "cuda"):
        self.audio_cfg = audio_cfg or AudioConfig()
        if self.audio_cfg.frontend != "torchaudio":
            raise ValueError("streaming supports the unified torchaudio "
                             "front-end")
        if mode not in ("host", "device", "native", "auto"):
            raise ValueError(f"unknown streaming mode {mode!r}")
        self.params = params or make_frontend_params(
            self.audio_cfg, device if mode == "device" else "cpu")
        if mode in ("native", "auto"):
            picked = "native" if self._native_usable() else "host"
            if picked != mode:
                logger.info("streaming featurizer: %s mode asked, %s mode "
                            "runs (libsirdsp %s)", mode, picked,
                            "built" if picked == "native" else
                            "not built or n_fft not a power of two")
            mode = picked
        self.mode = mode
        self.n_fft = self.params.n_fft
        self.hop = self.params.hop_length
        self.pad = self.n_fft // 2
        mel_fb = self.params.mel_fb.cpu().numpy()
        if mode == "host":
            # rFFT of the windowed frames, not the windowed-DFT matmuls:
            # numerically the same transform, microseconds for two frames.
            # fp32 by default; fp64 (host_dtype=np.float64) for the golden
            # parity tests.
            self._host_dtype = np.dtype(host_dtype)
            self._np_win = golden_hann(self.n_fft, self.audio_cfg).astype(
                self._host_dtype)
            self._np_fb = mel_fb.astype(self._host_dtype)
        # prepared-signal buffer: [left reflect pad | raw signal], written
        # incrementally so feed() never reallocates or copies the history
        self._prep_buf = np.zeros(self.pad + self.audio_cfg.max_samples,
                                  np.float32)
        if self.mode == "native":
            from speech_intent_recognizer_tpu_torch.data.native import (
                NativeStreamer)

            self._native = NativeStreamer(
                self._prep_buf, golden_hann(self.n_fft, self.audio_cfg),
                mel_fb, self.n_fft, self.hop, self.audio_cfg.max_samples)
        self.reset()

    def _native_usable(self) -> bool:
        from speech_intent_recognizer_tpu_torch.data import native

        return native.available() and (self.params.n_fft
                                       & (self.params.n_fft - 1)) == 0

    def _sync_native_state(self) -> None:
        st = self._native.state
        self._n = int(st[0])
        self._left_filled = int(st[1])
        self._frames_done = int(st[2])

    def reset(self) -> None:
        self._n = 0  # raw samples seen so far (capped)
        self._left_filled = 0  # how much of the left reflect pad is final
        self._prep_buf[: self.pad] = 0.0
        self._frames_done = 0  # frames already emitted
        self._mel_frames: list[np.ndarray] = []
        if self.mode == "native":
            self._native.reset()

    # ------------------------------------------------------------- internals

    @property
    def _signal(self) -> np.ndarray:
        """Raw samples seen so far (view into the prepared buffer)."""
        return self._prep_buf[self.pad : self.pad + self._n]

    def _prepared(self) -> np.ndarray:
        """Left-reflect-padded signal (the tail reflect is the finalize's)."""
        self._fill_left_pad()
        n = self._n
        if n < 2:
            return self._prep_buf[self.pad : self.pad + n]
        left = min(self.pad, n - 1)
        return self._prep_buf[self.pad - left : self.pad + n]

    def _fill_left_pad(self) -> None:
        """Mirror sig[1 : pad+1] into the pad region as samples arrive."""
        if self._left_filled >= self.pad:
            return
        avail = min(self.pad, self._n - 1)
        if avail > self._left_filled:
            src = self._prep_buf[self.pad + 1 + self._left_filled :
                                 self.pad + 1 + avail]
            self._prep_buf[self.pad - avail :
                           self.pad - self._left_filled] = src[::-1]
            self._left_filled = avail

    def _emit(self, frames_np: np.ndarray) -> None:
        if frames_np.shape[0] == 0:
            return
        if self.mode == "host":
            f = frames_np.astype(self._host_dtype) * self._np_win
            spec = np.fft.rfft(f, axis=1)
            power = (spec.real * spec.real + spec.imag * spec.imag
                     ).astype(self._host_dtype)
            mel = power @ self._np_fb
            self._mel_frames.append((10.0 * np.log10(
                np.maximum(mel, 1e-10), dtype=np.float32)).astype(np.float32))
        else:  # device: K4 per block of up to _BLOCK contiguous frames
            dev = self.params.window.device
            for b in range(0, frames_np.shape[0], _BLOCK):
                block = torch.from_numpy(np.array(
                    frames_np[b : b + _BLOCK], np.float32)).to(dev)
                self._mel_frames.append(
                    fk.mel_db(block, self.params).cpu().numpy())
        self._frames_done += frames_np.shape[0]

    def _window_frames(self, prepared: np.ndarray, start_frame: int,
                       n_frames: int) -> np.ndarray:
        """Raw (unwindowed) frames as a zero-copy strided view."""
        s0 = start_frame * self.hop
        end = s0 + (n_frames - 1) * self.hop + self.n_fft
        return np.lib.stride_tricks.sliding_window_view(
            prepared[s0:end], self.n_fft)[:: self.hop]

    def _tail_prepared(self, total_frames: int) -> np.ndarray:
        """The prepared signal with the right reflect pad (``x[clip(n - 2 -
        k, 0)]`` for k < pad), zero-extended to ``total_frames`` frames."""
        n = self._n
        sig = self._signal
        tail_idx = np.clip(n - 2 - np.arange(self.pad), 0, n - 1)
        prepared = np.concatenate([self._prepared(), sig[tail_idx]])
        need = (total_frames - 1) * self.hop + self.n_fft
        if len(prepared) < need:
            prepared = np.pad(prepared, (0, need - len(prepared)))
        return prepared

    # ------------------------------------------------------------------ API

    def feed(self, chunk: np.ndarray) -> int:
        """Append samples; compute all newly complete frames.

        A frame t needs ``t*hop + n_fft`` prepared samples, i.e.
        ``t*hop + pad`` raw samples (prepared = pad + raw so far).
        Returns the number of frames emitted so far.
        """
        if self.mode == "native":
            done = self._native.feed(chunk)
            self._sync_native_state()
            return done
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        space = self.audio_cfg.max_samples - self._n  # reference 5 s cap
        if space > 0 and chunk.size > 0:
            take = chunk[:space]
            self._prep_buf[self.pad + self._n :
                           self.pad + self._n + take.size] = take
            self._n += take.size
        n = self._n
        self._fill_left_pad()
        # complete frames available without tail padding
        avail = max(0, (n + self.pad - self.n_fft) // self.hop + 1)
        avail = min(avail, 1 + n // self.hop)
        new = avail - self._frames_done
        if new > 0 and n > self.pad:
            # n > pad: the left reflect region is final, so frame t starts
            # at prep_buf[t*hop] exactly
            self._emit(self._window_frames(self._prep_buf,
                                           self._frames_done, new))
        return self._frames_done

    def _stack_mel(self) -> np.ndarray:
        if self.mode == "native":
            return self._native.mel[: self._frames_done]
        if not self._mel_frames:
            return np.zeros((0, self.params.n_mels), np.float32)
        return np.concatenate(self._mel_frames, axis=0)

    def _normalize(self, mel: np.ndarray) -> np.ndarray:
        cnt = mel.size
        if cnt < 2:
            return mel
        mean = mel.sum() / cnt
        var = (np.square(mel.astype(np.float64)).sum() - cnt * mean ** 2)
        var = max(var / (cnt - 1), 0.0)
        return ((mel - mean) / (np.sqrt(var) + self.params.norm_eps)
                ).astype(np.float32)

    def partial_features(self) -> np.ndarray:
        """(n_mels, target_len) normalized features for frames so far."""
        return self._pad_target(self._normalize(self._stack_mel()))

    def _pad_target(self, mel: np.ndarray) -> np.ndarray:
        t_target = self.params.target_length
        out = np.zeros((self.params.n_mels, t_target), np.float32)
        t = min(mel.shape[0], t_target)
        out[:, :t] = mel[:t].T
        return out

    def finalize(self) -> np.ndarray:
        """Complete the utterance: tail reflect pad, remaining frames,
        per-utterance normalization, pad/trim, as the offline front-end."""
        if self.mode == "native":
            total = self._native.finalize()
            self._sync_native_state()
            return self._pad_target(self._normalize(self._native.mel[:total]))
        n = self._n
        total_frames = 1 + n // self.hop
        remaining = total_frames - self._frames_done
        if remaining > 0 and n >= 2:
            self._emit(self._window_frames(self._tail_prepared(total_frames),
                                           self._frames_done, remaining))
        return self._pad_target(self._normalize(self._stack_mel()))


def fused_finalize(model: torch.nn.Module, params: FrontendParams,
                   mel_bufs: np.ndarray, counts: np.ndarray,
                   tails: np.ndarray, n_tails: np.ndarray) -> torch.Tensor:
    """End-of-utterance of N utterances in one pass on ``params``' device.

    Args:
      model: the classifier, on that device.
      mel_bufs: (N, target_length, n_mels) float32 dB rows emitted so far,
        zero past each count.
      counts: (N,) rows of each buffer that hold frames.
      tails: (N, K, n_fft) float32 raw tail frames (K = 4 in the
        recognizer), only the first ``n_tails`` of each row valid.
      n_tails: (N,) valid tail frames.

    Copies the operands to the device and runs :func:`finalize_tensors`.
    Returns (N, C) float32 probabilities on the device.
    """
    dev = params.window.device
    with span("sir.finalize.upload"):
        mel = torch.from_numpy(np.ascontiguousarray(mel_bufs, np.float32)
                               ).to(dev)
        frames = torch.from_numpy(np.ascontiguousarray(tails, np.float32)
                                  ).to(dev)
        lengths = torch.from_numpy(np.stack([np.asarray(counts, np.int64),
                                             np.asarray(n_tails, np.int64)])
                                   ).to(dev)
    with torch.inference_mode():
        return finalize_tensors(model, params, mel, frames, lengths[0],
                                lengths[1])


def finalize_tensors(model: torch.nn.Module, params: FrontendParams,
                     mel: torch.Tensor, frames: torch.Tensor,
                     count: torch.Tensor, n_tail: torch.Tensor
                     ) -> torch.Tensor:
    """The device part of :func:`fused_finalize`, on its operands as
    tensors on ``params``' device (``count`` and ``n_tail`` int64).

    The N * K tail frames go through K4 in one launch; the valid ones are
    added at rows ``count + i`` (those below target_length); then the
    masked per-utterance normalization (mean and ddof=1 variance over
    ``count + n_tail`` rows, ``+ norm_eps`` on the std), the zero pad, and
    the model.  Returns (N, C) float32 probabilities.
    """
    dev = params.window.device
    n, k = frames.shape[:2]
    tmax, n_mels = params.target_length, params.n_mels
    tail_db = fk.mel_db(frames.reshape(n * k, params.n_fft), params)
    steps = torch.arange(k, device=dev)
    rows = count[:, None] + steps[None, :]  # (N, K)
    writable = (steps[None, :] < n_tail[:, None]) & (rows < tmax)
    flat = (torch.arange(n, device=dev)[:, None] * tmax
            + rows.clamp(0, tmax - 1)).view(-1)
    add = torch.where(writable.view(-1, 1), tail_db, 0.0)
    mel = mel.reshape(n * tmax, n_mels).index_add(0, flat, add).view(
        n, tmax, n_mels)
    total = count + n_tail
    rmask = (torch.arange(tmax, device=dev)[None, :]
             < total[:, None])[..., None].float()
    cnt = (total * n_mels).float()
    mean = (mel * rmask).sum(dim=(1, 2)) / cnt.clamp(min=1.0)
    centred = mel - mean[:, None, None]
    var = ((centred.square() * rmask).sum(dim=(1, 2))
           / (cnt - 1.0).clamp(min=1.0))
    feats = centred / (var.sqrt()[:, None, None] + params.norm_eps) * rmask
    logits = model(feats.transpose(1, 2))
    return torch.softmax(logits.float(), dim=-1)


class StreamFinalize(torch.nn.Module):
    """One utterance's end: (target_length, n_mels) float32 rows, the
    int64 count of rows that hold frames, (K, n_fft) float32 raw tail
    frames and the int64 count of valid ones -> (C,) probabilities;
    :func:`finalize_tensors` at N = 1, the classifier ``model`` and the
    front-end ``params`` held as a module."""

    def __init__(self, model: torch.nn.Module, params: FrontendParams):
        super().__init__()
        self.model = model
        self.frontend = FrontendModule(params)

    def forward(self, mel_buf, count, tail, n_tail):
        return finalize_tensors(self.model, self.frontend.params,
                                mel_buf[None], tail[None], count.reshape(1),
                                n_tail.reshape(1))[0]


class StreamClassify(torch.nn.Module):
    """(n_mels, target_length) normalized features -> (C,) probabilities:
    the partial hypothesis's classifier."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, feats):
        return torch.softmax(self.model(feats[None]).float(), dim=-1)[0]


def stream_calls(predictor) -> Dict[str, torch.nn.Module]:
    """``{"fused_finalize": ..., "classify": ...}`` of ``predictor``: its
    own when it has them (an exported artifact), else a
    :class:`StreamFinalize` and a :class:`StreamClassify` over its model,
    built once and kept on it, so that its sessions share them."""
    calls = getattr(predictor, "_stream_calls", None)
    if calls is None:
        calls = predictor._stream_calls = {
            "fused_finalize": StreamFinalize(predictor.model,
                                             predictor.frontend_params),
            "classify": StreamClassify(predictor.model)}
    return calls


_stamps = itertools.count()


class _Fetch:
    """Probabilities on their way to the host: on a CUDA device a
    non-blocking copy into pinned memory and the event recorded after it;
    on the CPU the tensor itself."""

    def __init__(self, probs: torch.Tensor):
        self.stamp = next(_stamps)  # dispatch order
        if probs.device.type == "cuda":
            self.host = torch.empty(probs.shape, dtype=probs.dtype,
                                    pin_memory=True)
            self.host.copy_(probs, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(probs.device))
        else:
            self.host, self.event = probs, None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class PendingResult(Mapping):
    """Asynchronously completing classification result.

    Holds the probabilities while the device is still computing them and
    copying them to the host.  ``ready()`` polls without blocking (the CUDA
    event after the copy); ``resolve()`` waits for it.  In a multi-session
    server this keeps the event loop feeding other sessions' audio while
    one session's end-of-utterance runs on the device.

    Implements :class:`collections.abc.Mapping`, so call sites that treat
    results as plain dicts (``r["confidence"]``, ``r.items()``,
    ``"confidence" in r``, ``dict(r)``, ``r.get(key, default)``) work
    unchanged when ``async_results`` is on.
    """

    # perf_counter_ns() of the dispatch of the device work, while tracing
    dispatched_ns: Optional[int] = None

    def __init__(self, probs: Optional[torch.Tensor], inv_label_map):
        if probs is not None:
            self.dispatched_ns = stamp()
        self._fetch = None if probs is None else _Fetch(probs)
        self._row = None  # set by BatchFinalizer: row of a batched result
        self._inv = inv_label_map
        self._dict: Optional[Dict] = None

    def _ensure_dispatched(self) -> None:
        """Hook for deferred results (see :class:`BatchFinalizer`): start
        the device work.  Base results are dispatched at construction."""

    def ready(self) -> bool:
        if self._dict is not None:
            return True
        return self._fetch is not None and self._fetch.ready()

    def _materialize(self) -> None:
        probs = self._fetch.host.numpy()
        if self._row is not None:
            probs = probs[self._row]
        pred = int(np.argmax(probs))
        self._dict = {
            "predicted_label": self._inv.get(pred, "Unknown"),
            "confidence": float(probs[pred]),
            "top_predictions": top_k_predictions(probs, self._inv, 3),
        }
        self._fetch = None

    def resolve(self) -> Dict:
        """Wait for the device and return the result dict."""
        if self._dict is None:
            self._ensure_dispatched()
            self._fetch.wait()
            self._materialize()
        return self._dict

    def get(self, key=None, default=None):
        """dict.get-compatible; the zero-argument form returns the dict."""
        d = self.resolve()
        return d if key is None else d.get(key, default)

    def __getitem__(self, key):
        return self.resolve()[key]

    def __iter__(self):
        return iter(self.resolve())

    def __len__(self):
        return len(self.resolve())

    @staticmethod
    def get_all(results: list) -> list:
        """Resolve many pending results with one wait.

        Every copy to the host is recorded on the device's stream in
        dispatch order, so waiting for the newest one that has not landed
        waits for all of them; the others are then ready.  Returns the
        resolved dicts."""
        live = list({id(r): r for r in results if r._dict is None}.values())
        for r in live:
            r._ensure_dispatched()
        waiting = [r._fetch for r in live if not r._fetch.ready()]
        if waiting:
            max(waiting, key=lambda f: f.stamp).wait()
        for r in live:
            r._materialize()
        return [r.resolve() for r in results]


class _DeferredFinalize(PendingResult):
    """A finalize result whose device work has not been dispatched yet: it
    sits in a :class:`BatchFinalizer` queue until the next flush."""

    def __init__(self, batcher: "BatchFinalizer", inv_label_map):
        super().__init__(None, inv_label_map)
        self._batcher = batcher

    def _ensure_dispatched(self) -> None:
        if self._fetch is None and self._dict is None:
            self._batcher.flush()


class BatchFinalizer:
    """Cross-session batching of end-of-utterance device work.

    At serving concurrency many sessions reach end-of-speech within one
    event-loop tick, and each batch-1 finalize pays its launches and copies
    whatever its size.  ``submit`` queues the finalize operands and returns
    a deferred :class:`PendingResult` at once; the queue runs as ONE
    :func:`fused_finalize` of exactly the queued rows when ``max_batch``
    requests accumulate, on ``flush()`` (the server calls it every drain
    tick), or when a deferred result is forced.  Each row is the single
    finalize's computation (tested against it).
    """

    def __init__(self, predictor, tail_max: int = 4, max_batch: int = 16):
        self.predictor = predictor
        self.tail_max = tail_max
        self.max_batch = max_batch
        self._queue: list = []

    def submit(self, mel_buf, count, tail, n_tail,
               inv_label_map) -> PendingResult:
        """Queue one finalize; returns a deferred result immediately."""
        if tail.shape[0] != self.tail_max:
            raise ValueError(f"expected {self.tail_max} tail frames, got "
                             f"{tail.shape[0]}")
        r = _DeferredFinalize(self, inv_label_map)
        self._queue.append((r, mel_buf, int(count), tail, int(n_tail)))
        if len(self._queue) >= self.max_batch:
            self.flush()
        return r

    def queued(self) -> int:
        """The finalizes waiting for the next flush."""
        return len(self._queue)

    def flush(self) -> int:
        """Dispatch every queued finalize as one device pass; returns how
        many there were.  Traced as the span ``sir.batcher.flush``, its
        copies to the device and its fetch to the host in spans of their
        own; each result's ``dispatched_ns`` is the flush's start."""
        if not self._queue:
            return 0
        with span("sir.batcher.flush"):
            t = stamp()
            q, self._queue = self._queue, []
            _, mels, counts, tails, n_tails = zip(*q)
            probs = fused_finalize(self.predictor.model,
                                   self.predictor.frontend_params,
                                   np.stack(mels), np.asarray(counts),
                                   np.stack(tails), np.asarray(n_tails))
            with span("sir.finalize.fetch"):
                fetch = _Fetch(probs)
            for i, (r, *_rest) in enumerate(q):
                r._fetch, r._row, r.dispatched_ns = fetch, i, t
        return len(q)


class StreamingRecognizer:
    """VAD-gated streaming intent recognition session.

    Feed audio chunks (float32, model sample rate); features are computed
    incrementally while speech is still being captured; on end-of-speech
    (silence >= ``silence_limit``) only finalize + classify run, on the
    predictor's device.  Sessions share the predictor's model and,
    optionally, one :class:`BatchFinalizer`.

    ``async_results=True`` makes ``feed``/``flush``/``partial_result``
    return a :class:`PendingResult` right after dispatching the device work
    instead of waiting for its value: the serving mode.
    """

    _TAIL_MAX = 4  # frames left at finalize: at most ~2

    def __init__(self, predictor, chunk_size: int = 1024,
                 threshold: float = 0.01, silence_limit: float = 1.0,
                 prior_recording: float = 0.5, async_results: bool = False,
                 featurizer_mode: str = "auto",
                 batch_finalizer: Optional[BatchFinalizer] = None):
        self.async_results = async_results
        self.batch_finalizer = batch_finalizer
        self.predictor = predictor
        self.audio_cfg = predictor.audio_cfg
        self.chunk_size = chunk_size
        self.vad = EnergyVAD(threshold)
        self.silence_limit = silence_limit
        self._prior_max = max(1, int(prior_recording
                                     * self.audio_cfg.sample_rate
                                     / chunk_size))
        self._prior: list[np.ndarray] = []
        self._featurizer = StreamingFeaturizer(
            params=predictor.frontend_params, audio_cfg=predictor.audio_cfg,
            mode=featurizer_mode)
        self._recording = False
        self._silence_chunks = 0

    def finalize_operands(self) -> tuple:
        """The end-of-utterance operands of :func:`fused_finalize` for this
        session, host-side slicing only: ``(mel_buf, count, tail,
        n_tail)``, the (target_length, n_mels) buffer of emitted rows, how
        many it holds, the (4, n_fft) raw tail frames and how many of them
        are valid."""
        fz = self._featurizer
        p = fz.params
        tmax = p.target_length
        stacked = fz._stack_mel()
        count = min(stacked.shape[0], tmax)
        mel_buf = np.zeros((tmax, p.n_mels), np.float32)
        mel_buf[:count] = stacked[:count]
        n = fz._n
        total_frames = min(1 + n // fz.hop, tmax)
        remaining = min(max(total_frames - fz._frames_done, 0),
                        self._TAIL_MAX)
        tail = np.zeros((self._TAIL_MAX, fz.n_fft), np.float32)
        if remaining > 0 and n >= 2:
            prepared = fz._tail_prepared(total_frames)
            for i in range(remaining):
                s0 = (fz._frames_done + i) * fz.hop
                tail[i] = prepared[s0 : s0 + fz.n_fft]
        return mel_buf, count, tail, remaining

    def _fused_finalize(self):
        """End-of-utterance: one pass on the device (or a queued row of
        the shared batch)."""
        mel_buf, count, tail, remaining = self.finalize_operands()
        inv = self.predictor.inv_label_map
        if self.batch_finalizer is not None:
            pending = self.batch_finalizer.submit(mel_buf, count, tail,
                                                  remaining, inv)
            return pending if self.async_results else pending.resolve()
        dev = self.predictor.device
        lengths = torch.tensor([count, remaining]).to(dev)
        with torch.inference_mode():
            probs = stream_calls(self.predictor)["fused_finalize"](
                torch.from_numpy(mel_buf).to(dev), lengths[0],
                torch.from_numpy(tail).to(dev), lengths[1])
        pending = PendingResult(probs, inv)
        return pending if self.async_results else pending.resolve()

    def _run_classifier(self, feats: np.ndarray):
        with torch.inference_mode():
            x = torch.from_numpy(feats).to(self.predictor.device)
            probs = stream_calls(self.predictor)["classify"](x)
        pending = PendingResult(probs, self.predictor.inv_label_map)
        return pending if self.async_results else pending.resolve()

    @property
    def recording(self) -> bool:
        return self._recording

    def feed(self, chunk: np.ndarray):
        """Feed one chunk; returns a result at end-of-utterance, else
        None.  Traced as the span ``sir.stream.feed``."""
        with span("sir.stream.feed"):
            return self._feed(np.asarray(chunk, np.float32).reshape(-1))

    def _feed(self, chunk: np.ndarray):
        speech = self.vad.is_speech(chunk)

        if not self._recording:
            self._prior.append(chunk)
            if len(self._prior) > self._prior_max:
                self._prior.pop(0)
            if speech:
                self._recording = True
                self._silence_chunks = 0
                self._featurizer.reset()
                for c in self._prior:  # pre-roll goes through the featurizer
                    self._featurizer.feed(c)
                self._prior = []
            return None

        self._featurizer.feed(chunk)
        self._silence_chunks = 0 if speech else self._silence_chunks + 1
        silence_s = (self._silence_chunks * self.chunk_size
                     / self.audio_cfg.sample_rate)
        if silence_s >= self.silence_limit:
            return self.flush()
        return None

    def partial_result(self):
        """Early hypothesis from the frames seen so far (mid-utterance): a
        :class:`PendingResult` with ``async_results``, else a dict."""
        if not self._recording:
            return None
        return self._run_classifier(self._featurizer.partial_features())

    def flush(self):
        """End the utterance in progress now; None when there is none."""
        if not self._recording:
            return None
        result = self._fused_finalize()
        self._recording = False
        self._featurizer.reset()
        return result
