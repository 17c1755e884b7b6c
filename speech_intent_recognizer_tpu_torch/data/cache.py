"""Feature cache: precomputed log-mel features as flat array records.

Counterpart of ``speech_intent_recognizer_tpu/data/cache.py``, with the
same file format, so a cache written by either package loads in the other:
a single ``.npz`` of contiguous arrays — ``features (N, n_mels, T)`` f32 +
``labels (N,)`` i32 — plus a ``.meta.json`` sidecar with paths and config.
For waveform-resident training the same layout holds int16 waveforms
(``waves``, ``lengths``, ``labels``; ``kind: "waveforms_int16"``).

Feature extraction is the batched device front-end
(:func:`..ops.frontend.log_mel_frontend`: on a CUDA device the K3 kernel at
the reference geometry and the K4 kernel at any other, the plain version on
the CPU).  The host only decodes audio, on a worker
thread, into fixed-width buffers.  A reader for the reference's ``.pt``
caches migrates them without recompute.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.data.audio_io import (
    load_audio, load_audio_int16)
from speech_intent_recognizer_tpu_torch.data.manifest import Manifest

logger = logging.getLogger(__name__)

CACHE_VERSION = 1


def cache_path_for(csv_path: str, cache_dir: str) -> str:
    stem = os.path.basename(csv_path)
    if stem.endswith(".csv"):
        stem = stem[:-4]
    return os.path.join(cache_dir, f"{stem}_features.npz")


def _decode_batch(paths, audio_cfg: AudioConfig, wire_dtype=np.float32):
    """Host decode into a fixed (B, max_samples) buffer + lengths.

    ``wire_dtype=np.int16`` is the half-byte staging format: bit-identical
    features for 16-bit PCM sources, <=2**-16 full-scale quantization for
    float/MP3 sources (see :func:`..data.audio_io.load_audio_int16`).  A
    file that fails to decode is logged and flagged in the mask; its
    features are zeros (the reference's fallback, ``dataset.py:123,158``).
    """
    max_samples = audio_cfg.max_samples
    buf = np.zeros((len(paths), max_samples), wire_dtype)
    lengths = np.zeros(len(paths), np.int32)
    ok = np.ones(len(paths), bool)
    int_wire = np.dtype(wire_dtype) == np.int16
    for i, p in enumerate(paths):
        try:
            if int_wire:
                x, _ = load_audio_int16(
                    p, target_sample_rate=audio_cfg.sample_rate)
            else:
                x, _ = load_audio(p, target_sample_rate=audio_cfg.sample_rate)
            n = min(len(x), max_samples)
            buf[i, :n] = x[:n]
            lengths[i] = n
            if n == 0:
                ok[i] = False
        except Exception as e:  # one bad file: logged, flagged, zeroed
            logger.error("error processing %s: %s", p, e)
            ok[i] = False
    return buf, lengths, ok


def _pack(buf: np.ndarray, lengths: np.ndarray):
    """Concatenate each row's real samples: (flat int16, row offsets)."""
    offsets = np.zeros(len(lengths), np.int32)
    offsets[1:] = np.cumsum(lengths[:-1])
    flat = np.zeros(max(int(lengths.sum()), 1), np.int16)
    for i, m in enumerate(lengths):
        flat[offsets[i]:offsets[i] + m] = buf[i, :m]
    return flat, offsets


def _unpack(flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
            width: int) -> torch.Tensor:
    """One gather rebuilds the zero-padded (B, width) int16 rows."""
    pos = torch.arange(width, device=flat.device, dtype=torch.int64)
    valid = pos[None, :] < lengths[:, None]
    idx = torch.where(valid, offsets[:, None].long() + pos[None, :], 0)
    return torch.where(valid, flat[idx], 0)


def _quantize(f: torch.Tensor):
    """Per-utterance int16 quantization of (B, n_mels, T) features, on the
    features' device, exactly as the JAX package does it: scale =
    max(max|f|, 1e-12) / 32767, q = round(f * (1 / scale))."""
    m = f.abs().amax(dim=(1, 2))
    scale = m.clamp(min=1e-12) * (1.0 / 32767.0)
    q = torch.round(f * (1.0 / scale)[:, None, None]).to(torch.int16)
    return q, scale


def precompute_features(
    manifest: Manifest,
    label_map: Dict[str, int],
    audio_cfg: Optional[AudioConfig] = None,
    batch_size: int = 64,
    progress: bool = True,
    wire_dtype: str = "int16_packed",
    fetch_dtype: str = "int16",
    features_out: Optional[str] = None,
    timings: Optional[dict] = None,
    device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Compute features for a manifest on ``device``.

    Returns (features (N, n_mels, T) f32, labels (N,) i32, ok mask, paths).
    Failed decodes get zero features and are flagged in the mask.

    Host decode runs on a worker thread (:class:`..data.prefetch.
    BackgroundLoader`); batch k + 1 is dispatched to the device before
    batch k's features are fetched.  Each batch is one front-end call, so
    on a CUDA device K3 (off the reference geometry K4) launches
    ceil(N / batch_size) times.

    Args:
      wire_dtype: "int16_packed" (default) stages only the real samples,
        one flat int16 buffer per batch, rebuilt into the padded (B, L)
        rows on the device with one gather; values are identical to
        "int16", which stages the dense zero-padded int16 buffer.  Both are
        bit-identical to "float32" for 16-bit PCM sources and within
        2**-16 full scale otherwise; "float32" is exact everywhere.
      fetch_dtype: "int16" (default) quantizes the finished features on the
        device with a per-utterance scale (max |x| / 32767) before the
        device->host copy; the cache stays float32 and the absolute error
        is <= scale / 2 ~ 1.5e-4 for normalized log-mels.  "float32" keeps
        the copy exact.
      features_out: optional ``.npy`` path — features stream into an
        ``np.lib.format.open_memmap``, so the (N, n_mels, T) array never
        occupies RAM; the returned features array is the flushed memmap.
      timings: optional dict, filled with per-stage seconds (decode /
        dispatch / fetch).
      device: where the front-end runs ("cuda": the K3 or K4 kernel;
        "cpu": the plain version).
    """
    from speech_intent_recognizer_tpu_torch.data.prefetch import (
        BackgroundLoader)
    from speech_intent_recognizer_tpu_torch.ops.frontend import (
        log_mel_frontend, make_frontend_params)

    audio_cfg = audio_cfg or AudioConfig()
    if wire_dtype not in ("int16_packed", "int16", "float32"):
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    if fetch_dtype not in ("int16", "float32"):
        raise ValueError(f"unknown fetch_dtype {fetch_dtype!r}")
    dev = torch.device(device)
    params = make_frontend_params(audio_cfg, dev)
    packed = wire_dtype == "int16_packed"
    int_wire = wire_dtype != "float32"
    quant_fetch = fetch_dtype == "int16"
    max_samples = audio_cfg.max_samples

    n = len(manifest)
    shape = (n, audio_cfg.n_mels, audio_cfg.mel_spec_length)
    if features_out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(features_out)),
                    exist_ok=True)
        feats = np.lib.format.open_memmap(features_out, mode="w+",
                                          dtype=np.float32, shape=shape)
    else:
        feats = np.zeros(shape, np.float32)
    labels = np.asarray([label_map.get(l, 0) for l in manifest.labels],
                        np.int32)
    ok_all = np.ones(n, bool)
    t_decode = [0.0]

    def produce():
        """Host decode on the worker thread."""
        np_wire = np.int16 if int_wire else np.float32
        for start in range(0, n, batch_size):
            t0 = time.perf_counter()
            chunk = manifest.paths[start:start + batch_size]
            buf, lengths, ok = _decode_batch(chunk, audio_cfg, np_wire)
            payload = _pack(buf, lengths) if packed else buf
            t_decode[0] += time.perf_counter() - t0
            yield start, len(chunk), payload, lengths, ok

    iterator = BackgroundLoader(produce, capacity=2)
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="precompute",
                            total=-(-n // batch_size))
        except ImportError:
            pass

    def featurize(payload, lengths: np.ndarray):
        if packed:
            flat, offsets = payload
            x = _unpack(torch.from_numpy(flat).to(dev),
                        torch.from_numpy(offsets).to(dev),
                        torch.from_numpy(lengths).to(dev), max_samples)
        else:
            x = torch.from_numpy(payload).to(dev)
        if int_wire:
            x = x.float() * (1.0 / 32768.0)
        ln = torch.from_numpy(np.maximum(lengths, 1)).to(dev)
        out = log_mel_frontend(x.contiguous(), ln, params)
        return _quantize(out) if quant_fetch else out

    t_dispatch = t_fetch = 0.0
    pending = None  # batch k-1, fetched only after k is dispatched

    def drain(entry):
        """Fetch a finished batch's features into the output array."""
        nonlocal t_fetch
        start, n_chunk, ok, out_dev = entry
        t0 = time.perf_counter()
        if quant_fetch:
            q, scale = out_dev
            out = (q.cpu().numpy().astype(np.float32)
                   * scale.cpu().numpy()[:, None, None])
        else:
            out = out_dev.cpu().numpy()
        t_fetch += time.perf_counter() - t0
        out[~ok] = 0.0  # zero features for failed decodes
        feats[start:start + n_chunk] = out
        ok_all[start:start + n_chunk] = ok

    with torch.inference_mode():
        for start, n_chunk, payload, lengths, ok in iterator:
            t0 = time.perf_counter()
            out_dev = featurize(payload, lengths)
            t_dispatch += time.perf_counter() - t0
            if pending is not None:
                drain(pending)
            pending = (start, n_chunk, ok, out_dev)
        if pending is not None:
            drain(pending)

    if features_out is not None:
        feats.flush()
    if timings is not None:
        timings.update(decode_s=t_decode[0], stage_dispatch_s=t_dispatch,
                       fetch_s=t_fetch, wire_dtype=wire_dtype,
                       fetch_dtype=fetch_dtype,
                       batches=-(-n // batch_size) if n else 0)
    return feats, labels, ok_all, list(manifest.paths)


def waveform_cache_path_for(csv_path: str, cache_dir: str) -> str:
    stem = os.path.basename(csv_path)
    if stem.endswith(".csv"):
        stem = stem[:-4]
    return os.path.join(cache_dir, f"{stem}_waveforms.npz")


def precompute_waveforms(
    manifest: Manifest,
    label_map: Dict[str, int],
    audio_cfg: Optional[AudioConfig] = None,
    progress: bool = True,
    waves_out: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list]:
    """Decode a manifest into an int16 waveform cache for waveform-resident
    training (``data.train_on_waveforms``).

    Returns (waves (N, max_samples) int16, lengths (N,) i32, labels (N,)
    i32, ok mask, paths), the JAX package's arrays: int16 is the same
    staging format as :func:`precompute_features`'s wire, bit-exact for
    PCM16 sources.  The whole split lives on the device and the trainer
    featurizes each batch inside its step (K3 on a CUDA device), which is
    what makes waveform augmentation (``ops/augment.py``) possible.

    ``waves_out``: optional ``.npy`` path; the waves stream into a memmap,
    so the (N, max_samples) array never occupies host RAM.
    """
    audio_cfg = audio_cfg or AudioConfig()
    n = len(manifest)
    max_samples = audio_cfg.max_samples
    if waves_out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(waves_out)),
                    exist_ok=True)
        waves = np.lib.format.open_memmap(waves_out, mode="w+",
                                          dtype=np.int16,
                                          shape=(n, max_samples))
        waves[:] = 0
    else:
        waves = np.zeros((n, max_samples), np.int16)
    lengths = np.zeros(n, np.int32)
    labels = np.asarray([label_map.get(l, 0) for l in manifest.labels],
                        np.int32)
    ok_all = np.ones(n, bool)

    iterator = enumerate(manifest.paths)
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="decode waveforms", total=n)
        except ImportError:
            pass
    for i, p in iterator:
        try:
            x, _ = load_audio_int16(p,
                                    target_sample_rate=audio_cfg.sample_rate)
            m = min(len(x), max_samples)
            waves[i, :m] = x[:m]
            lengths[i] = m
            if m == 0:
                ok_all[i] = False
        except Exception as e:  # one bad file: logged, flagged, zeroed
            logger.error("error processing %s: %s", p, e)
            ok_all[i] = False
    if waves_out is not None:
        waves.flush()
    return waves, lengths, labels, ok_all, list(manifest.paths)


def save_waveform_cache(path: str, waves: np.ndarray, lengths: np.ndarray,
                        labels: np.ndarray, paths: Iterable[str],
                        label_map: Dict[str, int],
                        audio_cfg: Optional[AudioConfig] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if isinstance(waves, np.memmap) and waves.dtype == np.int16:
        # waves streamed to disk (``waves_out=``): zip-store the backing
        # ``.npy``, as save_cache does for features
        import io
        import zipfile

        waves.flush()
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
            zf.write(waves.filename, "waves.npy")
            for name, arr in (("lengths", lengths.astype(np.int32)),
                              ("labels", labels.astype(np.int32))):
                buf = io.BytesIO()
                np.lib.format.write_array(buf, arr)
                zf.writestr(name + ".npy", buf.getvalue())
    else:
        np.savez(path, waves=np.asarray(waves, np.int16),
                 lengths=lengths.astype(np.int32),
                 labels=labels.astype(np.int32))
    cfg = audio_cfg or AudioConfig()
    meta = {
        "version": CACHE_VERSION,
        "kind": "waveforms_int16",
        "num_items": int(waves.shape[0]),
        "paths": list(paths),
        "label_map": label_map,
        "audio": {"sample_rate": cfg.sample_rate,
                  "max_samples": int(waves.shape[1])},
    }
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)
    logger.info("saved %d waveforms to %s", waves.shape[0], path)


def load_waveform_cache(path: str):
    """-> (waves (N, max_samples) int16, lengths, labels, meta dict)."""
    with np.load(path) as z:
        waves = z["waves"]
        lengths = z["lengths"]
        labels = z["labels"]
    meta = {}
    if os.path.exists(_meta_path(path)):
        with open(_meta_path(path)) as f:
            meta = json.load(f)
    return waves, lengths, labels, meta


def save_cache(path: str, features: np.ndarray, labels: np.ndarray,
               paths: Iterable[str], label_map: Dict[str, int],
               audio_cfg: Optional[AudioConfig] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if isinstance(features, np.memmap) and features.dtype == np.float32:
        # features streamed to disk during precompute (``features_out=``):
        # zip-store the backing ``.npy`` (one sequential copy); np.load reads
        # the result exactly as np.savez output
        import io
        import zipfile

        features.flush()
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
            zf.write(features.filename, "features.npy")
            buf = io.BytesIO()
            np.lib.format.write_array(buf, labels.astype(np.int32))
            zf.writestr("labels.npy", buf.getvalue())
    else:
        np.savez(path, features=np.asarray(features, np.float32),
                 labels=labels.astype(np.int32))
    meta = {
        "version": CACHE_VERSION,
        "num_items": int(features.shape[0]),
        "paths": list(paths),
        "label_map": label_map,
        "audio": {
            "sample_rate": (audio_cfg or AudioConfig()).sample_rate,
            "n_mels": int(features.shape[1]),
            "mel_spec_length": int(features.shape[2]),
        },
    }
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)
    logger.info("saved %d features to %s", features.shape[0], path)


def _meta_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".meta.json"


def load_cache(path: str):
    """-> (features, labels, meta dict)."""
    with np.load(path) as z:
        features = z["features"]
        labels = z["labels"]
    meta = {}
    if os.path.exists(_meta_path(path)):
        with open(_meta_path(path)) as f:
            meta = json.load(f)
    return features, labels, meta


def load_torch_cache(path: str, label_map: Dict[str, int],
                     target_length: int = 200):
    """Read a reference-format ``*_features.pt`` cache (a torch-saved dict
    ``{path: {'features': tensor, 'label': str}}``) into flat arrays —
    migration support."""
    from speech_intent_recognizer_tpu_torch.ops.frontend_numpy import (
        pad_or_trim_np)

    blob = torch.load(path, map_location="cpu", weights_only=True)
    paths, feats, labels = [], [], []
    for p, entry in blob.items():
        paths.append(p)
        feats.append(pad_or_trim_np(
            np.asarray(entry["features"], np.float32), target_length))
        labels.append(label_map.get(str(entry["label"]), 0))
    return (np.stack(feats), np.asarray(labels, np.int32), paths)
