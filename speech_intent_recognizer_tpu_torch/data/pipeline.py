"""Device-resident dataset.

Counterpart of ``speech_intent_recognizer_tpu/data/pipeline.py``: load the
flat feature cache once, place it on one device, and let the training loop
gather batches there.  :func:`build_dataset` resolves a manifest's features
as the JAX package does: cache hit -> load; a reference ``.pt`` cache ->
migrate; miss -> precompute (the K3 kernel on a CUDA device) and store.
:func:`build_waveform_dataset` does the same with the int16 waveform cache
of waveform-resident training (``data.train_on_waveforms``).

In a multi-process run (``parallel.initialize_distributed``) every process
holds the whole set on its device, as the JAX package replicates it over
the mesh.  With the cache on, process 0 resolves it (and writes it) while
the others wait at a barrier, then read what it wrote: N processes never
race on one cache file.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config import Config
from speech_intent_recognizer_tpu_torch.data import cache as cache_mod
from speech_intent_recognizer_tpu_torch.data.manifest import read_manifest
from speech_intent_recognizer_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)


@dataclass
class DeviceDataset:
    """Features (or int16 waveforms) and labels living on one device."""

    features: torch.Tensor  # (N, n_mels, T) float32, or (N, L) int16 waves
    labels: torch.Tensor  # (N,) int64
    num_items: int
    lengths: Optional[torch.Tensor] = None  # (N,) int32, waveform mode only

    @classmethod
    def from_arrays(cls, features: np.ndarray, labels: np.ndarray,
                    device: "str | torch.device",
                    lengths: Optional[np.ndarray] = None) -> "DeviceDataset":
        """With ``lengths``, ``features`` are waveforms and stay int16."""
        dtype = np.float32 if lengths is None else np.int16
        return cls(
            features=torch.as_tensor(np.asarray(features, dtype),
                                     device=device),
            labels=torch.as_tensor(np.asarray(labels, np.int64),
                                   device=device),
            num_items=int(features.shape[0]),
            lengths=None if lengths is None else torch.as_tensor(
                np.asarray(lengths, np.int32), device=device))


def _process_zero_first(cfg: Config, build: Callable[[], DeviceDataset],
                        load: Callable[[], DeviceDataset]) -> DeviceDataset:
    """``build`` on process 0 (or alone); the other processes of a group
    ``load`` the cache it wrote, after a barrier."""
    if not (cfg.data.use_feature_cache and distributed.is_initialized()):
        return build()
    if distributed.rank() == 0:
        ds = build()
        distributed.barrier()
        return ds
    distributed.barrier()
    return load()


def build_dataset(
    csv_path: str,
    label_map: Dict[str, int],
    cfg: Config,
    device: "str | torch.device" = "cuda",
) -> DeviceDataset:
    """Resolve features for a manifest: cache hit -> load; reference ``.pt``
    cache -> migrate; miss -> compute on ``device`` (and store, when
    ``cfg.data.use_feature_cache``), the reference's cache-or-extract flow
    (``dataset.py:43-102``) at dataset granularity."""
    cache_file = cache_mod.cache_path_for(csv_path, cfg.data.cache_dir)

    def load():
        feats, labels, _meta = cache_mod.load_cache(cache_file)
        return DeviceDataset.from_arrays(feats, labels, device)

    return _process_zero_first(
        cfg, lambda: _build_dataset(csv_path, label_map, cfg, device,
                                    cache_file), load)


def _build_dataset(csv_path, label_map, cfg, device, cache_file):
    use_cache = cfg.data.use_feature_cache
    if use_cache and os.path.exists(cache_file) and not cfg.data.force_precompute:
        feats, labels, _meta = cache_mod.load_cache(cache_file)
        logger.info("loaded %d cached features from %s", len(feats), cache_file)
        return DeviceDataset.from_arrays(feats, labels, device)

    legacy = cache_file[: -len(".npz")] + ".pt"
    if use_cache and os.path.exists(legacy) and not cfg.data.force_precompute:
        try:
            feats, labels, _paths = cache_mod.load_torch_cache(
                legacy, label_map, cfg.audio.mel_spec_length)
            logger.info("migrated %d features from legacy cache %s",
                        len(feats), legacy)
            return DeviceDataset.from_arrays(feats, labels, device)
        except Exception as e:
            logger.warning("legacy cache %s unreadable (%s); recomputing",
                           legacy, e)

    manifest = read_manifest(csv_path)
    feats, labels, _ok, paths = cache_mod.precompute_features(
        manifest, label_map, cfg.audio,
        batch_size=cfg.data.precompute_batch_size,
        wire_dtype=cfg.data.precompute_wire_dtype,
        fetch_dtype=cfg.data.precompute_fetch_dtype,
        device=device)
    if use_cache:
        cache_mod.save_cache(cache_file, feats, labels, paths, label_map,
                             cfg.audio)
    return DeviceDataset.from_arrays(feats, labels, device)


def build_waveform_dataset(
    csv_path: str,
    label_map: Dict[str, int],
    cfg: Config,
    device: "str | torch.device" = "cuda",
) -> DeviceDataset:
    """Waveform-resident variant of :func:`build_dataset`
    (``data.train_on_waveforms``): the dataset is the int16 waveform cache
    placed whole on ``device``; the trainer featurizes each batch inside
    its step (``train/loop.py``), which makes waveform augmentation
    possible.  Cache hit -> load; miss -> decode (and store, when
    ``cfg.data.use_feature_cache``)."""
    cache_file = cache_mod.waveform_cache_path_for(csv_path,
                                                   cfg.data.cache_dir)

    def load():
        waves, lengths, labels, _meta = cache_mod.load_waveform_cache(
            cache_file)
        return DeviceDataset.from_arrays(waves, labels, device,
                                         lengths=lengths)

    return _process_zero_first(
        cfg, lambda: _build_waveform_dataset(csv_path, label_map, cfg,
                                             device, cache_file), load)


def _build_waveform_dataset(csv_path, label_map, cfg, device, cache_file):
    use_cache = cfg.data.use_feature_cache
    if (use_cache and os.path.exists(cache_file)
            and not cfg.data.force_precompute):
        waves, lengths, labels, _meta = cache_mod.load_waveform_cache(
            cache_file)
        logger.info("loaded %d cached waveforms from %s", len(waves),
                    cache_file)
        return DeviceDataset.from_arrays(waves, labels, device,
                                         lengths=lengths)

    manifest = read_manifest(csv_path)
    waves, lengths, labels, _ok, paths = cache_mod.precompute_waveforms(
        manifest, label_map, cfg.audio)
    if use_cache:
        cache_mod.save_waveform_cache(cache_file, waves, lengths, labels,
                                      paths, label_map, cfg.audio)
    return DeviceDataset.from_arrays(waves, labels, device, lengths=lengths)
