"""Validated configuration schema.

The reference drives every stage from a flat, unvalidated YAML file
(``configs/config.yaml`` in the reference; loaded via ``yaml.safe_load`` at
``scripts/train.py:44-47`` with liberal ``config.get(key, default)``).  This
module keeps the exact same flat key names for drop-in compatibility, but
parses them into typed, validated dataclasses — a config typo fails fast
instead of silently training with a default.

Host-loader keys from the reference (``use_amp``, ``pin_memory``, ``gpu_id``,
``num_workers``, ...) are accepted and recorded so reference configs load
unchanged; the port answers them with bf16 compute and a device-resident
feature cache, or ignores them.

This is the port's own copy of
``speech_intent_recognizer_tpu/config/schema.py`` (the port imports nothing
of the JAX package): every section and key, so that one config file drives
both packages.  ``tests/test_torch_host.py`` pins it to the original: the
same file and overrides give equal ``dataclasses.asdict``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


class ConfigError(ValueError):
    """Raised when a config fails validation."""


@dataclass
class AudioConfig:
    """Feature front-end parameters.

    Defaults mirror the reference contract at
    ``scripts/precompute_features.py:21-36`` (16 kHz, n_fft 1024, hop 512,
    64 mels) and ``configs/config.yaml:43-45`` (200-frame pad/trim).
    """

    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 512
    win_length: Optional[int] = None  # defaults to n_fft
    n_mels: int = 64
    f_min: float = 0.0
    f_max: Optional[float] = None  # defaults to sample_rate / 2
    mel_spec_length: int = 200
    max_duration: float = 5.0  # seconds; reference caps at 5 s (:59-61)
    # "torchaudio": HTK mel, unit ref dB, per-utterance norm (training path)
    # "librosa": Slaney mel, ref=max dB, top_db 80, global norm (mic path,
    #            reference scripts/testing.py:193-217 — kept for parity tests)
    frontend: str = "torchaudio"
    # dB conversion / normalization details of the torchaudio path
    norm_eps: float = 1e-5

    def __post_init__(self) -> None:
        if self.win_length is None:
            self.win_length = self.n_fft
        if self.f_max is None:
            self.f_max = self.sample_rate / 2.0
        if self.frontend not in ("torchaudio", "librosa"):
            raise ConfigError(f"unknown frontend {self.frontend!r}")
        if self.n_fft < self.win_length:
            raise ConfigError("n_fft must be >= win_length")
        if self.hop_length <= 0 or self.n_fft <= 0 or self.n_mels <= 0:
            raise ConfigError("audio params must be positive")

    @property
    def max_samples(self) -> int:
        return int(self.max_duration * self.sample_rate)

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


@dataclass
class DataConfig:
    """Dataset manifests, label map and feature cache."""

    train_csv: str = "data/FSC/fluent_speech_commands_dataset/data/train_data.csv"
    valid_csv: str = "data/FSC/fluent_speech_commands_dataset/data/valid_data.csv"
    test_csv: str = "data/FSC/fluent_speech_commands_dataset/data/test_data.csv"
    label_map_path: str = "data/processed/label_map.json"
    output_dir: str = "data/processed"
    use_feature_cache: bool = True
    cache_dir: str = "data/cached_features"
    force_precompute: bool = False
    precompute_batch_size: int = 32
    # waveform staging format for precompute: "int16_packed" (default —
    # stages only real samples, ~4x fewer wire bytes than dense float32),
    # "int16" (dense, half of float32), or "float32" (bit-exact for
    # float/MP3 sources too; the int16 forms are already bit-exact for
    # 16-bit PCM sources)
    precompute_wire_dtype: str = "int16_packed"
    # feature readback format for precompute: "int16" (default — per-
    # utterance-scaled device-side quantization, half the return wire
    # bytes, <=1.5e-4 absolute error on normalized log-mels; the cache
    # stays float32) or "float32" (bit-exact readback)
    precompute_fetch_dtype: str = "int16"
    # augmentation (reference configs/config.yaml:38-40, dataset.py:69-71)
    use_augmentation: bool = True
    augment_prob: float = 0.7
    time_mask_param: int = 20
    freq_mask_param: int = 10
    # waveform-resident training: cache int16 waveforms instead of features
    # and featurize inside the train step (fused frontend); required
    # for use_waveform_augment to be live
    train_on_waveforms: bool = False
    use_waveform_augment: bool = False  # scripts/augment.py capability
    mixup_alpha: float = 0.2
    use_mixup: bool = False  # the reference declares mixup_alpha but never
    # wires it (configs/config.yaml:40); opt-in here


@dataclass
class ModelConfig:
    name: str = "cnn_gru"  # or "wav2vec"
    num_labels: int = 31
    conv_channels: tuple = (32, 64, 128)
    gru_hidden: int = 256
    gru_layers: int = 2
    dropout: float = 0.5
    # wav2vec variant (reference orphaned Wav2VecIntent)
    wav2vec_model: str = "facebook/wav2vec2-base"
    freeze_feature_extractor: bool = True


@dataclass
class TrainConfig:
    epochs: int = 15
    batch_size: int = 16
    lr: float = 5e-5
    weight_decay: float = 1e-4
    early_stop_patience: int = 5
    early_stop_delta: float = 1e-3
    grad_clip: float = 1.0
    # Mixed precision: bf16 compute, fp32 params/opt-state.  Replaces the
    # reference's AMP + GradScaler (train.py:93-101) — bf16 keeps fp32
    # dynamic range so no loss scaling is needed.
    bf16: bool = True
    save_path: str = "checkpoints/"
    seed: int = 42
    # resume support (the reference is save-only; we add full resume)
    resume: bool = False
    keep_checkpoints: int = 3
    eval_batch_multiplier: int = 2  # reference validates at 2x batch (train.py:214)
    log_every: int = 10
    # Large-batch recipe: linear warmup + optional cosine decay.  Defaults
    # reproduce the reference's constant-LR Adam; the large-batch recipe is
    # configs/large_batch.yaml.
    warmup_steps: int = 0
    lr_schedule: str = "constant"  # "constant" | "cosine"


@dataclass
class ParallelConfig:
    """Device mesh layout (``data`` is the batch axis, ``model`` shards
    wide weights when >1) and the multi-process launch.  The port's
    ``cli.train`` reads them: with a coordinator it joins a
    ``torch.distributed`` group of ``num_processes`` (one per device) and
    trains on its ``data_axis`` x ``model_axis`` grid: rows over ``data``,
    the split leaves over ``model`` (tensor parallelism).  ``cli.evaluate
    --data_parallel`` builds a ``data`` x ``model`` mesh in one process
    and runs its data shards."""

    data_axis: int = -1  # -1 = all remaining devices
    model_axis: int = 1
    # multi-host launch parameters
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


# Mapping of flat reference YAML keys -> (section, field) of the typed schema.
_FLAT_KEY_MAP = {
    # data
    "train_csv": ("data", "train_csv"),
    "valid_csv": ("data", "valid_csv"),
    "test_csv": ("data", "test_csv"),
    "label_map_path": ("data", "label_map_path"),
    "output_dir": ("data", "output_dir"),
    "use_feature_cache": ("data", "use_feature_cache"),
    "cache_dir": ("data", "cache_dir"),
    "force_precompute": ("data", "force_precompute"),
    "precompute_batch_size": ("data", "precompute_batch_size"),
    "precompute_wire_dtype": ("data", "precompute_wire_dtype"),
    "precompute_fetch_dtype": ("data", "precompute_fetch_dtype"),
    "train_on_waveforms": ("data", "train_on_waveforms"),
    "use_augmentation": ("data", "use_augmentation"),
    "augment_prob": ("data", "augment_prob"),
    "mixup_alpha": ("data", "mixup_alpha"),
    "use_mixup": ("data", "use_mixup"),
    "time_mask_param": ("data", "time_mask_param"),
    "freq_mask_param": ("data", "freq_mask_param"),
    "use_waveform_augment": ("data", "use_waveform_augment"),
    # model
    "num_labels": ("model", "num_labels"),
    "model_name": ("model", "name"),
    "gru_hidden": ("model", "gru_hidden"),
    "gru_layers": ("model", "gru_layers"),
    "dropout": ("model", "dropout"),
    "wav2vec_model": ("model", "wav2vec_model"),
    "freeze_feature_extractor": ("model", "freeze_feature_extractor"),
    # train
    "epochs": ("train", "epochs"),
    "batch_size": ("train", "batch_size"),
    "lr": ("train", "lr"),
    "weight_decay": ("train", "weight_decay"),
    "early_stop_patience": ("train", "early_stop_patience"),
    "early_stop_delta": ("train", "early_stop_delta"),
    "grad_clip": ("train", "grad_clip"),
    "save_path": ("train", "save_path"),
    "seed": ("train", "seed"),
    "resume": ("train", "resume"),
    "bf16": ("train", "bf16"),
    "log_every": ("train", "log_every"),
    "warmup_steps": ("train", "warmup_steps"),
    "lr_schedule": ("train", "lr_schedule"),
    # audio
    "sample_rate": ("audio", "sample_rate"),
    "n_mels": ("audio", "n_mels"),
    "n_fft": ("audio", "n_fft"),
    "hop_length": ("audio", "hop_length"),
    "mel_spec_length": ("audio", "mel_spec_length"),
    "max_duration": ("audio", "max_duration"),
    "frontend": ("audio", "frontend"),
    # parallel
    "data_axis": ("parallel", "data_axis"),
    "model_axis": ("parallel", "model_axis"),
    "coordinator_address": ("parallel", "coordinator_address"),
    "num_processes": ("parallel", "num_processes"),
    "process_id": ("parallel", "process_id"),
}

# Reference host-loader keys that mean nothing here.  Accepted so stock
# reference configs (configs/config.yaml in the reference) parse unchanged.
_IGNORED_REFERENCE_KEYS = {
    "use_amp",  # superseded by bf16
    "num_workers",
    "pin_memory",
    "prefetch_factor",
    "persistent_workers",
    "empty_cache_freq",
    "gpu_id",
    "dataset_path",
    "val_split",
}


@dataclass
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    ignored_keys: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        """Build from either a flat reference-style dict or a nested one."""
        sections: dict[str, dict[str, Any]] = {
            "audio": {},
            "data": {},
            "model": {},
            "train": {},
            "parallel": {},
        }
        ignored: dict[str, Any] = {}
        unknown: list[str] = []
        for key, value in (raw or {}).items():
            if key in sections and isinstance(value, dict):
                sections[key].update(value)
            elif key in _FLAT_KEY_MAP:
                sec, name = _FLAT_KEY_MAP[key]
                sections[sec][name] = value
            elif key in _IGNORED_REFERENCE_KEYS:
                ignored[key] = value
            else:
                unknown.append(key)
        if unknown:
            raise ConfigError(
                f"unknown config keys: {sorted(unknown)}. "
                "Valid keys are the reference configs/config.yaml keys or the "
                "nested [audio|data|model|train|parallel] sections."
            )
        cfg = cls(
            audio=_build(AudioConfig, sections["audio"]),
            data=_build(DataConfig, sections["data"]),
            model=_build(ModelConfig, sections["model"]),
            train=_build(TrainConfig, sections["train"]),
            parallel=_build(ParallelConfig, sections["parallel"]),
            ignored_keys=ignored,
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        t = self.train
        if t.epochs <= 0 or t.batch_size <= 0:
            raise ConfigError("epochs and batch_size must be positive")
        if not (0.0 <= self.data.augment_prob <= 1.0):
            raise ConfigError("augment_prob must be in [0, 1]")
        if t.lr <= 0:
            raise ConfigError("lr must be positive")
        if self.model.num_labels <= 1:
            raise ConfigError("num_labels must be > 1")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("ignored_keys", None)
        return d


def _build(cls, kwargs: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    bad = set(kwargs) - fields
    if bad:
        raise ConfigError(f"unknown keys for {cls.__name__}: {sorted(bad)}")
    coerced = {}
    for f in dataclasses.fields(cls):
        if f.name not in kwargs:
            continue
        v = kwargs[f.name]
        # YAML writes "5e-05" as str sometimes; coerce numerics like the
        # reference does with float(config.get('lr')) (train.py:243).
        if f.type in ("int", int) and v is not None:
            v = int(v)
        elif f.type in ("float", float) and v is not None:
            v = float(v)
        elif f.type in ("tuple", tuple) and v is not None:
            v = tuple(v)
        coerced[f.name] = v
    return cls(**coerced)
