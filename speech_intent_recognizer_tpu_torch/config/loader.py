"""YAML config loading with a dependency-free fallback parser.

Copy of ``speech_intent_recognizer_tpu/config/loader.py`` reduced to
reading: the reference loads configs with ``yaml.safe_load``
(``scripts/train.py:44-47``).  We do the same when PyYAML is importable, and
otherwise fall back to a tiny parser that covers the flat ``key: value`` +
comments subset the reference configs actually use, so the port has no hard
YAML dependency.
"""

from __future__ import annotations

import json
import os
from typing import Any

from speech_intent_recognizer_tpu_torch.config.schema import (
    AudioConfig, audio_config_from_dict)

try:  # pragma: no cover - environment dependent
    import yaml  # type: ignore

    _HAVE_YAML = True
except Exception:  # pragma: no cover
    yaml = None
    _HAVE_YAML = False


def _parse_scalar(text: str) -> Any:
    text = text.strip()
    if not text:
        return None
    if (text[0] == text[-1]) and text[0] in "\"'" and len(text) >= 2:
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "none", "~"):
        return None
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_parse_scalar(t) for t in inner.split(",")] if inner else []
    return text


def _mini_yaml_load(text: str) -> dict:
    """Parse the flat (plus one nesting level) YAML subset used by configs."""
    root: dict[str, Any] = {}
    stack: list[tuple[int, dict]] = [(0, root)]
    for rawline in text.splitlines():
        line = rawline.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, sep, value = line.strip().partition(":")
        if not sep:
            continue
        while stack and indent < stack[-1][0]:
            stack.pop()
        container = stack[-1][1]
        if value.strip():
            container[key.strip()] = _parse_scalar(value)
        else:
            child: dict[str, Any] = {}
            container[key.strip()] = child
            stack.append((indent + 2, child))
    return root


def load_raw(path: str) -> dict:
    with open(path, "r") as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    if _HAVE_YAML:
        return yaml.safe_load(text) or {}
    return _mini_yaml_load(text)


def load_audio_config(path: str) -> AudioConfig:
    """The audio section of the config file at ``path``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"config file not found: {path}")
    return audio_config_from_dict(load_raw(path))
