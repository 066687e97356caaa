"""Layered configuration manager.

Counterpart of ``audio_cut_tpu/config/manager.py``. Precedence, lowest first:

* the packaged ``defaults.json``: the JAX package's ``expert.yaml`` merged
  with its ``unified.yaml``, with ``gpu_pipeline.prefer_device: cuda``;
* ``VSS__section__key`` environment variables;
* runtime overrides (``set_runtime_config``, and each API call's own).

As in the JAX package, ``set_runtime_config`` records the dotted keys it
sets (``get_runtime_override_keys``), so that intent logic can tell the keys a
caller set from defaults, and every change of the config bumps a generation
counter. The API snapshots and restores ``mgr.config`` around a call; the
recorded keys survive that restore, as in the JAX package.

The defaults are JSON, so the port runs without PyYAML; an environment value
is parsed by the YAML scalar rules the JAX package applies to it (see
``_coerce_env_value``). External config files (``$AUDIO_CUT_TPU_CONFIG``,
``$VSS_EXTERNAL_CONFIG_PATH``) are YAML in the JAX package and not read by
this slice of the port; setting one raises (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import copy
import json
import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, Mapping, MutableMapping, Optional

_ENV_PREFIX = "VSS__"
_EXTERNAL_ENV_VARS = ("AUDIO_CUT_TPU_CONFIG", "VSS_EXTERNAL_CONFIG_PATH")
_DEFAULTS = Path(__file__).resolve().parent / "defaults.json"

_MISSING = object()

# YAML 1.1 scalars as PyYAML's safe_load reads them
_YAML_TRUE = {"true", "yes", "on"}
_YAML_FALSE = {"false", "no", "off"}
_YAML_NULL = {"null", "~", ""}
_INT_RE = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT_RE = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _coerce_env_value(raw: str) -> Any:
    """Parse an env-var override as a YAML scalar or JSON flow value.

    Covers what the JAX package's ``yaml.safe_load`` gives for the values
    its settings take: booleans (``true``/``yes``/``on`` and their opposites),
    null, decimal ints, floats written with a dot, and JSON-compatible lists
    and maps. Anything else stays a string.
    """
    text = raw.strip()
    low = text.lower()
    if low in _YAML_TRUE:
        return True
    if low in _YAML_FALSE:
        return False
    if low in _YAML_NULL:
        return None
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    if text[:1] in "[{":
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            return raw
    return raw


def get_nested(mapping: Mapping[str, Any], dotted: str, default: Any = None) -> Any:
    cursor: Any = mapping
    for part in dotted.split("."):
        if not isinstance(cursor, Mapping) or part not in cursor:
            return default
        cursor = cursor[part]
    return cursor


def set_nested(mapping: MutableMapping[str, Any], dotted: str, value: Any) -> None:
    parts = [p for p in dotted.split(".") if p]
    if not parts:
        return
    cursor: MutableMapping[str, Any] = mapping
    for part in parts[:-1]:
        nxt = cursor.get(part)
        if not isinstance(nxt, MutableMapping):
            nxt = {}
            cursor[part] = nxt
        cursor = nxt
    cursor[parts[-1]] = value


class ConfigManager:
    """Layered config with dotted access and tracked runtime overrides."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._runtime_keys: set[str] = set()
        self.config: Dict[str, Any] = {}
        self._generation = 0
        self.reload()

    def reload(self) -> None:
        with self._lock:
            for var in _EXTERNAL_ENV_VARS:
                if os.environ.get(var):
                    raise NotImplementedError(
                        f"${var} names a YAML config file; the PyTorch port reads its "
                        "packaged defaults.json and VSS__ variables only so far "
                        "(ROADMAP.md, queue 1, 'the other modes': config files)")
            with _DEFAULTS.open("r", encoding="utf-8") as fh:
                cfg: Dict[str, Any] = json.load(fh)
            self._apply_env_overrides(cfg)
            self._validate(cfg)
            self.config = cfg
            self._baseline = copy.deepcopy(cfg)
            self._runtime_keys = set()
            self._generation += 1

    @staticmethod
    def _apply_env_overrides(cfg: MutableMapping[str, Any]) -> None:
        # VSS__section__key=value  ->  section.key = parsed(value)
        for name, raw in os.environ.items():
            if not name.startswith(_ENV_PREFIX):
                continue
            dotted = name[len(_ENV_PREFIX):].replace("__", ".")
            set_nested(cfg, dotted, _coerce_env_value(raw))

    @staticmethod
    def _validate(cfg: Mapping[str, Any]) -> None:
        sr = get_nested(cfg, "audio.sample_rate", 44100)
        if not isinstance(sr, int) or sr <= 0:
            raise ValueError(f"audio.sample_rate must be a positive int, got {sr!r}")
        ch = get_nested(cfg, "audio.channels", 1)
        if ch not in (1, 2):
            raise ValueError(f"audio.channels must be 1 or 2, got {ch!r}")

    def get(self, dotted: str, default: Any = None) -> Any:
        with self._lock:
            value = get_nested(self.config, dotted, _MISSING)
        if value is _MISSING:
            return default
        return copy.deepcopy(value) if isinstance(value, (dict, list)) else value

    def set_runtime(self, overrides: Mapping[str, Any]) -> None:
        with self._lock:
            for dotted, value in overrides.items():
                set_nested(self.config, dotted, value)
                self._runtime_keys.add(dotted)
            self._generation += 1

    def reset_runtime(self) -> None:
        with self._lock:
            self.config = copy.deepcopy(self._baseline)
            self._runtime_keys = set()
            self._generation += 1

    def runtime_override_keys(self) -> set[str]:
        with self._lock:
            return set(self._runtime_keys)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return copy.deepcopy(self.config)

    def restore(self, snapshot: Mapping[str, Any]) -> None:
        with self._lock:
            self.config = copy.deepcopy(dict(snapshot))
            self._generation += 1

    def generation(self) -> int:
        """Monotonic counter bumped on every config mutation; cheap cache
        key for derived state that must not survive a config change."""
        with self._lock:
            return self._generation


_manager: Optional[ConfigManager] = None
_manager_lock = threading.Lock()


def get_config_manager() -> ConfigManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = ConfigManager()
        return _manager


def get_config(dotted: str, default: Any = None) -> Any:
    return get_config_manager().get(dotted, default)


def set_runtime_config(overrides: Mapping[str, Any]) -> None:
    get_config_manager().set_runtime(overrides)


def reset_runtime_config() -> None:
    get_config_manager().reset_runtime()


def get_runtime_override_keys() -> set[str]:
    return get_config_manager().runtime_override_keys()
