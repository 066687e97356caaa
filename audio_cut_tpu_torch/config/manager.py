"""Layered configuration manager.

Counterpart of ``audio_cut_tpu/config/manager.py``. Precedence, lowest first:

* the packaged ``defaults.json``: the JAX package's ``expert.yaml`` merged
  with its ``unified.yaml``, with ``gpu_pipeline.prefer_device: cuda``;
* the YAML file named by ``$AUDIO_CUT_TPU_CONFIG`` or
  ``$VSS_EXTERNAL_CONFIG_PATH`` (the first one set);
* the YAML file passed as ``ConfigManager(config_path)``;
* ``VSS__section__key`` environment variables;
* runtime overrides (``set_runtime_config``, and each API call's own).

Each file is deep-merged over the layers below it. A file that was named
but does not exist raises ``FileNotFoundError``, and one whose root is not
a mapping raises ``ValueError``, as in the JAX package.

As in the JAX package, ``set_runtime_config`` records the dotted keys it
sets (``get_runtime_override_keys``), so that intent logic can tell the keys a
caller set from defaults, and every change of the config bumps a generation
counter. The API snapshots and restores ``mgr.config`` around a call; the
recorded keys survive that restore, as in the JAX package.

The port reads YAML without PyYAML: ``config/yaml_subset.py`` reads the
subset the JAX package's config files use and raises on anything else. An
environment value is parsed by the same rules (``_coerce_env_value``).
"""

from __future__ import annotations

import copy
import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, MutableMapping, Optional

from audio_cut_tpu_torch.config import yaml_subset

_ENV_PREFIX = "VSS__"
_EXTERNAL_ENV_VARS = ("AUDIO_CUT_TPU_CONFIG", "VSS_EXTERNAL_CONFIG_PATH")
_DEFAULTS = Path(__file__).resolve().parent / "defaults.json"

_MISSING = object()


def deep_merge(base: MutableMapping[str, Any], overlay: Mapping[str, Any]) -> MutableMapping[str, Any]:
    """Recursively merge ``overlay`` into ``base`` (in place) and return it."""
    for key, value in overlay.items():
        if key in base and isinstance(base[key], MutableMapping) and isinstance(value, Mapping):
            deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def _coerce_env_value(raw: str) -> Any:
    """Parse an env-var override as a YAML document, as the JAX package's
    ``yaml.safe_load`` does; a value outside the subset stays a string, as
    one PyYAML cannot parse does there."""
    try:
        return yaml_subset.loads(raw)
    except ValueError:
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

    def __init__(self, config_path: Optional[str] = None) -> None:
        self._lock = threading.RLock()
        self._explicit_path = config_path
        self._runtime_keys: set[str] = set()
        self.config: Dict[str, Any] = {}
        self._generation = 0
        self.reload()

    def reload(self) -> None:
        with self._lock:
            cfg: Dict[str, Any] = {}
            for layer in self._layers():
                deep_merge(cfg, layer)
            self._apply_env_overrides(cfg)
            self._validate(cfg)
            self.config = cfg
            self._baseline = copy.deepcopy(cfg)
            self._runtime_keys = set()
            self._generation += 1

    def _layers(self) -> Iterable[Mapping[str, Any]]:
        with _DEFAULTS.open("r", encoding="utf-8") as fh:
            yield json.load(fh)
        for var in _EXTERNAL_ENV_VARS:
            path = os.environ.get(var)
            if path:
                yield self._load_yaml(Path(path))
                break
        if self._explicit_path:
            yield self._load_yaml(Path(self._explicit_path))

    @staticmethod
    def _load_yaml(path: Path) -> Mapping[str, Any]:
        if not path.exists():
            raise FileNotFoundError(f"config file not found: {path}")
        data = yaml_subset.load_file(path)
        if data is None:
            return {}
        if not isinstance(data, Mapping):
            raise ValueError(f"config root must be a mapping: {path}")
        return data

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
