"""Separation backends behind the engine.

Counterpart of ``audio_cut_tpu/separation/backends.py``. This slice of the
port has the ``convtdf`` backend only; asking for another raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from audio_cut_tpu_torch.config import get_config

_NOT_PORTED = {
    "spectral": "the spectral backend and the fallback chain",
    "waveunet": "other separator tiers (waveunet, onnx)",
    "onnx": "other separator tiers (waveunet, onnx)",
}

# backend instances (weights on the device) survive across engine/API calls;
# keyed by name, sample rate, device and the config values the backend reads,
# so a runtime-config change builds a new one. Bounded, oldest out first: each
# entry holds a model's weights in device memory.
_BACKEND_CACHE: Dict[Tuple, object] = {}
_BACKEND_CACHE_MAX = 4


def _config_key(name: str) -> Tuple:
    cfg = get_config(f"enhanced_separation.{name}", {}) or {}
    return tuple(sorted((k, str(v)) for k, v in cfg.items()))


def make_backend(name: str, sample_rate: int, device: torch.device):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"separation backend {name!r} is not in the PyTorch port yet: "
            f"ROADMAP.md, queue 1, '{_NOT_PORTED[name]}'")
    if name != "convtdf":
        raise ValueError(f"unknown separation backend {name!r}")
    device = torch.device(device)
    key = (name, int(sample_rate), str(device), _config_key(name))
    backend = _BACKEND_CACHE.get(key)
    if backend is None:
        from audio_cut_tpu_torch.models.convtdf import ConvTDFBackend

        backend = ConvTDFBackend(sample_rate, device)
        _BACKEND_CACHE[key] = backend
        while len(_BACKEND_CACHE) > _BACKEND_CACHE_MAX:
            _BACKEND_CACHE.pop(next(iter(_BACKEND_CACHE)))
    return backend
