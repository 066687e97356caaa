"""Separation backends behind the engine.

Counterpart of ``audio_cut_tpu/separation/backends.py``. ``make_backend``
builds ``convtdf`` (the packaged ConvTDF), ``waveunet`` (the waveform U-Net,
from the checkpoint ``train_separator --family waveunet`` writes), ``onnx``
(an MDX-class ``.onnx`` mask net, ``separation/onnx_backend.py``; no model
raises ``FileNotFoundError``) and ``spectral`` (the model-free
harmonic-percussive mask, also the trainer's held-out yardstick). The
spectral backend's median filters are elementwise min/max
networks, as in the JAX package (plain array code there, no Pallas); its
iSTFT ends in kernel K1.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.ops.stft import istft, stft
from audio_cut_tpu_torch.utils.device import indexed


@functools.lru_cache(maxsize=None)
def _batcher_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Compare-exchange pairs of Batcher's odd-even mergesort for n lanes."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (p * 2) == (i + j + k) // (p * 2):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def _median_of(parts: List[torch.Tensor]) -> torch.Tensor:
    """Exact elementwise median of same-shape tensors (odd count) by a
    min/max sorting network, as the JAX package computes it."""
    vals = list(parts)
    for a, b in _batcher_pairs(len(vals)):
        vals[a], vals[b] = torch.minimum(vals[a], vals[b]), torch.maximum(vals[a], vals[b])
    return vals[len(vals) // 2]


def _median_filter_axis(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Median filter along one axis via stacked shifted slices (edge-padded)."""
    half = size // 2
    axis = axis % x.ndim
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1).expand(*x.shape[:axis], half, *x.shape[axis + 1:])
    last = x.narrow(axis, n - 1, 1).expand(*x.shape[:axis], half, *x.shape[axis + 1:])
    xp = torch.cat([first, x, last], dim=axis)
    return _median_of([xp.narrow(axis, k, n) for k in range(size)])


# windows per spectral group, as in the JAX package's separate_windows_fn
WINDOW_GROUP = 4


class SpectralMaskBackend:
    """Model-free vocal/instrumental split via harmonic-percussive masking:
    median-filtered harmonic and percussive soft masks times a vocal-band
    weight, on the STFT at ``n_fft`` / ``hop``; the iSTFT runs K1."""

    name = "spectral"

    def __init__(self, sample_rate: int, n_fft: int = 2048, hop: int = 512):
        self.sample_rate = int(sample_rate)
        self.n_fft = n_fft
        self.hop = hop
        cfg = get_config("enhanced_separation.spectral", {}) or {}
        self.kernel_t = int(cfg.get("kernel_t", 31))
        self.kernel_f = int(cfg.get("kernel_f", 31))
        power = float(cfg.get("hpss_power", 2.0))
        # an integral exponent stays an int, as in the JAX package (there a
        # float exponent lowers to exp/log)
        self.power = int(power) if power == int(power) else power
        vs = get_config("vocal_separation", {}) or {}
        lo, hi = float(vs.get("vocal_freq_min", 100)), float(vs.get("vocal_freq_max", 4000))
        core_lo, core_hi = float(vs.get("vocal_core_min", 200)), float(vs.get("vocal_core_max", 1000))
        freqs = np.fft.rfftfreq(n_fft, d=1.0 / self.sample_rate)
        self._band = torch.from_numpy(np.clip(
            np.minimum((freqs - lo) / max(core_lo - lo, 1.0), (hi - freqs) / max(hi - core_hi, 1.0)),
            0.0, 1.0).astype(np.float32))
        self._band_by_device: Dict[str, torch.Tensor] = {}

    def _band_on(self, device: torch.device) -> torch.Tensor:
        """The band weight on ``device``, copied there once: a copy from
        pageable host memory in every group would wait for the device."""
        key = str(device)
        if key not in self._band_by_device:
            with torch.inference_mode(False):
                self._band_by_device[key] = self._band.to(device)
        return self._band_by_device[key]

    def _separate(self, audio: torch.Tensor, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        spec = stft(audio, n_fft=self.n_fft, hop=self.hop)        # [T, F]
        mag = torch.abs(spec)
        harm = _median_filter_axis(mag, self.kernel_t, axis=-2)   # smooth across time
        perc = _median_filter_axis(mag, self.kernel_f, axis=-1)   # smooth across freq
        hp = torch.pow(harm, self.power)
        pp = torch.pow(perc, self.power)
        total = hp + pp + 1e-10
        h_mask = hp / total
        # vocals: harmonically sustained energy inside the vocal band that is
        # NOT flat across frequency (percussive): band-weighted Wiener
        v_mask = h_mask * self._band_on(audio.device)[None, :]
        vocal = istft(spec * v_mask, n_fft=self.n_fft, hop=self.hop, length=length)
        return vocal, audio[..., :length] - vocal

    @torch.inference_mode()
    def separate_window(self, window: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One float32 window [S] on its device -> (vocal, instrumental), each [S]."""
        return self._separate(window, int(window.shape[-1]))

    @torch.inference_mode()
    def separate_windows(self, windows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The engine's batched path: [N, S] -> 2x [N, S]. Each group of up
        to ``WINDOW_GROUP`` windows is one STFT, the two median filters and
        one iSTFT (one K1 launch on the card); the group bounds the memory of
        the median network's slices. The windows are independent, so the last
        group is simply shorter: the JAX package zero-pads N to a multiple of
        the group because ``lax.map`` needs one static shape, which eager
        PyTorch does not."""
        length = int(windows.shape[-1])
        outs = [self._separate(windows[i:i + WINDOW_GROUP], length)
                for i in range(0, int(windows.shape[0]), WINDOW_GROUP)]
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


# backend instances (weights on the device) survive across engine/API calls;
# keyed by name, sample rate, device and the config values the backend reads,
# so a runtime-config change builds a new one. Bounded, oldest out first: each
# entry holds a model's weights in device memory.
_BACKEND_CACHE: Dict[Tuple, object] = {}
_BACKEND_CACHE_MAX = 4


def _config_key(name: str) -> Tuple:
    cfg = get_config(f"enhanced_separation.{name}", {}) or {}
    if name == "spectral":
        # the spectral backend also reads its band edges from vocal_separation
        cfg = {**cfg, **(get_config("vocal_separation", {}) or {})}
    key = tuple(sorted((k, str(v)) for k, v in cfg.items()))
    if name == "onnx":
        # the model's discovery also reads two environment variables
        key += (os.environ.get("AUDIO_CUT_ONNX_MODEL"), os.environ.get("MDX23_MODEL_FILENAME"))
    return key


def make_backend(name: str, sample_rate: int, device: torch.device):
    if name not in ("convtdf", "waveunet", "onnx", "spectral"):
        raise ValueError(f"unknown separation backend {name!r}")
    device = indexed(device)  # "cuda" and "cuda:0" are one card: one backend
    key = (name, int(sample_rate), str(device), _config_key(name))
    backend = _BACKEND_CACHE.get(key)
    if backend is None:
        if name == "spectral":
            backend = SpectralMaskBackend(sample_rate)
        elif name == "waveunet":
            from audio_cut_tpu_torch.models.waveunet import WaveUNetBackend

            backend = WaveUNetBackend(sample_rate, device)
        elif name == "onnx":
            from audio_cut_tpu_torch.separation.onnx_backend import OnnxSeparatorBackend

            backend = OnnxSeparatorBackend(sample_rate, device)
        else:
            from audio_cut_tpu_torch.models.convtdf import ConvTDFBackend

            backend = ConvTDFBackend(sample_rate, device)
        _BACKEND_CACHE[key] = backend
        while len(_BACKEND_CACHE) > _BACKEND_CACHE_MAX:
            _BACKEND_CACHE.pop(next(iter(_BACKEND_CACHE)))
    return backend
