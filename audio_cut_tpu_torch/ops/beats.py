"""Tempo estimation and the beat grid, in PyTorch.

Counterpart of ``audio_cut_tpu/ops/beats.py``: onset-envelope
autocorrelation (by FFT) over the lags of 30-240 BPM, a log-normal tempo
prior centred at 120 BPM, parabolic interpolation of the peak, then the
best of 64 beat phases by the onset strength a comb of beats collects.
``torch.argmax`` returns the first maximum and ``torch.round`` rounds ties
to even, as ``jnp`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class TempoResult(NamedTuple):
    bpm: torch.Tensor            # scalar f32
    period_frames: torch.Tensor  # scalar f32: frames per beat
    phase_frames: torch.Tensor   # scalar f32: offset of the first beat
    strength: torch.Tensor       # scalar f32: autocorrelation peak salience in [0, 1]


def estimate_tempo(
    onset_env: torch.Tensor,
    fps: float,
    min_bpm: float = 30.0,
    max_bpm: float = 240.0,
    n_phases: int = 64,
) -> TempoResult:
    """Global tempo and beat phase of an onset envelope [T]."""
    env = onset_env - torch.mean(onset_env)
    t = env.shape[-1]
    dev = env.device

    nfft = 1 << int(np.ceil(np.log2(max(4, 2 * t))))
    spec = torch.fft.rfft(env, n=nfft)
    ac = torch.fft.irfft(spec * torch.conj(spec), n=nfft)[:t]
    ac = ac / torch.clamp(ac[0], min=1e-10)

    lags = torch.arange(t, dtype=torch.float32, device=dev)
    bpm_of_lag = torch.where(lags > 0, 60.0 * fps / torch.clamp(lags, min=1.0),
                             torch.zeros((), device=dev))
    valid = (bpm_of_lag >= min_bpm) & (bpm_of_lag <= max_bpm)
    prior = torch.exp(-0.5 * ((torch.log2(torch.clamp(bpm_of_lag, min=1e-3))
                               - math.log2(120.0)) / 1.0) ** 2)
    score = torch.where(valid, ac * prior, torch.full((), -math.inf, device=dev))
    best_lag = torch.argmax(score)
    l0 = torch.clamp(best_lag, 1, t - 2)
    ym1, y0, yp1 = ac[l0 - 1], ac[l0], ac[l0 + 1]
    denom = ym1 - 2.0 * y0 + yp1
    delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (ym1 - yp1) / denom,
                        torch.zeros((), device=dev))
    delta = torch.clamp(delta, -0.5, 0.5)
    period = torch.clamp(best_lag.to(torch.float32) + delta, min=1.0)
    bpm = 60.0 * fps / period
    strength = torch.clamp(ac[best_lag], 0.0, 1.0)

    # a comb of beats at each trial phase; the phase whose comb collects the
    # most onset strength wins
    phases = torch.arange(n_phases, dtype=torch.float32, device=dev) / n_phases * period
    k = torch.arange(t, dtype=torch.float32, device=dev)
    pos = phases[:, None] + k[None, :] * period
    idx = torch.clamp(torch.round(pos).to(torch.int64), 0, t - 1)
    in_range = pos < t
    gains = torch.sum(torch.where(in_range, onset_env[idx], torch.zeros((), device=dev)), dim=1)
    phase = phases[torch.argmax(gains)]
    return TempoResult(bpm=bpm, period_frames=period, phase_frames=phase, strength=strength)


def beat_times_from_tempo(tempo: TempoResult, fps: float, duration_s: float) -> np.ndarray:
    """The beat grid on the host, as times in seconds."""
    period_s = float(tempo.period_frames) / fps
    phase_s = float(tempo.phase_frames) / fps
    if period_s <= 0:
        return np.zeros((0,), dtype=np.float64)
    n = max(0, int((duration_s - phase_s) / period_s) + 1)
    beats = phase_s + np.arange(n) * period_s
    return beats[beats < duration_s]


def classify_bpm(bpm: float) -> str:
    """BPM category of the threshold adaptation: slow < 90, fast > 140."""
    if bpm < 90.0:
        return "slow"
    if bpm > 140.0:
        return "fast"
    return "medium"
