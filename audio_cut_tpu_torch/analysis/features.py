"""TrackFeatures: the shared per-track feature store on the 0.05 s grid.

Counterpart of ``audio_cut_tpu/analysis/features.py``: frame RMS, spectral
flatness and onset (kernel K2 over one STFT), the MDD series and the tempo,
computed over the whole bucket-padded track on its device. The store holds
host numpy views, because every consumer is host-side planning over small
arrays. ``build_track_features`` (the feature build without a bundle)
serves the ``librosa_onset`` mode and the staged bundle path, which this
slice of the port does not have (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from audio_cut_tpu_torch.ops import beats as B
from audio_cut_tpu_torch.ops import frames as F

DEFAULT_HOP_S = 0.05
_FEATURE_NFFT = 2048
_RMS_FRAME = 2048


def _compute_features(audio: torch.Tensor, hop: int, fps: float) -> Dict[str, torch.Tensor]:
    from audio_cut_tpu_torch.ops.frame_stats import spectral_stats
    from audio_cut_tpu_torch.ops.stft import stft

    rms = F.frame_rms(audio, _RMS_FRAME, hop)
    # one STFT feeds both spectral stats (kernel K2 on the card)
    mag = torch.abs(stft(audio, n_fft=_FEATURE_NFFT, hop=hop)).contiguous()
    flat, onset = spectral_stats(mag)
    mdd = F.mdd_series(rms, flat, onset)
    tempo = B.estimate_tempo(onset, fps=fps)
    return {
        "rms": rms,
        "flatness": flat,
        "onset": onset,
        "mdd": mdd,
        "bpm": tempo.bpm,
        "period_frames": tempo.period_frames,
        "phase_frames": tempo.phase_frames,
        "tempo_strength": tempo.strength,
    }


@dataclass
class TrackFeatures:
    sr: int
    hop_s: float
    duration_s: float
    rms: np.ndarray
    flatness: np.ndarray
    onset: np.ndarray
    mdd: np.ndarray
    bpm: float
    tempo_strength: float
    beat_times: np.ndarray
    extras: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_frames(self) -> int:
        return int(self.rms.shape[-1])

    @property
    def fps(self) -> float:
        return 1.0 / self.hop_s

    def frame_index(self, t: float) -> int:
        return int(np.clip(round(t / self.hop_s), 0, self.n_frames - 1))

    def frame_slice(self, start_s: float, end_s: float) -> slice:
        lo = self.frame_index(start_s)
        hi = int(np.clip(round(end_s / self.hop_s), lo + 1, self.n_frames))
        return slice(lo, hi)

    def window_stats(self, feature: str, start_s: float, end_s: float) -> Dict[str, float]:
        arr = getattr(self, feature) if hasattr(self, feature) else self.extras[feature]
        seg = arr[self.frame_slice(start_s, end_s)]
        if seg.size == 0:
            return {"mean": 0.0, "min": 0.0, "max": 0.0}
        return {"mean": float(seg.mean()), "min": float(seg.min()), "max": float(seg.max())}

    def times(self) -> np.ndarray:
        return np.arange(self.n_frames) * self.hop_s

    def bpm_category(self) -> str:
        return B.classify_bpm(self.bpm)
