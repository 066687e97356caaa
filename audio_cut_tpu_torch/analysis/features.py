"""TrackFeatures: the shared per-track feature store on the 0.05 s grid.

Counterpart of ``audio_cut_tpu/analysis/features.py``: frame RMS, spectral
flatness and onset (kernel K2 over one STFT), the MDD series and the tempo,
computed over the whole bucket-padded track on its device. The store holds
host numpy views, because every consumer is host-side planning over small
arrays. The detection bundle (``analysis/bundle.py``) computes them inside
its pass; ``build_track_features`` computes them alone, on the device it is
given, for the ``librosa_onset`` mode (at hop 512).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.ops import beats as B
from audio_cut_tpu_torch.ops import frames as F

DEFAULT_HOP_S = 0.05
_FEATURE_NFFT = 2048
_RMS_FRAME = 2048
# audio lengths are padded up to a multiple of this many seconds, as in the
# JAX package, whose compiled shapes it bounds; the padded tail frames are
# trimmed off
_BUCKET_S = 15.0


def pad_to_bucket(x: np.ndarray, sr: int, bucket_s: float = _BUCKET_S) -> np.ndarray:
    bucket = int(round(bucket_s * sr))
    n = x.shape[-1]
    target = ((n + bucket - 1) // bucket) * bucket if n else bucket
    if target == n:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, target - n)]
    return np.pad(x, pad)


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


def flatten_outputs(out: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Tuple[int, ...]]]:
    """(flat float32 tensor, shapes): a pass's outputs in sorted key order,
    so that one copy brings them all to the host."""
    keys = sorted(out)
    flat = torch.cat([out[k].reshape(-1).to(torch.float32) for k in keys])
    return flat, {k: tuple(out[k].shape) for k in keys}


def unflatten_outputs(flat_host: np.ndarray, shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, np.ndarray]:
    """Cut the host copy of ``flatten_outputs`` back into its outputs; a
    scalar output comes back as a numpy scalar."""
    host: Dict[str, np.ndarray] = {}
    off = 0
    for k in sorted(shapes):
        shape = tuple(shapes[k])
        size = int(np.prod(shape)) if shape else 1
        v = flat_host[off:off + size]
        host[k] = v.reshape(shape) if shape else v[0]
        off += size
    return host


def track_features_from_host(
    host: Mapping[str, np.ndarray],
    sr: int,
    hop_s: float,
    n_true: int,
    beat_source: Optional[np.ndarray] = None,
) -> TrackFeatures:
    """The feature store from the host copies of ``_compute_features``'
    outputs over a padded track of true length ``n_true``, trimmed to its
    ``n_true // hop + 1`` frames. With ``beat_source`` (beat times in
    seconds) the beat grid and the bpm come from it instead of the tempo
    estimate."""
    hop = max(1, int(round(hop_s * sr)))
    duration_s = n_true / float(sr)
    n_frames = n_true // hop + 1
    if beat_source is not None:
        beat_times = np.asarray(beat_source, dtype=np.float64)
        bpm = 60.0 / float(np.median(np.diff(beat_times))) if beat_times.size > 1 else 0.0
        strength = 1.0
    else:
        tempo = B.TempoResult(
            bpm=host["bpm"], period_frames=host["period_frames"],
            phase_frames=host["phase_frames"], strength=host["tempo_strength"],
        )
        beat_times = B.beat_times_from_tempo(tempo, fps=sr / float(hop), duration_s=duration_s)
        bpm = float(host["bpm"])
        strength = float(host["tempo_strength"])
    return TrackFeatures(
        sr=sr,
        hop_s=hop_s,
        duration_s=duration_s,
        rms=host["rms"][:n_frames],
        flatness=host["flatness"][:n_frames],
        onset=host["onset"][:n_frames],
        mdd=host["mdd"][:n_frames],
        bpm=bpm,
        tempo_strength=strength,
        beat_times=beat_times,
    )


def build_track_features(
    audio: np.ndarray,
    sr: int,
    hop_s: float = DEFAULT_HOP_S,
    beat_source: Optional[np.ndarray] = None,
    *,
    device: torch.device,
) -> TrackFeatures:
    """The feature store of one track, computed on ``device`` with one upload
    and one host copy. ``audio`` is 1-D float32 at ``sr``; it is padded to
    the 15 s bucket and the padded tail frames are trimmed off. With
    ``beat_source`` (beat times in seconds) the beat grid and the bpm come
    from it instead of the tempo estimate."""
    audio = np.asarray(audio, dtype=np.float32)
    hop = max(1, int(round(hop_s * sr)))
    with torch.inference_mode():
        out = _compute_features(torch.from_numpy(pad_to_bucket(audio, sr)).to(device), hop,
                                sr / float(hop))
        flat, shapes = flatten_outputs(out)
        host = unflatten_outputs(flat.cpu().numpy(), shapes)
    return track_features_from_host(host, sr, hop_s, audio.shape[-1], beat_source)
