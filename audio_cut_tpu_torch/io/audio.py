"""Audio load/save/resample helpers (host side).

Counterpart of ``audio_cut_tpu/io/audio.py``: WAV decode through the port's
own codec, mono mix, and polyphase resampling with
``scipy.signal.resample_poly`` in float32, as the JAX package does. The
ffmpeg decode of compressed formats and the device ASR copy are not part of
this slice of the port (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy import signal as _signal

from audio_cut_tpu_torch.exceptions import AudioIOError
from audio_cut_tpu_torch.io.wavio import read_wav, write_wav

_SUPPORTED_EXTS = {".wav", ".wave"}


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 1:
        return audio
    return np.mean(audio, axis=-1, dtype=np.float32)


def resample_poly(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample along the time axis (axis 0), float32 end to end."""
    if sr_in == sr_out:
        return audio
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    out = _signal.resample_poly(np.asarray(audio, dtype=np.float32), up, down, axis=0)
    return np.asarray(out, dtype=np.float32)


def load_audio(
    path: Union[str, Path],
    target_sr: Optional[int] = None,
    mono: bool = True,
    normalize: bool = False,
) -> Tuple[np.ndarray, int]:
    """Load a WAV file as float32, optionally mono/resampled/normalized."""
    p = Path(path)
    if not p.exists():
        raise AudioIOError(f"audio file not found: {p}")
    ext = p.suffix.lower()
    if ext not in _SUPPORTED_EXTS:
        raise AudioIOError(
            f"unsupported audio format {ext!r} for {p.name}: the PyTorch port "
            "reads WAV only so far (ffmpeg decode: ROADMAP.md, queue 1)"
        )
    audio, sr = read_wav(p)
    if mono:
        audio = to_mono(audio)
    if target_sr is not None and target_sr != sr:
        audio = resample_poly(audio, sr, target_sr)
        sr = int(target_sr)
    if normalize:
        peak = float(np.max(np.abs(audio))) if audio.size else 0.0
        if peak > 0:
            audio = audio / peak
    return np.ascontiguousarray(audio, dtype=np.float32), sr


def save_audio(
    path: Union[str, Path],
    audio: np.ndarray,
    sample_rate: int,
    subtype: str = "PCM_24",
) -> str:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    write_wav(p, audio, sample_rate, subtype=subtype)
    return str(p)
