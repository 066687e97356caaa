"""Audio load/save/resample helpers (host side).

Counterpart of ``audio_cut_tpu/io/audio.py``: WAV decode through the port's
own codec; mp3, flac, m4a, mp4, ogg, opus, aac and wma through an ``ffmpeg``
subprocess (``ffprobe`` for the rate and channels), with the JAX package's
command lines and errors; mono mix, polyphase resampling with
``scipy.signal.resample_poly`` in float32, as the JAX package does, and the
16 kHz PCM_16 copy an ASR worker reads, made from a stem on its device
(``write_asr_copy_from_device``). The JAX package's host copy
(``write_asr_copy``) is its fallback when the device copy fails; the port has
no such fallback, so it has no host copy.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy import signal as _signal

from audio_cut_tpu_torch.exceptions import AudioIOError
from audio_cut_tpu_torch.io.wavio import read_wav, write_wav, write_wav_payload

_SUPPORTED_EXTS = {".wav", ".wave"}
_FFMPEG_EXTS = {".mp3", ".flac", ".m4a", ".mp4", ".ogg", ".opus", ".aac", ".wma"}
_UNSUPPORTED_HINT = (
    "cannot decode {src}: no ffmpeg on PATH and no {ext} decoder is bundled; "
    "install ffmpeg or convert with `ffmpeg -i {src} -acodec pcm_s24le out.wav` first"
)


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _decode_via_ffmpeg(path: Path) -> Tuple[np.ndarray, int]:
    """Decode a compressed file to float32 through ``ffmpeg`` on PATH:
    ``ffprobe`` gives the first audio stream's rate and channels (44.1 kHz
    stereo when it fails), ``ffmpeg`` the interleaved raw samples."""
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "a:0",
         "-show_entries", "stream=sample_rate,channels", "-of", "json", str(path)],
        capture_output=True,
    )
    sr, channels = 44100, 2
    if probe.returncode == 0:
        try:
            info = json.loads(probe.stdout)["streams"][0]
            sr = int(info.get("sample_rate", sr))
            channels = int(info.get("channels", channels))
        except (KeyError, IndexError, ValueError, json.JSONDecodeError):
            pass
    proc = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", str(path),
         "-f", "f32le", "-acodec", "pcm_f32le", "-"],
        capture_output=True,
    )
    if proc.returncode != 0:
        raise AudioIOError(
            f"ffmpeg failed to decode {path.name}: {proc.stderr.decode(errors='replace')[:300]}"
        )
    flat = np.frombuffer(proc.stdout, dtype="<f4")
    if channels > 1:
        flat = flat[: (flat.size // channels) * channels].reshape(-1, channels)
    return flat.astype(np.float32), sr


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
    """Load an audio file as float32, optionally mono/resampled/normalized."""
    p = Path(path)
    if not p.exists():
        raise AudioIOError(f"audio file not found: {p}")
    ext = p.suffix.lower()
    if ext in _SUPPORTED_EXTS:
        audio, sr = read_wav(p)
    elif ext in _FFMPEG_EXTS:
        if not ffmpeg_available():
            raise AudioIOError(_UNSUPPORTED_HINT.format(src=p.name, ext=ext))
        audio, sr = _decode_via_ffmpeg(p)
    else:
        raise AudioIOError(
            f"unsupported audio format {ext!r} for {p.name}; "
            f"supported: wav natively, {sorted(_FFMPEG_EXTS)} via ffmpeg"
        )
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


def write_asr_copy_from_device(
    audio_device,
    sample_rate: int,
    dest: Union[str, Path],
    asr_sr: int = 16000,
) -> str:
    """The ASR copy from a stem on its device: resampled to ``asr_sr`` by one
    float32 matrix product (``ops/resample.py``) and rounded to PCM_16 there
    (``ops/pcm.py``), so only int16 at 16 kHz crosses to the host. The stem
    is zero-padded to ``padded_track_len`` first, as in the JAX package; the
    padding's filter bleed lies past the copy's length, which the host slices
    to."""
    import torch.nn.functional as F

    from audio_cut_tpu_torch.ops.pcm import pcm16_pack_graph
    from audio_cut_tpu_torch.ops.resample import resample_graph
    from audio_cut_tpu_torch.separation.engine import padded_track_len

    n = int(audio_device.shape[-1])
    padded = padded_track_len(n, sample_rate)
    out_len = int(round(n * asr_sr / sample_rate))
    xp = F.pad(audio_device, (0, padded - n))
    i16 = pcm16_pack_graph(resample_graph(xp, sample_rate, asr_sr))[:out_len].cpu().numpy()
    p = Path(dest)
    p.parent.mkdir(parents=True, exist_ok=True)
    write_wav_payload(p, i16.astype("<i2").tobytes(), asr_sr, bits=16, channels=1)
    return str(p)
