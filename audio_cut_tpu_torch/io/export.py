"""Stem and segment export.

Counterpart of ``audio_cut_tpu/io/export.py`` for its ``wav`` format (PCM_24
by default, per-call options merged over it), including the pre-encoded
``pcm24_payload`` path for stems packed on the device (``ops/pcm.py``). The
JAX package's ffmpeg-backed mp3 format is not in this slice of the port
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np

from audio_cut_tpu_torch.exceptions import AudioIOError
from audio_cut_tpu_torch.io.audio import save_audio
from audio_cut_tpu_torch.io.wavio import write_wav_payload

_WAV_DEFAULTS = {"subtype": "PCM_24"}


def export_audio(
    path: Path,
    audio: np.ndarray,
    sr: int,
    fmt: str = "wav",
    options: Optional[Mapping[str, Any]] = None,
) -> str:
    if fmt != "wav":
        raise AudioIOError(f"unknown export format {fmt!r}; the PyTorch port writes 'wav'")
    opts = {**_WAV_DEFAULTS, **dict(options or {})}
    if path.suffix.lower() != ".wav":
        # append, never with_suffix: names legitimately end in ".<digit>"
        # (duration suffixes like "_12.3") which with_suffix would mangle
        path = path.parent / (path.name + ".wav")
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = opts.get("pcm24_payload")
    if payload is not None and str(opts["subtype"]) == "PCM_24":
        # pre-encoded device-quantized payload: no host float->int pass;
        # `audio` is the decoded equivalent for callers
        write_wav_payload(path, payload, sr, bits=24, channels=1)
        return str(path)
    return save_audio(path, audio, sr, subtype=str(opts["subtype"]))
