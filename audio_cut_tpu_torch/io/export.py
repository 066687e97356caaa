"""Pluggable export format registry.

Counterpart of ``audio_cut_tpu/io/export.py``: ``wav`` (PCM_24 by default,
including the pre-encoded ``pcm24_payload`` path for stems packed on the
device, ``ops/pcm.py``) and ``mp3`` (320 kbit/s through an ``ffmpeg`` binary
on PATH, from a PCM_16 temporary WAV), with per-call options merged over
each format's defaults. The splitter's ``output.format`` picks one.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

from audio_cut_tpu_torch.exceptions import AudioIOError
from audio_cut_tpu_torch.io.audio import save_audio
from audio_cut_tpu_torch.io.wavio import write_wav_payload

Exporter = Callable[[Path, np.ndarray, int, Dict[str, Any]], str]

_REGISTRY: Dict[str, "ExportFormat"] = {}


class ExportFormat:
    def __init__(self, name: str, extension: str, writer: Exporter,
                 defaults: Optional[Dict[str, Any]] = None):
        self.name = name
        self.extension = extension
        self.writer = writer
        self.defaults = dict(defaults or {})

    def write(self, path: Path, audio: np.ndarray, sr: int,
              options: Optional[Mapping[str, Any]] = None) -> str:
        opts = dict(self.defaults)
        if options:
            opts.update(options)
        return self.writer(path, audio, sr, opts)


def register_format(fmt: ExportFormat) -> None:
    _REGISTRY[fmt.name] = fmt


def get_format(name: str) -> ExportFormat:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise AudioIOError(f"unknown export format {name!r}; known: {sorted(_REGISTRY)}")


def _write_wav(path: Path, audio: np.ndarray, sr: int, opts: Dict[str, Any]) -> str:
    payload = opts.get("pcm24_payload")
    if payload is not None and str(opts.get("subtype", "PCM_24")) == "PCM_24":
        # pre-encoded device-quantized payload: no host float->int pass;
        # `audio` is the decoded equivalent for callers
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav_payload(path, payload, sr, bits=24, channels=1)
        return str(path)
    return save_audio(path, audio, sr, subtype=str(opts.get("subtype", "PCM_24")))


def _write_mp3(path: Path, audio: np.ndarray, sr: int, opts: Dict[str, Any]) -> str:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise AudioIOError("mp3 export requires an ffmpeg binary on PATH")
    bitrate = str(opts.get("bitrate", "320k"))
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=True) as tmp:
        save_audio(tmp.name, audio, sr, subtype="PCM_16")
        subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-i", tmp.name, "-b:a", bitrate, str(path)],
            check=True,
        )
    return str(path)


register_format(ExportFormat("wav", ".wav", _write_wav, {"subtype": "PCM_24"}))
register_format(ExportFormat("mp3", ".mp3", _write_mp3, {"bitrate": "320k"}))


def export_audio(
    path: Path,
    audio: np.ndarray,
    sr: int,
    fmt: str = "wav",
    options: Optional[Mapping[str, Any]] = None,
) -> str:
    fmt_obj = get_format(fmt)
    if path.suffix.lower() != fmt_obj.extension:
        # append, never with_suffix: names legitimately end in ".<digit>"
        # (duration suffixes like "_12.3") which with_suffix would mangle
        path = path.parent / (path.name + fmt_obj.extension)
    path.parent.mkdir(parents=True, exist_ok=True)
    return fmt_obj.write(path, audio, sr, options)
