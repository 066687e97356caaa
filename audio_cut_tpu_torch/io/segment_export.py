"""Segment export with the reference naming contract.

Counterpart of ``audio_cut_tpu/io/segment_export.py``. Naming parity (reference src/vocal_smart_splitter/core/utils/segment_exporter.py:26-105):
``segment_{index:03d}_{human|music}[_lib][{file_suffix}][_{dur:.1f}].{ext}``,
vocal copies under a subdir (``segments_vocal``), plus full-track export.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from audio_cut_tpu_torch.io.export import export_audio


@dataclass
class ExportResult:
    saved_files: List[str] = field(default_factory=list)
    mix_segment_files: List[str] = field(default_factory=list)
    vocal_segment_files: List[str] = field(default_factory=list)
    full_vocal_file: Optional[str] = None
    full_instrumental_file: Optional[str] = None


class SegmentExporter:
    def __init__(self, sample_rate: int = 44100) -> None:
        self.sample_rate = int(sample_rate)

    def _segment_name(
        self,
        index: int,
        is_vocal: bool,
        is_lib: bool,
        lib_suffix: str,
        file_suffix: str,
        duration_s: Optional[float],
    ) -> str:
        label = "human" if is_vocal else "music"
        parts = [f"segment_{index:03d}_{label}"]
        if is_lib:
            parts.append(lib_suffix)
        if file_suffix:
            parts.append(file_suffix)
        if duration_s is not None:
            parts.append(f"_{max(0.0, duration_s):.1f}")
        return "".join(parts)

    def export_segments(
        self,
        segments: Sequence[np.ndarray],
        output_dir: str,
        *,
        segment_is_vocal: Sequence[bool],
        export_format: str = "wav",
        export_options: Optional[Mapping[str, Any]] = None,
        lib_flags: Optional[Sequence[bool]] = None,
        lib_suffix: str = "_lib",
        subdir: Optional[str] = None,
        file_suffix: str = "",
        index_offset: int = 1,
        always_append_duration: bool = True,
    ) -> List[str]:
        base_dir = Path(output_dir)
        if subdir:
            base_dir = base_dir / subdir
        base_dir.mkdir(parents=True, exist_ok=True)

        saved: List[str] = []
        for i, audio in enumerate(segments):
            is_vocal = bool(segment_is_vocal[i]) if i < len(segment_is_vocal) else True
            is_lib = bool(lib_flags[i]) if lib_flags is not None and i < len(lib_flags) else False
            duration_s = len(audio) / float(self.sample_rate) if always_append_duration else None
            name = self._segment_name(i + index_offset, is_vocal, is_lib, lib_suffix, file_suffix, duration_s)
            saved.append(
                export_audio(base_dir / name, audio, self.sample_rate, export_format, export_options)
            )
        return saved

    def export_full_track(
        self,
        audio: np.ndarray,
        output_base: Path,
        *,
        export_format: str = "wav",
        export_options: Optional[Mapping[str, Any]] = None,
    ) -> str:
        return export_audio(Path(output_base), audio, self.sample_rate, export_format, export_options)
