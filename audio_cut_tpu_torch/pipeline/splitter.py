"""SmartSplitter: the mode-dispatch orchestrator.

Counterpart of ``audio_cut_tpu/pipeline/splitter.py``. The port runs
``v2.2_mdd`` (the default: pause detection, guards, layout, segments; on the
fused pass, or on the staged path with ``device_pipeline.fused_program:
false``), ``vpbd_acoustic`` and ``vpbd_asr`` (the unified candidate pool,
the phrase scorer and the DP planner before the same guards and layout;
``vpbd_asr`` adds lyric candidates when lyrics alignment is on), ``hybrid_mdd`` (the
``v2.2_mdd`` cuts snapped to beats, with _lib tags, on the sub-run's device
pass) and ``vocal_separation`` (stems only); ``librosa_onset`` raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.io.audio import load_audio
from audio_cut_tpu_torch.io.segment_export import SegmentExporter
from audio_cut_tpu_torch.pipeline.result import ResultBuilder

KNOWN_MODES = (
    "vocal_separation",
    "v2.2_mdd",
    "librosa_onset",
    "hybrid_mdd",
    "vpbd_acoustic",
    "vpbd_asr",
)

_NOT_PORTED = {
    "librosa_onset": "the other modes",
}


class SmartSplitter:
    def __init__(self, device: torch.device, sample_rate: Optional[int] = None) -> None:
        self.device = torch.device(device)
        self.sample_rate = int(sample_rate or get_config("audio.sample_rate", 44100))
        self.result_builder = ResultBuilder()
        self.segment_exporter = SegmentExporter(self.sample_rate)
        self._export_format = str(get_config("output.format", "wav"))
        self._export_options = dict(get_config("output.wav", {}) or {})
        self._separator = None  # created on first use
        # a hybrid_mdd run asks its v2.2_mdd sub-run to stash the device
        # pass (key, audio, stems, bundle) here, and pops it
        self._want_fused_pass_memo = False
        self._fused_pass_memo = None

    def split_audio_seamlessly(
        self,
        input_path: str,
        output_dir: str,
        mode: str = "v2.2_mdd",
        export_plan: Optional[Sequence[str]] = None,
    ) -> Dict[str, Any]:
        if mode not in KNOWN_MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {KNOWN_MODES}")
        if mode in _NOT_PORTED:
            raise NotImplementedError(
                f"mode {mode!r} is not in the PyTorch port yet: ROADMAP.md, queue 1, "
                f"'{_NOT_PORTED[mode]}'")
        Path(output_dir).mkdir(parents=True, exist_ok=True)

        if mode in ("v2.2_mdd", "vpbd_acoustic", "vpbd_asr"):
            from audio_cut_tpu_torch.pipeline.modes.pure_vocal import process_pure_vocal_split

            return process_pure_vocal_split(self, input_path, output_dir, mode=mode,
                                            export_plan=export_plan)
        if mode == "hybrid_mdd":
            from audio_cut_tpu_torch.pipeline.modes.hybrid import process_hybrid_mdd

            return process_hybrid_mdd(self, input_path, output_dir, export_plan=export_plan)
        from audio_cut_tpu_torch.pipeline.modes.separation_mode import process_vocal_separation

        return process_vocal_separation(self, input_path, output_dir, export_plan=export_plan)

    @property
    def separator(self):
        if self._separator is None:
            from audio_cut_tpu_torch.separation.engine import SeparationEngine

            self._separator = SeparationEngine(self.sample_rate, self.device)
        return self._separator

    def _load(self, input_path: str) -> np.ndarray:
        audio, _sr = load_audio(input_path, target_sr=self.sample_rate, mono=True)
        return audio

    @staticmethod
    def _normalize_export_plan(
        export_plan: Optional[Sequence[str]], default: Sequence[str]
    ) -> set:
        if export_plan is None:
            return set(default)
        plan = {str(p) for p in export_plan}
        if "none" in plan:
            return set()
        return plan
