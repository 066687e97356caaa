"""Vocal Phrase Boundary Detector: the unified candidate pool of the vpbd modes.

Counterpart of ``audio_cut_tpu/detection/vpbd.py``: acoustic candidates
(pauses, and breaths scaled by ``vpbd.breath_score_scale``), chorus-gated
weak-beat candidates, the +-120 ms pool merge with ``meta.sources``
provenance, vectorised boundary features and weighted scoring, the MDD
valley anchor times, the DP planner and the optional candidate debug JSON.
``vpbd.candidate_pool: legacy`` pins the acoustic-only pool.

The detector reads the detection bundle of the fused pass and never the
host waveform. ``vpbd_asr`` with ``lyrics_alignment.enabled`` aligns lyrics
through the configured provider (``lyrics/providers.py``) over a 16 kHz
PCM_16 copy of the vocal stem, made on the stem's device
(``io/audio.write_asr_copy_from_device``); the timeline's words, sentences
and mVAD regions then add lyric candidates to the pool. Without a timeline
(lyrics off, no provider, an unavailable provider or a provider that fails)
``vpbd_asr`` runs the acoustic path (effective mode ``vpbd.fallback_mode``)
with ``note = "lyrics_unavailable:<reason>"``; ``lyrics_alignment.strict``
raises instead.

Unlike the JAX package, the device ASR copy has no host fallback, and it
runs outside the ``try`` that turns a provider's failure into
``provider_error``: a failed copy raises, strict or not.
"""

from __future__ import annotations

import logging
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np

from audio_cut_tpu_torch.analysis.boundary_features import BoundaryFeatureExtractor
from audio_cut_tpu_torch.analysis.features import TrackFeatures
from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.cutting.beat_candidates import generate_beat_candidates
from audio_cut_tpu_torch.cutting.candidates import (
    CandidateSource,
    CutCandidate,
    adapt_acoustic_pauses,
    merge_candidate_pool,
)
from audio_cut_tpu_torch.cutting.planner import (
    GlobalCutPlanner,
    GlobalCutPlannerConfig,
    GlobalCutPlanResult,
)
from audio_cut_tpu_torch.cutting.scorer import PhraseBoundaryScorer, write_candidate_debug_json
from audio_cut_tpu_torch.detection.pause_detector import PureVocalPauseDetector
from audio_cut_tpu_torch.exceptions import LyricsAlignmentUnavailable
from audio_cut_tpu_torch.lyrics.candidates import LyricsBoundaryCandidateGenerator
from audio_cut_tpu_torch.lyrics.models import LyricsTimeline
from audio_cut_tpu_torch.lyrics.providers import (
    AlignRequest,
    NullLyricsProvider,
    build_lyrics_provider,
)

if TYPE_CHECKING:
    from audio_cut_tpu_torch.separation.engine import SeparationResult

logger = logging.getLogger(__name__)


@dataclass
class VPBDDetectionResult:
    selected: List[CutCandidate]
    suppressed: List[CutCandidate]
    plan: GlobalCutPlanResult
    candidate_counts: Dict[str, int] = field(default_factory=dict)
    timeline: Optional[LyricsTimeline] = None
    lyrics_alignment: Optional[Dict[str, Any]] = None
    note: Optional[str] = None

    def to_meta(self) -> Dict[str, Any]:
        return {
            "candidate_counts": dict(self.candidate_counts),
            "selected": [c.to_dict() for c in self.selected],
            "suppressed": [c.to_dict() for c in self.suppressed[:200]],
            "planner": dict(self.plan.metadata),
        }


class VocalPhraseBoundaryDetector:
    def __init__(self, sample_rate: int) -> None:
        self.sr = int(sample_rate)

    def detect(
        self,
        *,
        mode: str,
        features: TrackFeatures,
        focus_windows: Optional[List[Tuple[float, float]]],
        duration_s: float,
        bundle,
        output_dir: Optional[str] = None,
        stems: Optional[SeparationResult] = None,
    ) -> VPBDDetectionResult:
        """Candidates, scores and the plan, from the bundle's envelopes.
        ``stems.vocal_device`` is the vocal stem on its device, from which
        ``vpbd_asr`` makes the ASR copy when it aligns lyrics. The legacy
        multi-feature detector (``enable_relative_energy_mode: false``) runs
        YIN and LPC on it, and also reads its host copy
        ``stems.vocal_track``."""
        effective_mode = mode
        timeline: Optional[LyricsTimeline] = None
        lyrics_meta: Optional[Dict[str, Any]] = None
        note: Optional[str] = None

        # -- lyrics priors (vpbd_asr only) -----------------------------------
        if mode == "vpbd_asr":
            timeline, lyrics_meta, fallback_reason = self._align_lyrics(
                stems.vocal_device if stems is not None else None, duration_s)
            if timeline is None:
                effective_mode = str(get_config("vpbd.fallback_mode", "vpbd_acoustic"))
                note = f"lyrics_unavailable:{fallback_reason}"
                logger.warning("vpbd_asr falling back to %s (%s)", effective_mode, fallback_reason)
        if timeline is None:
            timeline = LyricsTimeline()

        # -- candidate pools ---------------------------------------------------
        pause_detector = PureVocalPauseDetector(self.sr)
        n_samples = int(duration_s * self.sr)
        pauses = pause_detector.detect_pure_vocal_pauses(
            features=features, focus_windows=focus_windows, enable_mdd=True,
            rms_env=bundle.vocal_rms_fine,
            env_db_grid=bundle.vocal_db_fine,
            env_db_stride=bundle.db_stride,
            n_samples=n_samples,
            stems=stems,
        )
        breath_range = tuple(get_config("v2_mdd.pure_vocal_detection.breath_duration_range", [0.1, 0.3]))
        acoustic = adapt_acoustic_pauses(
            pauses,
            breath_range=breath_range,  # type: ignore[arg-type]
            breath_score_scale=float(get_config("vpbd.breath_score_scale", 0.6)),
        )

        # candidate_pool=legacy pins the acoustic-only pool: no weak-beat and
        # no lyrics candidates enter the planner
        pool_mode = str(get_config("vpbd.candidate_pool", "unified"))

        beat_pool: List[CutCandidate] = []
        bc_cfg = get_config("vpbd.beat_candidates", {}) or {}
        if pool_mode != "legacy" and bc_cfg.get("enable", True):
            beat_pool = generate_beat_candidates(
                features,
                vocal_rms=bundle.vocal_rms_grid,
                bars_per_cut=int(bc_cfg.get("bars_per_cut", 2)),
                base_score=float(bc_cfg.get("base_score", 0.3)),
            )

        lyric_pool: List[CutCandidate] = []
        if (
            pool_mode != "legacy"
            and effective_mode == "vpbd_asr"
            and (timeline.words or timeline.sentences or timeline.vad_regions)
        ):
            lyric_pool = LyricsBoundaryCandidateGenerator().generate(timeline)
        pool = merge_candidate_pool([acoustic, beat_pool, lyric_pool], cluster_ms=120.0)
        counts = {
            "acoustic": len(acoustic),
            "beat": len(beat_pool),
            "lyrics": len(lyric_pool),
            "merged": len(pool),
            "pool_mode": pool_mode,
        }

        # -- scoring ------------------------------------------------------------
        mdd_times = self._mdd_valley_times(features)
        extractor = BoundaryFeatureExtractor(
            timeline=timeline,
            beat_times=features.beat_times,
            mdd_times=mdd_times,
            rms_series=features.rms,
            hop_s=features.hop_s,
            word_edge_tolerance_ms=float(get_config("phrase_boundary.word_edge_tolerance_ms", 60.0)),
        )
        acoustic_strength = [
            c.score if c.source in (CandidateSource.ACOUSTIC_PAUSE, CandidateSource.MDD_VALLEY) else 0.0
            for c in pool
        ]
        breath_strength = [c.score if c.source == CandidateSource.BREATH else 0.0 for c in pool]
        feats = extractor.extract_batch(
            [c.t for c in pool], acoustic_pause=acoustic_strength, breath=breath_strength
        )
        scorer = PhraseBoundaryScorer.from_config()
        scored = [scorer.score_candidate(c, f) for c, f in zip(pool, feats)]

        # -- planning -----------------------------------------------------------
        planner = GlobalCutPlanner(GlobalCutPlannerConfig.from_config())
        plan = planner.plan(scored, duration_s=duration_s)

        if output_dir and bool(get_config("vpbd.candidate_debug_json", True)):
            try:
                write_candidate_debug_json(scored, Path(output_dir) / "vpbd_candidates_debug.json")
            except OSError:
                logger.debug("candidate debug json write failed", exc_info=True)

        return VPBDDetectionResult(
            selected=plan.selected_candidates,
            suppressed=plan.suppressed_candidates,
            plan=plan,
            candidate_counts=counts,
            timeline=timeline,
            lyrics_alignment=lyrics_meta,
            note=note,
        )

    # -- helpers -------------------------------------------------------------

    def _align_lyrics(
        self, vocal_device, duration_s: float
    ) -> Tuple[Optional[LyricsTimeline], Optional[Dict[str, Any]], Optional[str]]:
        """(timeline, lyrics meta, fallback reason); no timeline when
        lyrics alignment is off, has no provider, or its provider is
        unavailable or fails, unless ``lyrics_alignment.strict``."""
        enabled = bool(get_config("lyrics_alignment.enabled", False))
        strict = bool(get_config("lyrics_alignment.strict", False))
        if not enabled:
            return None, None, "disabled"
        provider = build_lyrics_provider(strict=strict)
        if isinstance(provider, NullLyricsProvider) and not strict:
            return None, {"provider": provider.name, "fallback_reason": "no_provider"}, "no_provider"
        unavailable = (None, {"provider": provider.name, "fallback_reason": "unavailable"},
                       "unavailable")
        if not provider.available():
            if strict:
                raise LyricsAlignmentUnavailable(f"provider {provider.name} unavailable")
            return unavailable
        from audio_cut_tpu_torch.io.audio import write_asr_copy_from_device

        with tempfile.TemporaryDirectory() as td:
            asr_path = str(Path(td) / "vocal_16k.wav")
            # on the stem's device; its failure is no provider's and raises
            write_asr_copy_from_device(vocal_device, self.sr, asr_path)
            try:
                timeline = provider.align(AlignRequest(audio_path=asr_path, duration_s=duration_s))
            except LyricsAlignmentUnavailable:
                if strict:
                    raise
                return unavailable
            except Exception as exc:  # an external ASR worker failed: degrade
                if strict:
                    raise
                logger.warning("lyrics provider failed: %s", exc)
                return None, {"provider": provider.name,
                              "fallback_reason": str(exc)[:200]}, "provider_error"
        timeline.duration_s = timeline.duration_s or duration_s
        meta = {
            "provider": provider.name,
            "timeline": timeline.to_dict(),
            "word_count": len(timeline.words),
            "sentence_count": len(timeline.sentences),
        }
        return timeline, meta, None

    @staticmethod
    def _mdd_valley_times(features: TrackFeatures) -> List[float]:
        """Local minima of the MDD series as soft anchors."""
        mdd = features.mdd
        if mdd.size < 3:
            return []
        interior = (mdd[1:-1] < mdd[:-2]) & (mdd[1:-1] <= mdd[2:])
        idx = np.nonzero(interior)[0] + 1
        # keep only reasonably low valleys
        low = mdd[idx] <= np.percentile(mdd, 40)
        return [float(i * features.hop_s) for i in idx[low]]
