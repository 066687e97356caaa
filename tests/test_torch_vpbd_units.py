"""The vpbd modules of the port against the JAX package's, on the same seeded
numpy inputs: the config manager's runtime keys and generation, the schema-v3
expansion, the style profiles, AutoProfile (intent, style estimate,
interpolated overrides), the lyrics timeline, chorus regions, beat
candidates, the candidate adapters and the pool merge, the boundary
features, the scorer, the DP planner and its guard-shift metadata, the MDD
valley anchors, and the pre-guard valley snap and local valley refine.
Inputs follow ``tests/unit/test_planner_scorer.py``, ``test_auto_profile.py``
and ``test_valley_snap.py`` where they fit.

Tolerance: none. Every module is host numpy (or plain Python) with the same
operations in the same order on equal inputs, so each output is equal to the
JAX package's exactly, float for float.
"""

import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

REPO = Path(__file__).resolve().parents[1]
HOP = 0.05


# -- helpers ----------------------------------------------------------------


def _features(pkg: str, seed: int, *, n: int = 600, bpm: float = 120.0, loud_from: int = 300):
    """One TrackFeatures per package from the same seeded arrays: a 30 s
    grid, beats at ``bpm``, a louder, less flat section from ``loud_from``."""
    if pkg == "jax":
        from audio_cut_tpu.analysis.features import TrackFeatures
    else:
        from audio_cut_tpu_torch.analysis.features import TrackFeatures
    rng = np.random.default_rng(seed)
    rms = (0.05 + 0.02 * rng.random(n)).astype(np.float32)
    rms[loud_from:] *= 3.0 + rng.random(n - loud_from).astype(np.float32)
    flat = (0.4 + 0.2 * rng.random(n)).astype(np.float32)
    flat[loud_from:] *= 0.3
    onset = rng.random(n).astype(np.float32)
    mdd = np.clip(0.4 + 0.3 * np.sin(np.arange(n) / 7.0) + 0.1 * rng.standard_normal(n), 0, 1)
    beats = np.arange(0.0, n * HOP, 60.0 / bpm) + 0.013 * seed
    return TrackFeatures(sr=44100, hop_s=HOP, duration_s=n * HOP, rms=rms, flatness=flat,
                         onset=onset, mdd=mdd.astype(np.float32), bpm=bpm, tempo_strength=0.8,
                         beat_times=beats, extras={"vocal_coverage_ratio": 0.6})


def _candidates(pkg: str, seed: int, count: int, duration: float):
    if pkg == "jax":
        from audio_cut_tpu.cutting.candidates import CandidateSource, CutCandidate
    else:
        from audio_cut_tpu_torch.cutting.candidates import CandidateSource, CutCandidate
    rng = np.random.default_rng(seed)
    sources = list(CandidateSource)
    out = []
    for i in range(count):
        feats = {"vocal_cut_risk": float(rng.random()), "beat_conflict": float(rng.random())}
        out.append(CutCandidate(t=float(rng.uniform(-1.0, duration + 1.0)),
                                score=float(rng.uniform(-0.2, 1.2)),
                                source=sources[int(rng.integers(len(sources)))],
                                reasons=[f"r{int(rng.integers(3))}"], features=feats,
                                meta={"i": i}))
    return out


def _timeline(pkg: str):
    if pkg == "jax":
        from audio_cut_tpu.lyrics.models import LyricsTimeline, Sentence, VadRegion, Word
    else:
        from audio_cut_tpu_torch.lyrics.models import LyricsTimeline, Sentence, VadRegion, Word
    return LyricsTimeline(
        words=[Word("aa", 1.0, 2.0, 0.9), Word("bb", 3.0, 4.0, 0.9), Word("cc", 4.5, 5.0),
               Word("dd", 6.0, 7.5, 0.5)],
        sentences=[Sentence("aa bb.", 1.0, 4.0, 0.9), Sentence("cc dd", 4.5, 7.5)],
        vad_regions=[VadRegion(0.8, 4.2, "singing", 0.9), VadRegion(4.4, 7.6, "singing")],
    )


def _plan_dict(res):
    return {
        "cut_times": res.cut_times,
        "selected": [c.to_dict() for c in res.selected_candidates],
        "suppressed": [c.to_dict() for c in res.suppressed_candidates],
        "rescue": res.rescue_points,
        "feasible": res.feasible,
        "metadata": res.metadata,
    }


# -- config ------------------------------------------------------------------


def test_runtime_keys_and_generation_follow_the_jax_manager():
    from audio_cut_tpu.config.manager import ConfigManager as JaxManager
    from audio_cut_tpu_torch.config.manager import ConfigManager as TorchManager

    def trace(mgr):
        out = [mgr.generation(), sorted(mgr.runtime_override_keys())]
        snap = mgr.snapshot()
        mgr.set_runtime({"smart_cut.alignment": "beat", "global_planner.hard_max_s": 9.0})
        out += [mgr.generation(), sorted(mgr.runtime_override_keys()),
                mgr.get("global_planner.hard_max_s")]
        mgr.restore(snap)  # the API's restore after a call: the keys survive it
        out += [mgr.generation(), sorted(mgr.runtime_override_keys()),
                mgr.get("global_planner.hard_max_s")]
        mgr.set_runtime({"vpbd.candidate_pool": "legacy"})
        out += [mgr.generation(), sorted(mgr.runtime_override_keys())]
        mgr.reset_runtime()
        out += [mgr.generation(), sorted(mgr.runtime_override_keys()),
                mgr.get("vpbd.candidate_pool")]
        return out

    assert trace(TorchManager()) == trace(JaxManager())


def test_profiles_json_is_the_jax_yaml():
    yaml = pytest.importorskip("yaml")
    port = json.loads((REPO / "audio_cut_tpu_torch" / "config" / "profiles.json").read_text())
    want = {p.stem: yaml.safe_load(p.read_text())
            for p in (REPO / "audio_cut_tpu" / "config" / "profiles").glob("*.yaml")}
    assert port == want and sorted(port) == ["ballad", "edm", "pop", "rap"]


@pytest.mark.parametrize("name", ["ballad", "edm", "pop", "rap"])
def test_profile_override_maps(name):
    from audio_cut_tpu.config import auto_profile as J
    from audio_cut_tpu.config.derive import build_legacy_overrides as jax_legacy
    from audio_cut_tpu_torch.config import auto_profile as T
    from audio_cut_tpu_torch.config.derive import build_legacy_overrides as torch_legacy

    assert dataclasses.asdict(T.load_profile(name)) == dataclasses.asdict(J.load_profile(name))
    assert torch_legacy(T.load_profile(name)) == jax_legacy(J.load_profile(name))
    assert T.profile_override_map(name) == J.profile_override_map(name)


def test_unknown_profile_raises_file_not_found():
    from audio_cut_tpu_torch.config.auto_profile import load_profile

    with pytest.raises(FileNotFoundError, match="unknown style profile 'metal'"):
        load_profile("metal")


INTENTS = [
    {},
    {"segments": "few"}, {"segments": "medium"}, {"segments": "many"},
    {"segments": [6, 14]}, {"segments": (4.0, 9.0)},
    {"alignment": "lyric"}, {"alignment": "lyric_lean"}, {"alignment": "balanced"},
    {"alignment": "beat_lean"}, {"alignment": "beat"}, {"alignment": 0.3},
    {"alignment": "0.85"}, {"alignment": 0.5},
    {"segments": "few", "target_duration_s": [4, 9]},
    {"segments": "many", "target_duration_s": [5.0, 12.0]},
    {"cut_style": "rhythmic"}, {"cut_style": "dense"}, {"cut_style": "natural"},
    {"cut_style": "rhythmic", "alignment": "lyric"}, {"cut_style": "dense", "segments": "few"},
    {"profile": "Ballad", "lyrics": "off"},
    {"alignment": "nonsense"}, {"alignment": 1.5}, {"segments": "lots"}, {"segments": [5, 3]},
]


@pytest.mark.parametrize("explicit", [(), ("smart_cut.alignment", "smart_cut.segments")])
@pytest.mark.parametrize("i", range(len(INTENTS)))
def test_resolve_smart_cut_intent(i, explicit):
    from audio_cut_tpu.config import auto_profile as J
    from audio_cut_tpu_torch.config import auto_profile as T

    def run(mod):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                got = mod.resolve_smart_cut_intent(dict(INTENTS[i]), explicit_keys=set(explicit))
                over = mod.derive_smart_cut_overrides(dict(INTENTS[i]), explicit_keys=set(explicit))
                align = mod.derive_alignment_overrides(
                    got["alignment"], mod.STYLE_WEIGHTS["rap"],
                    alignment_poles={"beat": {"beat_affinity": 0.4}})
            except (ValueError, TypeError) as exc:
                # a list ``segments`` that is not an explicit key reaches a
                # set lookup in the JAX package and raises TypeError; the port
                # keeps that
                return (type(exc).__name__, str(exc))
        return got, over, align, [(w.category, str(w.message)) for w in caught]

    assert run(T) == run(J)


STYLES = [  # (bpm, energy cv, mdd, coverage, tempo strength): across estimate_style's thresholds
    (0.0, 0.3, 0.4, 0.6, 0.8), (100.0, 0.3, 0.4, 0.6, 0.01),
    (70.0, 0.1, 0.4, 0.6, 0.8), (88.0, 0.2, 0.4, 0.6, 0.8), (88.5, 0.2, 0.4, 0.6, 0.8),
    (130.0, 0.9, 0.4, 0.5, 0.8), (122.0, 0.7, 0.4, 0.55, 0.8), (121.0, 0.9, 0.4, 0.5, 0.8),
    (125.0, 0.3, 0.5, 0.7, 0.8), (118.0, 0.3, 0.45, 0.68, 0.8), (118.0, 0.3, 0.44, 0.68, 0.8),
    (105.0, 0.3, 0.4, 0.6, 0.8), (150.0, 0.3, 0.4, 0.6, 0.8), (175.0, 0.3, 0.4, 0.6, 0.8),
]


class _Feats:
    def __init__(self, bpm, cv, mdd, coverage, strength):
        rng = np.random.default_rng(0)
        base = np.abs(rng.standard_normal(100)) * cv + 1.0
        self.rms = (base / base.mean() * 0.2).astype(np.float32)
        self.mdd = np.full(100, mdd, np.float32)
        self.bpm = bpm
        self.tempo_strength = strength
        self.extras = {"vocal_coverage_ratio": coverage}


@pytest.mark.parametrize("cut_style", ["natural", "rhythmic"])
@pytest.mark.parametrize("i", range(len(STYLES)))
def test_estimate_style_and_auto_profile_overrides(i, cut_style):
    from audio_cut_tpu.config import auto_profile as J
    from audio_cut_tpu_torch.config import auto_profile as T

    def run(mod):
        est = mod.estimate_style(_Feats(*STYLES[i]))
        return dataclasses.asdict(est), mod.build_auto_profile_overrides(est, cut_style=cut_style)

    assert run(T) == run(J)


@pytest.mark.parametrize("style", ["ballad", "pop", "rap", "edm"])
@pytest.mark.parametrize("confidence", [0.5, 0.8])
def test_auto_profile_overrides_for_each_style(style, confidence):
    from audio_cut_tpu.config import auto_profile as J
    from audio_cut_tpu_torch.config import auto_profile as T

    feats = {"bpm": 95.0, "global_mdd": 0.4, "energy_cv": 0.3, "vocal_coverage_ratio": 0.6}
    got = T.build_auto_profile_overrides(T.StyleEstimate(style, confidence, dict(feats)))
    want = J.build_auto_profile_overrides(J.StyleEstimate(style, confidence, dict(feats)))
    assert got == want


# -- lyrics timeline ------------------------------------------------------------


def test_lyrics_timeline_round_trip_and_validation():
    from audio_cut_tpu.exceptions import TimelineValidationError as JaxError
    from audio_cut_tpu.lyrics.models import LyricsTimeline as JaxTimeline
    from audio_cut_tpu_torch.exceptions import TimelineValidationError as TorchError
    from audio_cut_tpu_torch.lyrics.models import LyricsTimeline as TorchTimeline

    data = {"words": [{"text": "b", "start_s": 3.0, "end_s": 4.0, "confidence": 0.9},
                      {"text": "a", "start_s": 1.0, "end_s": 2.0},
                      {"text": "bad", "start_s": 2.0, "end_s": 1.0}],
            "sentences": [{"text": "a b", "start_s": 1.0, "end_s": 10.003}],
            "vad_regions": [{"start_s": 0.5, "end_s": 4.5, "kind": "singing"}],
            "duration_s": 10.0, "language": "en", "source": "fixture",
            "forbidden_cut_times_s": [5.0, 2.0]}
    got = TorchTimeline.from_dict(data, strict=False)
    want = JaxTimeline.from_dict(data, strict=False)
    assert got.to_dict() == want.to_dict()
    assert got.word_intervals() == want.word_intervals()
    assert got.shift(1.5).to_dict() == want.shift(1.5).to_dict()
    with pytest.raises(TorchError):
        TorchTimeline.from_dict(data, strict=True)
    with pytest.raises(JaxError):
        JaxTimeline.from_dict(data, strict=True)


# -- analysis -------------------------------------------------------------------


@pytest.mark.parametrize("seed, bpm, loud_from", [(0, 120.0, 300), (1, 96.0, 200),
                                                  (2, 150.0, 450), (3, 128.0, 0)])
def test_chorus_regions_and_beat_candidates(seed, bpm, loud_from):
    from audio_cut_tpu.analysis.chorus import detect_chorus_regions as jax_chorus
    from audio_cut_tpu.cutting.beat_candidates import generate_beat_candidates as jax_beats
    from audio_cut_tpu_torch.analysis.chorus import detect_chorus_regions as torch_chorus
    from audio_cut_tpu_torch.cutting.beat_candidates import generate_beat_candidates as torch_beats

    fj = _features("jax", seed, bpm=bpm, loud_from=loud_from)
    ft = _features("torch", seed, bpm=bpm, loud_from=loud_from)
    bars = np.asarray(fj.beat_times)[::4]
    rj, mj = jax_chorus(fj, bars)
    rt, mt = torch_chorus(ft, bars)
    assert [dataclasses.asdict(r) for r in rt] == [dataclasses.asdict(r) for r in rj]
    np.testing.assert_array_equal(mt, mj)
    vocal_rms = np.random.default_rng(seed + 10).random(fj.n_frames).astype(np.float32)
    for kwargs in ({}, {"vocal_rms": vocal_rms, "bars_per_cut": 1, "base_score": 0.45}):
        got = [c.to_dict() for c in torch_beats(ft, **kwargs)]
        assert got == [c.to_dict() for c in jax_beats(fj, **kwargs)]
    if loud_from == 300:
        assert rt and got  # the loud half is a chorus with beat candidates


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mdd_valley_times(seed):
    from audio_cut_tpu.detection.vpbd import VocalPhraseBoundaryDetector as JaxDetector
    from audio_cut_tpu_torch.detection.vpbd import VocalPhraseBoundaryDetector as TorchDetector

    got = TorchDetector._mdd_valley_times(_features("torch", seed))
    assert got == JaxDetector._mdd_valley_times(_features("jax", seed)) and got


# -- candidates, features, scorer -------------------------------------------------


class _Pause:
    def __init__(self, rng):
        self.start_time = float(rng.uniform(0, 28))
        self.duration = float(rng.choice([0.1, 0.2, 0.3, 0.35, 0.8, 0.05]))
        self.end_time = self.start_time + self.duration
        self.cut_point = float(rng.choice([0.0, self.start_time + 0.5 * self.duration]))
        self.confidence = float(rng.uniform(0, 1.2))
        self.pause_type = str(rng.choice(["breath", "short", "long"]))


@pytest.mark.parametrize("scale", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_adapt_acoustic_pauses_and_pool_merge(seed, scale):
    from audio_cut_tpu.cutting import candidates as J
    from audio_cut_tpu_torch.cutting import candidates as T

    rng = np.random.default_rng(seed)
    pauses = [_Pause(rng) for _ in range(25)]
    got = T.adapt_acoustic_pauses(pauses, breath_score_scale=scale)
    want = J.adapt_acoustic_pauses(pauses, breath_score_scale=scale)
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    extra_t = _candidates("torch", seed, 20, 30.0)
    extra_j = _candidates("jax", seed, 20, 30.0)
    for cluster_ms in (0.0, 120.0, 800.0):
        merged_t = T.merge_candidate_pool([got, extra_t, []], cluster_ms=cluster_ms)
        merged_j = J.merge_candidate_pool([want, extra_j, []], cluster_ms=cluster_ms)
        assert [c.to_dict() for c in merged_t] == [c.to_dict() for c in merged_j]


@pytest.mark.parametrize("lyrics", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_features_and_scorer(seed, lyrics):
    from audio_cut_tpu.analysis.boundary_features import BoundaryFeatureExtractor as JaxExtractor
    from audio_cut_tpu.cutting.scorer import PhraseBoundaryScorer as JaxScorer
    from audio_cut_tpu.lyrics.models import LyricsTimeline as JaxTimeline
    from audio_cut_tpu_torch.analysis.boundary_features import (
        BoundaryFeatureExtractor as TorchExtractor,
    )
    from audio_cut_tpu_torch.cutting.scorer import PhraseBoundaryScorer as TorchScorer
    from audio_cut_tpu_torch.lyrics.models import LyricsTimeline as TorchTimeline

    rng = np.random.default_rng(seed)
    times = np.concatenate([rng.uniform(0.0, 9.0, 40), [1.0, 1.01, 1.5, 2.0, 2.25, 2.5, 4.0, 5.0]])
    ap = rng.random(times.size)
    br = rng.random(times.size) * (rng.random(times.size) < 0.3)
    kwargs = {"beat_times": [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0], "mdd_times": [2.5, 6.1],
              "rms_series": rng.random(200) * 0.1, "hop_s": HOP}
    xt = TorchExtractor(timeline=_timeline("torch") if lyrics else TorchTimeline(), **kwargs)
    xj = JaxExtractor(timeline=_timeline("jax") if lyrics else JaxTimeline(), **kwargs)
    ft = xt.extract_batch(times, acoustic_pause=ap, breath=br)
    fj = xj.extract_batch(times, acoustic_pause=ap, breath=br)
    assert [f.to_dict() for f in ft] == [f.to_dict() for f in fj]
    assert xt.extract(2.25).to_dict() == xj.extract(2.25).to_dict()
    weights = {"beat_affinity": 0.3, "singing_penalty": 0.1}
    for st, sj in ((TorchScorer(), JaxScorer()), (TorchScorer(weights), JaxScorer(weights))):
        assert [st.score(f) for f in ft] == [sj.score(f) for f in fj]
        ct = [st.score_candidate(c, f) for c, f in zip(_candidates("torch", seed, len(ft), 9.0), ft)]
        cj = [sj.score_candidate(c, f) for c, f in zip(_candidates("jax", seed, len(fj), 9.0), fj)]
        assert [c.to_dict() for c in ct] == [c.to_dict() for c in cj]


def test_candidate_debug_json(tmp_path):
    from audio_cut_tpu.cutting.scorer import write_candidate_debug_json as jax_write
    from audio_cut_tpu_torch.cutting.scorer import write_candidate_debug_json as torch_write

    torch_write(_candidates("torch", 3, 12, 20.0), tmp_path / "t" / "debug.json")
    jax_write(_candidates("jax", 3, 12, 20.0), tmp_path / "j" / "debug.json")
    assert (tmp_path / "t" / "debug.json").read_bytes() == (tmp_path / "j" / "debug.json").read_bytes()


# -- planner ----------------------------------------------------------------------

PLANS = [  # (seed, candidates, duration, planner config)
    (0, 30, 60.0, {}),
    (1, 80, 60.0, {"max_candidates_per_second": 1.0}),
    (2, 12, 30.0, {"hard_min_s": 2.0, "hard_max_s": 18.0, "target_min_s": 5.0, "target_max_s": 12.0}),
    (3, 40, 45.0, {"vocal_risk_weight": 0.6, "beat_conflict_weight": 0.3}),
    (4, 6, 1.5, {}),                                      # shorter than hard_min: tiny
    (5, 0, 35.0, {"hard_min_s": 2.0, "hard_max_s": 10.0}),  # no candidates: infeasible, rescue
    (6, 3, 50.0, {"hard_max_s": 8.0}),                    # too few: infeasible, rescue
    (7, 3, 50.0, {"hard_max_s": 8.0, "rescue_enabled": False}),
    (8, 0, 3.0, {"hard_min_s": 2.5, "hard_max_s": 2.9}),   # rescue at hard_min
    (9, 5, 0.0, {}),                                      # empty track
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_planner_plan_and_guard_shift_metadata(i):
    from audio_cut_tpu.cutting import planner as J
    from audio_cut_tpu.cutting.refine import CutAdjustment as JaxAdjustment
    from audio_cut_tpu_torch.cutting import planner as T
    from audio_cut_tpu_torch.cutting.refine import CutAdjustment as TorchAdjustment

    seed, count, duration, cfg = PLANS[i]
    rt = T.GlobalCutPlanner(T.GlobalCutPlannerConfig(**cfg)).plan(
        _candidates("torch", seed, count, duration), duration_s=duration)
    rj = J.GlobalCutPlanner(J.GlobalCutPlannerConfig(**cfg)).plan(
        _candidates("jax", seed, count, duration), duration_s=duration)
    assert _plan_dict(rt) == _plan_dict(rj)
    adj = [(c.t, c.t + 0.01, c.t + 0.02, c.score, 10.0, 20.0) for c in rj.selected_candidates[:3]]
    mt = T.apply_guard_shift_metadata(rt, [TorchAdjustment(*a) for a in adj])
    mj = J.apply_guard_shift_metadata(rj, [JaxAdjustment(*a) for a in adj])
    assert mt.metadata == mj.metadata
    points_t = [dataclasses.asdict(p) for p in T.planner_result_to_cut_points(rt)]
    assert points_t == [dataclasses.asdict(p) for p in J.planner_result_to_cut_points(rj)]
    if i in (5, 6):
        assert not rt.selected_candidates and rt.rescue_points
        assert rt.metadata["planner"] == "rescue"
    if i == 7:
        assert not rt.feasible


def test_planner_config_reads_the_config():
    from audio_cut_tpu.config import reset_runtime_config as jax_reset
    from audio_cut_tpu.config import set_runtime_config as jax_set
    from audio_cut_tpu.cutting.planner import GlobalCutPlannerConfig as JaxConfig
    from audio_cut_tpu_torch.config import reset_runtime_config as torch_reset
    from audio_cut_tpu_torch.config import set_runtime_config as torch_set
    from audio_cut_tpu_torch.cutting.planner import GlobalCutPlannerConfig as TorchConfig

    over = {"global_planner.hard_max_s": 14.0, "global_planner.rescue_enabled": False}
    torch_set(over)
    jax_set(over)
    try:
        assert dataclasses.asdict(TorchConfig.from_config()) == dataclasses.asdict(
            JaxConfig.from_config())
        assert TorchConfig.from_config().hard_max_s == 14.0
    finally:
        torch_reset()
        jax_reset()


# -- valley snap and refine -----------------------------------------------------------

SR = 44100
STRIDE = 32
GRID_SR = SR / STRIDE
SNAPS = [  # (candidate times, valleys (t, dB), word intervals, radius ms, min drop dB)
    ([5.0], [(5.3, -55.0)], None, 450.0, 1.5),
    ([4.0, 7.0], [], None, 450.0, 1.5),
    ([5.0], [(5.3, -55.0)], [(5.2, 5.4)], 450.0, 1.5),
    ([10.95], [(11.5, -55.0)], [(10.0, 12.0), (10.8, 11.0)], 900.0, 1.5),
    ([5.0], [(5.2, -31.0)], None, 450.0, 1.5),
    ([0.01, 3.0, 9.99], [(0.2, -50.0), (2.8, -45.0), (9.8, -60.0)], [(2.7, 2.9)], 500.0, 5.0),
]


@pytest.mark.parametrize("i", range(len(SNAPS)))
def test_valley_snap_and_local_refine(i):
    from audio_cut_tpu.cutting.refine import CutPoint as JaxPoint
    from audio_cut_tpu.pipeline.modes import pure_vocal as J
    from audio_cut_tpu_torch.cutting.refine import CutPoint as TorchPoint
    from audio_cut_tpu_torch.pipeline.modes import pure_vocal as T

    times, valleys, words, radius, drop = SNAPS[i]
    env = np.full(int(20.0 * GRID_SR), -30.0)
    for t, db in valleys:
        env[int(t * GRID_SR)] = db
    # the snap with no words, as the vpbd_acoustic call site runs it (the
    # words' case is the test below); the refine rejects a valley inside a
    # word, as the JAX one does
    got = T._valley_snap_points([TorchPoint(t, 0.8, kind="lyrics_gap") for t in times], env, SR,
                                STRIDE, radius_ms=radius, min_drop_db=drop)
    want = J._valley_snap_points([JaxPoint(t, 0.8, kind="lyrics_gap") for t in times], env, SR,
                                 STRIDE, radius_ms=radius, min_drop_db=drop, word_intervals=None)
    assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    refined = T._local_valley_refine(list(times), SR, radius_ms=radius, min_drop_db=drop,
                                     db_grid=env, db_stride=STRIDE, word_intervals=words)
    assert refined == J._local_valley_refine(list(times), None, SR, radius_ms=radius, window_ms=5.0,
                                             min_drop_db=drop, db_grid=env, db_stride=STRIDE,
                                             word_intervals=words)


@pytest.mark.parametrize("i", [i for i, snap in enumerate(SNAPS) if snap[2]])
def test_valley_snap_rejects_a_valley_inside_a_word(i):
    """vpbd_asr passes the timeline's words to the snap: a valley strictly
    inside a (merged) word is rejected there as in the JAX package."""
    from audio_cut_tpu.cutting.refine import CutPoint as JaxPoint
    from audio_cut_tpu.pipeline.modes import pure_vocal as J
    from audio_cut_tpu_torch.cutting.refine import CutPoint as TorchPoint
    from audio_cut_tpu_torch.pipeline.modes import pure_vocal as T

    times, valleys, words, radius, drop = SNAPS[i]
    env = np.full(int(20.0 * GRID_SR), -30.0)
    for t, db in valleys:
        env[int(t * GRID_SR)] = db
    got = T._valley_snap_points([TorchPoint(t, 0.8, kind="lyrics_gap") for t in times], env, SR,
                                STRIDE, radius_ms=radius, min_drop_db=drop, word_intervals=words)
    want = J._valley_snap_points([JaxPoint(t, 0.8, kind="lyrics_gap") for t in times], env, SR,
                                 STRIDE, radius_ms=radius, min_drop_db=drop, word_intervals=words)
    assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    no_words = T._valley_snap_points([TorchPoint(t, 0.8, kind="lyrics_gap") for t in times], env,
                                     SR, STRIDE, radius_ms=radius, min_drop_db=drop)
    assert [p.t for p in got] != [p.t for p in no_words]  # a word did reject a valley


def test_merge_word_intervals():
    from audio_cut_tpu.cutting.refine import merge_word_intervals as jax_merge
    from audio_cut_tpu_torch.cutting.refine import merge_word_intervals as torch_merge

    for iv in ([(10.0, 12.0), (10.8, 11.0), (12.5, 13.0)], [(1.0, 2.0), (2.0, 3.0)], [],
               [(3, 4), (1, 5), (6, 7)]):
        assert torch_merge(iv) == jax_merge(iv)
