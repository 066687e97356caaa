"""The vpbd host tail, bit for bit: given the same stems and the same detection
bundle, both packages must plan, cut, label, guard and report the same.

Both packages' ``separate_and_detect_fused`` return one fixed pair, a vocal
stem and a DetectionBundle that each package unpacks from ONE flat host copy
of the port's CPU bundle of a synthetic 30 s song, with a loud last third,
and the packaged ConvVAD (``torch_tail_pair.py``; built once for this
module). ``separate_and_segment`` then runs the whole vpbd host tail in each: VAD focus windows, the smart-cut
runtime (intent, AutoProfile style estimate, profile interpolation), the
unified candidate pool (pauses, breaths, chorus-gated beats, the +-120 ms
merge), the boundary features and the scorer, the DP planner, the pre-guard
valley snap, NMS and quiet guards, layout, the valley refine, classification,
the split and the export. Cases: the default pool, ``vpbd.candidate_pool:
legacy``, an explicit ballad profile at ``beat_lean`` alignment, ``vpbd_asr``
with lyrics alignment off (the default config), and two calls in a row.

Bound: none. The tail is host numpy on equal inputs in both, so the
manifests are equal apart from timings and paths (``cuts.final`` with its
enrichment, ``boundary_detection``, ``auto_profile``, ``note`` and
``qa_report`` included), and so is ``vpbd_candidates_debug.json``, byte for
byte. The segment files are equal byte for byte with the JAX package on its
numpy PCM codec, the one the port follows; its native codec may round a
sample one 24-bit step apart (``test_torch_mdd_tail.py`` holds that case).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_tail_pair import SR, build_pair, patch_fused  # noqa: E402

BACKEND = {"enhanced_separation.backend": "convtdf"}
CHORUS_S = 18.0  # a loud section of whole bars from here on: the beat pool's chorus
CASES = {
    "acoustic": ("vpbd_acoustic", {}, 1),
    "legacy_pool": ("vpbd_acoustic", {"vpbd.candidate_pool": "legacy"}, 1),
    "ballad_beat_lean": ("vpbd_acoustic", {"smart_cut.profile": "ballad",
                                           "smart_cut.alignment": "beat_lean"}, 1),
    "asr_lyrics_off": ("vpbd_asr", {}, 1),
    "two_calls": ("vpbd_acoustic", {}, 2),
}


@pytest.fixture(scope="module")
def song(tmp_path_factory):
    from audio_cut_tpu_torch.io import write_wav

    pair = build_pair("conv", chorus_s=CHORUS_S)
    path = tmp_path_factory.mktemp("vpbd_song") / "song.wav"
    write_wav(path, pair.mix, SR, subtype="FLOAT")
    return pair, path


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, song, tmp_path_factory):
    """[(JAX manifest, port manifest, JAX dir, port dir)] per call of the case."""
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    pair, path = song
    mode, extra, calls = CASES[request.param]
    overrides = {**BACKEND, **extra}
    root = tmp_path_factory.mktemp(f"vpbd_{request.param}")
    out = []
    mp = pytest.MonkeyPatch()
    try:
        patch_fused(mp, pair)
        mp.setattr(get_pcm_codec(), "_lib", None)  # the JAX package's numpy codec
        for call in range(calls):
            dj, dt = root / f"jax{call}", root / f"torch{call}"
            mj = jax_run(input_uri=str(path), export_dir=str(dj), mode=mode,
                         export_manifest=True, runtime_overrides=overrides)
            mt = torch_run(input_uri=str(path), export_dir=str(dt), mode=mode, device="cpu",
                           export_manifest=True, runtime_overrides=overrides)
            out.append((mj, mt, dj, dt))
    finally:
        mp.undo()
    return request.param, pair.mix, out


def _scrub(m):
    m = copy.deepcopy(m)
    m.pop("timings_ms")
    m.pop("manifest_path")
    m["artifacts"].pop("output_dir")
    return m


def test_the_song_is_planned_and_cut(runs):
    case, _, out = runs
    for _, mt, _, _ in out:
        assert mt["success"] and len(mt["segments"]) >= 3
        bd = mt["boundary_detection"]
        counts = bd["candidate_counts"]
        assert counts["acoustic"] > 0 and counts["merged"] > 0 and counts["lyrics"] == 0
        if case == "legacy_pool":
            assert counts["pool_mode"] == "legacy" and counts["beat"] == 0
        else:
            assert counts["pool_mode"] == "unified" and counts["beat"] > 0
        assert bd["planner"]["planner"] == "dynamic_programming" and bd["selected"]
        assert "final_time_by_raw_time" in bd["planner"]
        assert mt["auto_profile"]["intent"]["profile"] == (
            "ballad" if case == "ballad_beat_lean" else "auto")
        assert any(isinstance(c, dict) and "source" in c for c in mt["cuts"]["final"])
        if case == "asr_lyrics_off":
            assert mt["note"] == "lyrics_unavailable:disabled"
            assert mt["version"] == "vpbd_asr"
        else:
            assert "note" not in mt


def test_manifests_are_equal_but_timings_and_paths(runs):
    _, _, out = runs
    for mj, mt, _, _ in out:
        assert mt["cuts"] == mj["cuts"]
        assert mt["boundary_detection"] == mj["boundary_detection"]
        assert mt["auto_profile"] == mj["auto_profile"]
        assert mt.get("note") == mj.get("note")
        assert mt["qa_report"] == mj["qa_report"]
        assert _scrub(mt) == _scrub(mj)


def test_candidate_debug_json_is_equal(runs):
    _, _, out = runs
    for _, _, dj, dt in out:
        want = (dj / "vpbd_candidates_debug.json").read_bytes()
        assert (dt / "vpbd_candidates_debug.json").read_bytes() == want
        assert b'"vpbd_score"' in want


def test_segment_files_are_equal_and_splice_back(runs):
    from audio_cut_tpu_torch.io import read_wav
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    _, mix, out = runs
    for mj, mt, dj, dt in out:
        paths = [s["mix_path"] for s in mt["segments"]]
        assert paths == [s["mix_path"] for s in mj["segments"]]
        for rel in paths:
            assert (dt / rel).read_bytes() == (dj / rel).read_bytes()
        spliced = np.concatenate([read_wav(dt / rel)[0] for rel in paths])
        np.testing.assert_array_equal(spliced, decode_pcm24(encode_pcm24(mix)))
