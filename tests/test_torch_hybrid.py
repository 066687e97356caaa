"""hybrid_mdd: the host tail bit for bit against the JAX package, and the
one device pass per track that the fused-pass memo gives.

Parity. Both packages' ``separate_and_detect_fused`` return one fixed pair,
a vocal stem and a DetectionBundle that each package unpacks from ONE flat
host copy of the port's CPU bundle of a synthetic 30 s song, loud from 18 s
on, with the packaged ConvVAD (``torch_tail_pair.py``; built once for this
module). ``separate_and_segment(mode="hybrid_mdd")`` then runs in each the
``v2.2_mdd`` sub-run, which stashes the pass, the hybrid run, which pops
it, the beat analysis, the strategy, the quiet guards again, the _lib remap,
the classification, the split and the export. Cases: the defaults
(``snap_to_beat``, ``medium``), ``lib_alignment: beat_only``,
``beat_cut_density: high`` (bar-start cuts in the chorus),
``chorus_force_snap: true`` and ``vad_protection: false``. Every case but
``beat_only`` gives at least one _lib segment on this song: the chorus's
MDD cuts snap to quiet beats there, where ``beat_only`` finds no quiet bar
start to cut at.

Bound: none. The tail is host numpy on equal inputs in both, so the
manifests are equal apart from timings and paths, and so is the hybrid
metadata of the result (lib flags, beat analysis, strategy). The segment
files, their names with the _lib suffix included, are equal byte for byte
with the JAX package on its numpy PCM codec, the one the port follows.

One pass. On the tiny ConvTDF with the port on ``device="cpu"``, a hybrid
call runs the separation once (on the fused pass, or on the staged path), a
standalone ``v2.2_mdd`` call leaves no memo, a hybrid call pops its own, a
sub-run that raises leaves none, and a key that no longer matches costs a
second separation, with the same cuts.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from conftest import make_song  # noqa: E402
from torch_tail_pair import SR, build_pair, patch_fused  # noqa: E402

BACKEND = {"enhanced_separation.backend": "convtdf"}
TINY = {**BACKEND, "enhanced_separation.convtdf.checkpoint": "packaged_tiny"}
CHORUS_S = 18.0  # a loud section of whole bars from here on: the strategies' chorus
CASES = {
    "defaults": {},
    "beat_only": {"hybrid_mdd.lib_alignment": "beat_only"},
    "density_high": {"hybrid_mdd.beat_cut_density": "high"},
    "chorus_force_snap": {"hybrid_mdd.chorus_force_snap": True},
    "vad_protection_off": {"hybrid_mdd.vad_protection": False},
}
WITH_LIB = {"defaults", "density_high", "chorus_force_snap", "vad_protection_off"}
HYBRID_KEYS = ("segment_lib_flags", "lib_segment_count", "hybrid_config", "beat_analysis",
               "strategy")


@pytest.fixture(scope="module")
def song(tmp_path_factory):
    from audio_cut_tpu_torch.io import write_wav

    pair = build_pair("conv", chorus_s=CHORUS_S)
    path = tmp_path_factory.mktemp("hybrid_song") / "song.wav"
    write_wav(path, pair.mix, SR, subtype="FLOAT")
    return pair, path


def _capture_hybrid_results(mp, result_cls, into):
    """Record the result dict that each package's add_hybrid_metadata returns."""
    inner = result_cls.add_hybrid_metadata

    def add_hybrid_metadata(result, **kwargs):
        out = inner(result, **kwargs)
        into.append(out)
        return out

    mp.setattr(result_cls, "add_hybrid_metadata", staticmethod(add_hybrid_metadata))


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, song, tmp_path_factory):
    """(case, mix, JAX manifest, port manifest, JAX result, port result, dirs)."""
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu.pipeline.result import ResultBuilder as JaxResults
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run
    from audio_cut_tpu_torch.pipeline.result import ResultBuilder as TorchResults

    pair, path = song
    overrides = {**BACKEND, **CASES[request.param]}
    root = tmp_path_factory.mktemp(f"hybrid_{request.param}")
    dj, dt = root / "jax", root / "torch"
    rj, rt = [], []
    mp = pytest.MonkeyPatch()
    try:
        patch_fused(mp, pair)
        mp.setattr(get_pcm_codec(), "_lib", None)  # the JAX package's numpy codec
        _capture_hybrid_results(mp, JaxResults, rj)
        _capture_hybrid_results(mp, TorchResults, rt)
        mj = jax_run(input_uri=str(path), export_dir=str(dj), mode="hybrid_mdd",
                     export_manifest=True, runtime_overrides=overrides)
        mt = torch_run(input_uri=str(path), export_dir=str(dt), mode="hybrid_mdd", device="cpu",
                       export_manifest=True, runtime_overrides=overrides)
    finally:
        mp.undo()
    assert len(rj) == len(rt) == 1
    return request.param, pair.mix, mj, mt, rj[0], rt[0], dj, dt


def _scrub(m):
    m = copy.deepcopy(m)
    m.pop("timings_ms")
    m.pop("manifest_path")
    m["artifacts"].pop("output_dir")
    return m


def test_the_song_is_cut_on_beats(runs):
    case, _, _, mt, _, rt, _, _ = runs
    assert mt["success"] and mt["version"] == "hybrid_mdd" and len(mt["segments"]) >= 3
    assert rt["strategy"] == ("beat_only" if case == "beat_only" else "snap_to_beat")
    ba = rt["beat_analysis"]
    assert abs(ba["bpm"] - 120.0) < 2.0 and ba["chorus_regions"] and ba["high_energy_bars"] > 0
    assert (rt["lib_segment_count"] > 0) == (case in WITH_LIB)


def test_manifests_are_equal_but_timings_and_paths(runs):
    _, _, mj, mt, _, _, _, _ = runs
    assert mt["cuts"] == mj["cuts"]
    assert mt["guard"] == mj["guard"]
    assert mt["qa_report"] == mj["qa_report"]
    assert _scrub(mt) == _scrub(mj)


def test_hybrid_metadata_is_equal(runs):
    _, _, _, _, rj, rt, _, _ = runs
    for key in HYBRID_KEYS:
        assert rt[key] == rj[key], key


def test_segment_files_are_equal_lib_suffix_included(runs):
    from audio_cut_tpu_torch.io import read_wav
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    _, mix, mj, mt, _, rt, dj, dt = runs
    paths = [s["mix_path"] for s in mt["segments"]]
    assert paths == [s["mix_path"] for s in mj["segments"]]
    assert ["_lib" in p for p in paths] == rt["segment_lib_flags"]
    for rel in paths:
        assert (dt / rel).read_bytes() == (dj / rel).read_bytes()
    spliced = np.concatenate([read_wav(dt / rel)[0] for rel in paths])
    np.testing.assert_array_equal(spliced, decode_pcm24(encode_pcm24(mix)))


# -- one device pass per track: the fused-pass memo ----------------------------


@pytest.fixture(scope="module")
def short_song(tmp_path_factory):
    from audio_cut_tpu_torch.io import write_wav

    audio, sr = make_song(15.0)  # 15 s: a pause that the layout keeps, so a cut to compare
    root = tmp_path_factory.mktemp("hybrid_memo")
    write_wav(root / "a.wav", audio, sr, subtype="FLOAT")
    return root, audio


def _splitter():
    from audio_cut_tpu_torch.config import set_runtime_config
    from audio_cut_tpu_torch.pipeline.splitter import SmartSplitter

    set_runtime_config(TINY)
    return SmartSplitter("cpu", sample_rate=SR)


@pytest.fixture
def tiny_config():
    from audio_cut_tpu_torch.config import reset_runtime_config

    yield
    reset_runtime_config()


@pytest.mark.parametrize("fused_program", [True, False], ids=["fused", "staged"])
def test_hybrid_runs_one_device_pass_per_track(short_song, tmp_path, monkeypatch, fused_program):
    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.separation import fused
    from audio_cut_tpu_torch.separation.engine import SeparationEngine

    root, _ = short_song
    calls = _count_passes(monkeypatch, fused, SeparationEngine)
    m = separate_and_segment(input_uri=str(root / "a.wav"), export_dir=str(tmp_path / "out"),
                             mode="hybrid_mdd", device="cpu",
                             runtime_overrides={**TINY, "device_pipeline.fused_program": fused_program})
    assert m["success"]
    assert calls == {"pass": 1, "separation": 1}
    # the default config cuts the 15 s song's 11 windows into 6 pieces
    assert m["gpu"]["gpu_pipeline_mode"] == ("fused_pipelined_p6" if fused_program
                                             else "device_ola_pipelined_p6")


def _count_passes(monkeypatch, fused, engine_cls):
    """Counts the device passes and, within them, the separations."""
    calls = {"pass": 0, "separation": 0}
    inner_pass, inner_separation = fused.separate_and_detect_fused, engine_cls.separate_on_device

    def counting_pass(*args, **kwargs):
        calls["pass"] += 1
        return inner_pass(*args, **kwargs)

    def counting_separation(self, *args, **kwargs):
        calls["separation"] += 1
        return inner_separation(self, *args, **kwargs)

    monkeypatch.setattr(fused, "separate_and_detect_fused", counting_pass)
    monkeypatch.setattr(engine_cls, "separate_on_device", counting_separation)
    return calls


def test_standalone_run_leaves_no_memo_and_hybrid_pops_its_own(short_song, tmp_path, tiny_config):
    root, _ = short_song
    splitter = _splitter()
    assert splitter._fused_pass_memo is None and splitter._want_fused_pass_memo is False
    r = splitter.split_audio_seamlessly(str(root / "a.wav"), str(tmp_path / "o1"), mode="v2.2_mdd")
    assert r["success"] and splitter._fused_pass_memo is None
    popped = []
    inner = splitter.split_audio_seamlessly

    def sub_run(*args, **kwargs):
        out = inner(*args, **kwargs)
        if kwargs.get("mode") == "v2.2_mdd":
            popped.append(splitter._fused_pass_memo)
        return out

    splitter.split_audio_seamlessly = sub_run
    r = splitter.split_audio_seamlessly(str(root / "a.wav"), str(tmp_path / "o2"), mode="hybrid_mdd")
    assert r["success"] and splitter._fused_pass_memo is None
    assert splitter._want_fused_pass_memo is False
    assert len(popped) == 1 and popped[0] is not None  # the sub-run stashed, hybrid popped it


def test_a_sub_run_that_raises_leaves_no_memo(short_song, tmp_path, tiny_config, monkeypatch):
    from audio_cut_tpu_torch.pipeline.modes import pure_vocal

    root, _ = short_song

    def host_tail_fails(*args, **kwargs):  # after the stash, as a host-tail fault would be
        raise RuntimeError("host tail failed")

    monkeypatch.setattr(pure_vocal, "_plan_cuts", host_tail_fails)
    splitter = _splitter()
    with pytest.raises(RuntimeError, match="host tail failed"):
        splitter.split_audio_seamlessly(str(root / "a.wav"), str(tmp_path / "o"), mode="hybrid_mdd")
    assert splitter._fused_pass_memo is None and splitter._want_fused_pass_memo is False


def test_a_memo_miss_separates_again_and_cuts_the_same(short_song, tmp_path, monkeypatch):
    """A key that no longer matches (here the config's generation moved)
    costs a second separation and a bundle without the VAD, and gives the
    same cuts and segments."""
    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.pipeline.modes import hybrid
    from audio_cut_tpu_torch.separation import fused
    from audio_cut_tpu_torch.separation.engine import SeparationEngine

    root, _ = short_song
    song = str(root / "a.wav")
    hit = separate_and_segment(input_uri=song, export_dir=str(tmp_path / "hit"), mode="hybrid_mdd",
                               device="cpu", runtime_overrides=TINY)
    inner_key = hybrid.fused_pass_key

    def moved_generation(path):
        key = inner_key(path)
        return key[:3] + (key[3] + 1,)

    calls = _count_passes(monkeypatch, fused, SeparationEngine)
    monkeypatch.setattr(hybrid, "fused_pass_key", moved_generation)
    miss = separate_and_segment(input_uri=song, export_dir=str(tmp_path / "miss"),
                                mode="hybrid_mdd", device="cpu", runtime_overrides=TINY)
    assert calls == {"pass": 2, "separation": 2}
    assert miss["cuts"] == hit["cuts"] and len(hit["segments"]) >= 2
    assert [s["mix_path"] for s in miss["segments"]] == [s["mix_path"] for s in hit["segments"]]
