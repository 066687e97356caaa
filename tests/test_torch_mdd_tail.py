"""The v2.2_mdd host tail, bit for bit: given the same stems and the same
detection bundle, both packages must cut, label, guard and report the same.

Both packages' ``separate_and_detect_fused`` are replaced, in this test only
(``monkeypatch``), by a function that returns one fixed pair: a vocal stem
and a DetectionBundle unpacked by each package from ONE flat host copy (the
port's bundle of a synthetic 30 s song, on the CPU, with the packaged
ConvVAD, or without it for ``vad.backend: energy_gate``; see
``torch_tail_pair.py``). No file of either package changes.
``separate_and_segment(mode="v2.2_mdd")`` then runs the whole host tail in each: VAD focus windows, the
pause detector, NMS and quiet guards, layout, the valley refine,
classification, the split and the export.

Bound: none. The tail is host numpy on equal inputs in both, so the
manifests are equal apart from timings and paths, down to the last bit of
every cut, guard shift and QA figure.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_tail_pair import SR, build_pair, patch_fused  # noqa: E402


@pytest.fixture(scope="module", params=["conv", "energy_gate"])
def runs(request, tmp_path_factory):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    backend = request.param
    overrides = {"enhanced_separation.backend": "convtdf", "vad.backend": backend}
    root = tmp_path_factory.mktemp("mdd_tail")
    pair = build_pair(backend)
    mix = pair.mix
    song = root / "song.wav"
    write_wav(song, mix, SR, subtype="FLOAT")

    mp = pytest.MonkeyPatch()
    try:
        patch_fused(mp, pair)
        mj = jax_run(input_uri=str(song), export_dir=str(root / "jax"), mode="v2.2_mdd",
                     export_manifest=True, runtime_overrides=overrides)
        mt = torch_run(input_uri=str(song), export_dir=str(root / "torch"), mode="v2.2_mdd",
                       device="cpu", export_manifest=True, runtime_overrides=overrides)
    finally:
        mp.undo()
    return root, mix, mj, mt


def test_the_song_is_cut(runs):
    _, _, mj, mt = runs
    assert mj["success"] and mt["success"]
    assert len(mt["segments"]) >= 3
    assert {s["label"] for s in mt["segments"]} == {"human", "music"}
    assert mt["guard"]["adjustments"] and mt["cuts"]["suppressed"]


def test_cuts_labels_guards_and_qa_are_identical(runs):
    _, _, mj, mt = runs
    assert mt["cuts"] == mj["cuts"]
    assert [s["label"] for s in mt["segments"]] == [s["label"] for s in mj["segments"]]
    assert mt["guard"] == mj["guard"]
    assert mt["qa_report"] == mj["qa_report"]
    assert mt["separation"] == mj["separation"]


def test_manifests_are_equal_but_timings_and_paths(runs):
    _, _, mj, mt = runs

    def scrub(m):
        m = copy.deepcopy(m)
        m.pop("timings_ms")
        m.pop("manifest_path")
        m["artifacts"].pop("output_dir")
        return m

    assert scrub(mt) == scrub(mj)


def test_segments_match_and_splice_back(runs):
    """The same segment files. Their samples agree to one 24-bit step: the JAX
    package's native codec rounds the scaled sample through float32
    (``llrintf``) and decodes by a reciprocal multiply, where the port rounds
    the float64 product once and divides, as the JAX package's own numpy
    codec does. Each package's segments splice back to its own PCM-24
    encoding of the input exactly."""
    from audio_cut_tpu.io import read_wav as jax_read
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu_torch.io import read_wav
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    root, mix, mj, mt = runs
    assert [s["mix_path"] for s in mt["segments"]] == [s["mix_path"] for s in mj["segments"]]
    parts_j, parts_t = [], []
    for seg in mt["segments"]:
        xj, _ = jax_read(root / "jax" / seg["mix_path"])
        xt, _ = read_wav(root / "torch" / seg["mix_path"])
        assert xt.shape == xj.shape
        assert np.abs(xt.astype(np.float64) - xj).max() <= 1.0 / 8388607.0 + 1e-12
        parts_j.append(xj)
        parts_t.append(xt)
    codec = get_pcm_codec()
    np.testing.assert_array_equal(np.concatenate(parts_j), codec.decode_pcm24(codec.encode_pcm24(mix)))
    np.testing.assert_array_equal(np.concatenate(parts_t), decode_pcm24(encode_pcm24(mix)))
