"""The slice end to end: separate_and_segment(mode="vocal_separation") through
both packages on the same synthetic song, with the packaged tiny ConvTDF in
bfloat16 as in production; the port runs on device="cpu".

Both runs pin the backend to convtdf (tests/conftest.py pins the JAX package
to spectral through the environment) and keep the default config otherwise:
both packages cut the 15 s bucket's 11 windows into 6 pipelined pieces, so
the manifests carry the same gpu_pipeline_mode (``device_ola_pipelined_p6``
for vocal_separation, ``fused_pipelined_p6`` for v2.2_mdd).

Bounds: bfloat16 rounds at other places in XLA and in PyTorch, so the vocal
stems agree to an SNR of 30 dB or more, and the confidence, an energy ratio
of the vocal, to 1e-3. Everything else in the
manifest is equal, apart from timings and the output paths. In each package
the instrumental file is exactly its own PCM-24 encoding of mix - vocal.
"""

import copy

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import make_song  # noqa: E402

OVERRIDES = {
    "enhanced_separation.backend": "convtdf",
    "enhanced_separation.convtdf.checkpoint": "packaged_tiny",
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    root = tmp_path_factory.mktemp("slice")
    audio, sr = make_song(4.0)
    song = root / "song.wav"
    write_wav(song, audio, sr, subtype="FLOAT")
    mj = jax_run(input_uri=str(song), export_dir=str(root / "jax"), mode="vocal_separation",
                 export_manifest=True, runtime_overrides=OVERRIDES)
    mt = torch_run(input_uri=str(song), export_dir=str(root / "torch"),
                   mode="vocal_separation", device="cpu", export_manifest=True,
                   runtime_overrides=OVERRIDES)
    return root, audio, mj, mt


def test_same_files(runs):
    root, _, mj, mt = runs
    assert mj["success"] and mt["success"]
    names = sorted(p.name for p in (root / "jax").iterdir())
    assert names == sorted(p.name for p in (root / "torch").iterdir())
    assert names == ["SegmentManifest.json", "song_instrumental_4.0.wav", "song_vocal_4.0.wav"]


def test_same_manifest_but_timings_and_paths(runs):
    root, _, mj, mt = runs

    def scrub(m):
        m = copy.deepcopy(m)
        m.pop("timings_ms")
        m.pop("manifest_path")
        m["artifacts"].pop("output_dir")
        for k in ("gpu_pipeline_compute_ms", "gpu_pipeline_total_ms", "gpu_pipeline_device"):
            m["gpu"].pop(k)
        m["separation"].pop("confidence")
        return m

    assert scrub(mt) == scrub(mj)
    assert mt["gpu"]["gpu_pipeline_device"] == "cpu"
    assert mt["gpu"]["gpu_pipeline_mode"] == "device_ola_pipelined_p6"
    assert abs(mt["separation"]["confidence"] - mj["separation"]["confidence"]) <= 1e-3


def test_vocal_stems_agree(runs):
    from audio_cut_tpu_torch.io import read_wav

    root, audio, mj, mt = runs
    vj, _ = read_wav(root / "jax" / mj["artifacts"]["vocal_full"])
    vt, _ = read_wav(root / "torch" / mt["artifacts"]["vocal_full"])
    assert vj.shape == vt.shape == audio.shape
    assert np.isfinite(vt).all()
    vj64 = vj.astype(np.float64)
    snr = 10 * np.log10(np.sum(vj64 ** 2) / np.sum((vj64 - vt) ** 2))
    assert snr >= 30.0, snr


def test_instrumental_is_the_exact_complement_in_both(runs):
    from audio_cut_tpu.io import read_wav as jax_read
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24, read_wav

    root, audio, mj, mt = runs
    codec = get_pcm_codec()
    v, _ = jax_read(root / "jax" / mj["artifacts"]["vocal_full"])
    i, _ = jax_read(root / "jax" / mj["artifacts"]["instrumental_full"])
    np.testing.assert_array_equal(i, codec.decode_pcm24(codec.encode_pcm24(audio - v)))
    v, _ = read_wav(root / "torch" / mt["artifacts"]["vocal_full"])
    i, _ = read_wav(root / "torch" / mt["artifacts"]["instrumental_full"])
    np.testing.assert_array_equal(i, decode_pcm24(encode_pcm24(audio - v)))


# -- the default mode: v2.2_mdd ---------------------------------------------
#
# The same song generator at 15 s: it pads to the same 15 s bucket as 10 s
# (so it costs the JAX package no more) and has a pause the layout keeps,
# where 10 s comes out as one segment with no cut to compare. The port runs
# with no mode (the default, v2.2_mdd); the JAX package with the mode named.
# Both use the tiny ConvTDF in bfloat16 and the packaged ConvVAD.
#
# Bounds: bfloat16 separation noise moves the vocal stem, and with it the
# envelopes the cuts are read from, so every cut agrees within 441 samples
# (10 ms) and the segment count and labels are equal. Each package's segments
# splice back to its own PCM-24 encoding of the input exactly.


@pytest.fixture(scope="module")
def mdd_runs(tmp_path_factory):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    root = tmp_path_factory.mktemp("slice_mdd")
    audio, sr = make_song(15.0)
    song = root / "song.wav"
    write_wav(song, audio, sr, subtype="FLOAT")
    mj = jax_run(input_uri=str(song), export_dir=str(root / "jax"), mode="v2.2_mdd",
                 runtime_overrides=OVERRIDES)
    mt = torch_run(input_uri=str(song), export_dir=str(root / "torch"), device="cpu",
                   runtime_overrides=OVERRIDES)
    return root, audio, mj, mt


def test_mdd_same_segments_and_labels(mdd_runs):
    _, _, mj, mt = mdd_runs
    assert mj["success"] and mt["success"]
    assert mt["version"] == mj["version"] == "v2.2_mdd"
    assert mt["gpu"]["gpu_pipeline_mode"] == mj["gpu"]["gpu_pipeline_mode"] == "fused_pipelined_p6"
    assert len(mt["segments"]) == len(mj["segments"]) >= 2
    assert [s["label"] for s in mt["segments"]] == [s["label"] for s in mj["segments"]]


def test_mdd_cuts_within_10_ms(mdd_runs):
    _, _, mj, mt = mdd_runs
    sj, st = mj["cuts"]["samples"], mt["cuts"]["samples"]
    assert len(st) == len(sj)
    assert max(abs(a - b) for a, b in zip(st, sj)) <= 441


def test_mdd_segments_splice_back_in_both(mdd_runs):
    from audio_cut_tpu.io import read_wav as jax_read
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24, read_wav

    root, audio, mj, mt = mdd_runs
    codec = get_pcm_codec()
    xj = np.concatenate([jax_read(root / "jax" / s["mix_path"])[0] for s in mj["segments"]])
    xt = np.concatenate([read_wav(root / "torch" / s["mix_path"])[0] for s in mt["segments"]])
    np.testing.assert_array_equal(xj, codec.decode_pcm24(codec.encode_pcm24(audio)))
    np.testing.assert_array_equal(xt, decode_pcm24(encode_pcm24(audio)))
