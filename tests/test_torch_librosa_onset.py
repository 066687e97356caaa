"""librosa_onset and build_track_features, against the JAX package.

``separate_and_segment(mode="librosa_onset")`` builds the track's features on
its device at hop 512 (``analysis/features.build_track_features``: one STFT,
K2's plain version here on the CPU, the tempo), then cuts on the host: the
bpm's bar grid, per-bar energy classes, silence midpoints, the density's
cadence and the short merge (``pipeline/splitter.plan_onset_cuts``). The
separation, where it runs, only labels the segments.

Bounds:
* ``pad_to_bucket``, ``_silence_midpoints`` and the host cut logic are numpy
  on equal inputs: exact.
* The features: both packages compute in float32 with two libraries' FFTs
  and sum in other orders, so they are held to the bounds of
  ``test_torch_bundle.py`` (rms rtol 1e-5; flatness rtol 2e-4 / atol 2e-5;
  onset and mdd atol 1e-4; the tempo 1e-4 relative).
* End to end, the bpm and the bar duration agree to rtol 1e-6 (the two
  packages' bpm differ by an ulp of float32 at most on these songs); every
  other manifest field, the cuts and the labels are equal. Mix segment
  samples agree to one 24-bit step (the PCM-24 codecs, as in
  ``test_torch_mdd_tail.py``), vocal segment samples within the spectral
  stems' 1e-5 (``test_torch_spectral.py``).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from conftest import make_song  # noqa: E402

SR = 44100
SPECTRAL = {"enhanced_separation.backend": "spectral", "device_pipeline.pipelined_upload": False}
BPM_RTOL = 1e-6
FEATURE_TOL = {"rms": (1e-5, 1e-7), "flatness": (2e-4, 2e-5), "onset": (2e-4, 1e-4),
               "mdd": (0.0, 1e-4)}
STEP = 1.0 / 8388607.0  # one 24-bit step


@pytest.mark.parametrize("shape, bucket_s", [
    ((0,), 15.0),           # empty: one whole bucket
    ((44100 * 15,), 15.0),  # a whole bucket: unchanged
    ((44100 * 16 + 3,), 15.0),
    ((2, 1000), 0.5),       # leading axes are not padded
])
def test_pad_to_bucket(shape, bucket_s):
    from audio_cut_tpu.analysis.features import pad_to_bucket as jax_pad
    from audio_cut_tpu_torch.analysis.features import pad_to_bucket

    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    got, want = pad_to_bucket(x, SR, bucket_s), jax_pad(x, SR, bucket_s)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.shape[-1] % int(round(bucket_s * SR)) == 0


@pytest.mark.parametrize("hop_s, beats", [(512 / SR, False), (0.05, False), (512 / SR, True)])
def test_build_track_features_matches_jax(hop_s, beats):
    """A 17 s song (padded to 30 s), at librosa_onset's hop and at the
    bundle's 0.05 s grid; and with a given beat grid (``beat_source``)."""
    from audio_cut_tpu.analysis.features import build_track_features as jax_build
    from audio_cut_tpu_torch.analysis.features import build_track_features

    audio, sr = make_song(17.0)
    source = np.arange(0.25, 17.0, 0.52) if beats else None
    want = jax_build(audio, sr, hop_s=hop_s, beat_source=source)
    got = build_track_features(audio, sr, hop_s=hop_s, beat_source=source, device="cpu")
    assert got.n_frames == want.n_frames == audio.size // int(round(hop_s * sr)) + 1
    assert (got.sr, got.hop_s, got.duration_s) == (want.sr, want.hop_s, want.duration_s)
    for name, (rtol, atol) in FEATURE_TOL.items():
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
    if beats:
        assert got.bpm == want.bpm and got.tempo_strength == want.tempo_strength == 1.0
        np.testing.assert_array_equal(got.beat_times, want.beat_times)
    else:
        assert abs(got.bpm - want.bpm) <= 1e-4 * want.bpm and abs(got.bpm - 120.0) < 2.0
        assert abs(got.tempo_strength - want.tempo_strength) <= 1e-4
        assert got.beat_times.shape == want.beat_times.shape
        np.testing.assert_allclose(got.beat_times, want.beat_times, rtol=0, atol=1e-3)


@pytest.mark.parametrize("mask", [
    "0000000000",
    "0111100011",   # the last run ends at the last frame
    "1110000111",   # and the first at the first
    "1111111111",
    "0101010110",   # runs shorter than the minimum
])
def test_silence_midpoints_match_jax(mask):
    from audio_cut_tpu.pipeline.splitter import _silence_midpoints as jax_mid
    from audio_cut_tpu_torch.pipeline.splitter import _silence_midpoints

    low = np.array([c == "1" for c in mask])
    rms_db = np.where(low, -60.0, -10.0) + np.linspace(0.0, 1.0, low.size)
    times = np.arange(low.size) * (512 / SR)
    for min_dur in (0.0, 0.02, 0.05):
        got = _silence_midpoints(rms_db, times, -40.0, min_dur)
        assert got == jax_mid(rms_db, times, -40.0, min_dur)
        assert all(isinstance(t, float) for t in got)


def _runs(root, song, overrides, export_types=None):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    kw = dict(input_uri=str(song), mode="librosa_onset", export_manifest=True,
              runtime_overrides=overrides, export_types=export_types)
    mj = jax_run(export_dir=str(root / "jax"), **kw)
    mt = torch_run(export_dir=str(root / "torch"), device="cpu", **kw)
    return mj, mt


def _scrub(m):
    """The manifest without timings and paths, and without the bpm and the
    bar duration, which return apart."""
    m = copy.deepcopy(m)
    m.pop("timings_ms")
    m.pop("manifest_path")
    m["artifacts"].pop("output_dir")
    smart = m["smart_segmentation"]
    return m, (smart.pop("bpm"), smart.pop("bar_duration_s"))


def _assert_segments_match(root, mj, mt, key="mix_path", atol=STEP):
    from audio_cut_tpu.io import read_wav as jax_read
    from audio_cut_tpu_torch.io import read_wav

    assert [s[key] for s in mt["segments"]] == [s[key] for s in mj["segments"]]
    for seg in mt["segments"]:
        xj, _ = jax_read(root / "jax" / seg[key])
        xt, _ = read_wav(root / "torch" / seg[key])
        assert xt.shape == xj.shape
        assert np.abs(xt.astype(np.float64) - xj).max() <= atol + 1e-12


@pytest.mark.parametrize("density", ["low", "medium", "high", "custom"])
def test_without_separation_matches_jax(tmp_path, density):
    """``use_vocal_separation: false``: no separation, every segment human;
    the manifests and the segment files equal the JAX package's."""
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    audio, sr = make_song(20.0)
    song = tmp_path / "song.wav"
    write_wav(song, audio, sr, subtype="FLOAT")
    overrides = {"librosa_onset.use_vocal_separation": False}
    if density == "custom":
        overrides.update({"librosa_onset.density_custom.enable": True,
                          "librosa_onset.density_custom.verse_bars": 3,
                          "librosa_onset.density_custom.chorus_bars": 1})
    else:
        overrides["librosa_onset.density"] = density
    mj, mt = _runs(tmp_path, song, overrides)
    assert mt["success"] and mj["success"]
    assert mt["smart_segmentation"]["method"] == "smart_segment_v2"
    assert mt["smart_segmentation"]["silence_boundaries"]
    assert len(mt["segments"]) >= 2 and {s["label"] for s in mt["segments"]} == {"human"}
    assert mt["separation"] == {"backend": None, "confidence": None} and "gpu" not in mt
    (sj, (bpm_j, bar_j)), (st, (bpm_t, bar_t)) = _scrub(mj), _scrub(mt)
    assert st == sj
    assert bpm_t == pytest.approx(bpm_j, rel=BPM_RTOL)
    assert bar_t == pytest.approx(bar_j, rel=BPM_RTOL)
    _assert_segments_match(tmp_path, mj, mt)
    from audio_cut_tpu_torch.io import read_wav

    parts = [read_wav(tmp_path / "torch" / s["mix_path"])[0] for s in mt["segments"]]
    np.testing.assert_array_equal(np.concatenate(parts), decode_pcm24(encode_pcm24(audio)))


def test_with_spectral_separation_matches_jax(tmp_path):
    """With the separation (the spectral backend, the JAX suite's pin) on a
    song with an 8 s beat-only intro: the same cuts, labels (a music one
    among them) and smart segmentation, one vocal segment per segment."""
    from audio_cut_tpu.io import write_wav
    from torch_tail_pair import song as tail_song

    mix, _ = tail_song()
    song = tmp_path / "song.wav"
    write_wav(song, mix, SR, subtype="FLOAT")
    mj, mt = _runs(tmp_path, song, SPECTRAL, export_types=("mix_segments", "vocal_segments"))
    labels = [s["label"] for s in mt["segments"]]
    assert mt["cuts"]["samples"] == mj["cuts"]["samples"] and len(labels) >= 2
    assert labels == [s["label"] for s in mj["segments"]] and "music" in labels
    (sj, (bpm_j, bar_j)), (st, (bpm_t, bar_t)) = _scrub(mj), _scrub(mt)
    assert st["smart_segmentation"] == sj["smart_segmentation"]
    assert bpm_t == pytest.approx(bpm_j, rel=BPM_RTOL)
    assert bar_t == pytest.approx(bar_j, rel=BPM_RTOL)
    assert mt["separation"]["backend"] == "spectral"
    assert len(mt["artifacts"]["human_segments"]) == len(labels)
    _assert_segments_match(tmp_path, mj, mt)
    # the vocal stems agree within test_torch_spectral.py's bound
    _assert_segments_match(tmp_path, mj, mt, key="vocal_path", atol=1e-5)


def test_failed_separation_raises(monkeypatch, tmp_path):
    """The JAX package goes on without stems when the separation fails; the
    port raises, as on every other path: ``convtdf`` with a missing
    checkpoint."""
    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.io import write_wav
    from audio_cut_tpu_torch.separation import backends

    monkeypatch.setattr(backends, "_BACKEND_CACHE", {})
    song = tmp_path / "song.wav"
    write_wav(song, np.zeros(SR, np.float32), SR)
    with pytest.raises(FileNotFoundError):
        separate_and_segment(
            input_uri=str(song), export_dir=str(tmp_path / "out"), mode="librosa_onset",
            device="cpu", runtime_overrides={
                "enhanced_separation.backend": "convtdf",
                "enhanced_separation.convtdf.checkpoint": str(tmp_path / "missing.msgpack"),
            })
    assert not list((tmp_path / "out").glob("*.wav"))
