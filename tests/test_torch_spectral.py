"""The spectral backend on the engine's device OLA, against the JAX package.

``make_backend("spectral", ...)`` builds the model-free harmonic-percussive
mask; the engine runs it on the config schedule (10 s windows, 2.5 s
overlap, 0.5 s halo, align 4096), groups of 4 windows, one K1 launch per
group on the card (the plain OLA here, on the CPU).

Every end-to-end run turns the pipelined piece upload off in both
packages, so that these tests hold the whole-track path;
``test_torch_pipelined.py`` holds the pieces to it, and
``test_torch_slice.py`` compares the manifests with the pieces on.

Bounds: both packages compute in float32 with two libraries' FFTs, and the
medians are exact selections of nearly equal inputs, so a window's vocal
agrees within atol 1e-5 (the bound of ``test_torch_train.py`` for one
window) and the OLA of such windows within the same; a PCM-24 stem may then
differ from the JAX package's by a few 24-bit steps, held at 1e-5. The
instrumental is the exact complement of the vocal in each package, and the
manifests and cuts are equal.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from conftest import make_song  # noqa: E402

OVERRIDES = {"enhanced_separation.backend": "spectral", "device_pipeline.pipelined_upload": False}
STEM_ATOL = 1e-5


def test_separate_windows_matches_jax():
    """5 seeded windows of 2 s: groups of 4 and 1 in the port, where the
    JAX package pads to 8; each window is independent of its group."""
    import jax.numpy as jnp
    import torch

    from audio_cut_tpu.separation.backends import SpectralMaskBackend as JSpectral
    from audio_cut_tpu_torch.separation.backends import make_backend

    sr = 44100
    windows = (0.3 * np.random.default_rng(12).standard_normal((5, 2 * sr))).astype(np.float32)
    jv, ji = JSpectral(sr).separate_windows_fn(jnp.asarray(windows))
    x = torch.from_numpy(windows)
    tv, ti = make_backend("spectral", sr, "cpu").separate_windows(x)
    assert tv.shape == ti.shape == (5, 2 * sr)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    assert torch.equal(ti, x - tv)
    np.testing.assert_allclose(np.asarray(ji), windows - np.asarray(jv), atol=1e-6, rtol=0)


def _scrub(m):
    m = copy.deepcopy(m)
    m.pop("timings_ms")
    m.pop("manifest_path", None)
    m["artifacts"].pop("output_dir")
    for k in ("gpu_pipeline_compute_ms", "gpu_pipeline_total_ms", "gpu_pipeline_device"):
        m["gpu"].pop(k)
    m["separation"].pop("confidence")
    return m


@pytest.fixture(scope="module")
def separation_runs(tmp_path_factory):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    root = tmp_path_factory.mktemp("spectral_sep")
    audio, sr = make_song(12.0)
    song = root / "song.wav"
    write_wav(song, audio, sr, subtype="FLOAT")
    mj = jax_run(input_uri=str(song), export_dir=str(root / "jax"), mode="vocal_separation",
                 export_manifest=True, runtime_overrides=OVERRIDES)
    mt = torch_run(input_uri=str(song), export_dir=str(root / "torch"), mode="vocal_separation",
                   device="cpu", export_manifest=True, runtime_overrides=OVERRIDES)
    return root, audio, mj, mt


def test_vocal_separation_manifest(separation_runs):
    _, _, mj, mt = separation_runs
    assert mj["success"] and mt["success"]
    assert _scrub(mt) == _scrub(mj)
    assert mt["gpu"]["gpu_pipeline_backend"] == "spectral"
    assert mt["gpu"]["gpu_pipeline_chunks"] == 2
    assert mt["gpu"]["gpu_pipeline_device"] == "cpu"
    assert abs(mt["separation"]["confidence"] - mj["separation"]["confidence"]) <= 1e-6


def test_vocal_separation_stems(separation_runs):
    from audio_cut_tpu_torch.io import read_wav

    root, audio, mj, mt = separation_runs
    for key in ("vocal_full", "instrumental_full"):
        sj, _ = read_wav(root / "jax" / mj["artifacts"][key])
        st, _ = read_wav(root / "torch" / mt["artifacts"][key])
        assert sj.shape == st.shape == audio.shape
        np.testing.assert_allclose(st, sj, atol=STEM_ATOL, rtol=0)


def test_vocal_separation_instrumental_is_the_exact_complement(separation_runs):
    from audio_cut_tpu.io import read_wav as jax_read
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24, read_wav

    root, audio, mj, mt = separation_runs
    codec = get_pcm_codec()
    v, _ = jax_read(root / "jax" / mj["artifacts"]["vocal_full"])
    i, _ = jax_read(root / "jax" / mj["artifacts"]["instrumental_full"])
    np.testing.assert_array_equal(i, codec.decode_pcm24(codec.encode_pcm24(audio - v)))
    v, _ = read_wav(root / "torch" / mt["artifacts"]["vocal_full"])
    i, _ = read_wav(root / "torch" / mt["artifacts"]["instrumental_full"])
    np.testing.assert_array_equal(i, decode_pcm24(encode_pcm24(audio - v)))


def test_v22_mdd_cuts(tmp_path):
    """The default mode with the spectral backend on a 15 s song (the same
    15 s bucket as 12 s): the same cut samples and segments."""
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    audio, sr = make_song(15.0)
    song = tmp_path / "song.wav"
    write_wav(song, audio, sr, subtype="FLOAT")
    mj = jax_run(input_uri=str(song), export_dir=str(tmp_path / "jax"), mode="v2.2_mdd",
                 runtime_overrides=OVERRIDES)
    mt = torch_run(input_uri=str(song), export_dir=str(tmp_path / "torch"), device="cpu",
                   runtime_overrides=OVERRIDES)
    assert mt["gpu"]["gpu_pipeline_backend"] == "spectral"
    assert len(mt["cuts"]["samples"]) >= 3  # at least one cut inside the song
    assert mt["cuts"]["samples"] == mj["cuts"]["samples"]
    keys = ("id", "start", "end", "label", "mix_path")
    assert [{k: s[k] for k in keys} for s in mt["segments"]] == \
        [{k: s[k] for k in keys} for s in mj["segments"]]


def test_backend_key_covers_the_vocal_band(monkeypatch):
    """A runtime change to ``vocal_separation.vocal_freq_min`` builds a
    backend with the new band; a key on ``enhanced_separation.spectral``
    alone would hand back the cached backend with the old one."""
    import torch

    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.separation import backends

    monkeypatch.setattr(backends, "_BACKEND_CACHE", {})
    first = backends.make_backend("spectral", 44100, "cpu")
    assert backends.make_backend("spectral", 44100, "cpu") is first
    set_runtime_config({"vocal_separation.vocal_freq_min": 300})
    try:
        second = backends.make_backend("spectral", 44100, "cpu")
        fresh = backends.SpectralMaskBackend(44100)
    finally:
        reset_runtime_config()
    assert not torch.equal(second._band, first._band)
    assert torch.equal(second._band, fresh._band)
    assert backends.make_backend("spectral", 44100, "cpu") is first


def test_failed_primary_backend_raises_and_builds_no_spectral(monkeypatch, tmp_path):
    """``convtdf`` with a missing checkpoint and ``enable_fallback: true``
    raises through the entry point; no spectral backend is built in its place."""
    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.io import write_wav
    from audio_cut_tpu_torch.separation import backends

    monkeypatch.setattr(backends, "_BACKEND_CACHE", {})
    built = []
    monkeypatch.setattr(backends.SpectralMaskBackend, "__init__",
                        lambda self, *a, **k: built.append(a))
    song = tmp_path / "song.wav"
    write_wav(song, np.zeros(44100, np.float32), 44100)
    missing = tmp_path / "missing.msgpack"
    with pytest.raises(FileNotFoundError):
        separate_and_segment(
            input_uri=str(song), export_dir=str(tmp_path / "out"), mode="vocal_separation",
            device="cpu", runtime_overrides={
                "enhanced_separation.backend": "convtdf",
                "enhanced_separation.convtdf.checkpoint": str(missing),
                "enhanced_separation.enable_fallback": True,
                "enhanced_separation.fallback_backend": "spectral",
            })
    assert built == []
    assert not [key for key in backends._BACKEND_CACHE if key[0] == "spectral"]
