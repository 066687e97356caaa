"""The ONNX separator tier (``separation/onnx_backend.py``, the ``onnx``
backend) of the port against the JAX package, on the CPU.

1. ``separate_windows`` against the JAX backend's ``separate_windows_fn`` on
   seeded windows: the identity-mask model of ``tests/unit/test_onnx.py``
   (n_fft 1024, hop 256, dim_t 64, all 513 bins) named as a vocal and as an
   instrumental model, and the mini MDX fixture (its geometry read from the
   file) at shifts 1 and 2. Both stems within 1e-5 * max(1, max |JAX|)
   (float32 on both sides; the two FFT libraries round differently).
2. The backend's settings against the JAX backend's: the model's geometry
   over the config's, the window, the engine schedule, ``output: auto``,
   ``map_group // shifts``; and the cache key of ``make_backend``, which
   reads the two environment names as the JAX package's does.
3. What raises, in both packages where both raise: no model
   (``FileNotFoundError``, also with ``enable_fallback`` on, where the JAX
   engine falls back), ``dim_f > n_fft / 2 + 1``, a graph with two inputs,
   an unsupported op; and, in the port only (the JAX package re-tiles), a
   window of another length.
4. ``separate`` through the port's engine on the identity model gives the
   mix back within 5e-3 (the JAX package's engine bound for that model).
5. The slice: ``separate_and_segment(device="cpu")`` in ``v2.2_mdd`` on the
   identity model against the JAX package's call: both run the onnx
   backend, the same number of cuts, each within one dB-grid stride, and
   the port's segments splice back to the PCM-24 input exactly.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from conftest import make_song  # noqa: E402

from audio_cut_tpu.onnx import Graph, Node, save_model as jax_save  # noqa: E402

MDX_MINI = Path(__file__).resolve().parent / "fixtures" / "onnx" / "mdxnet_trim_mini.onnx"
SR = 44100
IDENTITY = {"enhanced_separation.onnx.n_fft": 1024, "enhanced_separation.onnx.hop": 256,
            "enhanced_separation.onnx.dim_f": 513, "enhanced_separation.onnx.dim_t": 64}


def _identity_model(path, n_inputs=1, op="Mul"):
    """Mask net that passes the spectrogram through (vocal = input mix)."""
    inputs = ["input"] + [f"extra{k}" for k in range(1, n_inputs)]
    g = Graph(nodes=[Node(op, ["input", "one"], ["output"], "id", {})],
              initializers={"one": np.asarray(1.0, np.float32)},
              inputs=inputs, outputs=["output"],
              input_shapes={name: [None, 4, None, None] for name in inputs})
    jax_save(g, str(path))
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("onnx_models")
    return {"vocal": _identity_model(root / "tiny_vocal_model.onnx"),
            "instrumental": _identity_model(root / "tiny_inst_model.onnx"),
            "two_inputs": _identity_model(root / "two_inputs_vocal.onnx", n_inputs=2),
            "unsupported": _identity_model(root / "lstm_vocal.onnx", op="LSTM")}


class _Both:
    """The same runtime overrides in both packages' config while active."""

    def __init__(self, overrides):
        self.overrides = overrides

    def __enter__(self):
        from audio_cut_tpu.config import set_runtime_config as set_jax
        from audio_cut_tpu_torch.config import set_runtime_config as set_port

        set_jax(self.overrides)
        set_port(self.overrides)
        return self

    def __exit__(self, *exc):
        from audio_cut_tpu.config import reset_runtime_config as reset_jax
        from audio_cut_tpu_torch.config import reset_runtime_config as reset_port

        reset_jax()
        reset_port()


def _backends(overrides):
    from audio_cut_tpu.separation.onnx_backend import OnnxSeparatorBackend as JaxBackend
    from audio_cut_tpu_torch.separation.onnx_backend import OnnxSeparatorBackend

    with _Both(overrides):
        return JaxBackend(SR), OnnxSeparatorBackend(SR, "cpu")


def _window_cases(models):
    return {
        "identity_vocal": {**IDENTITY, "enhanced_separation.onnx.model_path": str(models["vocal"])},
        "identity_instrumental": {**IDENTITY, "enhanced_separation.onnx.model_path":
                                  str(models["instrumental"])},
        "mdx_mini": {"enhanced_separation.onnx.model_path": str(MDX_MINI)},
        "mdx_mini_shifts_2": {"enhanced_separation.onnx.model_path": str(MDX_MINI),
                              "enhanced_separation.onnx.shifts": 2},
    }


@pytest.mark.parametrize("case", ["identity_vocal", "identity_instrumental", "mdx_mini",
                                  "mdx_mini_shifts_2"])
def test_separate_windows_matches_jax(case, models):
    jb, tb = _backends(_window_cases(models)[case])
    assert (tb.output, tb.shifts, tb.map_group) == (jb.output, jb.shifts, jb.map_group)
    x = (0.2 * np.random.default_rng(4).standard_normal((3, tb.window_samples))).astype(np.float32)
    want = [np.asarray(s) for s in jb.separate_windows_fn(jnp.asarray(x))]
    got = [s.numpy() for s in tb.separate_windows(torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert g.shape == w.shape == x.shape and g.dtype == np.float32
        assert float(np.abs(g - w).max()) <= 1e-5 * max(1.0, float(np.abs(w).max()))
    if case.startswith("identity"):
        # the model's stem is the mix: the other stem is the complement, ~0
        stem, rest = got if tb.output == "vocals" else got[::-1]
        assert float(np.abs(stem - x).max()) < 1e-3 and float(np.abs(rest).max()) < 1e-3


def test_backend_settings_match_jax():
    """Config dim_f 2048 / dim_t 256 against the fixture's [None, 4, 128, 32]:
    the model wins."""
    jb, tb = _backends({"enhanced_separation.onnx.model_path": str(MDX_MINI),
                        "enhanced_separation.onnx.dim_f": 2048,
                        "enhanced_separation.onnx.dim_t": 256,
                        "enhanced_separation.onnx.map_group": 3})
    assert (tb.dim_f, tb.dim_t, tb.window_samples) == (jb.dim_f, jb.dim_t, jb.window_samples) \
        == (128, 32, 31 * 1024)
    assert tb.engine_geometry() == jb.engine_geometry()
    assert (tb.output, tb.map_group, tb.shifts, tb.model_path) == \
        (jb.output, jb.map_group, jb.shifts, jb.model_path) == ("instrumental", 3, 1, str(MDX_MINI))
    assert tb.net.param_count() == sum(v.size for v in jb.params.values())


def test_make_backend_cache_key(models, monkeypatch):
    from audio_cut_tpu.separation.backends import _config_key as jax_key
    from audio_cut_tpu_torch.separation.backends import _config_key, make_backend

    monkeypatch.setenv("AUDIO_CUT_ONNX_MODEL", str(models["vocal"]))
    with _Both(IDENTITY):
        assert _config_key("onnx") == jax_key("onnx")
        first = make_backend("onnx", SR, "cpu")
        assert make_backend("onnx", SR, "cpu") is first and first.model_path == str(models["vocal"])
        monkeypatch.setenv("AUDIO_CUT_ONNX_MODEL", str(models["instrumental"]))
        assert _config_key("onnx") == jax_key("onnx")
        second = make_backend("onnx", SR, "cpu")
        assert second is not first and second.output == "instrumental"


@pytest.mark.parametrize("case", ["no_model", "no_model_fallback_on", "dim_f_beyond_n_fft",
                                  "two_inputs", "unsupported_op"])
def test_backend_refuses_as_jax(case, models, tmp_path, monkeypatch):
    from audio_cut_tpu.separation.onnx_backend import OnnxSeparatorBackend as JaxBackend
    from audio_cut_tpu_torch.separation.backends import make_backend

    monkeypatch.delenv("AUDIO_CUT_ONNX_MODEL", raising=False)
    monkeypatch.chdir(tmp_path)  # no models/ directory to find a default file in
    overrides, exc, match = {
        "no_model": ({}, FileNotFoundError, "no ONNX separation model found"),
        "no_model_fallback_on": ({"enhanced_separation.enable_fallback": True},
                                 FileNotFoundError, "no ONNX separation model found"),
        "dim_f_beyond_n_fft": ({"enhanced_separation.onnx.model_path": str(MDX_MINI),
                                "enhanced_separation.onnx.n_fft": 128,
                                "enhanced_separation.onnx.hop": 32}, ValueError, "dim_f"),
        "two_inputs": ({**IDENTITY, "enhanced_separation.onnx.model_path":
                        str(models["two_inputs"])}, ValueError, "single-input"),
        "unsupported_op": ({**IDENTITY, "enhanced_separation.onnx.model_path":
                            str(models["unsupported"])}, ValueError, r"unsupported ops: \['LSTM'\]"),
    }[case]
    with _Both(overrides):
        with pytest.raises(exc, match=match):
            JaxBackend(SR)
        with pytest.raises(exc, match=match):
            make_backend("onnx", SR, "cpu")


def test_other_window_length_raises(models):
    _, tb = _backends({**IDENTITY, "enhanced_separation.onnx.model_path": str(models["vocal"])})
    with pytest.raises(NotImplementedError,
                       match=r"queue 1, 'other separator tiers \(waveunet, onnx\)'"):
        tb.separate_windows(torch.zeros(2, tb.window_samples + 256))


def test_separate_runs_the_engine(models):
    _, tb = _backends({**IDENTITY, "enhanced_separation.onnx.model_path": str(models["vocal"])})
    audio = (0.1 * np.random.default_rng(3).standard_normal(SR * 3)).astype(np.float32)
    v, i = tb.separate(audio)
    assert v.shape == i.shape == audio.shape and v.dtype == np.float32
    assert float(np.abs(v - audio).max()) < 5e-3 and float(np.abs(i).max()) < 5e-3


# -- the slice: separate_and_segment() with the onnx backend ---------------------------
#
# Both packages serve the identity model at n_fft 1024, hop 256, dim_t 64
# (16128-sample windows). The vocal stem is the mix, so the cuts come from
# the song's own pauses; the bound is the other tiers': the same count, each
# within one step of the dB grid the cuts are snapped on (DB_STRIDE samples).


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory, models):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    root = tmp_path_factory.mktemp("onnx_slice")
    overrides = {"enhanced_separation.backend": "onnx",
                 "enhanced_separation.onnx.model_path": str(models["vocal"]), **IDENTITY}
    audio, sr = make_song(12.0)
    song = root / "song.wav"
    write_wav(song, audio, sr, subtype="FLOAT")
    mj = jax_run(input_uri=str(song), export_dir=str(root / "jax"), mode="v2.2_mdd",
                 export_types=["mix_segments"], runtime_overrides=overrides)
    mt = torch_run(input_uri=str(song), export_dir=str(root / "torch"), device="cpu",
                   export_types=["mix_segments"], runtime_overrides=overrides)
    return root, audio, mj, mt


def test_slice_cuts_agree_and_splice_back(slice_runs):
    from audio_cut_tpu_torch.analysis.bundle import DB_STRIDE
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24, read_wav

    root, audio, mj, mt = slice_runs
    assert mj["success"] and mt["success"]
    for m in (mj, mt):
        assert m["separation"]["backend"] == m["gpu"]["gpu_pipeline_backend"] == "onnx"
    assert mt["gpu"]["gpu_pipeline_device"] == "cpu"
    assert mt["gpu"]["gpu_pipeline_chunks"] == mj["gpu"]["gpu_pipeline_chunks"]
    sj, st = mj["cuts"]["samples"], mt["cuts"]["samples"]
    assert len(st) == len(sj) >= 3  # the ends and at least one cut inside
    assert max(abs(a - b) for a, b in zip(st, sj)) <= DB_STRIDE
    xt = np.concatenate([read_wav(root / "torch" / s["mix_path"])[0] for s in mt["segments"]])
    np.testing.assert_array_equal(xt, decode_pcm24(encode_pcm24(audio)))
