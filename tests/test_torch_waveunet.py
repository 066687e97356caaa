"""The WaveUNet separator tier: the port against the JAX package at the
``--small`` geometry (window 16384, channels 8, depth 3), on seeded numpy
inputs and one flax parameter tree (flax's initialisation, with random
biases so that every leaf's mapping shows).

The JAX side of the float32 checks builds ``WaveUNetNet(..., dtype=
jnp.float32)`` here; the package is unchanged. Each test states its
tolerance.
"""

import json
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
nn = pytest.importorskip("flax.linen")
serialization = pytest.importorskip("flax.serialization")

from conftest import make_song  # noqa: E402

SMALL = dict(window_samples=16384, channels=8, depth=3)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _snr_db(ref, est) -> float:
    ref = np.asarray(ref, np.float64)
    return 10 * math.log10(float(np.sum(ref ** 2)) / float(np.sum((ref - est) ** 2)))


@pytest.fixture(scope="module")
def params():
    """flax's initialisation of the small net (one compile of ``init``), its
    biases replaced by seeded draws."""
    from audio_cut_tpu.models.waveunet import WaveUNetSeparator

    tree = jax.device_get(jax.jit(WaveUNetSeparator(44100, **SMALL).init_params)(
        jax.random.PRNGKey(3)))
    rng = np.random.default_rng(2)
    return jax.tree_util.tree_map(
        lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32) if p.ndim == 1
        else np.asarray(p), tree)


def _audio(rows=2, seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal((rows, SMALL["window_samples"]))
            ).astype(np.float32)


def _port_sep(params, dtype):
    from audio_cut_tpu_torch.models.waveunet import WaveUNetSeparator, convert_waveunet_params

    sep = WaveUNetSeparator(44100, dtype=dtype, **SMALL)
    sep.net.load_state_dict(convert_waveunet_params(params), strict=True)
    return sep


def test_net_matches_flax_f32(params):
    """The float32 net within atol 1e-5 of flax (outputs of order 1; the two
    libraries sum the same float32 products in other orders)."""
    from audio_cut_tpu.models.waveunet import WaveUNetNet as JNet

    x = _audio()
    jnet = JNet(channels=SMALL["channels"], depth=SMALL["depth"], dtype=jnp.float32)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)[..., None]))[..., 0]
    with torch.no_grad():
        got = _port_sep(params, torch.float32).net(torch.from_numpy(x)[:, None]).numpy()[:, 0]
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _strided(rng, length):
    from audio_cut_tpu_torch.models.waveunet import same_conv1d

    x = rng.standard_normal((2, length, 3)).astype(np.float32)
    conv = nn.Conv(5, (8,), strides=(4,), padding="SAME", dtype=jnp.float32)
    p = jax.device_get(conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    p["bias"] = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(conv.apply({"params": p}, jnp.asarray(x)))
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(p["kernel"], (2, 1, 0))))
    got = same_conv1d(torch.from_numpy(x).transpose(1, 2), w, torch.from_numpy(p["bias"]), 4)
    return got.transpose(1, 2).numpy(), want


def _transposed(rng):
    from audio_cut_tpu_torch.models.waveunet import same_conv_transpose1d

    x = rng.standard_normal((2, 37, 6)).astype(np.float32)
    conv = nn.ConvTranspose(4, (8,), strides=(4,), padding="SAME", dtype=jnp.float32)
    p = jax.device_get(conv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    p["bias"] = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(conv.apply({"params": p}, jnp.asarray(x)))
    # (k, in, out) -> (in, out, k), the taps flipped
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(p["kernel"], (1, 2, 0))[:, :, ::-1]))
    got = same_conv_transpose1d(torch.from_numpy(x).transpose(1, 2), w,
                                torch.from_numpy(p["bias"]), 4)
    assert got.shape[-1] == 4 * x.shape[1]
    return got.transpose(1, 2).numpy(), want


def _gelu(rng):
    from audio_cut_tpu_torch.models.waveunet import gelu

    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    return gelu(torch.from_numpy(x)).numpy(), np.asarray(nn.gelu(jnp.asarray(x)))


def _std(rng):
    from audio_cut_tpu_torch.models.waveunet import input_scale

    # short, off-centre rows, where ddof 1 would be 1.07x ddof 0; a silent row
    x = (rng.standard_normal((3, 8)) + 2.0).astype(np.float32)
    x[2] = 0.0
    want = np.asarray(jnp.std(jnp.asarray(x), axis=-1, keepdims=True) + 1e-6)
    return input_scale(torch.from_numpy(x)).numpy(), want


@pytest.mark.parametrize("case", ["strided_same_conv", "strided_same_conv_odd_length",
                                  "conv_transpose_same", "gelu_tanh", "std_ddof0"])
def test_layer_matches_flax(case):
    """Each place where the flax semantics are easy to miss, against flax in
    float32: the stride-4 SAME conv at a length divisible by 4 (pads 2, 2)
    and at one that is not (pads 2, 3), the stride-4 SAME ConvTranspose (pads
    5, 5 on the dilated input, kernel unflipped; 4n samples), the tanh GELU
    and the ddof-0 std + 1e-6. Tolerance: 1e-6 absolute (float32 rounding of
    sums of at most 48 products of order-1 values)."""
    rng = np.random.default_rng(9)
    with torch.no_grad():
        got, want = {
            "strided_same_conv": lambda: _strided(rng, 64),
            "strided_same_conv_odd_length": lambda: _strided(rng, 63),
            "conv_transpose_same": lambda: _transposed(rng),
            "gelu_tanh": lambda: _gelu(rng),
            "std_ddof0": lambda: _std(rng),
        }[case]()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_separate_fn_bf16_matches_jax(params):
    """``WaveUNetSeparator.separate_fn`` in bfloat16, as in production: the
    vocal within SNR >= 30 dB of the JAX package's (bfloat16 rounds at other
    places in XLA and in PyTorch), the instrumental the exact complement."""
    from audio_cut_tpu.models.waveunet import WaveUNetSeparator as JSep

    x = _audio(4, seed=5)
    jsep = JSep(44100, **SMALL)
    jv, _ = jax.jit(lambda p, a: jsep.separate_fn(p, a, a.shape[-1]))(params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    tv, ti = _port_sep(params, torch.bfloat16).separate(xt, x.shape[-1])
    assert tv.dtype == torch.float32 and tv.shape == x.shape
    assert _snr_db(jv, tv.numpy()) >= 30.0
    assert torch.equal(ti, xt - tv)


def test_param_tree_round_trip_and_count(params):
    """convert and its inverse give flax's tree back bit for bit; the full
    serving geometry (channels 24, depth 4) has flax's 1,028,785 parameters."""
    from audio_cut_tpu.models.waveunet import WaveUNetNet as JNet
    from audio_cut_tpu_torch.models.waveunet import (
        WaveUNetNet, convert_waveunet_params, to_flax_params)

    back = dict(_leaves(to_flax_params(convert_waveunet_params(params))))
    want = dict(_leaves(params))
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) and back[k].dtype == np.float32 for k in want)
    shapes = jax.eval_shape(JNet().init, jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1)))
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    n_port = sum(p.numel() for p in WaveUNetNet().parameters())
    assert n_port == n_flax == 1_028_785


def test_init_params_follow_flax(params):
    """Every kernel: mean and std of a truncated normal at +-2 sigma with
    variance 1 / fan_in (flax's lecun_normal, fan_in = taps x input
    channels), within 5 standard errors of the sample, and nothing beyond
    the truncation; flax's own draws pass the same bounds. Biases are 0."""
    from audio_cut_tpu.models.waveunet import WaveUNetSeparator as JSep
    from audio_cut_tpu_torch.models.waveunet import WaveUNetSeparator, to_flax_params

    flax_tree = dict(_leaves(jax.device_get(jax.jit(JSep(44100, **SMALL).init_params)(
        jax.random.PRNGKey(4)))))
    sep = WaveUNetSeparator(44100, **SMALL)
    sep.init_params(torch.Generator().manual_seed(0))
    port_tree = dict(_leaves(to_flax_params(sep.net.state_dict())))
    assert port_tree.keys() == flax_tree.keys() == dict(_leaves(params)).keys()
    kernels = 0
    for k, want in flax_tree.items():
        got = port_tree[k]
        assert got.shape == want.shape and got.dtype == np.float32, k
        if not k.endswith("kernel"):
            assert not got.any() and not want.any(), k
            continue
        kernels += 1
        std = math.sqrt(1.0 / int(np.prod(want.shape[:-1])))  # (k, in)
        for draws in (got, want):
            n = draws.size
            assert abs(float(draws.mean())) <= 5 * std / math.sqrt(n), k
            assert abs(float(draws.std()) - std) <= 5 * std * math.sqrt(1.4 / (4 * n)), k
            assert float(np.abs(draws).max()) <= 2 * std / 0.87962566103423978 * (1 + 1e-6), k
    assert kernels == 2 * 3 + 6 + 2 * 3  # encoder, bottleneck, decoder


@pytest.fixture()
def checkpoint(tmp_path, params):
    """The small tree as the JAX package writes it, with its sidecar."""
    path = tmp_path / "waveunet_small.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    (tmp_path / "waveunet_small.msgpack.json").write_text(
        json.dumps({"channels": SMALL["channels"], "depth": SMALL["depth"]}))
    return path


@pytest.mark.parametrize("case", ["unset_fallback_on", "unset_fallback_off", "packaged",
                                  "orbax_dir", "onnx"])
def test_make_backend_refuses(case, tmp_path, monkeypatch):
    """No checkpoint, or ``packaged`` (none ships), raises whatever
    ``enable_fallback`` says (the JAX package would run random weights with
    the fallback off); an orbax directory raises naming queue 1; ``onnx``
    with no model file raises ``FileNotFoundError`` (the JAX engine would
    fall back to another backend)."""
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.separation.backends import make_backend

    overrides, name, exc, match = {
        "unset_fallback_on": ({"enhanced_separation.waveunet.checkpoint": None,
                               "enhanced_separation.enable_fallback": True},
                              "waveunet", RuntimeError, "checkpoint is unset"),
        "unset_fallback_off": ({"enhanced_separation.waveunet.checkpoint": None,
                                "enhanced_separation.enable_fallback": False},
                               "waveunet", RuntimeError, "checkpoint is unset"),
        "packaged": ({}, "waveunet", RuntimeError, "no packaged checkpoint ships"),
        "orbax_dir": ({"enhanced_separation.waveunet.checkpoint": str(tmp_path)},
                      "waveunet", NotImplementedError, "orbax directories: ROADMAP.md, queue 1"),
        "onnx": ({}, "onnx", FileNotFoundError, "no ONNX separation model found"),
    }[case]
    monkeypatch.delenv("AUDIO_CUT_ONNX_MODEL", raising=False)
    monkeypatch.chdir(tmp_path)  # no models/ directory to find a default file in
    set_runtime_config(overrides)
    try:
        with pytest.raises(exc, match=match):
            make_backend(name, 44100, "cpu")
    finally:
        reset_runtime_config()


def test_backend_from_msgpack_and_sidecar(checkpoint, params):
    """``make_backend("waveunet")`` from a JAX-written msgpack: the sidecar
    pins channels and depth over the config's 24 and 4, the engine schedule
    is the JAX package's (overlap 4096, halo 1024, align 4096 at a 16384
    window), ``separate_windows`` equals the separator in groups of
    ``map_group`` bit for bit, ``separate`` runs the engine, and a window of
    another length raises naming the re-tiling item."""
    from audio_cut_tpu.models.waveunet import WaveUNetBackend as JBackend
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.models.waveunet import WaveUNetBackend
    from audio_cut_tpu_torch.separation.backends import make_backend

    overrides = {"enhanced_separation.waveunet.checkpoint": str(checkpoint),
                 "enhanced_separation.waveunet.window_samples": SMALL["window_samples"],
                 "enhanced_separation.waveunet.map_group": 3}
    set_runtime_config(overrides)
    try:
        backend = make_backend("waveunet", 44100, "cpu")
        assert make_backend("waveunet", 44100, "cpu") is backend
    finally:
        reset_runtime_config()
    assert isinstance(backend, WaveUNetBackend) and backend.name == "waveunet"
    assert (backend.sep.net.channels, backend.sep.net.depth, backend.map_group) == (8, 3, 3)
    jb = JBackend.__new__(JBackend)
    jb.sample_rate, jb.sep = 44100, backend.sep  # engine_geometry reads these two
    assert backend.engine_geometry() == JBackend.engine_geometry(jb)
    assert backend.engine_geometry()["overlap_s"] * 44100 == pytest.approx(4096)
    windows = torch.from_numpy(_audio(4, seed=6))
    v, i = backend.separate_windows(windows)
    for j in (0, 3):
        want, _ = backend.sep.separate(windows[j:j + 3], windows.shape[-1])
        assert torch.equal(v[j:j + 3], want)
    assert torch.equal(i, windows - v)
    with pytest.raises(NotImplementedError, match="other separator tiers"):
        backend.separate_windows(windows[:, :8192])
    from audio_cut_tpu_torch.separation.engine import dequantize, upload_pair

    song = make_song(2.0)[0]
    vocal, inst = backend.separate(song)
    assert vocal.shape == inst.shape == song.shape and np.isfinite(vocal).all()
    # the stems sum to the engine's mix (the int16 upload), up to float32
    # rounding of the weighted window sums
    mix = dequantize(*upload_pair(song, song.size), "cpu").numpy()
    assert np.abs(vocal + inst - mix).max() <= 1e-6


# -- the slice: separate_and_segment() with the WaveUNet backend -------------
#
# Both packages serve the same JAX-written small checkpoint and sidecar at a
# 16384-sample window (the config's window_samples): the 15 s bucket's 54
# windows in 8 pipelined pieces. The port runs v2.2_mdd with no mode on
# device="cpu"; both export the mix segments and the full vocal.
#
# Bounds: bfloat16 separation noise (SNR >= 30 dB between the stems) moves
# the envelopes the cuts are read from by at most one step of the dB grid
# they are snapped on (DB_STRIDE samples); the cut count is equal.


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory, params):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    root = tmp_path_factory.mktemp("waveunet_slice")
    ckpt = root / "waveunet_small.msgpack"
    # flax's own initialisation, zero biases and all
    ckpt.write_bytes(serialization.to_bytes(jax.tree_util.tree_map(
        lambda p: np.zeros_like(p) if p.ndim == 1 else p, params)))
    (root / "waveunet_small.msgpack.json").write_text(json.dumps({"channels": 8, "depth": 3}))
    overrides = {"enhanced_separation.backend": "waveunet",
                 "enhanced_separation.waveunet.checkpoint": str(ckpt),
                 "enhanced_separation.waveunet.window_samples": SMALL["window_samples"]}
    audio, sr = make_song(15.0)
    song = root / "song.wav"
    write_wav(song, audio, sr, subtype="FLOAT")
    exports = ["mix_segments", "full_vocal"]
    mj = jax_run(input_uri=str(song), export_dir=str(root / "jax"), mode="v2.2_mdd",
                 export_types=exports, runtime_overrides=overrides)
    mt = torch_run(input_uri=str(song), export_dir=str(root / "torch"), device="cpu",
                   export_types=exports, runtime_overrides=overrides)
    return root, audio, mj, mt


def test_slice_runs_the_waveunet_in_both(slice_runs):
    _, _, mj, mt = slice_runs
    assert mj["success"] and mt["success"]
    assert mt["version"] == mj["version"] == "v2.2_mdd"
    for m in (mj, mt):
        assert m["separation"]["backend"] == m["gpu"]["gpu_pipeline_backend"] == "waveunet"
        assert m["gpu"]["gpu_pipeline_chunks"] == 54
    assert mt["gpu"]["gpu_pipeline_mode"] == mj["gpu"]["gpu_pipeline_mode"] == "fused_pipelined_p8"
    assert mt["gpu"]["gpu_pipeline_device"] == "cpu"


def test_slice_vocal_stems_agree(slice_runs):
    from audio_cut_tpu_torch.io import read_wav

    root, audio, mj, mt = slice_runs
    vj, _ = read_wav(root / "jax" / mj["artifacts"]["vocal_full"])
    vt, _ = read_wav(root / "torch" / mt["artifacts"]["vocal_full"])
    assert vj.shape == vt.shape == audio.shape and np.isfinite(vt).all()
    assert _snr_db(vj, vt) >= 30.0


def test_slice_cuts_agree_and_splice_back(slice_runs):
    from audio_cut_tpu_torch.analysis.bundle import DB_STRIDE
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24, read_wav

    root, audio, mj, mt = slice_runs
    sj, st = mj["cuts"]["samples"], mt["cuts"]["samples"]
    assert len(st) == len(sj) >= 3  # the ends and at least one cut inside
    assert max(abs(a - b) for a, b in zip(st, sj)) <= DB_STRIDE
    assert [s["label"] for s in mt["segments"]] == [s["label"] for s in mj["segments"]]
    xt = np.concatenate([read_wav(root / "torch" / s["mix_path"])[0] for s in mt["segments"]])
    np.testing.assert_array_equal(xt, decode_pcm24(encode_pcm24(audio)))
