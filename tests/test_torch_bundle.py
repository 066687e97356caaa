"""The detection bundle: the port's ``_bundle_fn`` against the JAX package's,
with the packaged ConvVAD, on one 10 s mix/vocal pair (a click track at
120 BPM under a voiced tone with two quiet gaps), padded to the engine's
15 s bucket as the serving path pads it.

Tolerances, by what each output sums:
* RMS envelopes (per-bin cumulative sums, scanned in another order):
  rtol 1e-5, atol 1e-7;
* flatness (K2's plain version over an STFT from another FFT library):
  rtol 2e-4, atol 2e-5, the bound of K2 itself. Onset: rtol 2e-4, atol
  1e-4, because log1p(1000 |X|) magnifies the two FFT libraries' rounding
  (about 2e-6 * max |X|) up to 1000-fold in near-silent bins before the mean
  over 1025 bins. The MDD series, which min-max normalises both, atol 1e-4;
* dB grids: atol 1e-3 dB;
* VAD probabilities: atol 1e-4 (see tests/test_torch_vad.py);
* the tempo (bpm, period, phase): 1e-4 relative; its strength atol 1e-4;
* the vocal energy (a float32 sum of 661,504 squares): rtol 1e-5.
The flat layout (sorted keys, shapes) equals the JAX package's, and both
packages' ``unpack_bundle`` give equal arrays from the same flat copy.
``build_detection_bundle`` (the bundle, its one host copy and the unpack)
agrees with the JAX package's within the same bounds, given the vocal cut
to its true length, which it pads with zeros as the JAX caller does.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

JB = importlib.import_module("audio_cut_tpu.analysis.bundle")
JV = importlib.import_module("audio_cut_tpu.models.vad")
TB = importlib.import_module("audio_cut_tpu_torch.analysis.bundle")
TV = importlib.import_module("audio_cut_tpu_torch.models.vad")

SR = 44100
N_TRUE = 10 * SR
PADDED = 661504  # padded_track_len of 10 s with the ConvTDF's hop-1024 alignment

TOL = {
    "rms": (1e-5, 1e-7), "vocal_rms_grid": (1e-5, 1e-7), "vocal_rms_fine": (1e-5, 1e-7),
    "act_rms": (1e-5, 1e-7),
    "flatness": (2e-4, 2e-5), "onset": (2e-4, 1e-4), "mdd": (0.0, 1e-4),
    "vocal_db_guard": (0.0, 1e-3), "mix_db_guard": (0.0, 1e-3),
    "mix_db_refine": (0.0, 1e-3), "vocal_db_fine": (0.0, 1e-3),
    "vad_probs": (0.0, 1e-4),
    "bpm": (1e-4, 0.0), "period_frames": (1e-4, 0.0), "phase_frames": (1e-4, 0.0),
    "tempo_strength": (0.0, 1e-4), "vocal_energy": (1e-5, 0.0),
}


def _pair():
    t = np.arange(N_TRUE) / SR
    vocal = 0.3 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 5.5 * t)))
    vocal += 0.1 * np.sin(2 * np.pi * 440 * t)
    for a, b in ((3.0, 3.8), (6.5, 7.1)):  # two quiet gaps
        vocal[int(a * SR):int(b * SR)] *= 1e-3
    clicks = np.zeros(N_TRUE)
    rng = np.random.default_rng(11)
    for beat in np.arange(0.0, 10.0, 0.5):
        i = int(beat * SR)
        clicks[i:i + 1500] += 0.5 * np.exp(-np.arange(1500) / 200.0) * rng.standard_normal(1500)
    mix = np.pad(vocal + clicks, (0, PADDED - N_TRUE)).astype(np.float32)
    return mix, np.pad(vocal, (0, PADDED - N_TRUE)).astype(np.float32)


@pytest.fixture(scope="module")
def bundles():
    from types import SimpleNamespace

    from flax.serialization import msgpack_restore

    ckpt = TV.packaged_checkpoint_path()
    with open(ckpt, "rb") as f:  # the params as flax restores them, without flax's init
        jax_vad = SimpleNamespace(net=JV.ConvVADNet(32, 4, 3), params=msgpack_restore(f.read()))
    torch_vad = TV.ConvVAD(SR, ckpt, "cpu")
    mix, vocal = _pair()
    statics = TB.bundle_statics(SR)
    assert statics == JB.bundle_statics(SR)
    jout = JB._bundle_fn(jnp.asarray(mix), jnp.asarray(vocal), jax_vad.params, SR, *statics, 32, 4, 3)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    with torch.inference_mode():
        tout = TB._bundle_fn(torch.from_numpy(mix), torch.from_numpy(vocal), torch_vad.net,
                             SR, *statics)
        flat, shapes = TB.flatten_bundle(tout)
    tout = {k: v.numpy() for k, v in tout.items()}
    jshapes = JB.bundle_shapes(PADDED, SR, statics, jax_vad)
    return jax_vad, torch_vad, statics, jout, tout, flat.numpy(), shapes, jshapes


@pytest.mark.parametrize("key", sorted(TOL))
def test_every_bundle_output_matches_jax(bundles, key):
    _, _, _, jout, tout, _, _, _ = bundles
    want, got = jout[key], tout[key]
    assert got.shape == want.shape and got.dtype == np.float32
    rtol, atol = TOL[key]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_the_pair_has_a_beat_and_speech(bundles):
    _, _, _, jout, tout, _, _, _ = bundles
    assert abs(float(tout["bpm"]) - 120.0) < 2.0
    assert 0.1 < float((tout["vad_probs"] > 0.2).mean()) < 0.95


def test_flat_layout_and_unpack_equal_jax(bundles):
    jax_vad, torch_vad, statics, jout, _, flat, shapes, jshapes = bundles
    assert list(shapes) == sorted(jshapes) == sorted(TOL)
    assert {k: tuple(v.shape) for k, v in jshapes.items()} == shapes
    assert flat.shape == (sum(int(np.prod(s)) for s in shapes.values()),)
    # one flat copy in the JAX package's layout, unpacked by both packages
    jflat = np.concatenate([np.ravel(jout[k]).astype(np.float32) for k in sorted(jout)])
    jb = JB.unpack_bundle(jflat, jshapes, SR, N_TRUE, statics, jax_vad)
    tb = TB.unpack_bundle(jflat, shapes, SR, N_TRUE, statics, torch_vad)
    for name in ("vocal_rms_grid", "vocal_rms_fine", "vocal_db_guard", "mix_db_guard",
                 "mix_db_refine", "vocal_db_fine", "act_rms", "vad_probs"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    for name in ("fine_fps", "db_stride", "act_fps", "vad_fps", "vocal_energy", "sr"):
        assert getattr(tb, name) == getattr(jb, name)
    for name in ("rms", "flatness", "onset", "mdd", "beat_times"):
        np.testing.assert_array_equal(getattr(tb.features, name), getattr(jb.features, name))
    for name in ("bpm", "tempo_strength", "hop_s", "duration_s"):
        assert getattr(tb.features, name) == getattr(jb.features, name)


def test_build_detection_bundle_matches_jax(bundles):
    from dataclasses import fields

    jax_vad, torch_vad, _, _, _, _, _, _ = bundles
    mix, vocal = _pair()
    jb = JB.build_detection_bundle(jnp.asarray(mix), jnp.asarray(vocal), SR, N_TRUE,
                                   vad_model=jax_vad)
    tb = TB.build_detection_bundle(torch.from_numpy(mix), torch.from_numpy(vocal[:N_TRUE]), SR,
                                   N_TRUE, vad_model=torch_vad)
    for name in ("vocal_rms_grid", "vocal_rms_fine", "vocal_db_guard", "mix_db_guard",
                 "mix_db_refine", "vocal_db_fine", "act_rms", "vad_probs", "vocal_energy"):
        got, want = np.asarray(getattr(tb, name)), np.asarray(getattr(jb, name))
        assert got.shape == want.shape, name
        rtol, atol = TOL[name]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    for name in ("rms", "flatness", "onset", "mdd"):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(getattr(tb.features, name), getattr(jb.features, name),
                                   rtol=rtol, atol=atol, err_msg=name)
    assert abs(tb.features.bpm - jb.features.bpm) <= TOL["bpm"][0] * abs(jb.features.bpm)
    assert abs(tb.features.tempo_strength - jb.features.tempo_strength) <= TOL["tempo_strength"][1]
    # the beats follow the tempo's period and phase, within their 1e-4 over 10 s
    assert tb.features.beat_times.shape == jb.features.beat_times.shape
    np.testing.assert_allclose(tb.features.beat_times, jb.features.beat_times, rtol=0.0,
                               atol=1e-4 * N_TRUE / SR)
    for f in fields(jb):
        if f.name not in ("features", "vocal_rms_grid", "vocal_rms_fine", "vocal_db_guard",
                          "mix_db_guard", "mix_db_refine", "vocal_db_fine", "act_rms",
                          "vad_probs", "vocal_energy"):
            assert getattr(tb, f.name) == getattr(jb, f.name), f.name
