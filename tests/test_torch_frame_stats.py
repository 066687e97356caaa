"""Kernel K2's plain version and the feature-grid envelopes: the port against
the JAX package on the same seeded numpy inputs.

K2 (spectral flatness and onset flux) is held at rtol 2e-4 / atol 2e-5
against both the JAX package's jnp twin and its Pallas kernel in interpret
mode, the tolerance the JAX package holds its own kernel to
(tests/unit/test_pallas_kernels.py): means of logs over 1025 bins, summed in
another order.

The windowed RMS envelopes are sums of squares from per-bin cumulative sums;
XLA and PyTorch scan in different orders, so they are held at rtol 1e-5 and
an atol of 1e-6 of the signal's RMS. The feature STFT (n_fft 2048, hop 2205:
hop > n_fft) frames exactly as the JAX package does.
"""

import importlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

JK = importlib.import_module("audio_cut_tpu.ops.pallas.frame_stats")
JF = importlib.import_module("audio_cut_tpu.ops.frames")
JS = importlib.import_module("audio_cut_tpu.ops.stft")
TK = importlib.import_module("audio_cut_tpu_torch.ops.frame_stats")
TF = importlib.import_module("audio_cut_tpu_torch.ops.frames")
TS = importlib.import_module("audio_cut_tpu_torch.ops.stft")


def _mag(shape, seed):
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal(shape)).astype(np.float32)
    mag[3] = 0.0  # a silent frame: log(0 + eps) and a negative flux step
    return mag


@pytest.mark.parametrize("shape", [(64, 1025), (300, 1025), (257, 129)])
def test_k2_plain_version_matches_jax_twin_and_interpreted_kernel(shape):
    mag = _mag(shape, seed=shape[0])
    ft, ot = (x.numpy() for x in TK.spectral_stats(torch.from_numpy(mag)))
    fr, orf = (np.asarray(x) for x in JK.spectral_stats_reference(jnp.asarray(mag)))
    fi, oi = (np.asarray(x) for x in JK.spectral_stats_interpret(jnp.asarray(mag)))
    assert ft.shape == ot.shape == (shape[0],) and ft.dtype == ot.dtype == np.float32
    for got, want in ((ft, fr), (ot, orf), (ft, fi), (ot, oi)):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert ot[0] == 0.0


def test_k2_wrapper_takes_the_plain_version_only_on_the_cpu():
    mag = torch.from_numpy(_mag((8, 33), seed=1))
    before = TK.K2.launches
    flat, onset = TK.spectral_stats(mag)
    assert TK.K2.launches == before  # nothing launched for a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        TK.spectral_stats_cuda(mag)


def _song(n, seed):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal(n)
    x[n // 3:n // 3 + 4000] *= 1e-4  # a quiet stretch inside a loud track
    return x.astype(np.float32)


@pytest.mark.parametrize("frame, hop", [(2048, 2205), (1102, 441), (2205, 882), (512, 512)])
def test_frame_rms_matches_jax(frame, hop):
    x = _song(44100 * 3 + 123, seed=frame)
    want = np.asarray(JF.frame_rms(jnp.asarray(x), frame, hop))
    got = TF.frame_rms(torch.from_numpy(x), frame, hop).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * 0.3)


def test_mdd_series_matches_jax():
    rng = np.random.default_rng(5)
    rms, flat, onset = (rng.random(301).astype(np.float32) for _ in range(3))
    want = np.asarray(JF.mdd_series(jnp.asarray(rms), jnp.asarray(flat), jnp.asarray(onset)))
    got = TF.mdd_series(*(torch.from_numpy(a) for a in (rms, flat, onset))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_feature_stft_with_hop_above_n_fft_matches_jax():
    x = _song(2205 * 40 + 77, seed=9)
    fj = np.asarray(JS.frame_signal(jnp.asarray(x), 2048, 2205))
    ft = TS.frame_signal(torch.from_numpy(x), 2048, 2205).numpy()
    assert ft.shape == fj.shape == (41, 2048)
    np.testing.assert_array_equal(ft, fj)
    mj = np.abs(np.asarray(JS.stft(jnp.asarray(x), n_fft=2048, hop=2205)))
    mt = torch.abs(TS.stft(torch.from_numpy(x), 2048, 2205)).numpy()
    assert np.abs(mt - mj).max() <= 2e-6 * mj.max()
