"""STFT, iSTFT, framing and kernel K1's plain version: the port against the
JAX package on the same inputs (numpy, seeded).

Tolerances: framing and the overlap-add are exact copies and sums in the same
order, held at atol 1e-5 as the JAX package holds its own Pallas kernel
(tests/unit/test_pallas_kernels.py). iSTFT outputs are at signal scale and
held at atol 1e-5 too. STFT spectra grow with n_fft (|X| ~ 50 here), and two
FFT libraries sum in different orders: float32 rounding of an n-point FFT is
about eps * log2(n) relative, so they are held at 2e-6 * max|X|.
"""

import importlib

import numpy as np
import pytest
import torch

from audio_cut_tpu_torch.testing import K1_EDGE_SHAPES

jnp = pytest.importorskip("jax.numpy")

J = importlib.import_module("audio_cut_tpu.ops.stft")
T = importlib.import_module("audio_cut_tpu_torch.ops.stft")
GEOMS = [(2048, 512), (6144, 1024)]


def _signal(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n_fft, hop", GEOMS)
@pytest.mark.parametrize("batch", [None, 2])
def test_frame_signal_and_stft_match_jax(n_fft, hop, batch):
    n = 24 * hop + 77  # not a hop multiple: the reflect pad and last frame matter
    x = _signal((n,) if batch is None else (batch, n), seed=n_fft + (batch or 0))
    fj = np.asarray(J.frame_signal(jnp.asarray(x), n_fft, hop))
    ft = T.frame_signal(torch.from_numpy(x), n_fft, hop).numpy()
    assert ft.shape == fj.shape
    np.testing.assert_allclose(ft, fj, atol=1e-5, rtol=0)
    sj = np.asarray(J.stft(jnp.asarray(x), n_fft=n_fft, hop=hop))
    st = T.stft(torch.from_numpy(x), n_fft, hop).numpy()
    assert st.shape == sj.shape and st.dtype == np.complex64
    assert np.abs(st - sj).max() <= 2e-6 * np.abs(sj).max()


@pytest.mark.parametrize("n_fft, hop", GEOMS)
@pytest.mark.parametrize("batch", [None, 3])
def test_istft_matches_jax(n_fft, hop, batch):
    n = 20 * hop
    x = _signal((n,) if batch is None else (batch, n), seed=7 + n_fft)
    spec = np.asarray(J.stft(jnp.asarray(x), n_fft=n_fft, hop=hop))
    for length in (n, n - 123, n + 321):
        ij = np.asarray(J.istft(jnp.asarray(spec), n_fft=n_fft, hop=hop, length=length))
        it = T.istft(torch.from_numpy(spec.copy()), n_fft, hop, length=length).numpy()
        assert it.shape == ij.shape
        np.testing.assert_allclose(it, ij, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_fft, hop", GEOMS)
@pytest.mark.parametrize("batch", [None, 3])
def test_plain_ola_matches_jax_reference_and_pallas_interpret(n_fft, hop, batch):
    from audio_cut_tpu.ops.pallas.ola import windowed_ola_interpret, windowed_ola_reference
    from audio_cut_tpu_torch.ops.ola import windowed_ola, windowed_ola_reference as plain

    n = 13
    frames = np.random.default_rng(n_fft).standard_normal(
        (n, n_fft) if batch is None else (batch, n, n_fft)).astype(np.float32)
    win = np.array(J.hann_window(n_fft))
    want = np.asarray(windowed_ola_reference(jnp.asarray(frames), jnp.asarray(win), hop))
    got = plain(torch.from_numpy(frames), torch.from_numpy(win), hop).numpy()
    assert got.shape == want.shape == frames.shape[:-2] + ((n - 1) * hop + n_fft,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        windowed_ola(torch.from_numpy(frames), torch.from_numpy(win), hop).numpy(), got)
    if n_fft == 2048:  # the Pallas kernel in interpret mode, at its test size
        pal = np.asarray(windowed_ola_interpret(jnp.asarray(frames), jnp.asarray(win), hop))
        np.testing.assert_allclose(got, pal, atol=1e-5, rtol=0)


def test_hann_window_matches_jax():
    for n in (1024, 2048, 6144):
        np.testing.assert_allclose(T.hann_window(n).numpy(), np.asarray(J.hann_window(n)),
                                   atol=1e-7, rtol=0)


def test_istft_roundtrip():
    """The round trip of tests/unit/test_pallas_kernels.py, through the port."""
    x = (np.random.default_rng(3).standard_normal(86 * 512) * 0.3).astype(np.float32)
    spec = T.stft(torch.from_numpy(x), n_fft=2048, hop=512)
    back = T.istft(spec, n_fft=2048, hop=512, length=x.size).numpy()
    np.testing.assert_allclose(back, x, atol=1e-4)


def test_ola_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    meta device stands in for a device tensor the kernel does not take."""
    from audio_cut_tpu_torch.ops.ola import K1, windowed_ola

    frames = torch.empty((4, 8, 512), device="meta")
    window = torch.empty((512,), device="meta")
    before = K1.launches
    with pytest.raises(ValueError, match="CUDA"):
        windowed_ola(frames, window, 128)
    assert K1.launches == before


def test_ola_kernel_source_matches_wrapper_signature():
    """The C launch function the wrapper binds exists with eight arguments."""
    import re
    from pathlib import Path

    from audio_cut_tpu_torch.ops.ola import K1

    src = (Path(T.__file__).resolve().parents[1] / "csrc" / "ola.cu").read_text()
    m = re.search(r'extern "C" int windowed_ola_launch\(([^)]*)\)', src, re.S)
    assert m is not None and K1.symbol == "windowed_ola_launch"
    assert len(m.group(1).split(",")) == len(K1._argtypes) == 8


def test_ola_kernel_terms_in_flight_match_the_shared_edges():
    """The edge ``r above kMaxRatio`` of ``testing.K1_EDGE_SHAPES`` is one for
    the kernel's own kMaxRatio."""
    import re
    from pathlib import Path

    from audio_cut_tpu_torch.testing import K1_MAX_RATIO

    src = (Path(T.__file__).resolve().parents[1] / "csrc" / "ola.cu").read_text()
    assert re.findall(r"constexpr int kMaxRatio = (\d+);", src) == [str(K1_MAX_RATIO)]


@pytest.mark.parametrize("edge, batch, n, L, hop, offset", K1_EDGE_SHAPES)
def test_k1_edge_cases_are_their_edges(edge, batch, n, L, hop, offset):
    """Each of K1's shared edge cases (the card tests hold the kernel there)
    is that edge, and K1's plain version agrees with the JAX reference on it."""
    from audio_cut_tpu.ops.pallas.ola import windowed_ola_reference
    from audio_cut_tpu_torch.ops.ola import windowed_ola_reference as plain
    from audio_cut_tpu_torch.testing import k1_edge_holds, k1_inputs

    assert k1_edge_holds(edge, batch, n, L, hop, offset)
    frames = k1_inputs((batch, n, L), n + L, "cpu", offset)
    got = plain(frames, T.hann_window(L), hop).numpy()
    want = np.asarray(windowed_ola_reference(jnp.asarray(frames.numpy()),
                                             jnp.asarray(np.array(J.hann_window(L))), hop))
    assert got.shape == want.shape == (batch, (n - 1) * hop + L)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
