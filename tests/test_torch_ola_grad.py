"""K1's backward on the CPU: the port's ``WindowedOLA`` against the JAX
package's custom VJP ``_ola_bwd``, reached by ``jax.vjp`` of the interpreted
Pallas kernel (``windowed_ola_interpret``), and the iSTFT's gradient against
the JAX iSTFT's.

Tolerances: the frames' gradient is one float32 product per element on both
sides, so it is held exactly. The window's gradient sums B*N products per
column in another order (torch's reduction against XLA's); at these shapes
(at most 39 terms of order 1) float32 reordering stays below 1e-5, held at
atol 1e-5. The iSTFT gradient passes through each package's irfft adjoint
(two FFT libraries), held at 1e-5 * max |JAX|, as the STFT tests hold their
spectra to FFT rounding.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

SHAPES = [((21, 512), 128), ((3, 13, 256), 64)]  # 2-D, and batched


def _inputs(shape, hop, seed):
    rng = np.random.default_rng(seed)
    n, L = shape[-2], shape[-1]
    frames = rng.standard_normal(shape).astype(np.float32)
    window = rng.uniform(0.0, 1.0, L).astype(np.float32)
    g = rng.standard_normal(shape[:-2] + ((n - 1) * hop + L,)).astype(np.float32)
    return frames, window, g


@pytest.mark.parametrize("shape, hop", SHAPES)
def test_windowed_ola_backward_matches_jax_vjp(shape, hop):
    from audio_cut_tpu.ops.pallas.ola import windowed_ola_interpret
    from audio_cut_tpu_torch.ops.ola import WindowedOLA, windowed_ola_backward_reference

    frames, window, g = _inputs(shape, hop, seed=shape[-1])
    out_j, vjp = jax.vjp(lambda f, w: windowed_ola_interpret(f, w, hop),
                         jnp.asarray(frames), jnp.asarray(window))
    want_f, want_w = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    f = torch.from_numpy(frames).requires_grad_(True)
    w = torch.from_numpy(window).requires_grad_(True)
    out = WindowedOLA.apply(f, w, hop)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=0)
    out.backward(torch.from_numpy(g))
    assert np.array_equal(f.grad.numpy(), want_f)
    np.testing.assert_allclose(w.grad.numpy(), want_w, atol=1e-5, rtol=0)

    ref_f, ref_w = windowed_ola_backward_reference(torch.from_numpy(g), torch.from_numpy(frames),
                                                   torch.from_numpy(window), hop)
    assert torch.equal(ref_f, f.grad) and torch.equal(ref_w, w.grad)


@pytest.mark.parametrize("want_frames, want_window", [(True, False), (False, True)])
def test_plain_backward_computes_only_the_outputs_asked_for(want_frames, want_window):
    """Each output alone equals the same output computed with both, exactly;
    the one not asked for is None, and without the window's gradient the
    frames are not needed."""
    from audio_cut_tpu_torch.ops.ola import windowed_ola_backward_reference

    frames, window, g = (torch.from_numpy(x) for x in _inputs((3, 13, 256), 64, seed=4))
    both = windowed_ola_backward_reference(g, frames, window, 64)
    got = windowed_ola_backward_reference(
        g, frames if want_window else None, window, 64, frames_shape=frames.shape,
        want_frames=want_frames, want_window=want_window)
    for want, one, ref in zip((want_frames, want_window), got, both):
        assert torch.equal(one, ref) if want else one is None


@pytest.mark.parametrize("shape, hop", [((9, 32), 8), ((2, 5, 16), 4)])
def test_windowed_ola_gradcheck_float64(shape, hop):
    from audio_cut_tpu_torch.ops.ola import WindowedOLA

    frames, window, _ = _inputs(shape, hop, seed=1)
    f = torch.from_numpy(frames.astype(np.float64)).requires_grad_(True)
    w = torch.from_numpy(window.astype(np.float64)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: WindowedOLA.apply(a, b, hop), (f, w))


def test_windowed_ola_asks_only_for_the_gradients_it_needs():
    """A constant window (the iSTFT's) gets no gradient and its frames are not
    kept; under no_grad the Function is not entered at all."""
    from audio_cut_tpu_torch.ops.ola import windowed_ola

    frames, window, g = _inputs((2, 9, 256), 64, seed=2)
    f = torch.from_numpy(frames).requires_grad_(True)
    out = windowed_ola(f, torch.from_numpy(window), 64)
    assert out.grad_fn is not None and out.grad_fn.saved_tensors[0] is None
    out.backward(torch.from_numpy(g))
    assert f.grad is not None
    with torch.no_grad():
        assert windowed_ola(f, torch.from_numpy(window), 64).grad_fn is None


@pytest.mark.parametrize("n_fft, hop, batch", [(512, 128, 2), (1024, 256, None)])
def test_istft_gradient_matches_jax(n_fft, hop, batch):
    from audio_cut_tpu.ops.stft import istft as jistft
    from audio_cut_tpu_torch.ops.stft import istft

    rng = np.random.default_rng(n_fft)
    n_frames, bins = 17, n_fft // 2 + 1
    lead = () if batch is None else (batch,)
    spec = (rng.standard_normal(lead + (n_frames, bins))
            + 1j * rng.standard_normal(lead + (n_frames, bins))).astype(np.complex64)
    length = (n_frames - 1) * hop - 37
    weight = rng.standard_normal(lead + (length,)).astype(np.float32)

    def loss_j(s):
        return jnp.sum(jistft(s, n_fft=n_fft, hop=hop, length=length) * weight)

    # jax.grad of a real function of a complex input is the conjugate of
    # torch's convention (d/dx + i d/dy)
    want = np.conj(np.asarray(jax.grad(loss_j)(jnp.asarray(spec))))
    s = torch.from_numpy(spec).requires_grad_(True)
    (istft(s, n_fft, hop, length=length) * torch.from_numpy(weight)).sum().backward()
    got = s.grad.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
