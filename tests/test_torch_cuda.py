"""The port's CUDA kernels on the card (marker ``cuda``); each test skips
where torch sees no CUDA device. Run on a GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda.py

K1 is held against its plain version at atol 1e-5 (the tolerance the JAX
package holds its Pallas kernel to); both sum the same products in the same
order, so they agree to the bit in practice. K2 is held against its plain
version at rtol 2e-4 / atol 2e-5, the JAX package's bound for its own
kernel: the same transcendentals, summed over the bins in another order.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("batch, n, L, hop", [
    (4, 256, 6144, 1024),  # the serving shapes of ConvTDF-large: full groups
    (3, 256, 6144, 1024),  # and the last group of a 60 s track
    (None, 21, 512, 128),
    (3, 13, 256, 64),
    (2, 1, 2048, 512),     # a single frame: only the masked edges
])
def test_k1_matches_plain_version(cuda, batch, n, L, hop):
    from audio_cut_tpu_torch.ops.ola import K1, windowed_ola, windowed_ola_reference
    from audio_cut_tpu_torch.ops.stft import hann_window

    shape = (n, L) if batch is None else (batch, n, L)
    frames = torch.from_numpy(
        np.random.default_rng(n).standard_normal(shape).astype(np.float32)).to(cuda)
    window = hann_window(L, device=cuda)
    before = K1.launches
    got = windowed_ola(frames, window, hop)
    want = windowed_ola_reference(frames, window, hop)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5


def test_k1_rejects_what_it_does_not_take(cuda):
    from audio_cut_tpu_torch.ops.ola import windowed_ola

    window = torch.ones(512, device=cuda)
    with pytest.raises(TypeError):
        windowed_ola(torch.ones((4, 512), device=cuda, dtype=torch.float64), window.double(), 128)
    with pytest.raises(ValueError):
        windowed_ola(torch.ones((4, 512), device=cuda), window, 100)
    with pytest.raises(ValueError):
        windowed_ola(torch.ones((512, 4), device=cuda).t(), window, 128)


@pytest.mark.parametrize("t, f", [
    (1201, 1025),  # the feature grid of a 60 s song (n_fft 2048, hop 2205)
    (3601, 1025),  # and of a 3-minute song
    (257, 129),    # the JAX package's edge shape
    (1, 1025),     # one frame: onset 0
])
def test_k2_matches_plain_version(cuda, t, f):
    from audio_cut_tpu_torch.ops.frame_stats import K2, spectral_stats, spectral_stats_reference

    mag = np.abs(np.random.default_rng(t).standard_normal((t, f))).astype(np.float32)
    mag[t // 2] = 0.0  # a silent frame
    x = torch.from_numpy(mag).to(cuda)
    before = K2.launches
    flat, onset = spectral_stats(x)
    want_flat, want_onset = spectral_stats_reference(x)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    assert flat.shape == onset.shape == (t,)
    torch.testing.assert_close(flat, want_flat, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(onset, want_onset, rtol=2e-4, atol=2e-5)
    assert float(onset[0]) == 0.0


def test_k2_rejects_what_it_does_not_take(cuda):
    from audio_cut_tpu_torch.ops.frame_stats import spectral_stats

    with pytest.raises(TypeError):
        spectral_stats(torch.ones((4, 33), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        spectral_stats(torch.ones((33, 4), device=cuda).t())
    with pytest.raises(ValueError):
        spectral_stats(torch.ones((2, 4, 33), device=cuda))
