"""The port's CUDA kernels on the card (marker ``cuda``); each test skips
where torch sees no CUDA device. Run on a GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda.py

K1 is held against its plain version at atol 1e-5 (the tolerance the JAX
package holds its Pallas kernel to), and bit for bit (``torch.equal``) at
every shape a path launches it at and at its edges (``K1_SHAPES`` and
``K1_EDGE_SHAPES`` of ``audio_cut_tpu_torch/testing.py``): both round each
product, then add the terms in the same order, m ascending. K2 is held against its plain
version at rtol 2e-4 / atol 2e-5, the JAX package's bound for its own
kernel: the same transcendentals, summed over the bins in another order.
K1's backward: the frames' gradient (K1B) is one product per element and is
held exactly; the window's (K1W) sums B*N products per column in another
order than torch's reduction, held per column at 1e-5 of the sum of |terms|
(reordering moves a float32 sum of n terms by at most about n * 6e-8 of
it). K1W's order is fixed by its plan, so two launches agree to the bit.
K0, the library check, is x * 2 and is held exactly.
"""

import numpy as np
import pytest
import torch

from audio_cut_tpu_torch.testing import (
    K1_EDGE_SHAPES, K1_SHAPES, K1W_EDGE_SHAPES, k1_edge_holds, k1_inputs, k1w_edge_holds, k1w_error,
    k1w_inputs)

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


def _k1_equals_plain_version(device, batch, n, L, hop, offset=0):
    from audio_cut_tpu_torch.ops.ola import K1, windowed_ola, windowed_ola_reference
    from audio_cut_tpu_torch.ops.stft import hann_window

    frames = k1_inputs((batch, n, L), n + L, device, offset)
    window = hann_window(L, device=device)
    before = K1.launches
    got = windowed_ola(frames, window, hop)
    want = windowed_ola_reference(frames, window, hop)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    assert got.shape == want.shape == (batch, (n - 1) * hop + L)
    assert torch.equal(got, want)


@pytest.mark.parametrize("what, batch, n, L, hop", K1_SHAPES)
def test_k1_equals_plain_version_at_every_path_shape(cuda, what, batch, n, L, hop):
    _k1_equals_plain_version(cuda, batch, n, L, hop)


@pytest.mark.parametrize("edge, batch, n, L, hop, offset", K1_EDGE_SHAPES)
def test_k1_equals_plain_version_at_its_edges(cuda, edge, batch, n, L, hop, offset):
    assert k1_edge_holds(edge, batch, n, L, hop, offset), edge
    _k1_equals_plain_version(cuda, batch, n, L, hop, offset)


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
    (133, 1025),   # one more frame than an H100 has SMs
    (50, 1025),    # fewer frames than SMs
    (300, 1024),   # every row 16 B aligned
    (77, 3),       # rows narrower than a warp
    (64, 1),       # one bin
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


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k2_takes_a_spectrogram_off_16_byte_alignment(cuda, offset):
    """A contiguous view that starts `offset` floats past a 16 B boundary."""
    from audio_cut_tpu_torch.ops.frame_stats import spectral_stats, spectral_stats_reference

    t, f = 1201, 1025
    mag = np.abs(np.random.default_rng(offset).standard_normal((t, f))).astype(np.float32)
    padded = torch.zeros(t * f + offset, device=cuda)
    padded[offset:] = torch.from_numpy(mag).to(cuda).reshape(-1)
    x = padded[offset:].view(t, f)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    flat, onset = spectral_stats(x)
    want_flat, want_onset = spectral_stats_reference(x)
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


@pytest.mark.parametrize("batch, n, L, hop", [
    (4, 128, 6144, 1024),  # the training shape of ConvTDF-large at batch 4
    (4, 256, 6144, 1024),
    (None, 21, 512, 128),
    (3, 13, 256, 64),
    (2, 7, 90, 30),        # hop not a multiple of 4: the scalar path
])
def test_k1_backward_matches_plain_version(cuda, batch, n, L, hop):
    from audio_cut_tpu_torch.ops.ola import (
        K1B, K1W, ola_backward_frames_cuda, ola_backward_window_cuda,
        windowed_ola_backward_reference)
    from audio_cut_tpu_torch.ops.stft import frame_signal, hann_window

    shape = (n, L) if batch is None else (batch, n, L)
    rng = np.random.default_rng(n + L)
    frames = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal(
        shape[:-2] + ((n - 1) * hop + L,)).astype(np.float32)).to(cuda)
    window = hann_window(L, device=cuda)
    b0, w0 = K1B.launches, K1W.launches
    got_f = ola_backward_frames_cuda(g, frames.shape, window, hop)
    got_w = ola_backward_window_cuda(g, frames, window, hop)
    want_f, want_w = windowed_ola_backward_reference(g, frames, window, hop)
    raw = frame_signal(g, L, hop, center=False)[..., :n, :]
    scale = (raw * frames).abs().sum(dim=tuple(range(raw.ndim - 1)))
    torch.cuda.synchronize()
    assert (K1B.launches, K1W.launches) == (b0 + 1, w0 + 1)
    assert torch.equal(got_f, want_f)
    assert got_w.shape == (L,)
    assert bool(((got_w - want_w).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("edge, batch, n, L, hop, offset", K1W_EDGE_SHAPES)
def test_k1w_matches_plain_version_at_its_edges(cuda, edge, batch, n, L, hop, offset):
    from audio_cut_tpu_torch.ops.ola import K1W, ola_backward_window_cuda, window_plan
    from audio_cut_tpu_torch.ops.stft import hann_window

    plan = window_plan(batch * n, L, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert k1w_edge_holds(edge, batch, n, L, hop, offset, plan), f"{edge}: not so under {plan}"
    frames, g = k1w_inputs((batch, n, L), hop, seed=n + L, device=cuda, offset=offset)
    before = K1W.launches
    got = ola_backward_window_cuda(g, frames, hann_window(L, device=cuda), hop)
    torch.cuda.synchronize()
    assert K1W.launches == before + 1
    assert got.shape == (L,)
    assert k1w_error(got, g, frames, hop)[1] <= 1e-5


def test_k1w_gives_the_same_bits_twice(cuda):
    from audio_cut_tpu_torch.ops.ola import ola_backward_window_cuda
    from audio_cut_tpu_torch.ops.stft import hann_window

    frames, g = k1w_inputs((4, 128, 6144), 1024, seed=11, device=cuda)
    window = hann_window(6144, device=cuda)
    first = ola_backward_window_cuda(g, frames, window, 1024)
    second = ola_backward_window_cuda(g, frames, window, 1024)
    assert torch.equal(first, second)


def test_k1w_raises_on_a_plan_it_does_not_take(cuda):
    from audio_cut_tpu_torch.ops.ola import K1W

    frames, g = k1w_inputs((2, 9, 512), 128, seed=3, device=cuda)
    out = torch.empty(512, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    # (tile_cols, row_lanes, cluster, rows_per_lane): a cluster over 8; lanes that miss rows
    for plan in ((32, 2, 16, 1), (32, 2, 2, 1)):
        with pytest.raises(RuntimeError):
            K1W.launch(cuda, g.data_ptr(), frames.data_ptr(), out.data_ptr(), 2, 9, 512, 128,
                       *plan, stream)


def test_windowed_ola_with_a_trainable_window_launches_k1w_once(cuda):
    """The window's gradient through autograd is K1W's, bit for bit."""
    from audio_cut_tpu_torch.ops.ola import K1B, K1W, ola_backward_window_cuda, windowed_ola
    from audio_cut_tpu_torch.ops.stft import hann_window

    frames, g = k1w_inputs((2, 33, 2048), 512, seed=5, device=cuda)
    window = hann_window(2048, device=cuda).requires_grad_(True)
    counts = (K1B.launches, K1W.launches)
    windowed_ola(frames, window, 512).backward(g)
    assert (K1B.launches, K1W.launches) == (counts[0], counts[1] + 1)
    assert torch.equal(window.grad, ola_backward_window_cuda(g, frames, window.detach(), 512))


def test_autograd_through_istft_launches_k1_backward(cuda):
    """A loss through the card's iSTFT gets its gradient through K1B (the
    window is a constant: K1W never launches), equal to the CPU's within
    1e-5 * max |CPU| (cuFFT against the CPU's FFT)."""
    from audio_cut_tpu_torch.ops.ola import K1, K1B, K1W
    from audio_cut_tpu_torch.ops.stft import istft

    rng = np.random.default_rng(3)
    spec = (rng.standard_normal((2, 40, 513))
            + 1j * rng.standard_normal((2, 40, 513))).astype(np.complex64)
    weight = rng.standard_normal((2, 39 * 256)).astype(np.float32)
    grads = {}
    counts = (K1.launches, K1B.launches, K1W.launches)
    for d in (cuda, torch.device("cpu")):
        s = torch.from_numpy(spec).to(d).requires_grad_(True)
        (istft(s, 1024, 256, length=39 * 256) * torch.from_numpy(weight).to(d)).sum().backward()
        grads[d.type] = s.grad.cpu()
    assert (K1.launches, K1B.launches, K1W.launches) == (counts[0] + 1, counts[1] + 1, counts[2])
    ref = grads["cpu"]
    assert float((grads["cuda"] - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_inference_keeps_one_k1_launch_and_saves_nothing(cuda):
    from audio_cut_tpu_torch.ops.ola import K1, K1B, windowed_ola
    from audio_cut_tpu_torch.ops.stft import hann_window

    frames = torch.randn((4, 16, 2048), device=cuda, requires_grad=True)
    counts = (K1.launches, K1B.launches)
    with torch.inference_mode():
        out = windowed_ola(frames, hann_window(2048, device=cuda), 512)
    assert out.grad_fn is None
    assert (K1.launches, K1B.launches) == (counts[0] + 1, counts[1])


def test_k0_library_check_and_probe(cuda):
    from audio_cut_tpu_torch.ops.cuda import (
        LIBRARY_CHECK, PROBE_SHAPE, K0, check_kernel_library, probe_cuda, probe_reference)

    before = K0.launches
    check_kernel_library(cuda)
    assert K0.launches == before + 1
    assert LIBRARY_CHECK[cuda.index] == 0.0
    x = torch.randn(PROBE_SHAPE, device=cuda)
    assert torch.equal(probe_cuda(x), probe_reference(x))
    # n that is no multiple of 4, and views that start off a 16 B boundary
    for n, offset in ((1023, 0), (5, 0), (3, 0), (300_001, 0), (1024, 1), (1023, 3), (7, 2)):
        v = torch.randn(n + offset, device=cuda)[offset:]
        assert v.data_ptr() % 16 == 4 * offset
        assert torch.equal(probe_cuda(v), probe_reference(v))
    with pytest.raises(ValueError):
        probe_cuda(x.double())


def test_first_launch_of_a_process_runs_the_library_check(cuda):
    """In a fresh process, the first launch of any kernel launches K0 first."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from audio_cut_tpu_torch.ops.cuda import K0, LIBRARY_CHECK\n"
        "from audio_cut_tpu_torch.ops.frame_stats import K2, spectral_stats\n"
        "assert K0.launches == 0 and not LIBRARY_CHECK\n"
        "spectral_stats(torch.ones((3, 33), device='cuda'))\n"
        "torch.cuda.synchronize()\n"
        "print(K0.launches, K2.launches, LIBRARY_CHECK == {0: 0.0})\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "1", "True"]


def test_vpbd_acoustic_on_the_card_launches_k1_and_k2(cuda, tmp_path):
    """The vpbd mode through the entry point on the card, with the packaged
    tiny ConvTDF: the fused pass launches K1 and K2, and the manifest carries
    the planner's boundary detection and the auto profile."""
    from conftest import make_song

    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.io import write_wav
    from audio_cut_tpu_torch.ops.frame_stats import K2
    from audio_cut_tpu_torch.ops.ola import K1

    audio, sr = make_song(12.0)
    write_wav(tmp_path / "song.wav", audio, sr, subtype="FLOAT")
    k1, k2 = K1.launches, K2.launches
    m = separate_and_segment(
        input_uri=str(tmp_path / "song.wav"), export_dir=str(tmp_path / "out"),
        mode="vpbd_acoustic",
        runtime_overrides={"enhanced_separation.backend": "convtdf",
                           "enhanced_separation.convtdf.checkpoint": "packaged_tiny"})
    assert m["success"] and m["gpu"]["gpu_pipeline_device"] == "cuda"
    assert K1.launches > k1 and K2.launches == k2 + 1
    assert m["boundary_detection"]["candidate_counts"]["merged"] > 0
    assert "final_time_by_raw_time" in m["boundary_detection"]["planner"]
    assert m["auto_profile"]["intent"]["profile"] == "auto"
    assert (tmp_path / "out" / "vpbd_candidates_debug.json").exists()


def test_yin_lpc_and_track_features_on_the_card_match_the_cpu(cuda):
    """YIN, LPC (the legacy detector's analysis) and build_track_features at
    librosa_onset's hop 512 on the card against the CPU, on a 12 s song.
    Bounds: voicing and formant strength atol 1e-3 and f0 within 0.5 Hz on
    >= 99.5% of frames (cuFFT and the CPU's FFT round differently, which may
    flip a frame across YIN's 0.15 dip rule); the features within
    chip_smoke.py's BUNDLE_TOL bounds (rms rtol 1e-5, flatness K2's bound,
    mdd atol 1e-4, the bpm 1e-4 relative), the onset within the difference
    the two sides' spectrograms imply (``testing.onset_allowed``) plus K2's
    bound; K2 launches once."""
    from conftest import make_song

    from audio_cut_tpu_torch.analysis.features import (
        _FEATURE_NFFT,
        build_track_features,
        pad_to_bucket,
    )
    from audio_cut_tpu_torch.ops.frame_stats import K2
    from audio_cut_tpu_torch.ops.stft import stft
    from audio_cut_tpu_torch.ops.voice import lpc_formant_strength, yin_f0
    from audio_cut_tpu_torch.testing import onset_allowed

    audio, sr = make_song(12.0)
    x = torch.from_numpy(audio).to(cuda)
    f_card, v_card = yin_f0(x, sr)
    f_cpu, v_cpu = yin_f0(audio, sr)
    assert f_card.shape == f_cpu.shape == ((audio.size - 1764) // 441 + 1,)
    assert np.abs(v_card - v_cpu).max() <= 1e-3
    assert np.mean(np.abs(f_card - f_cpu) <= 0.5) >= 0.995
    np.testing.assert_allclose(lpc_formant_strength(x, sr), lpc_formant_strength(audio, sr),
                               rtol=0, atol=1e-3)

    k2 = K2.launches
    card = build_track_features(audio, sr, hop_s=512 / sr, device=cuda)
    assert K2.launches == k2 + 1
    cpu = build_track_features(audio, sr, hop_s=512 / sr, device="cpu")
    assert card.n_frames == cpu.n_frames == audio.size // 512 + 1
    for name, rtol, atol in (("rms", 1e-5, 1e-7), ("flatness", 2e-4, 2e-5), ("mdd", 0.0, 1e-4)):
        np.testing.assert_allclose(getattr(card, name), getattr(cpu, name), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert abs(card.bpm - cpu.bpm) <= 1e-4 * cpu.bpm
    padded = torch.from_numpy(pad_to_bucket(audio, sr))
    mags = [torch.abs(stft(padded.to(d), n_fft=_FEATURE_NFFT, hop=512)).cpu().numpy()
            [:card.n_frames] for d in (cuda, "cpu")]
    err = np.abs(card.onset.astype(np.float64) - cpu.onset)
    assert np.all(err <= onset_allowed(*mags) + 2e-4 * np.abs(cpu.onset) + 2e-5)


def test_pipelined_pieces_on_the_card_match_the_whole_track(cuda):
    """The pipelined piece upload on the card, with the packaged tiny ConvTDF
    on a 15 s song (11 windows, 6 pieces): one K1 launch a piece against one
    a group of 4 on the whole-track path, the mix bit for bit, the stems
    within the CPU test's bound (``tests/test_torch_pipelined.py``), and the
    upload's host buffer pinned."""
    from conftest import make_song

    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.ops.ola import K1
    from audio_cut_tpu_torch.separation import engine as E

    audio, sr = make_song(15.0)
    out = {}
    try:
        for pipelined in (True, False):
            set_runtime_config({"enhanced_separation.backend": "convtdf",
                                "enhanced_separation.convtdf.checkpoint": "packaged_tiny",
                                "device_pipeline.pipelined_upload": pipelined})
            k1 = K1.launches
            out[pipelined] = E.SeparationEngine(sr, cuda).separate_on_device(audio) + (
                K1.launches - k1,)
            reset_runtime_config()
    finally:
        reset_runtime_config()
    (v_p, i_p, mix_p, meta_p, k1_p), (v_m, i_m, mix_m, meta_m, k1_m) = out[True], out[False]
    assert (meta_p["gpu_pipeline_mode"], k1_p) == ("device_ola_pipelined_p6", 6)
    assert (meta_m["gpu_pipeline_mode"], k1_m) == ("device_ola", 3)
    assert torch.equal(mix_p, mix_m)
    for got, want, snr_min in ((v_p, v_m, 40.0), (i_p, i_m, 30.0)):
        diff = (got.double() - want.double())
        assert float(diff.abs().max()) <= 1e-2
        if diff.abs().max() > 0:
            assert 10 * np.log10(float((want.double() ** 2).sum() / (diff ** 2).sum())) >= snr_min
    staging = [t for layout in E._OLA_CACHE.values() if layout for t in layout["staging"].values()]
    assert staging and all(t.is_pinned() for t in staging)
