"""Engine helpers and the PCM-24 pack: the port equals the JAX package
exactly over a few track lengths (integer arithmetic and numpy copies, so no
tolerance)."""

import importlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from audio_cut_tpu.separation import engine as JE  # noqa: E402
from audio_cut_tpu_torch.separation import engine as TE  # noqa: E402

SR = 44100
# sub-bucket, exact bucket, 60 s (3 windows of ConvTDF-large at map_group 4),
# just past the 75 s long-track switch, and 3 minutes
LENGTHS = [1, 4 * SR, int(15 * SR), 60 * SR, 76 * SR + 17, 180 * SR]
ALIGNS = [1, 256, 1024, 4096]


@pytest.mark.parametrize("n", LENGTHS)
def test_padded_track_len_equals_jax(n):
    for align in ALIGNS:
        assert TE.padded_track_len(n, SR, align) == JE.padded_track_len(n, SR, align)


def _geometries():
    from audio_cut_tpu.separation.tiling import stft_engine_geometry as jgeom
    from audio_cut_tpu_torch.separation.tiling import stft_engine_geometry as tgeom

    out = []
    for win, n_fft, hop in (((256 - 1) * 1024, 6144, 1024), ((256 - 1) * 256, 1024, 256)):
        g = tgeom(SR, win, n_fft, hop)
        assert g == jgeom(SR, win, n_fft, hop)
        out.append(g)
    out.append({"chunk_s": 10.0, "overlap_s": 2.5, "halo_s": 0.5, "align": 4096})
    return out


@pytest.mark.parametrize("n", [4 * SR, 60 * SR, 180 * SR])
def test_chunk_schedule_and_ola_plan_equal_jax(n):
    for g in _geometries():
        padded = TE.padded_track_len(n, SR, g["align"])
        args = (padded, SR, g["chunk_s"], g["overlap_s"], g["halo_s"], g["align"])
        tp, tw = TE.chunk_schedule(*args)
        jp, jw = JE.chunk_schedule(*args)
        assert tw == jw and [tuple(vars(p).values()) for p in tp] == \
            [tuple(vars(p).values()) for p in jp]
        t_plans, t_win, t_wts, t_inv = TE.ola_plan(*args)
        j_plans, j_win, j_wts, j_inv = JE.ola_plan(*args)
        assert t_win == j_win and len(t_plans) == len(j_plans)
        np.testing.assert_array_equal(t_wts, j_wts)
        np.testing.assert_array_equal(t_inv, j_inv)


def test_convtdf_large_geometry_gives_three_groups_for_a_minute():
    """The sizing the chip check relies on: 60 s pads to 11 model windows,
    which map_group 4 runs as 3 forwards (3 launches of K1) with the piece
    upload off; by default they run as 6 pieces of at most 2 windows (6
    launches, ``test_torch_pipelined.py``)."""
    from audio_cut_tpu_torch.separation.tiling import stft_engine_geometry

    g = stft_engine_geometry(SR, 255 * 1024, 6144, 1024)
    padded = TE.padded_track_len(60 * SR, SR, g["align"])
    plans, window = TE.chunk_schedule(padded, SR, g["chunk_s"], g["overlap_s"], g["halo_s"],
                                      g["align"])
    assert (padded, window, len(plans), -(-len(plans) // 4)) == (2646016, 261120, 11, 3)


@pytest.mark.parametrize("seed, scale", [(0, 0.9), (1, 1e-3), (2, 2.5), (3, 0.0)])
def test_quantize_upload_equals_jax(seed, scale):
    x = (np.random.default_rng(seed).standard_normal(50_000) * scale).astype(np.float32)
    t_raw, t_scale = TE.quantize_upload(x)
    j_raw, j_scale = JE.quantize_upload(x)
    assert t_raw.dtype == j_raw.dtype == np.int16
    np.testing.assert_array_equal(t_raw, j_raw)
    assert t_scale == j_scale and type(t_scale) is type(j_scale)


def test_estimate_confidence_equals_jax():
    rng = np.random.default_rng(4)
    mix = rng.standard_normal(10_000).astype(np.float32)
    for share in (0.0, 0.2, 0.59, 1.0, 3.0):
        voc = (mix * np.sqrt(share)).astype(np.float32)
        assert TE._estimate_confidence(mix, voc) == JE._estimate_confidence(mix, voc)


def test_pcm24_pack_equals_jax():
    J = importlib.import_module("audio_cut_tpu.ops.pcm")
    T = importlib.import_module("audio_cut_tpu_torch.ops.pcm")
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.uniform(-1.2, 1.2, 40_000),
        # exact half-LSB ties, both rails and zero: the rounding mode shows here
        (np.arange(-50, 50) + 0.5) / 8388607.0,
        [-1.0, 1.0, -1.5, 1.5, 0.0, -0.0, 0.5 / 8388607.0, -0.5 / 8388607.0],
    ]).astype(np.float32)
    want = np.asarray(J.pcm24_pack_graph(jnp.asarray(x)))
    got = T.pcm24_pack_graph(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert T.pcm24_planes_to_payload(got) == J.pcm24_planes_to_payload(want)
    np.testing.assert_array_equal(T.pcm24_planes_to_float(got), J.pcm24_planes_to_float(want))


def test_pcm24_host_codec_equals_jax_numpy_codec():
    """The port's host encoder is the JAX package's numpy codec (float64
    product, half to even); the decoder inverts it."""
    from audio_cut_tpu.native.loader import PcmCodec
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    codec = PcmCodec.__new__(PcmCodec)
    codec._lib = None  # the JAX package's numpy path
    x = np.random.default_rng(10).uniform(-1.1, 1.1, 30_000).astype(np.float32)
    payload = encode_pcm24(x)
    assert payload == codec.encode_pcm24(x)
    np.testing.assert_array_equal(decode_pcm24(payload), codec.decode_pcm24(payload))
