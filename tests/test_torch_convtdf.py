"""ConvTDFNet and ConvTDFSeparator: the port against flax on the packaged
weights, in float32 on both sides.

Tolerance: max |port - flax| <= 1e-4 * max |flax|. Both sides run the same
float32 convolutions and matmuls, summed in another order by another library
(XLA's CPU convolutions vs oneDNN). Over ~12 layers of 3x3x64..256 sums that
reordering stays near float32 rounding (~1e-6 of the range), so 1e-4 leaves
room for other CPUs while staying far below what a wrong pad, flip or layout
gives (an error of the order of the output itself).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
serialization = pytest.importorskip("flax.serialization")

WEIGHTS = Path(__file__).resolve().parents[1] / "audio_cut_tpu" / "models" / "weights"


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name, dim_f", [
    ("convtdf_large_v1", 2048),   # the production net at full width: F 2048, C 32, depth 3
    ("convtdf_tiny_v1", 384),
])
def test_convtdf_net_matches_flax_f32(name, dim_f):
    import jax

    from audio_cut_tpu.models.convtdf import ConvTDFNet as JNet
    from audio_cut_tpu_torch.models.convtdf import ConvTDFNet, load_checkpoint

    meta = json.loads((WEIGHTS / f"{name}.msgpack.json").read_text())
    tree = serialization.msgpack_restore((WEIGHTS / f"{name}.msgpack").read_bytes())
    x = np.random.default_rng(11).standard_normal((1, 16, dim_f, 2)).astype(np.float32)
    jnet = JNet(channels=meta["channels"], depth=meta["depth"],
                tdf_bottleneck=meta["tdf_bottleneck"], dtype=jnp.float32)
    want = np.asarray(jax.jit(jnet.apply)({"params": tree}, jnp.asarray(x)))

    net = ConvTDFNet(dim_f, meta["channels"], meta["depth"], meta["tdf_bottleneck"],
                     dtype=torch.float32)
    net.load_state_dict(load_checkpoint(str(WEIGHTS / f"{name}.msgpack")))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_convtdf_odd_sizes_pad_like_flax():
    """Odd T and F take the (1, 1) "SAME" pad of the strided conv and the
    crop after the transposed conv; random weights of the tiny geometry."""
    import jax

    from audio_cut_tpu.models.convtdf import ConvTDFNet as JNet
    from audio_cut_tpu_torch.models.convtdf import ConvTDFNet, convert_convtdf_params

    jnet = JNet(channels=8, depth=2, tdf_bottleneck=8, dtype=jnp.float32)
    x = np.random.default_rng(5).standard_normal((2, 11, 37, 2)).astype(np.float32)
    # random weights, biases and norm offsets, drawn with numpy at flax's shapes
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    net = ConvTDFNet(37, 8, 2, 8, dtype=torch.float32)
    net.load_state_dict(convert_convtdf_params(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("b, c, t, f", [(1, 32, 16, 64), (2, 8, 11, 37), (1, 3, 1, 5)])
def test_mask_head_conv_matches_flax_conv_f32(b, c, t, f):
    """The head's float32 3x3 conv (one matmul over the channels, nine shifted
    adds) against the JAX head, flax ``Conv(2, (3, 3), "SAME")`` in float32.
    Tolerance 1e-5 * max |flax|: at most 9 * 32 float32 products summed in
    another order, far below the error of a wrong tap or shift."""
    import flax.linen as fnn

    from audio_cut_tpu_torch.models.convtdf import _conv_weight, _head_conv_f32

    rng = np.random.default_rng(100 * t + f)
    x = rng.standard_normal((b, t, f, c)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, c, 2)).astype(np.float32)
    bias = rng.standard_normal(2).astype(np.float32)
    head = fnn.Conv(2, (3, 3), padding="SAME", dtype=jnp.float32)
    want = np.asarray(head.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    got = _head_conv_f32(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                         _conv_weight(kernel), torch.from_numpy(bias))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_separator_window_matches_jax_f32():
    """One model window of the tiny checkpoint through STFT -> net -> mask ->
    iSTFT, in float32: vocal and instrumental against the JAX separator."""
    import jax

    from audio_cut_tpu.models.convtdf import ConvTDFSeparator as JSep
    from audio_cut_tpu_torch.models.convtdf import ConvTDFSeparator, load_checkpoint

    meta = json.loads((WEIGHTS / "convtdf_tiny_v1.msgpack.json").read_text())
    geom = {k: meta[k] for k in ("n_fft", "hop", "dim_f", "dim_t", "channels", "depth",
                                  "tdf_bottleneck")}
    geom["dim_t"] = 32  # a short window keeps the test fast; the net is convolutional in T
    tree = serialization.msgpack_restore((WEIGHTS / "convtdf_tiny_v1.msgpack").read_bytes())
    jsep = JSep(44100, **geom)
    jsep.net = jsep.net.clone(dtype=jnp.float32)
    win = (jsep.dim_t - 1) * jsep.hop
    x = (np.random.default_rng(2).standard_normal((2, win)) * 0.3).astype(np.float32)
    jv, ji = jax.jit(lambda a: jsep.separate_fn(tree, a, win))(jnp.asarray(x))

    sep = ConvTDFSeparator(44100, dtype=torch.float32, **geom)
    sep.net.load_state_dict(load_checkpoint(str(WEIGHTS / "convtdf_tiny_v1.msgpack")))
    tv, ti = sep.separate(torch.from_numpy(x), win)
    _close(tv.numpy(), np.asarray(jv))
    _close(ti.numpy(), np.asarray(ji))
