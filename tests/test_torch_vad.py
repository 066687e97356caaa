"""ConvVAD and the resampler: the port against the JAX package on the same
seeded numpy inputs, with the packaged ``convvad_v1.msgpack`` at its full
width (channels 32, depth 4, context 3).

Tolerances:
* ConvVADNet logits, float32 on both sides: max |diff| <= 1e-4 * max |ref|.
  The convs are matrix products here and XLA convolutions there, and flax's
  GroupNorm takes the fast variance E[x^2] - E[x]^2; both sum in other
  orders.
* resample_graph: one float32 product of 568 taps per output sample; held at
  atol 1e-6 on a signal of unit scale.
* device_probs_graph (resample, windows, forward, sigmoid): probabilities
  within 1e-4.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

JV = importlib.import_module("audio_cut_tpu.models.vad")
JR = importlib.import_module("audio_cut_tpu.ops.resample")
TV = importlib.import_module("audio_cut_tpu_torch.models.vad")
TR = importlib.import_module("audio_cut_tpu_torch.ops.resample")


@pytest.fixture(scope="module")
def models():
    """(flax net, its params, the port's ConvVAD). The flax params are the
    checkpoint's msgpack tree as flax restores it, without flax's init."""
    from flax.serialization import msgpack_restore

    ckpt = TV.packaged_checkpoint_path()
    sidecar = JV.read_vad_sidecar(ckpt)
    net = JV.ConvVADNet(channels=sidecar["channels"], depth=sidecar["depth"],
                        context=sidecar["context"])
    with open(ckpt, "rb") as f:
        params = msgpack_restore(f.read())
    return net, params, TV.ConvVAD(44100, ckpt, "cpu")


def test_converter_maps_every_leaf_and_the_sidecar(models):
    net, params, torch_vad = models
    assert (torch_vad.net.channels, torch_vad.net.depth, torch_vad.net.context) == (
        net.channels, net.depth, net.context) == (32, 4, 3)
    assert torch_vad.threshold == 0.2
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(torch_vad.net.state_dict()) == n_leaves == 2 * 7 * 2 + 2


@pytest.mark.parametrize("length", [
    int(JV.WINDOW_S * 16000) + 2 * 10752,  # the serving window (8 s interior, halo 10752)
    3 * 4096 + 777,  # odd: SAME pads (4, 4), then odd lengths downstream
])
def test_convvadnet_matches_flax(models, length):
    net, params, torch_vad = models
    x = (0.3 * np.random.default_rng(length).standard_normal((2, length))).astype(np.float32)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = torch_vad.net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, length // TV.FRAME)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("n", [44100 * 2, 44100 * 2 + 331])
def test_resample_graph_matches_jax(n):
    x = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    want = np.asarray(JR.resample_graph(jnp.asarray(x), 44100, 16000))
    got = TR.resample_graph(torch.from_numpy(x), 44100, 16000).numpy()
    assert got.shape == want.shape == (int(round(n * 16000 / 44100)),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_device_probs_graph_matches_jax(models):
    _, params, torch_vad = models
    t = np.arange(20 * 44100) / 44100.0
    rng = np.random.default_rng(3)
    x = 0.05 * rng.standard_normal(t.size)
    voiced = (t % 4.0) < 2.5  # 2.5 s phrases, 1.5 s gaps
    x += voiced * 0.4 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
    x = x.astype(np.float32)
    want = np.asarray(JV.device_probs_graph(
        params, jnp.asarray(x), sr_in=44100, channels=32, depth=4, context=3))
    with torch.inference_mode():
        got = TV.device_probs_graph(torch_vad.net, torch.from_numpy(x), sr_in=44100).numpy()
    assert got.shape == want.shape == (4 * 250,)  # 20 s -> 4 windows of 250 frames
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # and the same speech segments from them (the detector itself is held to
    # the JAX package's, bit for bit, by tests/test_torch_mdd_tail.py)
    n = x.size
    assert torch_vad.detect(got, n_true=n).segments == torch_vad.detect(want, n_true=n).segments
    assert len(torch_vad.detect(got, n_true=n).segments) >= 4
