"""The ConvTDF trainer: the port against the JAX package at the ``--small``
geometry (n_fft 512, hop 128, dim_f 128, dim_t 32, channels 8, depth 2,
TDF 16), on the same seeded numpy inputs.

The JAX side runs the float32 net (``ConvTDFNet(..., dtype=jnp.float32)``,
swapped in here; the package is unchanged) so the comparison is of the
algorithm, not of bfloat16 rounding. Each test states its tolerance.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")
serialization = pytest.importorskip("flax.serialization")

SMALL = dict(n_fft=512, hop=128, dim_f=128, dim_t=32, channels=8, depth=2, tdf_bottleneck=16)


def _jax_sep():
    from audio_cut_tpu.models.convtdf import ConvTDFNet, ConvTDFSeparator

    sep = ConvTDFSeparator(44100, **SMALL)
    sep.net = ConvTDFNet(channels=8, depth=2, tdf_bottleneck=16, dtype=jnp.float32)
    return sep


def _port_sep(dtype=torch.float32):
    from audio_cut_tpu_torch.models.convtdf import ConvTDFSeparator

    return ConvTDFSeparator(44100, dtype=dtype, **SMALL)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


@pytest.fixture(scope="module")
def jax_params():
    """flax's initialisation of the float32 small net (the one compile of
    ``init`` in this file; it also serves as the restore template)."""
    return jax.device_get(jax.jit(_jax_sep().init_params)(jax.random.PRNGKey(3)))


def _batch(window, seed=4):
    from audio_cut_tpu_torch.training.sep_data import synth_pair

    rng = np.random.default_rng(seed)
    pairs = [synth_pair(rng, window) for _ in range(2)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def test_loss_and_gradients_match_jax_f32(jax_params):
    """Loss and its three terms within rtol 1e-5 (float32 FFTs and convs of
    two libraries, summed in other orders, over means of ~10^4 terms); every
    gradient leaf within 1e-4 * max |JAX leaf| (the same reordering carried
    back through ~12 layers, as the forward test holds the net's output)."""
    from audio_cut_tpu.training.trainer import TrainConfig as JCfg, make_loss_fn as jloss
    from audio_cut_tpu_torch.models.convtdf import convert_convtdf_params, to_flax_params
    from audio_cut_tpu_torch.training.trainer import TrainConfig, make_loss_fn

    jsep = _jax_sep()
    mix, vocal = _batch(jsep.window_samples)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss(jsep, JCfg()), has_aux=True))(
        jax_params, jnp.asarray(mix), jnp.asarray(vocal))

    sep = _port_sep()
    sep.net.load_state_dict(convert_convtdf_params(jax_params))
    names, params = zip(*sep.net.named_parameters())
    loss, metrics = make_loss_fn(sep, TrainConfig())(torch.from_numpy(mix), torch.from_numpy(vocal))
    grads = torch.autograd.grad(loss, params)
    assert float(jm["pause_rms"]) > 1e-3  # the batch has silent target frames
    for key in ("loss", "spec_l1", "wave_l1", "pause_rms"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(jm[key]), rtol=1e-5)
    got = dict(_leaves(to_flax_params(dict(zip(names, grads)))))
    want = dict(_leaves(jax.device_get(jg)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


def test_optimizer_matches_optax_over_three_steps(jax_params):
    """Three steps of ClippedAdamW against optax's chain on the same
    gradients, the first two above the clip norm and the third below it.
    Parameters and both moments within rtol 1e-5 / atol 1e-7: the same
    float32 operations in the same order, apart from the global norm's sum
    over the leaves (another leaf order) and the fused kernels XLA makes."""
    from audio_cut_tpu.training.trainer import TrainConfig as JCfg, make_optimizer as jopt
    from audio_cut_tpu_torch.models.convtdf import convert_convtdf_params, to_flax_params
    from audio_cut_tpu_torch.training.trainer import TrainConfig, make_optimizer

    rng = np.random.default_rng(8)
    grad_trees = [jax.tree_util.tree_map(
        lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), jax_params)
        for scale in (0.5, 0.2, 1e-3)]
    cfg = dict(learning_rate=1e-3)
    tx = jopt(JCfg(**cfg))
    jp, js = jax_params, tx.init(jax_params)

    @jax.jit
    def jstep(g, s, p):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    sep = _port_sep()
    sep.net.load_state_dict(convert_convtdf_params(jax_params))
    names, params = zip(*sep.net.named_parameters())
    opt = make_optimizer(TrainConfig(**cfg))
    state = opt.init(params)
    for gt in grad_trees:
        jp, js = jstep(gt, js, jp)
        g = convert_convtdf_params(gt)
        opt.apply(params, [g[n] for n in names], state)
        adam = js[1][0]
        for mine, theirs in ((dict(zip(names, params)), jp),
                             (dict(zip(names, state.mu)), adam.mu),
                             (dict(zip(names, state.nu)), adam.nu)):
            got = dict(_leaves(to_flax_params(mine)))
            for k, want in _leaves(jax.device_get(theirs)):
                np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-7, err_msg=k)
    assert state.count == int(adam.count) == 3


def test_init_params_follow_flax(jax_params):
    """Every kernel leaf: mean and std of a truncated normal at +-2 sigma with
    variance 1 / fan_in (flax's lecun_normal), within 5 standard errors of the
    sample (the draws differ: torch's generator is not jax's), and no value
    beyond the truncation; flax's own draws pass the same bounds. Biases,
    GroupNorm scales and offsets equal flax's exactly (0, 1, 0)."""
    from audio_cut_tpu_torch.models.convtdf import to_flax_params

    flax_tree = dict(_leaves(jax_params))
    sep = _port_sep()
    sep.init_params(torch.Generator().manual_seed(0))
    port_tree = dict(_leaves(to_flax_params(sep.net.state_dict())))
    assert port_tree.keys() == flax_tree.keys()
    kernels = 0
    for k, want in flax_tree.items():
        got = port_tree[k]
        assert got.shape == want.shape and got.dtype == np.float32, k
        if not k.endswith("kernel"):
            assert np.array_equal(got, want), k
            continue
        kernels += 1
        fan_in = int(np.prod(want.shape[:-1]))  # (kh, kw, in) or (in,)
        std = math.sqrt(1.0 / fan_in)
        for draws in (got, want):
            n = draws.size
            assert abs(float(draws.mean())) <= 5 * std / math.sqrt(n), k
            # a truncated normal at +-2 sigma has kurtosis ~2.4: the sample
            # std's standard error is about std * sqrt((2.4 - 1) / (4 n))
            assert abs(float(draws.std()) - std) <= 5 * std * math.sqrt(1.4 / (4 * n)), k
            assert float(np.abs(draws).max()) <= 2 * std / 0.87962566103423978 * (1 + 1e-6), k
    assert kernels == 2 * 6 + 2 * 6 + 2 + 2 + 1  # blocks' convs and dense, down, up, head


def test_checkpoint_reads_in_flax_jax_and_the_port(tmp_path, jax_params):
    """What the port writes is the bytes flax writes, and reads back in flax,
    the JAX package's load_checkpoint and the port: identical arrays."""
    from audio_cut_tpu.models.convtdf import load_checkpoint as jload
    from audio_cut_tpu_torch.models.convtdf import (
        convert_convtdf_params, load_checkpoint, to_flax_params)
    from audio_cut_tpu_torch.training.trainer import Trainer

    trainer = Trainer(_port_sep(), device="cpu")
    trainer.load_params(convert_convtdf_params(jax_params))
    path = tmp_path / "ckpt.msgpack"
    trainer.save_checkpoint(str(path))
    data = path.read_bytes()
    tree = to_flax_params(trainer.sep.net.state_dict())
    assert data == serialization.to_bytes(tree)
    want = dict(_leaves(jax_params))
    for restored in (serialization.msgpack_restore(data),
                     serialization.from_bytes(jax_params, data),
                     jload(str(path), template=lambda: jax_params)):
        got = dict(_leaves(jax.device_get(restored)))
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want)
    state = load_checkpoint(str(path))
    assert all(torch.equal(v, state[k]) for k, v in trainer.sep.net.state_dict().items())
    with pytest.raises(NotImplementedError, match="Other separator tiers"):
        trainer.save_checkpoint(str(tmp_path / "orbax_dir"))


def test_sep_data_equals_the_jax_module_bit_for_bit():
    from audio_cut_tpu.training import sep_data as J
    from audio_cut_tpu_torch.training import sep_data as T

    for augment in (False, True):
        jit = J.synth_batches(30000, 2, np.random.default_rng(11), augment=augment)
        tit = T.synth_batches(30000, 2, np.random.default_rng(11), augment=augment)
        for _ in range(2):
            (jm, jv), (tm, tv) = next(jit), next(tit)
            assert np.array_equal(jm, tm) and np.array_equal(jv, tv)
    mix, vocal = T.synth_pair(np.random.default_rng(2), 20000)
    assert T.si_snr(mix, vocal) == J.si_snr(mix, vocal)


def test_prefetch_passes_a_producer_error_on():
    from audio_cut_tpu_torch.training.prefetch import PrefetchBatches

    def make_iter(seed):
        yield np.zeros(2), np.zeros(2)
        raise ValueError(f"producer {seed} broke")

    batches = PrefetchBatches(make_iter, threads=2)
    try:
        with pytest.raises(RuntimeError, match="producer died") as info:
            for _ in range(10):
                next(batches)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        batches.close()


def test_spectral_backend_matches_jax():
    """2 s of audio through the spectral mask at n_fft 2048 / hop 512 (the
    trainer's held-out yardstick): vocal within atol 1e-5 (float32 FFTs of two
    libraries; the medians are exact selections of nearly equal inputs) and
    the instrumental the exact complement in the port."""
    from audio_cut_tpu.separation.backends import SpectralMaskBackend as JSpectral
    from audio_cut_tpu_torch.separation.backends import SpectralMaskBackend

    from conftest import make_song

    audio, sr = make_song(2.0)
    jv, _ = JSpectral(sr).separate_window(jnp.asarray(audio))
    x = torch.from_numpy(audio)
    tv, ti = SpectralMaskBackend(sr).separate_window(x)
    assert tv.shape == (audio.size,)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    assert torch.equal(ti, x - tv)


def test_train_separator_small_on_cpu(tmp_path, jax_params):
    """The entry point at --small on the CPU: it runs, the loss falls, and the
    checkpoint it writes loads in the port and in the JAX package alike."""
    from audio_cut_tpu.models.convtdf import load_checkpoint as jload
    from audio_cut_tpu_torch.models.convtdf import load_checkpoint, to_flax_params
    from audio_cut_tpu_torch.training.train_separator import main

    path = tmp_path / "small.msgpack"
    report = {}
    rc = main(["--small", "--synthetic", "--steps", "3", "--device", "cpu",
               "--checkpoint", str(path)], report=report)
    assert rc == 0 and len(report["steps"]) == 3
    losses = [s["loss"] for s in report["steps"]]
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], losses
    state = report["trainer"].sep.net.state_dict()
    assert all(torch.equal(v, load_checkpoint(str(path))[k]) for k, v in state.items())
    restored = dict(_leaves(jax.device_get(jload(str(path), template=lambda: jax_params))))
    want = dict(_leaves(to_flax_params(state)))
    assert restored.keys() == want.keys()
    assert all(np.array_equal(restored[k], want[k]) for k in want)


def test_bf16_train_step_reduces_loss():
    """As tests/unit/test_convtdf.py checks for the JAX trainer: bfloat16
    activations on float32 parameters, five steps, the loss falls; every
    parameter gets a gradient through the casts in forward."""
    from audio_cut_tpu_torch.training.trainer import TrainConfig, Trainer

    sep = _port_sep(torch.bfloat16)
    trainer = Trainer(sep, TrainConfig(learning_rate=1e-3), device="cpu")
    rng = np.random.default_rng(1)
    mix = (rng.standard_normal((2, sep.window_samples)) * 0.1).astype(np.float32)
    before = [p.detach().clone() for p in trainer.params]
    losses = [trainer.train_step(mix, mix * 0.5)["loss"] for _ in range(5)]
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in trainer.params)
    assert all(not torch.equal(a, b) for a, b in zip(before, trainer.params))


def test_resume_from_the_packaged_checkpoint_path(tmp_path):
    """--resume with a path loads that checkpoint before the first step."""
    from audio_cut_tpu_torch.models.convtdf import load_checkpoint
    from audio_cut_tpu_torch.training.train_separator import main
    from audio_cut_tpu_torch.training.trainer import Trainer

    start = tmp_path / "start.msgpack"
    Trainer(_port_sep(), generator=torch.Generator().manual_seed(5), device="cpu"
            ).save_checkpoint(str(start))
    report = {}
    assert main(["--small", "--synthetic", "--steps", "1", "--lr", "0", "--device", "cpu",
                 "--resume", str(start)], report=report) == 0
    want = load_checkpoint(str(start))
    # lr 0: AdamW moves nothing, so the parameters are still the resumed ones
    assert all(torch.equal(v, want[k])
               for k, v in report["trainer"].sep.net.state_dict().items())
    assert Path(start).exists()
