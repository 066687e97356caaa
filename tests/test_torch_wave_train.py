"""The WaveUNet trainer: the port against the JAX package at the ``--small``
geometry (window 16384, channels 8, depth 3), on the same seeded numpy
inputs. The JAX side runs the float32 net (``WaveUNetNet(...,
dtype=jnp.float32)``, swapped in here; the package is unchanged) so the
comparison is of the algorithm, not of bfloat16 rounding. Each test states
its tolerance.
"""

import json
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")
serialization = pytest.importorskip("flax.serialization")

SMALL = dict(window_samples=16384, channels=8, depth=3)


def _jax_sep():
    from audio_cut_tpu.models.waveunet import WaveUNetNet, WaveUNetSeparator

    sep = WaveUNetSeparator(44100, **SMALL)
    sep.net = WaveUNetNet(channels=SMALL["channels"], depth=SMALL["depth"], dtype=jnp.float32)
    return sep


def _port_sep(dtype=torch.float32):
    from audio_cut_tpu_torch.models.waveunet import WaveUNetSeparator

    return WaveUNetSeparator(44100, dtype=dtype, **SMALL)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


@pytest.fixture(scope="module")
def jax_params():
    """flax's initialisation of the float32 small net (the one compile of
    ``init`` in this file; also the restore template)."""
    return jax.device_get(jax.jit(_jax_sep().init_params)(jax.random.PRNGKey(7)))


def _batch(seed=4):
    from audio_cut_tpu_torch.training.sep_data import synth_pair

    rng = np.random.default_rng(seed)
    pairs = [synth_pair(rng, SMALL["window_samples"]) for _ in range(2)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def test_wave_loss_and_gradients_match_jax_f32(jax_params):
    """The loss and its three terms within rtol 1e-5 (float32 convs and FFTs
    of two libraries, summed in other orders, over means of ~10^4 terms);
    every gradient leaf within 1e-4 * max |JAX leaf| (the same reordering
    carried back through the net's 18 convs)."""
    from audio_cut_tpu.training.trainer import TrainConfig as JCfg
    from audio_cut_tpu.training.wave_trainer import make_wave_loss_fn as jloss
    from audio_cut_tpu_torch.models.waveunet import convert_waveunet_params, to_flax_params
    from audio_cut_tpu_torch.training.trainer import TrainConfig
    from audio_cut_tpu_torch.training.wave_trainer import make_wave_loss_fn

    mix, vocal = _batch()
    (_, jm), jg = jax.jit(jax.value_and_grad(jloss(_jax_sep(), JCfg()), has_aux=True))(
        jax_params, jnp.asarray(mix), jnp.asarray(vocal))

    sep = _port_sep()
    sep.net.load_state_dict(convert_waveunet_params(jax_params))
    names, params = zip(*sep.net.named_parameters())
    loss, metrics = make_wave_loss_fn(sep, TrainConfig())(torch.from_numpy(mix),
                                                          torch.from_numpy(vocal))
    grads = torch.autograd.grad(loss, params)
    assert float(jm["pause_rms"]) > 1e-4  # the batch has silent target frames
    for key in ("loss", "spec_l1", "wave_l1", "pause_rms"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    got = dict(_leaves(to_flax_params(dict(zip(names, grads)))))
    want = dict(_leaves(jax.device_get(jg)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


def test_optimizer_matches_optax_over_three_steps(jax_params):
    """Three steps of the port's ClippedAdamW on the WaveUNet's parameters
    against optax's chain on the same gradients, the first two above the
    clip norm and the third below it: parameters and both moments within
    rtol 1e-5 / atol 1e-7 (the same float32 operations; the global norm sums
    the leaves in another order)."""
    from audio_cut_tpu.training.trainer import TrainConfig as JCfg, make_optimizer as jopt
    from audio_cut_tpu_torch.models.waveunet import convert_waveunet_params, to_flax_params
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
    sep.net.load_state_dict(convert_waveunet_params(jax_params))
    names, params = zip(*sep.net.named_parameters())
    opt = make_optimizer(TrainConfig(**cfg))
    state = opt.init(params)
    for gt in grad_trees:
        jp, js = jstep(gt, js, jp)
        g = convert_waveunet_params(gt)
        opt.apply(params, [g[n] for n in names], state)
        adam = js[1][0]
        for mine, theirs in ((dict(zip(names, params)), jp),
                             (dict(zip(names, state.mu)), adam.mu),
                             (dict(zip(names, state.nu)), adam.nu)):
            got = dict(_leaves(to_flax_params(mine)))
            for k, want in _leaves(jax.device_get(theirs)):
                np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-7, err_msg=k)
    assert state.count == int(adam.count) == 3


def test_port_checkpoint_serves_in_the_jax_package(tmp_path, jax_params):
    """What WaveTrainer writes is the bytes flax writes; the JAX package's
    load_checkpoint reads it into a tree equal to the port's parameters,
    and its separator then gives the port's float32 vocal within atol 1e-5."""
    from audio_cut_tpu.models.convtdf import load_checkpoint as jload
    from audio_cut_tpu_torch.models.waveunet import load_checkpoint, to_flax_params
    from audio_cut_tpu_torch.training.wave_trainer import WaveTrainer

    trainer = WaveTrainer(_port_sep(), generator=torch.Generator().manual_seed(5), device="cpu")
    path = tmp_path / "wave.msgpack"
    trainer.save_checkpoint(str(path))
    tree = to_flax_params(trainer.sep.net.state_dict())
    assert path.read_bytes() == serialization.to_bytes(tree)
    restored = jax.device_get(jload(str(path), template=lambda: jax_params))
    got, want = dict(_leaves(restored)), dict(_leaves(tree))
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    state = load_checkpoint(str(path))
    assert all(torch.equal(v, state[k]) for k, v in trainer.sep.net.state_dict().items())
    x = (0.2 * np.random.default_rng(3).standard_normal((2, SMALL["window_samples"]))
         ).astype(np.float32)
    jsep = _jax_sep()
    jv, _ = jax.jit(lambda p, a: jsep.separate_fn(p, a, a.shape[-1]))(restored, jnp.asarray(x))
    tv, _ = trainer.sep.separate(torch.from_numpy(x), x.shape[-1])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="Other separator tiers"):
        trainer.save_checkpoint(str(tmp_path / "orbax_dir"))


def test_train_separator_waveunet_small_on_cpu(tmp_path, jax_params):
    """``--family waveunet --small --synthetic`` on the CPU: three bfloat16
    steps (each on a new batch) with finite losses, the WaveUNet's geometry,
    every parameter moved from its seeded start, and a checkpoint that the
    port and the JAX package read back equal to the trained parameters (no
    sidecar without the stem generator)."""
    from audio_cut_tpu.models.convtdf import load_checkpoint as jload
    from audio_cut_tpu_torch.models.waveunet import WaveUNetSeparator, load_checkpoint, to_flax_params
    from audio_cut_tpu_torch.training.train_separator import main
    from audio_cut_tpu_torch.training.wave_trainer import WaveTrainer

    path = tmp_path / "small.msgpack"
    report = {}
    rc = main(["--family", "waveunet", "--small", "--synthetic", "--steps", "3", "--device", "cpu",
               "--checkpoint", str(path)], report=report)
    assert rc == 0 and len(report["steps"]) == 3
    trainer = report["trainer"]
    assert isinstance(trainer, WaveTrainer) and isinstance(trainer.sep, WaveUNetSeparator)
    assert (trainer.sep.window_samples, trainer.sep.net.channels, trainer.sep.net.depth) == (
        16384, 8, 3)
    assert trainer.sep.net.dtype == torch.bfloat16
    assert all(math.isfinite(s[k]) for s in report["steps"]
               for k in ("loss", "spec_l1", "wave_l1", "pause_rms"))
    start = WaveUNetSeparator(44100, **SMALL)
    start.init_params(torch.Generator().manual_seed(0))  # the entry point's seed
    state = trainer.sep.net.state_dict()
    assert all(not torch.equal(v, state[k]) for k, v in start.net.state_dict().items())
    assert all(torch.equal(v, load_checkpoint(str(path))[k]) for k, v in state.items())
    restored = dict(_leaves(jax.device_get(jload(str(path), template=lambda: jax_params))))
    want = dict(_leaves(to_flax_params(state)))
    assert restored.keys() == want.keys() and all(np.array_equal(restored[k], want[k])
                                                  for k in want)
    assert not (tmp_path / "small.msgpack.json").exists()


def test_train_separator_waveunet_bootstrap_writes_its_sidecar(tmp_path):
    """``--bootstrap`` (the synthetic stem generator) writes the geometry
    sidecar of channels and depth, runs the held-out SI-SNR, and the
    checkpoint serves through ``make_backend("waveunet")`` at the sidecar's
    geometry."""
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.separation.backends import make_backend
    from audio_cut_tpu_torch.training.train_separator import main

    path = tmp_path / "boot.msgpack"
    report = {}
    assert main(["--family", "waveunet", "--small", "--bootstrap", "--steps", "2", "--batch", "2",
                 "--eval-pairs", "1", "--datagen-threads", "0", "--device", "cpu",
                 "--checkpoint", str(path)], report=report) == 0
    assert json.loads((tmp_path / "boot.msgpack.json").read_text()) == {"channels": 8, "depth": 3}
    assert report["eval"] is not None and all(map(math.isfinite, report["eval"]))
    set_runtime_config({"enhanced_separation.waveunet.checkpoint": str(path),
                        "enhanced_separation.waveunet.window_samples": 16384})
    try:
        backend = make_backend("waveunet", 44100, "cpu")
    finally:
        reset_runtime_config()
    trained = report["trainer"].sep.net.state_dict()
    assert all(torch.equal(v, trained[k]) for k, v in backend.sep.net.state_dict().items())


@pytest.mark.parametrize("case", ["resume_path", "resume_packaged", "too_few_steps"])
def test_train_separator_waveunet_resume_and_refusal(case, tmp_path):
    """``--resume`` with a path starts from that checkpoint (lr 0 keeps it);
    ``--resume packaged`` finds no packaged WaveUNet; a run stopped by its
    budget before min(50, steps) steps refuses to save."""
    from audio_cut_tpu_torch.models.waveunet import load_checkpoint
    from audio_cut_tpu_torch.training.train_separator import main
    from audio_cut_tpu_torch.training.wave_trainer import WaveTrainer

    base = ["--family", "waveunet", "--small", "--synthetic", "--device", "cpu"]
    if case == "resume_path":
        start = tmp_path / "start.msgpack"
        WaveTrainer(_port_sep(), generator=torch.Generator().manual_seed(5), device="cpu"
                    ).save_checkpoint(str(start))
        report = {}
        assert main([*base, "--steps", "1", "--lr", "0", "--resume", str(start)],
                    report=report) == 0
        want = load_checkpoint(str(start))
        assert all(torch.equal(v, want[k])
                   for k, v in report["trainer"].sep.net.state_dict().items())
    elif case == "resume_packaged":
        with pytest.raises(SystemExit, match="no packaged checkpoint"):
            main([*base, "--steps", "1", "--resume", "packaged"])
    else:
        path = tmp_path / "early.msgpack"
        assert main([*base, "--steps", "5", "--max-minutes", "1e-9",
                     "--checkpoint", str(path)]) == 4
        assert not path.exists()


def test_bf16_wave_train_step_reduces_loss():
    """As the ConvTDF trainer's test: bfloat16 activations on float32
    parameters, five steps on one batch at lr 1e-3, the loss falls; every
    parameter gets a gradient through the casts in forward."""
    from audio_cut_tpu_torch.training.trainer import TrainConfig
    from audio_cut_tpu_torch.training.wave_trainer import WaveTrainer

    trainer = WaveTrainer(_port_sep(torch.bfloat16), TrainConfig(learning_rate=1e-3), device="cpu")
    mix, vocal = _batch(seed=6)
    before = [p.detach().clone() for p in trainer.params]
    losses = [trainer.train_step(mix, vocal)["loss"] for _ in range(5)]
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in trainer.params)
    assert all(not torch.equal(a, b) for a, b in zip(before, trainer.params))


def test_wave_trainer_mesh_raises():
    from audio_cut_tpu_torch.training.trainer import TrainConfig
    from audio_cut_tpu_torch.training.wave_trainer import WaveTrainer, make_wave_loss_fn

    with pytest.raises(NotImplementedError, match="Scale-out and shell"):
        WaveTrainer(_port_sep(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Scale-out and shell"):
        make_wave_loss_fn(_port_sep(), TrainConfig(), mesh=object())
