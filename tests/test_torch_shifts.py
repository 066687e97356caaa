"""Shift averaging (``enhanced_separation.convtdf.shifts > 1``) of the port
against the JAX package, on the CPU.

1. ``tiling.shift_averaged`` at shifts 1, 2 and 3 over a toy forward whose
   output depends on the sample's position (so a delay that is not undone
   shows), in float32: atol 1e-6. Both sides add the same float32 terms in
   the same order; the bound leaves room only for the two libraries' last
   bit of the division.
2. ``ConvTDFSeparator.separate_shifted`` of the packaged tiny checkpoint at
   dim_t 32, float32, shifts 2, against ``separate_shifted_fn``: the bound
   of ``test_separator_window_matches_jax_f32``, max |port - JAX| <= 1e-4 *
   max |JAX|.
3. ``ConvTDFBackend`` at shifts 2 and 3 (the tiny checkpoint, float32 on
   both sides): its ``map_group`` is the JAX backend's, max(1, 4 // shifts),
   and ``separate_windows`` on 3 model windows agrees with
   ``separate_windows_fn`` within the same 1e-4 bound. The JAX backend reads
   the checkpoint with ``msgpack_restore``, as the tests above do: its own
   reader first builds a template by an eager flax init, which compiles
   each of its ~200 ops on the CPU (about 26 s) for the same tree.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
serialization = pytest.importorskip("flax.serialization")

WEIGHTS = Path(__file__).resolve().parents[1] / "audio_cut_tpu" / "models" / "weights"
TINY = {"enhanced_separation.backend": "convtdf",
        "enhanced_separation.convtdf.checkpoint": "packaged_tiny"}
HOP = 256


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("shifts", [1, 2, 3])
def test_shift_averaged_matches_jax(shifts):
    from audio_cut_tpu.separation.tiling import shift_averaged as jax_shift_averaged
    from audio_cut_tpu_torch.separation.tiling import shift_averaged

    rng = np.random.default_rng(10 + shifts)
    x = rng.standard_normal((2, 4 * HOP + 37)).astype(np.float32)
    ramp = np.linspace(0.5, 1.5, x.shape[-1], dtype=np.float32)

    # not shift-equivariant: a delay that is not undone changes the result
    want = np.asarray(jax_shift_averaged(lambda v: v * v * jnp.asarray(ramp), HOP, shifts)(
        jnp.asarray(x)))
    got = shift_averaged(lambda v: v * v * torch.from_numpy(ramp), HOP, shifts)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_separate_shifted_matches_jax_f32():
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
    x = (np.random.default_rng(3).standard_normal((2, win)) * 0.3).astype(np.float32)
    jv, ji = jax.jit(lambda a: jsep.separate_shifted_fn(tree, a, win, 2))(jnp.asarray(x))

    sep = ConvTDFSeparator(44100, dtype=torch.float32, **geom)
    sep.net.load_state_dict(load_checkpoint(str(WEIGHTS / "convtdf_tiny_v1.msgpack")))
    tv, ti = sep.separate_shifted(torch.from_numpy(x), win, 2)
    _close(tv.numpy(), np.asarray(jv))
    _close(ti.numpy(), np.asarray(ji))


def _restore(path, template=None):
    return serialization.msgpack_restore(Path(path).read_bytes())


@pytest.mark.parametrize("shifts", [2, 3])
def test_backend_separate_windows_matches_jax(shifts, monkeypatch):
    import audio_cut_tpu.models.convtdf as jax_convtdf
    from audio_cut_tpu.config import reset_runtime_config as jax_reset
    from audio_cut_tpu.config import set_runtime_config as jax_set
    from audio_cut_tpu.models.convtdf import ConvTDFBackend as JBackend
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.models.convtdf import ConvTDFBackend

    monkeypatch.setattr(jax_convtdf, "load_checkpoint", _restore)
    overrides = {**TINY, "enhanced_separation.convtdf.shifts": shifts}
    try:
        jax_set(overrides)
        set_runtime_config(overrides)
        jbk = JBackend(44100)
        bk = ConvTDFBackend(44100, "cpu", dtype=torch.float32)
    finally:
        jax_reset()
        reset_runtime_config()
    jbk.sep.net = jbk.sep.net.clone(dtype=jnp.float32)
    assert (bk.shifts, bk.map_group) == (jbk.shifts, jbk.map_group) == (shifts, max(1, 4 // shifts))

    win = bk.sep.window_samples
    x = (np.random.default_rng(20 + shifts).standard_normal((3, win)) * 0.3).astype(np.float32)
    jv, ji = jbk.separate_windows_fn(jnp.asarray(x))
    tv, ti = bk.separate_windows(torch.from_numpy(x))
    _close(tv.numpy(), np.asarray(jv))
    _close(ti.numpy(), np.asarray(ji))
