"""The pipelined piece upload (``device_pipeline.pipelined_upload``, on by
default) of the port's engine, on the CPU.

1. The layout equals the JAX package's ``_piece_layout`` (groups, spans,
   ``span_len``, ``kmax``, weight rows, offsets, and where it is None) for
   three track lengths, three geometries and five settings. Both engines get
   a stub backend with the geometry, so nothing runs a model. Bound: none.
   The port keeps only the real windows of the last piece, so its weight
   rows and offsets are the JAX package's without the zero rows it pads
   with.
2. The stems of the pipelined path against the whole-track path of the
   same engine: the packaged tiny ConvTDF in bfloat16 on a 15 s song (11
   windows, 6 pieces) and the spectral backend on a 25 s song (4 windows,
   2 pieces). The mix is equal bit for bit. The ConvTDF's stems differ,
   because bfloat16 convolutions round differently at batch 2 than at
   batch 4: measured SNR 56.5 dB for the vocal and 34.6 dB for the
   instrumental (the same difference on a quieter stem), max |diff| 2.1e-3;
   held at 40 dB, 30 dB (the bound of ``test_torch_slice.py``) and 1e-2.
   The spectral stems were equal; held at atol 1e-5, the bound of the JAX
   package's own test.
3. A runtime change of the geometry takes a fresh layout, whose stems equal
   the whole-track path's at that geometry (the JAX package's
   ``test_pipelined_geometry_change_uses_fresh_combine``).
4. The staged pass (``staged=True``: the staged path, hybrid's memo miss)
   against the fused pass over the pieces: the bundle equal bit for bit,
   the labels ``device_ola_pipelined_p6`` and ``fused_pipelined_p6``, where
   6 is the JAX package's piece count for the same schedule.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from conftest import make_song  # noqa: E402

SR = 44100
TINY = {"enhanced_separation.backend": "convtdf",
        "enhanced_separation.convtdf.checkpoint": "packaged_tiny"}
SPECTRAL = {"enhanced_separation.backend": "spectral"}
LENGTHS = [4 * SR, 60 * SR, 180 * SR + 17]
# the ConvTDF stems, pipelined against whole-track: the least SNR of the vocal
# and of the instrumental (which has less energy for the same difference),
# and the largest difference
CONV_SNR_DB = {"vocal": 40.0, "instrumental": 30.0}
CONV_ATOL = 1e-2
SPECTRAL_ATOL = 1e-5


class _Stub:
    """A backend that is only a geometry (None: the config schedule)."""

    name = "stub"

    def __init__(self, geometry):
        if geometry is not None:
            self.engine_geometry = lambda: dict(geometry)
        self.separate_windows_fn = None  # what the JAX layout asks for


def _geometries():
    from audio_cut_tpu_torch.separation.tiling import stft_engine_geometry

    # ConvTDF-large, the packaged tiny ConvTDF, and the config schedule
    return [stft_engine_geometry(SR, 255 * 1024, 6144, 1024),
            stft_engine_geometry(SR, 255 * 256, 1024, 256), None]


def _both(overrides):
    from audio_cut_tpu.config import set_runtime_config as jax_set
    from audio_cut_tpu_torch.config import set_runtime_config as torch_set

    jax_set(overrides)
    torch_set(overrides)


def _reset_both():
    from audio_cut_tpu.config import reset_runtime_config as jax_reset
    from audio_cut_tpu_torch.config import reset_runtime_config as torch_reset

    jax_reset()
    torch_reset()


@pytest.mark.parametrize("settings", [
    {},                                                        # pieces of 2, at most 8
    {"device_pipeline.piece_windows": 1, "device_pipeline.max_pieces": 64},   # 1 a piece
    {"device_pipeline.piece_windows": 3},                      # 3, 3, 3, 2 at 60 s
    {"device_pipeline.max_pieces": 2},                         # the cap widens the pieces
    {"device_pipeline.pipelined_upload": False},               # None
], ids=["default", "one_window", "uneven", "capped", "off"])
def test_piece_layout_equals_jax(settings):
    from audio_cut_tpu.separation.engine import SeparationEngine as JaxEngine
    from audio_cut_tpu_torch.separation.engine import SeparationEngine as TorchEngine
    from audio_cut_tpu_torch.separation.engine import padded_track_len

    seen_none = seen_layout = 0
    _both(settings)
    try:
        for geometry in _geometries():
            stub = _Stub(geometry)
            je = JaxEngine(SR, backend=stub)
            te = TorchEngine(SR, "cpu")
            te._backend, te._backend_name = stub, "stub"
            align = geometry["align"] if geometry else 4096
            for n in LENGTHS:
                padded = padded_track_len(n, SR, align)
                jl, tl = je._piece_layout(padded), te._piece_layout(padded)
                assert (jl is None) == (tl is None), (geometry, n)
                if jl is None:
                    seen_none += 1
                    continue
                seen_layout += 1
                for key in ("per", "window", "n_chunks", "groups", "spans", "span_len", "kmax",
                            "padded_len"):
                    assert tl[key] == jl[key], key
                assert np.array_equal(tl["inv_wsum"].numpy(), jl["inv_wsum"])
                jrows = [np.asarray(r) for r in jl["wts_dev"]]
                ks = [len(g) for g in tl["groups"]]
                assert np.array_equal(np.concatenate([r.numpy() for r in tl["weights"]]),
                                      np.concatenate([r[:k] for r, k in zip(jrows, ks)]))
                assert not any(r[k:].any() for r, k in zip(jrows, ks))  # the JAX padding rows
                assert tl["offsets"] == [np.asarray(o)[:k].tolist()
                                         for o, k in zip(jl["offs_dev"], ks)]
                # the owned samples partition the track
                owned = tl["owned"]
                assert owned[0][0] == 0 and owned[-1][1] == padded
                assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))
    finally:
        _reset_both()
    if settings.get("device_pipeline.pipelined_upload") is False:
        assert seen_layout == 0
    else:
        # every setting meets both: a 15 s bucket of 10 s windows has 2
        assert seen_layout > 0 and seen_none > 0


def _separate(overrides, seconds):
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.separation.engine import SeparationEngine

    audio, _ = make_song(seconds)
    out = {}
    try:
        for pipelined in (True, False):
            set_runtime_config({**overrides, "device_pipeline.pipelined_upload": pipelined})
            out[pipelined] = SeparationEngine(SR, "cpu").separate_on_device(audio)
            reset_runtime_config()
    finally:
        reset_runtime_config()
    return out


@pytest.fixture(scope="module")
def stems():
    return {"convtdf": _separate(TINY, 15.0), "spectral": _separate(SPECTRAL, 25.0)}


@pytest.mark.parametrize("backend, label", [("convtdf", "device_ola_pipelined_p6"),
                                            ("spectral", "device_ola_pipelined_p2")])
def test_pipelined_mix_is_the_whole_track_mix(stems, backend, label):
    (_, _, mix_p, meta_p), (_, _, mix_m, meta_m) = stems[backend][True], stems[backend][False]
    assert meta_p["gpu_pipeline_mode"] == label
    assert meta_m["gpu_pipeline_mode"] == "device_ola"
    assert meta_p["gpu_pipeline_chunks"] == meta_m["gpu_pipeline_chunks"]
    assert torch.equal(mix_p, mix_m)


def test_pipelined_convtdf_stems_within_the_batch_bound(stems):
    (v_p, i_p, _, _), (v_m, i_m, _, _) = stems["convtdf"][True], stems["convtdf"][False]
    for stem, got, want in (("vocal", v_p, v_m), ("instrumental", i_p, i_m)):
        want64 = want.double()
        snr = 10 * np.log10(float((want64 ** 2).sum() / ((got.double() - want64) ** 2).sum()))
        assert snr >= CONV_SNR_DB[stem], (stem, snr)
        assert float((got - want).abs().max()) <= CONV_ATOL


def test_pipelined_spectral_stems_equal_the_whole_track(stems):
    (v_p, i_p, _, _), (v_m, i_m, _, _) = stems["spectral"][True], stems["spectral"][False]
    np.testing.assert_allclose(v_p.numpy(), v_m.numpy(), atol=SPECTRAL_ATOL, rtol=0)
    np.testing.assert_allclose(i_p.numpy(), i_m.numpy(), atol=SPECTRAL_ATOL, rtol=0)


def test_pipelined_geometry_change_uses_fresh_layout(stems):
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.separation.engine import SeparationEngine, padded_track_len

    audio, _ = make_song(25.0)
    padded = padded_track_len(audio.size, SR, 4096)
    try:
        set_runtime_config(SPECTRAL)
        eng0 = SeparationEngine(SR, "cpu")
        before = eng0._piece_layout(padded)  # cached by the stems' pipelined run
        set_runtime_config({"device_pipeline.overlap_seconds": 3.5})
        eng_p = SeparationEngine(SR, "cpu")
        assert eng_p.backend is eng0.backend  # one backend instance, one token
        v_p, i_p, mix_p, meta_p = eng_p.separate_on_device(audio)
        after = eng_p._piece_layout(padded)
        set_runtime_config({"device_pipeline.pipelined_upload": False})
        v_m, i_m, mix_m, meta_m = SeparationEngine(SR, "cpu").separate_on_device(audio)
    finally:
        reset_runtime_config()
    assert after is not before and after["spans"] != before["spans"]
    assert meta_p["gpu_pipeline_mode"].startswith("device_ola_pipelined_p")
    assert meta_m["gpu_pipeline_mode"] == "device_ola"
    np.testing.assert_allclose(v_p.numpy(), v_m.numpy(), atol=SPECTRAL_ATOL, rtol=0)
    np.testing.assert_allclose(i_p.numpy(), i_m.numpy(), atol=SPECTRAL_ATOL, rtol=0)
    assert torch.equal(mix_p, mix_m)


def test_staged_pass_equals_the_fused_pass_over_pieces():
    from dataclasses import fields

    from audio_cut_tpu.separation.engine import SeparationEngine as JaxEngine
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.models.vad import build_vad
    from audio_cut_tpu_torch.separation import fused
    from audio_cut_tpu_torch.separation.engine import SeparationEngine, padded_track_len

    audio, _ = make_song(15.0)
    try:
        set_runtime_config(TINY)
        engine = SeparationEngine(SR, "cpu")
        vad = build_vad(SR, "cpu")
        sep_f, bundle_f = fused.separate_and_detect_fused(engine, vad, audio)
        sep_s, bundle_s = fused.separate_and_detect_fused(engine, vad, audio, staged=True)
        geometry = engine._geometry()
    finally:
        reset_runtime_config()
    # the JAX package's piece count for this schedule, at the default config
    je = JaxEngine(SR, backend=_Stub(dict(zip(("chunk_s", "overlap_s", "halo_s", "align"),
                                              geometry))))
    pieces = len(je._piece_layout(padded_track_len(audio.size, SR, geometry[3]))["spans"])
    assert pieces == 6
    assert sep_f.device_meta["gpu_pipeline_mode"] == f"fused_pipelined_p{pieces}"
    assert sep_s.device_meta["gpu_pipeline_mode"] == f"device_ola_pipelined_p{pieces}"
    assert torch.equal(sep_f.vocal_device, sep_s.vocal_device)
    for f in fields(bundle_f):
        a, b = getattr(bundle_f, f.name), getattr(bundle_s, f.name)
        if f.name == "features":
            for g in fields(a):
                np.testing.assert_array_equal(getattr(b, g.name), getattr(a, g.name), err_msg=g.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)
