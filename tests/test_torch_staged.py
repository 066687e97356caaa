"""The staged bundle path (``device_pipeline.fused_program: false``).

1. The port against itself, on ``device="cpu"`` with the packaged tiny
   ConvTDF and the packaged ConvVAD, on a 15 s song. The port runs the
   staged path as the fused pass under another label, so a staged call
   separates the track again and builds its bundle through the same
   function. Bound: none. The bundles that reach the host tail are equal
   bit for bit, and the manifests are equal apart from timings, paths and
   ``gpu_pipeline_mode`` (``device_ola_pipelined_p6`` against
   ``fused_pipelined_p6``: the default config cuts the 11 windows into 6
   pieces on both paths).
   For ``v2.2_mdd`` and ``vpbd_acoustic``.
2. The port's staged path against the JAX package's. The JAX package's
   ``separate_for_detection`` and the port's ``separate_on_device`` return
   the stems of one fixed pair, and each package's ``build_detection_bundle``
   returns the DetectionBundle that it unpacks from ONE flat host copy of
   the port's CPU bundle of a synthetic 30 s song (``torch_tail_pair.py``).
   ``separate_and_segment`` then runs the staged branch and the whole host
   tail in each. Bound: none; the manifests are equal apart from timings
   and paths.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from conftest import make_song  # noqa: E402
from torch_tail_pair import SR, build_pair  # noqa: E402

TINY = {"enhanced_separation.backend": "convtdf",
        "enhanced_separation.convtdf.checkpoint": "packaged_tiny"}
STAGED = {"device_pipeline.fused_program": False}
STAGED_META = {"gpu_pipeline_backend": "convtdf", "gpu_pipeline_chunks": 11,
               "gpu_pipeline_mode": "device_ola"}
TIMED = ("gpu_pipeline_compute_ms", "gpu_pipeline_total_ms")


def _scrub(m, gpu_keys=()):
    m = copy.deepcopy(m)
    m.pop("timings_ms")
    m.pop("manifest_path", None)
    m["artifacts"].pop("output_dir")
    for k in gpu_keys:
        m["gpu"].pop(k, None)
    return m


@pytest.fixture(scope="module", params=["v2.2_mdd", "vpbd_acoustic"])
def port_runs(request, tmp_path_factory):
    """{path: (manifest, the bundle that reached the host tail)}."""
    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.io import write_wav
    from audio_cut_tpu_torch.pipeline.modes import pure_vocal

    root = tmp_path_factory.mktemp("staged_port")
    audio, sr = make_song(15.0)
    write_wav(root / "song.wav", audio, sr, subtype="FLOAT")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        inner = pure_vocal._plan_cuts
        for path, extra in (("fused", {}), ("staged", STAGED)):
            seen = []

            def plan_cuts(audio, sr, bundle, *args, **kwargs):
                seen.append(bundle)
                return inner(audio, sr, bundle, *args, **kwargs)

            mp.setattr(pure_vocal, "_plan_cuts", plan_cuts)
            m = separate_and_segment(input_uri=str(root / "song.wav"), export_dir=str(root / path),
                                     mode=request.param, device="cpu",
                                     runtime_overrides={**TINY, **extra})
            assert len(seen) == 1
            out[path] = (m, seen[0])
    finally:
        mp.undo()
    return request.param, out


def test_staged_bundle_equals_fused_bit_for_bit(port_runs):
    from dataclasses import fields

    _, out = port_runs
    fused, staged = out["fused"][1], out["staged"][1]
    assert fused.vad_probs is not None and fused.vocal_energy is not None
    for f in fields(fused):
        a, b = getattr(fused, f.name), getattr(staged, f.name)
        if f.name == "features":
            for g in fields(a):
                np.testing.assert_array_equal(getattr(b, g.name), getattr(a, g.name), err_msg=g.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)


def test_staged_manifest_equals_fused_but_the_mode(port_runs):
    mode, out = port_runs
    mf, ms = out["fused"][0], out["staged"][0]
    assert mf["success"] and ms["success"] and ms["version"] == mode
    assert len(ms["segments"]) >= 2
    assert mf["gpu"]["gpu_pipeline_mode"] == "fused_pipelined_p6"
    assert ms["gpu"]["gpu_pipeline_mode"] == "device_ola_pipelined_p6"
    timed = TIMED + ("gpu_pipeline_mode",)
    assert _scrub(ms, timed) == _scrub(mf, timed)


@pytest.fixture(scope="module")
def jax_pair_runs(tmp_path_factory):
    """(JAX manifest, port manifest, calls) of one staged call each on the pair."""
    import jax as jax_mod

    from audio_cut_tpu.analysis import bundle as JB
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu.separation import fused as jax_fused
    from audio_cut_tpu.separation.engine import SeparationEngine as JaxEngine
    from audio_cut_tpu.separation.engine import SeparationResult as JaxResult
    from audio_cut_tpu_torch.analysis import bundle as TB
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run
    from audio_cut_tpu_torch.io import write_wav
    from audio_cut_tpu_torch.separation.engine import SeparationEngine as TorchEngine

    pair = build_pair("conv")
    n = pair.mix.size
    root = tmp_path_factory.mktemp("staged_pair")
    write_wav(root / "song.wav", pair.mix, SR, subtype="FLOAT")
    jshapes = {k: jax_mod.ShapeDtypeStruct(s, np.float32) for k, s in pair.shapes.items()}
    calls = {"jax": [], "torch": []}

    def fake_separation(result_cls):
        def separate_for_detection(self, audio, need_instrumental=True):
            assert need_instrumental is False and len(audio) == n
            calls["jax"].append("separate_for_detection")
            sep = result_cls(vocal_track=pair.vocal.copy(), instrumental_track=None,
                             backend_used="convtdf", separation_confidence=None,
                             device_meta=dict(STAGED_META))
            sep._mix_energy = float(np.mean(np.square(audio)))
            return sep
        return separate_for_detection

    def fake_bundle(side, bundle_mod, shapes, vad):
        def build_detection_bundle(mix_dev, vocal_dev, sr, n_true, *, guard_win_ms,
                                   refine_win_ms, vad_model):
            assert (sr, n_true, guard_win_ms, refine_win_ms) == (SR, n, 80.0, 5.0)
            assert vad_model is vad
            calls[side].append("build_detection_bundle")
            return bundle_mod.unpack_bundle(pair.flat, shapes, SR, n, pair.statics, vad_model)
        return build_detection_bundle

    def no_fused(*args, **kwargs):
        raise AssertionError("the fused pass ran on the staged path")

    mp = pytest.MonkeyPatch()
    try:
        import torch

        mp.setattr(get_pcm_codec(), "_lib", None)  # the JAX package's numpy codec
        mp.setattr(JaxEngine, "separate_for_detection", fake_separation(JaxResult))
        mp.setattr(JB, "build_detection_bundle", fake_bundle("jax", JB, jshapes, pair.jax_vad))
        mp.setattr(jax_fused, "separate_and_detect_fused", no_fused)

        def torch_separate_on_device(self, audio):
            assert len(audio) == n
            calls["torch"].append("separate_on_device")
            return (torch.from_numpy(pair.vocal), None, torch.from_numpy(pair.mix),
                    dict(STAGED_META))

        mp.setattr(TorchEngine, "separate_on_device", torch_separate_on_device)
        mp.setattr(TB, "build_detection_bundle", fake_bundle("torch", TB, pair.shapes, pair.torch_vad))
        overrides = {"enhanced_separation.backend": "convtdf", **STAGED}
        mj = jax_run(input_uri=str(root / "song.wav"), export_dir=str(root / "jax"),
                     mode="v2.2_mdd", export_manifest=True, runtime_overrides=overrides)
        mt = torch_run(input_uri=str(root / "song.wav"), export_dir=str(root / "torch"),
                       mode="v2.2_mdd", device="cpu", export_manifest=True,
                       runtime_overrides=overrides)
    finally:
        mp.undo()
    return mj, mt, calls


def test_staged_path_runs_in_both(jax_pair_runs):
    mj, mt, calls = jax_pair_runs
    assert calls["jax"] == ["separate_for_detection", "build_detection_bundle"]
    assert calls["torch"] == ["separate_on_device", "build_detection_bundle"]
    assert mj["success"] and mt["success"] and len(mt["segments"]) >= 3
    assert mt["gpu"]["gpu_pipeline_mode"] == "device_ola"


def test_staged_manifests_are_equal_but_timings_and_paths(jax_pair_runs):
    mj, mt, _ = jax_pair_runs
    assert mt["cuts"] == mj["cuts"]
    assert mt["separation"] == mj["separation"]
    assert _scrub(mt, TIMED) == _scrub(mj, TIMED)
