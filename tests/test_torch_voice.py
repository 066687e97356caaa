"""The legacy multi-feature pause detector and its YIN/LPC analysis, against
the JAX package.

``v2_mdd.pure_vocal_detection.enable_relative_energy_mode: false`` rescores
the energy valleys by voicing (YIN), formant (LPC residual), flatness and
duration evidence, and takes each cut's silence floor from the host vocal.
The port runs YIN and LPC as torch code on the stem's device (the CPU here),
with the Viterbi, the refinement and the formant frequencies in host numpy.

Bounds:
* ``yin_f0`` and ``lpc_formant_strength``: both packages compute the frames'
  FFT autocorrelations in float32 with two libraries' FFTs, so voicing and
  formant strength agree within atol 1e-4 and f0 within 0.05 Hz on every
  frame of these inputs (a flip of the Viterbi path would move f0 by a bin).
* ``lpc_formant_frequencies`` is host float64 numpy in both: exact.
* The detector on one (vocal, bundle) pair: the same pauses, types, cut
  points and grades; confidences within atol 1e-6 (they are weighted sums
  of frame counts over the voicing threshold and of means of the formant
  strength, which agree within 1e-4 at worst and far closer here).
* End to end through ``tests/torch_tail_pair.py:patch_fused``, ``v2.2_mdd``
  and ``vpbd_acoustic``: the manifests equal the JAX package's apart from
  timings and paths, and the segment files to one 24-bit step (the PCM-24
  codecs, as in ``test_torch_mdd_tail.py``).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_tail_pair import SR, build_pair, patch_fused  # noqa: E402

LEGACY = {"v2_mdd.pure_vocal_detection.enable_relative_energy_mode": False}
VOICING_ATOL = 1e-4
F0_ATOL_HZ = 0.05
CONFIDENCE_ATOL = 1e-6
STEP = 1.0 / 8388607.0  # one 24-bit step


def _signal(case: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    t = np.arange(int(1.5 * SR)) / SR
    f0 = 220.0 * (1 + 0.02 * np.sin(2 * np.pi * 5.0 * t))
    tone = 0.3 * sum(np.sin(2 * np.pi * h * np.cumsum(f0) / SR) / h for h in range(1, 4))
    if case == "vibrato":
        x = tone
    elif case == "noise":
        x = 0.1 * rng.standard_normal(t.size)
    elif case == "silence_gap":  # a tone, silence, then noise
        x = tone.copy()
        x[SR // 2:SR] = 0.0
        x[SR:] = 0.1 * rng.standard_normal(t.size - SR)
    elif case == "short":  # shorter than one 40 ms frame
        x = tone[:1500]
    else:
        raise AssertionError(case)
    return x.astype(np.float32)


CASES = ["vibrato", "noise", "silence_gap", "short"]


@pytest.mark.parametrize("case", CASES)
def test_yin_f0_matches_jax(case):
    from audio_cut_tpu.ops import voice as J
    from audio_cut_tpu_torch.ops import voice as T

    x = _signal(case)
    fj, vj = J.yin_f0(x, SR)
    ft, vt = T.yin_f0(x, SR)
    assert ft.dtype == vt.dtype == np.float32
    assert ft.shape == fj.shape and vt.shape == vj.shape
    assert (ft.size == 0) == (case == "short")
    np.testing.assert_allclose(vt, vj, rtol=0, atol=VOICING_ATOL)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=F0_ATOL_HZ)
    if case == "vibrato":
        assert np.all(np.abs(ft - 220.0) < 10.0) and vt.min() > 0.9
    if case == "silence_gap":  # silent frames are unvoiced on both sides
        silent = slice(int(0.55 * 100), int(0.95 * 100))
        assert np.all(vt[silent] == 0.0) and np.all(vj[silent] == 0.0)


@pytest.mark.parametrize("case", CASES)
def test_lpc_formant_strength_matches_jax(case):
    from audio_cut_tpu.ops import voice as J
    from audio_cut_tpu_torch.ops import voice as T

    x = _signal(case)
    want, got = J.lpc_formant_strength(x, SR), T.lpc_formant_strength(x, SR)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (got.size == 0) == (case == "short")
    np.testing.assert_allclose(got, want, rtol=0, atol=VOICING_ATOL)
    if case == "vibrato":  # a resonant tone against white noise
        assert got.mean() > T.lpc_formant_strength(_signal("noise"), SR).mean() + 0.3


@pytest.mark.parametrize("case", CASES)
def test_lpc_formant_frequencies_match_jax(case):
    from audio_cut_tpu.ops import voice as J
    from audio_cut_tpu_torch.ops import voice as T

    x = _signal(case)
    for seg in (x, x[:4000], np.zeros(2000, np.float32)):
        np.testing.assert_array_equal(T.lpc_formant_frequencies(seg, SR),
                                      J.lpc_formant_frequencies(seg, SR))


@pytest.fixture(scope="module")
def pair():
    return build_pair("conv")


def test_detector_matches_jax(pair):
    """The detector alone on the pair, with the flag off: the port's YIN/LPC
    run on the vocal as a (CPU) tensor, the JAX package's on the host copy."""
    import torch

    from audio_cut_tpu.analysis import bundle as JB
    from audio_cut_tpu.config import reset_runtime_config as jax_reset
    from audio_cut_tpu.config import set_runtime_config as jax_set
    from audio_cut_tpu.detection.pause_detector import PureVocalPauseDetector as JDetector
    from audio_cut_tpu_torch.analysis import bundle as TB
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.detection.pause_detector import PureVocalPauseDetector
    from audio_cut_tpu_torch.separation.engine import SeparationResult

    stems = SeparationResult(None, None, "test", None)
    stems.vocal_device = torch.from_numpy(pair.vocal)
    n = pair.mix.size
    jshapes = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in pair.shapes.items()}
    bundles = [JB.unpack_bundle(pair.flat, jshapes, SR, n, pair.statics, None),
               TB.unpack_bundle(pair.flat, pair.shapes, SR, n, pair.statics, None)]
    kw = [dict(features=b.features, rms_env=b.vocal_rms_fine, env_db_grid=b.vocal_db_fine,
               env_db_stride=b.db_stride, n_samples=n) for b in bundles]
    jax_set(LEGACY)
    set_runtime_config(LEGACY)
    try:
        want = JDetector(SR).detect_pure_vocal_pauses(pair.vocal, **kw[0])
        got = PureVocalPauseDetector(SR).detect_pure_vocal_pauses(stems=stems, **kw[1])
        with pytest.raises(ValueError, match="needs the vocal waveform"):
            PureVocalPauseDetector(SR).detect_pure_vocal_pauses(**kw[1])
    finally:
        jax_reset()
        reset_runtime_config()
    assert len(got) == len(want) >= 3
    assert all(p.pause_type.startswith("multi_feature") for p in got)
    assert {p.quality_grade for p in got} == {p.quality_grade for p in want}
    for g, w in zip(got, want):
        assert (g.start_time, g.end_time, g.duration, g.pause_type, g.cut_point,
                g.quality_grade) == (w.start_time, w.end_time, w.duration, w.pause_type,
                                     w.cut_point, w.quality_grade)
        assert abs(g.confidence - w.confidence) <= CONFIDENCE_ATOL
        assert g.features.keys() == w.features.keys()
        assert g.features.get("formant_freqs_hz") == w.features.get("formant_freqs_hz")


@pytest.fixture(scope="module", params=["v2.2_mdd", "vpbd_acoustic"])
def runs(request, pair, tmp_path_factory):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    mode = request.param
    overrides = {"enhanced_separation.backend": "convtdf", **LEGACY}
    root = tmp_path_factory.mktemp("legacy")
    song = root / "song.wav"
    write_wav(song, pair.mix, SR, subtype="FLOAT")
    mp = pytest.MonkeyPatch()
    try:
        patch_fused(mp, pair)
        kw = dict(input_uri=str(song), mode=mode, export_manifest=True,
                  runtime_overrides=overrides, export_types=("mix_segments", "vocal_segments"))
        mj = jax_run(export_dir=str(root / "jax"), **kw)
        mt = torch_run(export_dir=str(root / "torch"), device="cpu", **kw)
    finally:
        mp.undo()
    return root, mj, mt


def test_legacy_manifests_match_jax(runs):
    _, mj, mt = runs

    def scrub(m):
        m = copy.deepcopy(m)
        m.pop("timings_ms")
        m.pop("manifest_path")
        m["artifacts"].pop("output_dir")
        return m

    assert mt["success"] and len(mt["segments"]) >= 3
    assert scrub(mt) == scrub(mj)


def test_legacy_segments_match_jax(runs):
    from audio_cut_tpu.io import read_wav as jax_read
    from audio_cut_tpu_torch.io import read_wav

    root, mj, mt = runs
    for key in ("mix_path", "vocal_path"):
        assert [s[key] for s in mt["segments"]] == [s[key] for s in mj["segments"]]
        for seg in mt["segments"]:
            xj, _ = jax_read(root / "jax" / seg[key])
            xt, _ = read_wav(root / "torch" / seg[key])
            assert xt.shape == xj.shape
            assert np.abs(xt.astype(np.float64) - xj).max() <= STEP + 1e-12
