"""The v2.2_mdd host tail, bit for bit: given the same stems and the same
detection bundle, both packages must cut, label, guard and report the same.

Both packages' ``separate_and_detect_fused`` are replaced, in this test only
(``monkeypatch``), by a function that returns one fixed pair: a vocal stem
and a DetectionBundle unpacked by each package from ONE flat host copy (the
port's bundle of a synthetic 30 s song, on the CPU, with the packaged
ConvVAD, or without it for ``vad.backend: energy_gate``). No file of either
package changes. ``separate_and_segment(mode=
"v2.2_mdd")`` then runs the whole host tail in each: VAD focus windows, the
pause detector, NMS and quiet guards, layout, the valley refine,
classification, the split and the export.

Bound: none. The tail is host numpy on equal inputs in both, so the
manifests are equal apart from timings and paths, down to the last bit of
every cut, guard shift and QA figure.
"""

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

SR = 44100
DUR_S = 30.0
FAKE_META = {"gpu_pipeline_backend": "convtdf", "gpu_pipeline_chunks": 11,
             "gpu_pipeline_mode": "fused_single_program"}


def _song():
    """(mix, vocal): an 8 s beat-only intro, then sung phrases of 1.6-3.5 s
    with 0.5-1.2 s gaps, over clicks at 120 BPM."""
    rng = np.random.default_rng(21)
    n = int(DUR_S * SR)
    t = np.arange(n) / SR
    vocal = np.zeros(n)
    start = 8.0
    while start + 2.0 < DUR_S:
        length = rng.uniform(1.6, 3.5)
        seg = (t >= start) & (t < min(start + length, DUR_S))
        f0 = rng.uniform(180, 300) * (1 + 0.01 * np.sin(2 * np.pi * 5.5 * t[seg]))
        x = sum(np.sin(2 * np.pi * h * np.cumsum(f0) / SR) / h for h in range(1, 5))
        ramp = np.minimum(1.0, np.minimum(np.arange(x.size), x.size - np.arange(x.size)) / (0.04 * SR))
        vocal[seg] += 0.3 * x * ramp
        start += length + rng.uniform(0.5, 1.2)
    bed = np.zeros(n)
    for beat in np.arange(0.0, DUR_S, 0.5):
        i = int(beat * SR)
        k = min(2000, n - i)
        bed[i:i + k] += 0.15 * np.exp(-np.arange(k) / 300.0) * rng.standard_normal(k)
    vocal *= 0.9
    return (vocal + bed).astype(np.float32), vocal.astype(np.float32)


@pytest.fixture(scope="module", params=["conv", "energy_gate"])
def runs(request, tmp_path_factory):
    from audio_cut_tpu.analysis import bundle as JB
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.io import write_wav
    from audio_cut_tpu.models.vad import build_vad as jax_build_vad
    from audio_cut_tpu.separation import fused as jax_fused
    from audio_cut_tpu.separation.engine import SeparationResult as JaxResult
    from audio_cut_tpu_torch.analysis import bundle as TB
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run
    from audio_cut_tpu_torch.models.vad import build_vad as torch_build_vad
    from audio_cut_tpu_torch.separation import fused as torch_fused
    from audio_cut_tpu_torch.separation.engine import SeparationResult as TorchResult
    from audio_cut_tpu_torch.separation.engine import padded_track_len

    backend = request.param
    overrides = {"enhanced_separation.backend": "convtdf", "vad.backend": backend}
    root = tmp_path_factory.mktemp("mdd_tail")
    mix, vocal = _song()
    song = root / "song.wav"
    write_wav(song, mix, SR, subtype="FLOAT")
    n = mix.size
    padded = padded_track_len(n, SR, 1024)
    statics = TB.bundle_statics(SR)
    if backend == "conv":
        torch_vad, jax_vad = torch_build_vad(SR, "cpu"), jax_build_vad(SR)
    else:  # the energy gate: no ConvVAD in the bundle
        torch_vad = jax_vad = None
    with torch.inference_mode():
        out = TB._bundle_fn(torch.from_numpy(np.pad(mix, (0, padded - n))),
                            torch.from_numpy(np.pad(vocal, (0, padded - n))),
                            torch_vad.net if torch_vad is not None else None, SR, *statics)
        flat, shapes = TB.flatten_bundle(out)
    flat = flat.numpy()
    jshapes = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}

    def fake(result_cls, bundle_mod, vad):
        def separate_and_detect_fused(engine, vad_model, audio, *, guard_win_ms, refine_win_ms):
            assert vad_model is vad and len(audio) == n
            assert (guard_win_ms, refine_win_ms) == (80.0, 5.0)
            sep = result_cls(vocal_track=vocal.copy(), instrumental_track=None,
                             backend_used="convtdf", separation_confidence=None,
                             device_meta=dict(FAKE_META))
            sep._mix_energy = float(np.mean(np.square(audio)))
            bundle = bundle_mod.unpack_bundle(flat, shapes if bundle_mod is TB else jshapes,
                                              SR, n, statics, vad_model)
            if bundle.vocal_energy is not None:  # as both packages' fused pass sets it
                ratio = bundle.vocal_energy / (sep._mix_energy + 1e-12)
                sep.separation_confidence = float(np.clip(1.0 - abs(ratio - 0.35) / 0.65, 0.1, 0.99))
            return sep, bundle
        return separate_and_detect_fused

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_fused, "separate_and_detect_fused", fake(JaxResult, JB, jax_vad))
        mp.setattr(torch_fused, "separate_and_detect_fused", fake(TorchResult, TB, torch_vad))
        mj = jax_run(input_uri=str(song), export_dir=str(root / "jax"), mode="v2.2_mdd",
                     export_manifest=True, runtime_overrides=overrides)
        mt = torch_run(input_uri=str(song), export_dir=str(root / "torch"), mode="v2.2_mdd",
                       device="cpu", export_manifest=True, runtime_overrides=overrides)
    finally:
        mp.undo()
    return root, mix, mj, mt


def test_the_song_is_cut(runs):
    _, _, mj, mt = runs
    assert mj["success"] and mt["success"]
    assert len(mt["segments"]) >= 3
    assert {s["label"] for s in mt["segments"]} == {"human", "music"}
    assert mt["guard"]["adjustments"] and mt["cuts"]["suppressed"]


def test_cuts_labels_guards_and_qa_are_identical(runs):
    _, _, mj, mt = runs
    assert mt["cuts"] == mj["cuts"]
    assert [s["label"] for s in mt["segments"]] == [s["label"] for s in mj["segments"]]
    assert mt["guard"] == mj["guard"]
    assert mt["qa_report"] == mj["qa_report"]
    assert mt["separation"] == mj["separation"]


def test_manifests_are_equal_but_timings_and_paths(runs):
    _, _, mj, mt = runs

    def scrub(m):
        m = copy.deepcopy(m)
        m.pop("timings_ms")
        m.pop("manifest_path")
        m["artifacts"].pop("output_dir")
        return m

    assert scrub(mt) == scrub(mj)


def test_segments_match_and_splice_back(runs):
    """The same segment files. Their samples agree to one 24-bit step: the JAX
    package's native codec rounds the scaled sample through float32
    (``llrintf``) and decodes by a reciprocal multiply, where the port rounds
    the float64 product once and divides, as the JAX package's own numpy
    codec does. Each package's segments splice back to its own PCM-24
    encoding of the input exactly."""
    from audio_cut_tpu.io import read_wav as jax_read
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu_torch.io import read_wav
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    root, mix, mj, mt = runs
    assert [s["mix_path"] for s in mt["segments"]] == [s["mix_path"] for s in mj["segments"]]
    parts_j, parts_t = [], []
    for seg in mt["segments"]:
        xj, _ = jax_read(root / "jax" / seg["mix_path"])
        xt, _ = read_wav(root / "torch" / seg["mix_path"])
        assert xt.shape == xj.shape
        assert np.abs(xt.astype(np.float64) - xj).max() <= 1.0 / 8388607.0 + 1e-12
        parts_j.append(xj)
        parts_t.append(xt)
    codec = get_pcm_codec()
    np.testing.assert_array_equal(np.concatenate(parts_j), codec.decode_pcm24(codec.encode_pcm24(mix)))
    np.testing.assert_array_equal(np.concatenate(parts_t), decode_pcm24(encode_pcm24(mix)))
