"""The batch entry point of the port, ``separate_and_segment_batch``, and the
modules behind it, on the CPU, with the spectral backend that
``tests/conftest.py`` pins and the JAX batch test's small schedule (2 s
windows).

1. ``parallel/batch.separate_tracks_mesh`` over two tracks of two lengths
   (two padded-length groups):
   - against the JAX ``separate_tracks_mesh`` over its 8 virtual CPU
     devices: atol 1e-5, the bound of the JAX package's own test;
   - a one-device CPU mesh against the port engine's ``separate_on_device``
     of each track: atol 1e-5, the spectral bound of
     ``tests/test_torch_pipelined.py``;
   - a mesh of two CPU devices against a mesh of one: atol 1e-6. No sample
     here lies under more than two windows, so the per-device sum adds the
     same two terms as one device does.
2. ``separation/precomputed.PrecomputedStemEngine``: its mix equals the
   engine's mix (``torch.equal``); for a track past ``LONG_TRACK_S`` (80 s)
   its mix and padded vocal have the length of ``padded_track_len`` and of
   the JAX ``_padded`` (the fault ``test_batch_long_track_parity`` guards,
   without an 80 s pipeline run).
3. ``separate_and_segment_batch(device="cpu")`` over three songs of two
   lengths (two of them with the same file name in two folders) and a
   corrupt file:
   - each manifest's cuts and segments equal the port's single
     ``separate_and_segment`` of the same file, exactly;
   - against the JAX batch of the same files: the same segment labels, and
     cuts within 441 samples (10 ms), the bound of
     ``tests/test_torch_slice.py:test_mdd_cuts_within_10_ms``;
   - the corrupt file fills its own slot, the same-stem files export to
     ``song`` and ``song_1``, and ``workers=2`` gives the manifests of
     ``workers=1``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from conftest import make_song  # noqa: E402

SR = 44100
SMALL_SCHEDULE = {
    "device_pipeline.chunk_seconds": 2.0,
    "device_pipeline.overlap_seconds": 0.5,
    "device_pipeline.halo_seconds": 0.1,
}
MESH_ATOL = 1e-5
SPLIT_ATOL = 1e-6
# manifest fields that the batch and single calls must share (timings,
# export paths and the separation label differ by design)
SAME = ("success", "cuts", "segments", "guard", "separation", "stats", "audio")


@pytest.fixture
def small_schedule():
    from audio_cut_tpu.config import reset_runtime_config as jax_reset
    from audio_cut_tpu.config import set_runtime_config as jax_set
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config

    jax_set(dict(SMALL_SCHEDULE))
    set_runtime_config(dict(SMALL_SCHEDULE))
    yield
    jax_reset()
    reset_runtime_config()


@pytest.fixture(scope="module")
def tracks():
    return [make_song(9.0, seed=5)[0], make_song(17.0, seed=6)[0]]


def _mesh_stems(tracks, devices):
    from audio_cut_tpu_torch.parallel.batch import separate_tracks_mesh
    from audio_cut_tpu_torch.parallel.mesh import make_mesh

    return separate_tracks_mesh(tracks, SR, mesh=make_mesh(devices), backend="spectral")


def test_mesh_stems_match_jax_mesh(tracks, small_schedule):
    from audio_cut_tpu.parallel.batch import separate_tracks_mesh as jax_mesh
    from audio_cut_tpu.parallel.mesh import make_mesh as jax_make_mesh

    want = jax_mesh(tracks, SR, mesh=jax_make_mesh(jax.devices()[:8], dp=8, sp=1, tp=1),
                    backend="spectral")
    got = _mesh_stems(tracks, "cpu")
    for audio, (v, i), (vj, ij) in zip(tracks, got, want):
        assert v.shape == i.shape == audio.shape
        np.testing.assert_allclose(v.numpy(), vj, atol=MESH_ATOL, rtol=0)
        np.testing.assert_allclose(i.numpy(), ij, atol=MESH_ATOL, rtol=0)


def test_mesh_stems_match_engine_and_split(tracks, small_schedule):
    from audio_cut_tpu_torch.separation.engine import SeparationEngine
    from audio_cut_tpu_torch.separation.precomputed import PrecomputedStemEngine

    one = _mesh_stems(tracks, "cpu")
    two = _mesh_stems(tracks, ["cpu", "cpu"])
    engine = SeparationEngine(SR, "cpu")
    for audio, (v, i), (v2, i2) in zip(tracks, one, two):
        v_ref, i_ref, mix_ref, _ = engine.separate_on_device(audio)
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), atol=MESH_ATOL, rtol=0)
        np.testing.assert_allclose(i.numpy(), i_ref.numpy(), atol=MESH_ATOL, rtol=0)
        np.testing.assert_allclose(v2.numpy(), v.numpy(), atol=SPLIT_ATOL, rtol=0)
        np.testing.assert_allclose(i2.numpy(), i.numpy(), atol=SPLIT_ATOL, rtol=0)
        # the injected engine's mix is the engine's, to the bit
        pre = PrecomputedStemEngine(SR, "cpu", v, "spectral", align=engine._geometry()[3])
        vocal_dev, _, mix, meta = pre.separate_on_device(audio)
        assert torch.equal(mix, mix_ref)
        assert torch.equal(vocal_dev, v)
        assert meta["gpu_pipeline_mode"] == "mesh_batch_precomputed"


def test_precomputed_pads_a_long_track_like_the_engine():
    from audio_cut_tpu.separation.precomputed import PrecomputedStemEngine as JaxPre
    from audio_cut_tpu_torch.separation.engine import LONG_TRACK_S, padded_track_len
    from audio_cut_tpu_torch.separation.precomputed import PrecomputedStemEngine

    n = int(80.0 * SR) + 17
    assert n > LONG_TRACK_S * SR
    audio = (0.1 * np.random.default_rng(4).standard_normal(n)).astype(np.float32)
    align = 1024
    want = padded_track_len(n, SR, align)
    jax_len = JaxPre(SR, audio, None, "spectral", align=align)._padded(audio, n).shape[-1]
    pre = PrecomputedStemEngine(SR, "cpu", audio, "spectral", align=align)
    assert want == jax_len
    assert want // SR == 120  # the 60 s long bucket, not the 15 s rule's 90 s
    assert pre.mix_device(audio).shape[-1] == want
    assert pre.vocal_device(n).shape[-1] == want


@pytest.fixture(scope="module")
def batch_runs(tmp_path_factory):
    """The port's batch (workers 1 and 2), the port's single calls and the
    JAX batch over the same files."""
    from audio_cut_tpu.api import separate_and_segment_batch as jax_batch
    from audio_cut_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audio_cut_tpu_torch.api import separate_and_segment, separate_and_segment_batch
    from audio_cut_tpu_torch.io import write_wav

    root = tmp_path_factory.mktemp("batch")
    songs = [("a/song.wav", 12.0, 8), ("b/song.wav", 12.0, 9), ("gamma.wav", 20.0, 4)]
    paths = []
    for rel, seconds, seed in songs:
        path = root / rel
        path.parent.mkdir(exist_ok=True)
        write_wav(path, make_song(seconds, seed=seed)[0], SR)
        paths.append(path)
    bad = root / "bad.wav"
    bad.write_bytes(b"RIFFnot-actually-a-wav")
    uris = [str(p) for p in paths] + [str(bad)]

    run = dict(input_uris=uris, device="cpu", runtime_overrides=SMALL_SCHEDULE)
    batch = separate_and_segment_batch(export_dir=str(root / "batch"), **run)
    batch2 = separate_and_segment_batch(export_dir=str(root / "batch2"), workers=2, **run)
    single = [separate_and_segment(input_uri=str(p), export_dir=str(root / "single" / str(k)),
                                   device="cpu", runtime_overrides=SMALL_SCHEDULE)
              for k, p in enumerate(paths)]
    jax_manifests = jax_batch(
        input_uris=[str(p) for p in paths], export_dir=str(root / "jax"),
        runtime_overrides=SMALL_SCHEDULE,
        mesh=jax_make_mesh(jax.devices()[:8], dp=8, sp=1, tp=1))
    return {"batch": batch, "batch2": batch2, "single": single, "jax": jax_manifests,
            "bad": bad}


def test_batch_manifests_equal_single_calls(batch_runs):
    for mb, ms in zip(batch_runs["batch"], batch_runs["single"]):
        assert mb["success"] and ms["success"]
        assert mb["cuts"] == ms["cuts"]
        assert mb["segments"] == ms["segments"]
        assert len(mb["segments"]) >= 2
        assert mb["gpu"]["gpu_pipeline_mode"] == "mesh_batch_precomputed"
        assert mb["gpu"]["gpu_pipeline_batch_size"] == 4
        assert ms["gpu"]["gpu_pipeline_mode"].startswith("fused_pipelined_p")


def test_batch_matches_the_jax_batch(batch_runs):
    for mb, mj in zip(batch_runs["batch"], batch_runs["jax"]):
        assert mj["success"]
        assert [s["label"] for s in mb["segments"]] == [s["label"] for s in mj["segments"]]
        st, sj = mb["cuts"]["samples"], mj["cuts"]["samples"]
        assert len(st) == len(sj)
        assert max(abs(a - b) for a, b in zip(st, sj)) <= 441


def test_bad_file_fills_its_slot_and_names_are_deduplicated(batch_runs):
    *good, bad = batch_runs["batch"]
    assert bad["success"] is False and bad["error"]
    assert bad["input_file"] == str(batch_runs["bad"].resolve())
    assert [Path(m["manifest_path"]).parent.name for m in good] == ["song", "song_1", "gamma"]


def test_two_workers_give_the_same_manifests(batch_runs):
    for m1, m2 in zip(batch_runs["batch"], batch_runs["batch2"]):
        assert {k: m1.get(k) for k in SAME} == {k: m2.get(k) for k in SAME}
