"""vpbd_asr with lyric priors, the lyrics providers and the intent arguments,
against the JAX package.

Unit parity, each on seeded or fixture inputs (``tests/fixtures/lyrics/``),
port against the JAX function: the worker protocol, every provider name of
``build_lyrics_provider`` (the ``auto`` chain with and without ``null``, each
provider's availability, strict ``null``), the fake provider, the CLI and
in-process seams over a stand-in worker, the lyric candidates, the
segment attach, ``restore_guards_outside_words`` and ``pcm16_pack_graph``:
equal, bound none. The device ASR copy on a CPU tensor (a float32 matrix
product in each library, summed in another association) agrees within one
PCM_16 step; the port carries no host copy, as it has no host fallback.

Host-tail parity: both packages get the same stems and bundle
(``torch_tail_pair.py``) and run ``separate_and_segment`` to the end; the
manifests are equal apart from timings and paths, and the segment files
byte for byte (the JAX package on its numpy PCM codec, which the port
follows). Cases: ``vpbd_asr`` with the fake provider on the fixture
timeline, the same through the intent (``segments="many"``),
``segments="many"`` on the default chain (``lyrics_unavailable:no_provider``)
and a missing fixture (``unavailable``); strict ``null`` raises
``LyricsAlignmentUnavailable`` in both.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_tail_pair import SR, build_pair, patch_fused, song  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "lyrics"
TIMELINE = FIXTURES / "simple_song_timeline.json"
FIRERED = FIXTURES / "fireredasr2s_result.jsonl"
BACKEND = {"enhanced_separation.backend": "convtdf"}
FAKE = {"lyrics_alignment.provider": "fake", "lyrics_alignment.fixture_path": str(TIMELINE)}
ON = {"lyrics_alignment.enabled": True}


def _both_configs(overrides):
    """Make ``overrides`` the runtime config of both packages."""
    from audio_cut_tpu.config import reset_runtime_config as jreset
    from audio_cut_tpu.config import set_runtime_config as jset
    from audio_cut_tpu_torch.config import reset_runtime_config as treset
    from audio_cut_tpu_torch.config import set_runtime_config as tset

    jreset()
    treset()
    jset(dict(overrides))
    tset(dict(overrides))


@pytest.fixture
def configs():
    from audio_cut_tpu.config import reset_runtime_config as jreset
    from audio_cut_tpu_torch.config import reset_runtime_config as treset

    yield _both_configs
    jreset()
    treset()


def _fixture_worker(payload):
    """A stand-in in-process ASR worker: the fixture's worker response."""
    assert payload["sample_rate"] == 16000
    return json.loads(FIRERED.read_text().splitlines()[0])


# -- protocol -----------------------------------------------------------------


def test_protocol_normalizes_the_worker_response():
    from audio_cut_tpu.lyrics import protocol as jp
    from audio_cut_tpu_torch.lyrics import protocol as tp

    payload = json.loads(FIRERED.read_text().splitlines()[0])
    for shift in (0.0, 12.5):
        want = jp.normalize_response(payload, global_t0_s=shift).to_dict()
        assert tp.normalize_response(payload, global_t0_s=shift).to_dict() == want
        assert len(want["words"]) == 8
    for lang in (None, "zh"):
        assert tp.build_analyze_request("a.wav", 16000, lang, 1.5) == \
            jp.build_analyze_request("a.wav", 16000, lang, 1.5)


# -- providers ------------------------------------------------------------------

PROVIDER_CASES = {
    "disabled": ("disabled", {}),
    "off": ("off", {}),
    "none": ("none", {}),
    "null": ("null", {}),
    "null_strict": ("null", {"lyrics_alignment.strict": True}),
    "fake": ("fake", {"lyrics_alignment.fixture_path": str(TIMELINE)}),
    "fake_missing": ("fake", {"lyrics_alignment.fixture_path": "no/such/timeline.json"}),
    "sidecar_no_endpoint": ("sidecar", {}),
    "cli_no_binary": ("cli", {"fire_red.cli.executable": "no-such-asr-binary-7f3a"}),
    "in_process_no_module": ("in_process", {"fire_red.in_process.entrypoint": "no_such_asr_mod:fn"}),
    "in_process": ("in_process", {"fire_red.in_process.entrypoint":
                                  "test_torch_lyrics:_fixture_worker"}),
    "auto_default": ("auto", {"lyrics_alignment.fixture_path": str(TIMELINE)}),
    "auto_without_null": ("auto", {"fire_red.provider_order": ["sidecar", "cli", "in_process"],
                                   "lyrics_alignment.fixture_path": str(TIMELINE)}),
    "auto_without_null_no_fixture": ("auto", {"fire_red.provider_order": ["sidecar", "cli"]}),
    "auto_null_first": ("auto", {"fire_red.provider_order": ["null", "in_process"],
                                 "fire_red.in_process.entrypoint":
                                 "test_torch_lyrics:_fixture_worker",
                                 "lyrics_alignment.fixture_path": str(TIMELINE)}),
    "auto_in_process": ("auto", {"fire_red.provider_order": ["sidecar", "in_process", "null"],
                                 "fire_red.in_process.entrypoint":
                                 "test_torch_lyrics:_fixture_worker"}),
}


@pytest.mark.parametrize("case", sorted(PROVIDER_CASES))
def test_build_lyrics_provider(configs, case):
    from audio_cut_tpu.lyrics.providers import build_lyrics_provider as jbuild
    from audio_cut_tpu_torch.lyrics.providers import build_lyrics_provider as tbuild

    name, overrides = PROVIDER_CASES[case]
    configs(overrides)
    jp, tp = jbuild(name), tbuild(name)
    assert type(tp).__name__ == type(jp).__name__
    assert tp.name == jp.name
    assert tp.available() == jp.available()
    assert getattr(tp, "strict", None) == getattr(jp, "strict", None)


def test_auto_chain_picks(configs):
    """What the chain resolves to, spelled out (the cases above hold it equal)."""
    from audio_cut_tpu_torch.lyrics.providers import build_lyrics_provider

    expect = {"auto_default": "null", "auto_without_null": "fake",
              "auto_without_null_no_fixture": "null", "auto_null_first": "null",
              "auto_in_process": "in_process"}
    for case, want in expect.items():
        name, overrides = PROVIDER_CASES[case]
        configs(overrides)
        assert build_lyrics_provider(name).name == want, case


def test_unknown_provider_and_strict_null_raise():
    from audio_cut_tpu.exceptions import LyricsAlignmentUnavailable as JUnavailable
    from audio_cut_tpu.exceptions import LyricsProviderError as JError
    from audio_cut_tpu.lyrics.providers import AlignRequest as JRequest
    from audio_cut_tpu.lyrics.providers import NullLyricsProvider as JNull
    from audio_cut_tpu.lyrics.providers import build_lyrics_provider as jbuild
    from audio_cut_tpu_torch.exceptions import LyricsAlignmentUnavailable, LyricsProviderError
    from audio_cut_tpu_torch.lyrics.providers import AlignRequest, NullLyricsProvider
    from audio_cut_tpu_torch.lyrics.providers import build_lyrics_provider

    with pytest.raises(JError):
        jbuild("whisper")
    with pytest.raises(LyricsProviderError):
        build_lyrics_provider("whisper")
    with pytest.raises(JUnavailable):
        JNull(strict=True).align(JRequest(audio_path="x.wav"))
    with pytest.raises(LyricsAlignmentUnavailable):
        NullLyricsProvider(strict=True).align(AlignRequest(audio_path="x.wav"))
    assert NullLyricsProvider().align(AlignRequest(audio_path="x.wav")).to_dict() == \
        JNull().align(JRequest(audio_path="x.wav")).to_dict()


def test_fake_provider_timeline():
    from audio_cut_tpu.lyrics.providers import AlignRequest as JRequest
    from audio_cut_tpu.lyrics.providers import FakeLyricsProvider as JFake
    from audio_cut_tpu_torch.lyrics import FakeLyricsProvider
    from audio_cut_tpu_torch.lyrics.providers import AlignRequest

    want = JFake(str(TIMELINE)).align(JRequest(audio_path="x.wav"))
    got = FakeLyricsProvider(str(TIMELINE)).align(AlignRequest(audio_path="x.wav"))
    assert got.to_dict() == want.to_dict()
    assert got.source == want.source == "fake" and len(got.words) == 8


def test_in_process_and_cli_seams(tmp_path):
    """Both seams over a stand-in worker give the JAX package's timeline."""
    from audio_cut_tpu.lyrics.cli_provider import CliLyricsProvider as JCli
    from audio_cut_tpu.lyrics.in_process import InProcessLyricsProvider as JInProcess
    from audio_cut_tpu.lyrics.providers import AlignRequest as JRequest
    from audio_cut_tpu_torch.lyrics.cli_provider import CliLyricsProvider
    from audio_cut_tpu_torch.lyrics.in_process import InProcessLyricsProvider
    from audio_cut_tpu_torch.lyrics.providers import AlignRequest

    spec = "test_torch_lyrics:_fixture_worker"
    want = JInProcess(spec).align(JRequest(audio_path="x.wav")).to_dict()
    assert InProcessLyricsProvider(spec).align(AlignRequest(audio_path="x.wav")).to_dict() == want
    # a worker executable: reads the request on stdin, writes the response file
    exe = tmp_path / "asr-worker"
    exe.write_text(
        f"#!{sys.executable}\n"
        "import json, sys\n"
        "req = json.load(sys.stdin)\n"
        "assert req['audio_path'] == 'x.wav'\n"
        f"line = open({str(FIRERED)!r}).read().splitlines()[0]\n"
        "open(sys.argv[sys.argv.index('--output') + 1], 'w').write(line)\n")
    exe.chmod(0o755)
    cli_want = JCli(str(exe)).align(JRequest(audio_path="x.wav"))
    cli_got = CliLyricsProvider(str(exe)).align(AlignRequest(audio_path="x.wav"))
    assert cli_got.to_dict() == cli_want.to_dict()
    assert cli_got.source == "cli" and cli_got.to_dict()["words"] == want["words"]


# -- candidates, attach, guard restore, PCM_16 ----------------------------------------


def _timelines():
    from audio_cut_tpu.lyrics.models import LyricsTimeline as JTimeline
    from audio_cut_tpu_torch.lyrics.models import LyricsTimeline

    data = json.loads(TIMELINE.read_text())
    cjk = {"words": [{"text": "你", "start_s": 1.0, "end_s": 1.3},
                     {"text": "好", "start_s": 1.35, "end_s": 1.7},
                     {"text": "world", "start_s": 2.4, "end_s": 2.9}],
           "sentences": [{"text": "你好 world", "start_s": 1.0, "end_s": 2.9}]}
    return [(JTimeline.from_dict(d, strict=False), LyricsTimeline.from_dict(d, strict=False))
            for d in (data, cjk)]


def test_lyrics_candidates():
    from audio_cut_tpu.lyrics.candidates import LyricsBoundaryCandidateGenerator as JGen
    from audio_cut_tpu_torch.lyrics.candidates import LyricsBoundaryCandidateGenerator

    for jt, tt in _timelines():
        want = [c.to_dict() for c in JGen().generate(jt)]
        assert [c.to_dict() for c in LyricsBoundaryCandidateGenerator().generate(tt)] == want
        assert want


def test_attach_lyrics_to_segments():
    from audio_cut_tpu.lyrics.segment_attach import attach_lyrics_to_segments as jattach
    from audio_cut_tpu_torch.lyrics.segment_attach import attach_lyrics_to_segments

    bounds = [0.0, 1.15, 2.0, 4.15, 8.0, 12.0, 20.0]
    segments = [{"id": f"{i:04d}", "start": a, "end": b, "label": "human"}
                for i, (a, b) in enumerate(zip(bounds, bounds[1:]))]
    for jt, tt in _timelines():
        want = jattach(copy.deepcopy(segments), jt)
        assert attach_lyrics_to_segments(copy.deepcopy(segments), tt) == want
        assert any("lyrics" in s for s in want)


def _restore_case(pkg, seed: int):
    """Seeded cuts, guard adjustments and (overlapping) words."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.5, 29.0, 28))
    words = [(float(s), float(s + rng.uniform(0.15, 1.2))) for s in starts]
    adjustments = []
    for raw in np.sort(rng.uniform(0.2, 29.8, 14)):
        shift = float(rng.choice([0.0, rng.uniform(0.005, 0.45)]))
        adjustments.append(pkg.CutAdjustment(
            raw_time=float(raw), guard_time=float(raw + shift), final_time=float(raw + shift),
            score=float(rng.random()), guard_shift_ms=shift * 1e3, final_shift_ms=shift * 1e3))
    cuts = [a.final_time for a in adjustments]
    return cuts, adjustments, words, float(rng.choice([0.2, 1.2]))


@pytest.mark.parametrize("seed", range(6))
def test_restore_guards_outside_words(seed):
    from audio_cut_tpu.cutting import refine as jrefine
    from audio_cut_tpu_torch.cutting import refine as trefine

    out = []
    for pkg in (jrefine, trefine):
        cuts, adjustments, words, gap = _restore_case(pkg, seed)
        times, adj, n = pkg.restore_guards_outside_words(
            cuts, adjustments, words, duration_s=30.0, sr=SR, min_gap_s=gap)
        out.append((times, None if adj is None else [a.to_dict() for a in adj], n))
    assert out[1] == out[0]


def test_restore_guards_outside_words_restores():
    """Over the seeds above, some boundaries are restored and some are not."""
    from audio_cut_tpu_torch.cutting import refine

    counts = []
    for seed in range(6):
        cuts, adjustments, words, gap = _restore_case(refine, seed)
        counts.append(refine.restore_guards_outside_words(
            cuts, adjustments, words, duration_s=30.0, sr=SR, min_gap_s=gap)[2])
    assert max(counts) > 0 and min(counts) < max(counts), counts


def test_pcm16_pack_graph():
    import jax.numpy as jnp
    import torch

    from audio_cut_tpu.ops.pcm import pcm16_pack_graph as jpack
    from audio_cut_tpu_torch.ops.pcm import pcm16_pack_graph

    rng = np.random.default_rng(5)
    halves = (np.arange(-40, 40) + 0.5) / 32767.0  # exact ties of the rounding
    x = np.concatenate([rng.uniform(-1.3, 1.3, 20000), halves, [-1.0, 1.0, 0.0, -0.0]])
    x = x.astype(np.float32)
    got = pcm16_pack_graph(torch.from_numpy(x))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpack(jnp.asarray(x))))


# -- the ASR copy ---------------------------------------------------------------------


def _read_i16(path):
    import wave

    with wave.open(str(path), "rb") as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (16000, 2, 1)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


@pytest.fixture(scope="module")
def vocal():
    return song()[1][: 20 * SR]


def test_write_asr_copy_from_device(tmp_path, vocal):
    import jax.numpy as jnp
    import torch

    from audio_cut_tpu.io.audio import write_asr_copy_from_device as jcopy
    from audio_cut_tpu_torch.io.audio import write_asr_copy_from_device

    want = _read_i16(jcopy(jnp.asarray(vocal), SR, tmp_path / "jax.wav"))
    got = _read_i16(write_asr_copy_from_device(torch.from_numpy(vocal), SR,
                                               tmp_path / "torch.wav"))
    assert got.size == want.size == 20 * 16000
    assert np.abs(got - want).max() <= 1
    assert np.abs(got).max() > 1000  # a voice, not silence


# -- host-tail parity -------------------------------------------------------------------

TAIL_CASES = {
    # name: (mode, segments, overrides)
    "asr_fake": ("vpbd_asr", None, {**ON, **FAKE}),
    "intent_fake": (None, "many", FAKE),
    "intent_default_chain": (None, "many", {}),
    "missing_fixture": ("vpbd_asr", None, {**ON, "lyrics_alignment.provider": "fake",
                                           "lyrics_alignment.fixture_path": "no/such.json"}),
}


@pytest.fixture(scope="module")
def tail_song(tmp_path_factory):
    from audio_cut_tpu_torch.io import write_wav

    pair = build_pair("conv", chorus_s=18.0)
    path = tmp_path_factory.mktemp("lyrics_song") / "song.wav"
    write_wav(path, pair.mix, SR, subtype="FLOAT")
    return pair, path


@pytest.fixture(scope="module", params=sorted(TAIL_CASES))
def tail_run(request, tail_song, tmp_path_factory):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.native import get_pcm_codec
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run

    pair, path = tail_song
    mode, segments, extra = TAIL_CASES[request.param]
    overrides = {**BACKEND, **extra}
    root = tmp_path_factory.mktemp(f"lyrics_{request.param}")
    dj, dt = root / "jax", root / "torch"
    mp = pytest.MonkeyPatch()
    try:
        patch_fused(mp, pair)
        mp.setattr(get_pcm_codec(), "_lib", None)  # the JAX package's numpy codec
        mj = jax_run(input_uri=str(path), export_dir=str(dj), mode=mode, segments=segments,
                     export_manifest=True, runtime_overrides=overrides)
        mt = torch_run(input_uri=str(path), export_dir=str(dt), mode=mode, segments=segments,
                       device="cpu", export_manifest=True, runtime_overrides=overrides)
    finally:
        mp.undo()
    return request.param, pair.mix, mj, mt, dj, dt


def _scrub(m):
    m = copy.deepcopy(m)
    m.pop("timings_ms")
    m.pop("manifest_path")
    m["artifacts"].pop("output_dir")
    return m


def test_tail_what_each_case_gives(tail_run):
    case, _, _, mt, _, _ = tail_run
    assert mt["success"] and mt["version"] == "vpbd_asr"
    counts = mt["boundary_detection"]["candidate_counts"]
    la = mt.get("lyrics_alignment") or {}
    if case in ("asr_fake", "intent_fake"):
        assert "note" not in mt and la["provider"] == "fake" and la["word_count"] == 8
        assert counts["lyrics"] > 0
        assert any("lyrics" in s for s in mt["segments"])
    else:
        reason = "no_provider" if case == "intent_default_chain" else "unavailable"
        assert mt["note"] == f"lyrics_unavailable:{reason}"
        assert la["fallback_reason"] == reason and counts["lyrics"] == 0
        assert not any("lyrics" in s for s in mt["segments"])
    if case.startswith("intent"):
        assert mt["intent"]["segments"] == "many"
    else:
        assert "intent" not in mt


def test_tail_manifests_are_equal_but_timings_and_paths(tail_run):
    _, _, mj, mt, _, _ = tail_run
    assert mt["cuts"] == mj["cuts"]
    assert mt["segments"] == mj["segments"]
    assert mt.get("intent") == mj.get("intent")
    assert mt.get("lyrics_alignment") == mj.get("lyrics_alignment")
    assert _scrub(mt) == _scrub(mj)


def test_tail_segment_files_are_equal_and_splice_back(tail_run):
    from audio_cut_tpu_torch.io import read_wav
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    _, mix, mj, mt, dj, dt = tail_run
    paths = [s["mix_path"] for s in mt["segments"]]
    assert paths == [s["mix_path"] for s in mj["segments"]]
    for rel in paths:
        assert (dt / rel).read_bytes() == (dj / rel).read_bytes()
    spliced = np.concatenate([read_wav(dt / rel)[0] for rel in paths])
    np.testing.assert_array_equal(spliced, decode_pcm24(encode_pcm24(mix)))


def test_strict_null_raises_in_both(tail_song, tmp_path):
    from audio_cut_tpu.api import separate_and_segment as jax_run
    from audio_cut_tpu.exceptions import LyricsAlignmentUnavailable as JUnavailable
    from audio_cut_tpu_torch.api import separate_and_segment as torch_run
    from audio_cut_tpu_torch.exceptions import LyricsAlignmentUnavailable

    pair, path = tail_song
    overrides = {**BACKEND, **ON, "lyrics_alignment.provider": "null",
                 "lyrics_alignment.strict": True}
    mp = pytest.MonkeyPatch()
    try:
        patch_fused(mp, pair)
        with pytest.raises(JUnavailable):
            jax_run(input_uri=str(path), export_dir=str(tmp_path / "jax"), mode="vpbd_asr",
                    runtime_overrides=overrides)
        with pytest.raises(LyricsAlignmentUnavailable):
            torch_run(input_uri=str(path), export_dir=str(tmp_path / "torch"), mode="vpbd_asr",
                      device="cpu", runtime_overrides=overrides)
    finally:
        mp.undo()
