"""The port's shell against the JAX package's: ``cli.py`` (its parser, its
``batch`` verb), ``config/migrate.py`` and ``quick_start.py``, on the CPU.

1. Parser parity: every option of ``audio_cut_tpu_torch.cli``'s parser and of
   its ``batch`` verb has the option strings, destination, action, type,
   choices and default of the JAX package's (help texts differ: ``--device``
   names cuda and cpu). ``resolve_effective_mode`` and ``_parse_segments``
   agree on a table of inputs, a bad ``--segments`` raising ``SystemExit``
   with the same message.
2. ``build_runtime_overrides`` gives the JAX package's map on a table of
   flag sets, ``--compat-config v2`` over a legacy YAML among them (the JAX
   side reads it with PyYAML, the port with ``config/yaml_subset.py``), with
   the same deprecation warnings. YAML outside the subset raises, naming
   the line.
3. Exit codes: a missing input gives 2; without ``--device`` and with no
   CUDA, the command and its ``batch`` verb raise and export nothing.
4. End to end on the spectral backend that ``tests/conftest.py`` pins: one
   ``--device cpu --json --validate-reconstruction`` call gives rc 0,
   ``reconstruction: OK`` and the manifest of ``separate_and_segment(...,
   device="cpu")`` on the same song, apart from timings and paths; the
   ``batch`` verb over two songs gives the cuts and segments of two single
   calls.
5. ``quick_start``: the JAX package's contract cases
   (``tests/contracts/test_quick_start_contract.py``) with ``input`` and the
   API call monkeypatched, under ``gpu_pipeline.prefer_device: cpu``; and,
   with no CUDA and the default config, it raises before the first question.
"""

import argparse
import json
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import audio_cut_tpu.cli as jax_cli  # noqa: E402
import audio_cut_tpu_torch.cli as cli  # noqa: E402
from conftest import make_song  # noqa: E402

SR = 44100
# manifest fields that hold wall times or this run's paths
TIMINGS_AND_PATHS = ("timings_ms", "artifacts", "manifest_path", "reconstruction_ok")

LEGACY_YAML = """\
audio:
  sample_rate: 44100
  channels: 1
pure_vocal_detection:
  min_pause_duration: 0.6
  peak_relative_threshold_ratio: 0.3
  f0_weight: 0.2
quality_control:
  min_split_gap: 1.5
  nms_topk_per_10s: 3
  enforce_quiet_cut:
    search_right_ms: 300
    floor_db_override: -48.5
v2_mdd:
  quality_control:
    min_split_gap: 1.4
vocal_pause_splitting:
  voice_threshold: 0.5
output:
  directory: legacy_out
"""


def _grab_parser(fn, *args):
    """The parser that ``fn`` builds inline: its ``parse_args`` is stopped."""

    class Got(Exception):
        pass

    def stop(self, *a, **k):
        raise Got(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = stop
    try:
        fn(*args)
    except Got as got:
        return got.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError(f"{fn} built no parser")


def parser_options(parser):
    """Each option of ``parser`` as (option strings, dest, action, type,
    choices, default, nargs), keyed by dest."""
    return {a.dest: (tuple(a.option_strings), a.dest, type(a).__name__, a.type,
                     a.choices, a.default, a.nargs)
            for a in parser._actions}


@pytest.mark.parametrize("verb", ["main", "batch"])
def test_parser_matches_jax(verb):
    if verb == "main":
        jax_parser, port_parser = jax_cli.build_parser(), cli.build_parser()
    else:
        jax_parser = _grab_parser(jax_cli._batch_main, [])
        port_parser = cli.build_batch_parser()
    want, got = parser_options(jax_parser), parser_options(port_parser)
    assert got == want
    assert "device" in got and ("--mode" in got["mode"][0])
    # the mode choices are the port's own KNOWN_MODES, equal to the JAX list
    from audio_cut_tpu_torch.pipeline.splitter import KNOWN_MODES

    assert list(got["mode"][4]) == list(KNOWN_MODES)
    if verb == "main":
        assert "cuda" in port_parser._option_string_actions["--device"].help


@pytest.mark.parametrize("mode, segments, align", [
    (None, None, None), ("hybrid_mdd", None, None), (None, "few", None),
    (None, None, "beat"), ("v2.2_mdd", "many", "0.5"),
])
def test_effective_mode_matches_jax(mode, segments, align):
    ns = argparse.Namespace(mode=mode, segments=segments, align=align)
    assert cli.resolve_effective_mode(ns) == jax_cli.resolve_effective_mode(ns)


@pytest.mark.parametrize("value", [None, "few", " Medium ", "many", "6-14", "6.5-14.25", "x",
                                   "lots"])
def test_parse_segments_matches_jax(value):
    def outcome(fn):
        try:
            return ("value", fn(value))
        except SystemExit as exc:
            return ("exit", str(exc))

    got, want = outcome(cli._parse_segments), outcome(jax_cli._parse_segments)
    assert got == want
    if value in ("x", "lots"):
        assert got[0] == "exit"


def _overrides(module, argv):
    args = module.build_parser().parse_args(["song.wav", *argv])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = ("map", module.build_runtime_overrides(args))
        except SystemExit as exc:
            out = ("exit", str(exc))
    return out, [(w.category, str(w.message)) for w in caught]


@pytest.mark.parametrize("argv", [
    [], ["--profile", "pop"], ["--lyrics-provider", "disabled"],
    ["--lyrics-provider", "fake", "--lyrics-fixture", "tl.json"],
    ["--sidecar-endpoint", "http://localhost:9"],
    ["--asr-chunk-s", "20", "--asr-overlap-s", "1.5", "--asr-strict"],
    ["--compat-config", "v2"],
    ["--compat-config", "v2", "--compat-config-path", "LEGACY"],
    ["--compat-config", "v2", "--compat-config-path", "LEGACY", "--profile", "edm",
     "--lyrics-provider", "null"],
], ids=["none", "profile", "disabled", "fake", "sidecar", "asr", "compat_no_path", "compat",
        "compat_and_flags"])
def test_runtime_overrides_match_jax(argv, tmp_path):
    pytest.importorskip("yaml")
    legacy = tmp_path / "legacy.yaml"
    legacy.write_text(LEGACY_YAML)
    argv = [str(legacy) if a == "LEGACY" else a for a in argv]
    (got, got_warn), (want, want_warn) = _overrides(cli, argv), _overrides(jax_cli, argv)
    assert got == want and got_warn == want_warn
    if str(legacy) in argv:
        overrides = got[1]
        # mapped keys reach the runtime map; the removed ones warn
        assert overrides["v2_mdd.pure_vocal_detection.min_pause_duration"] == 0.6
        assert any("f0_weight" in msg for _, msg in got_warn)
        assert any("voice_threshold" in msg for _, msg in got_warn)


def test_migrate_report_matches_jax():
    yaml = pytest.importorskip("yaml")
    from audio_cut_tpu.config.migrate import migrate_v2_config as jax_migrate
    from audio_cut_tpu_torch.config.migrate import migrate_v2_config
    from audio_cut_tpu_torch.config.yaml_subset import loads

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        schema, report = migrate_v2_config(loads(LEGACY_YAML))
        jax_schema, jax_report = jax_migrate(yaml.safe_load(LEGACY_YAML))
    assert report == jax_report
    assert vars(schema) == vars(jax_schema)
    assert report["removed"] == ["pure_vocal_detection.f0_weight",
                                 "vocal_pause_splitting.voice_threshold"]


def test_compat_config_outside_the_subset_raises(tmp_path):
    legacy = tmp_path / "legacy.yaml"
    legacy.write_text("audio:\n  sample_rate: 44100\nkeys:\n  - a\n")
    args = cli.build_parser().parse_args(
        ["song.wav", "--compat-config", "v2", "--compat-config-path", str(legacy)])
    with pytest.raises(ValueError, match="line 4"):
        cli.build_runtime_overrides(args)


def test_missing_input_exits_2(tmp_path, capsys):
    rc = cli.main([str(tmp_path / "missing.wav"), "-o", str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 2
    assert "input audio not found" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("verb", [[], ["batch"]], ids=["main", "batch"])
def test_no_device_without_cuda_raises(verb, tmp_path, monkeypatch):
    from audio_cut_tpu_torch.io import write_wav

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    song = tmp_path / "song.wav"
    write_wav(song, np.zeros(4410, np.float32), SR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([*verb, str(song), "-o", str(tmp_path / "out")])
    with pytest.raises(ValueError, match="'cuda', 'cuda:N' or 'cpu'"):
        cli.main([*verb, str(song), "-o", str(tmp_path / "out"), "--device", "tpu"])
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """Two short songs and their single ``separate_and_segment`` manifests on
    the CPU."""
    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.io import write_wav

    root = tmp_path_factory.mktemp("songs")
    out = []
    for name, seconds, seed in (("a", 16.0, 3), ("b", 9.0, 4)):
        path = root / f"{name}.wav"
        write_wav(path, make_song(seconds, seed=seed)[0], SR)
        m = separate_and_segment(input_uri=str(path), export_dir=str(root / f"single_{name}"),
                                 device="cpu", export_manifest=True)
        out.append((path, m))
    return out


def _comparable(manifest):
    m = {k: v for k, v in manifest.items() if k not in TIMINGS_AND_PATHS}
    m["gpu"] = {k: v for k, v in (m.get("gpu") or {}).items() if not k.endswith("_ms")}
    return json.loads(json.dumps(m))


def test_cli_end_to_end_matches_the_api(songs, tmp_path, capsys):
    path, single = songs[0]
    rc = cli.main([str(path), "-o", str(tmp_path / "out"), "--device", "cpu", "--json",
                   "--validate-reconstruction"])
    out = capsys.readouterr().out
    assert rc == 0
    head, _, body = out.partition("{")
    assert head.strip() == "reconstruction: OK"
    manifest = json.loads("{" + body)
    assert manifest["reconstruction_ok"] is True and manifest["success"] is True
    assert len(manifest["segments"]) >= 2
    assert (tmp_path / "out" / "SegmentManifest.json").is_file()
    assert _comparable(manifest) == _comparable(single)


def test_batch_verb_gives_the_single_calls_cuts(songs, tmp_path, capsys):
    paths = [str(p) for p, _ in songs]
    rc = cli.main(["batch", *paths, "-o", str(tmp_path / "out"), "--device", "cpu", "--json"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert lines[-1] == f"batch: {len(paths)}/{len(paths)} tracks succeeded"
    rows = [json.loads(line) for line in lines[:-1]]
    assert [r["input"] for r in rows] == paths and all(r["success"] for r in rows)
    for row, (_, single) in zip(rows, songs):
        with open(row["manifest"], encoding="utf-8") as fh:
            manifest = json.load(fh)
        assert manifest["gpu"]["gpu_pipeline_mode"] == "mesh_batch_precomputed"
        assert manifest["cuts"] == json.loads(json.dumps(single["cuts"]))
        assert manifest["segments"] == json.loads(json.dumps(single["segments"]))
        assert row["segments"] == single["stats"]["num_segments"]


# -- quick_start ------------------------------------------------------------


@pytest.fixture()
def cpu_config(monkeypatch):
    """``gpu_pipeline.prefer_device: cpu`` through the environment layer, in a
    fresh config manager that the test's end puts back."""
    from audio_cut_tpu_torch.config import manager

    monkeypatch.setenv("VSS__gpu_pipeline__prefer_device", "cpu")
    monkeypatch.setattr(manager, "_manager", manager.ConfigManager())


@pytest.fixture()
def song_dir(tmp_path):
    from audio_cut_tpu_torch.io import write_wav

    t = np.arange(SR * 2) / SR
    x = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    d = tmp_path / "input"
    d.mkdir()
    write_wav(d / "a.wav", x, SR)
    write_wav(d / "b.wav", x, SR)
    return tmp_path


def _run(monkeypatch, song_dir, answers, api=None):
    import audio_cut_tpu_torch.quick_start as qs

    calls = []

    def fake_api(**kwargs):
        calls.append(kwargs)
        return {"success": True, "stats": {"num_segments": 1}}

    it = iter(answers)
    monkeypatch.setattr(qs, "separate_and_segment", api or fake_api)
    monkeypatch.setattr("builtins.input", lambda *_a: next(it))
    rc = qs.run_interactive(str(song_dir / "input"), output_dir=str(song_dir / "out"))
    return rc, calls


def test_quick_start_split_answers_route_to_intent(monkeypatch, song_dir, cpu_config):
    rc, calls = _run(monkeypatch, song_dir, ["1", "split", "many", "beat_lean"])
    assert rc == 0 and len(calls) == 1
    kw = calls[0]
    assert kw["mode"] is None
    assert kw["segments"] == "many"
    assert kw["alignment"] == "beat_lean"
    assert kw["export_manifest"] is True


def test_quick_start_separate_answer_routes_to_vocal_separation(monkeypatch, song_dir, cpu_config):
    rc, calls = _run(monkeypatch, song_dir, ["2", "separate"])
    assert rc == 0 and len(calls) == 1
    assert calls[0]["mode"] == "vocal_separation"
    assert calls[0]["segments"] is None and calls[0]["alignment"] is None


def test_quick_start_batch_runs_every_file(monkeypatch, song_dir, cpu_config):
    rc, calls = _run(monkeypatch, song_dir, ["all", "split", "", ""])
    assert rc == 0 and len(calls) == 2
    assert calls[0]["segments"] == "medium"
    assert calls[0]["alignment"] == "balanced"
    assert len({kw["export_dir"] for kw in calls}) == 2


def test_quick_start_invalid_then_valid_answers(monkeypatch, song_dir, cpu_config):
    rc, calls = _run(monkeypatch, song_dir, ["9", "1", "nope", "split", "some", "few", "beat"])
    assert rc == 0 and len(calls) == 1
    assert calls[0]["segments"] == "few" and calls[0]["alignment"] == "beat"


def test_quick_start_empty_dir_exit_code(tmp_path, cpu_config):
    import audio_cut_tpu_torch.quick_start as qs

    assert qs.run_interactive(str(tmp_path / "missing")) == 2


def test_quick_start_api_failure_sets_exit_code(monkeypatch, song_dir, cpu_config):
    def boom(**kwargs):
        raise RuntimeError("backend exploded")

    rc, _ = _run(monkeypatch, song_dir, ["1", "split", "", ""], api=boom)
    assert rc == 1


def test_quick_start_without_cuda_raises_before_asking(monkeypatch, song_dir):
    # no answer is scripted: a question would raise StopIteration instead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(monkeypatch, song_dir, [])
