"""Host I/O and config of the PyTorch port against the JAX package.

1. The ffmpeg seam. A stub ``ffmpeg``/``ffprobe`` (a Python script this test
   writes into ``tmp_path`` and puts first on PATH; no ffmpeg is installed)
   logs its arguments; ``ffprobe`` reports 22.05 kHz stereo, ``ffmpeg``
   "decodes" a file of raw float32 samples by copying it and "encodes" by
   copying its input WAV. Both packages decode the same ``.mp3`` to the same
   array (mono and resampled, or not), issue the same commands, and write
   the same PCM_16 temporary WAV for mp3 export. With no ffmpeg on PATH both
   raise the same ``AudioIOError``. The splitter's ``output.format: mp3``
   reaches the export. Bound: none.
2. The YAML reader (``config/yaml_subset.py``) equals ``yaml.safe_load`` on
   the JAX package's config files and on scalars at the edges of YAML 1.1's
   rules, and raises, naming the line, on an anchor, a block scalar and a tag.
3. The config layers: a file named by ``$AUDIO_CUT_TPU_CONFIG`` (or
   ``$VSS_EXTERNAL_CONFIG_PATH``) and one passed to ``ConfigManager`` give
   both packages the same config, ``VSS__`` variables still override the
   file, and a missing file or a root that is not a mapping raise alike.
"""

import json
import math
import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest

yaml = pytest.importorskip("yaml")
pytest.importorskip("jax")

REPO = Path(__file__).resolve().parents[1]
CONFIG_FILES = sorted((REPO / "audio_cut_tpu" / "config").glob("*.yaml")) + sorted(
    (REPO / "audio_cut_tpu" / "config" / "profiles").glob("*.yaml"))

STUB = """#!{python}
import json, os, shutil, sys
name, args = os.path.basename(sys.argv[0]), sys.argv[1:]
with open(os.environ["STUB_FFMPEG_LOG"], "a") as fh:
    fh.write(json.dumps([name] + args) + "\\n")
if name == "ffprobe":
    print(json.dumps({{"streams": [{{"sample_rate": "22050", "channels": 2}}]}}))
elif "-f" in args:  # decode: the "compressed" file holds raw float32 samples
    with open(args[args.index("-i") + 1], "rb") as fh:
        sys.stdout.buffer.write(fh.read())
else:  # encode: the output is the input WAV
    shutil.copyfile(args[args.index("-i") + 1], args[-1])
"""


@pytest.fixture
def stub_ffmpeg(tmp_path, monkeypatch):
    """The stub's directory first on PATH; returns the log reader."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("ffmpeg", "ffprobe"):
        exe = bin_dir / name
        exe.write_text(STUB.format(python=sys.executable))
        exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setenv("STUB_FFMPEG_LOG", str(log))

    def calls():
        lines = log.read_text().splitlines() if log.exists() else []
        log.unlink(missing_ok=True)
        return [json.loads(line) for line in lines]

    return calls


@pytest.mark.parametrize("mono, target_sr", [(True, 44100), (False, None)])
def test_mp3_decodes_alike(stub_ffmpeg, tmp_path, mono, target_sr):
    from audio_cut_tpu.io.audio import load_audio as jax_load
    from audio_cut_tpu_torch.io.audio import load_audio as torch_load

    frames = np.random.default_rng(3).uniform(-0.5, 0.5, (22050, 2)).astype("<f4")
    src = tmp_path / "song.mp3"
    src.write_bytes(frames.tobytes())
    xj, srj = jax_load(src, target_sr=target_sr, mono=mono)
    calls_j = stub_ffmpeg()
    xt, srt = torch_load(src, target_sr=target_sr, mono=mono)
    calls_t = stub_ffmpeg()
    assert srt == srj == (target_sr or 22050)
    assert xt.dtype == xj.dtype == np.float32
    np.testing.assert_array_equal(xt, xj)
    if not mono:
        np.testing.assert_array_equal(xt, frames)
    assert calls_t == calls_j and [c[0] for c in calls_t] == ["ffprobe", "ffmpeg"]


def test_mp3_export_issues_the_same_command(stub_ffmpeg, tmp_path):
    from audio_cut_tpu.io.export import export_audio as jax_export
    from audio_cut_tpu_torch.io.export import export_audio as torch_export

    audio = np.random.default_rng(4).uniform(-0.9, 0.9, 4410).astype(np.float32)
    out = {}
    for side, export in (("jax", jax_export), ("torch", torch_export)):
        written = export(tmp_path / side / "seg_1.5", audio, 44100, "mp3")
        assert written == str(tmp_path / side / "seg_1.5.mp3")
        (call,) = stub_ffmpeg()
        tmp_wav = call[call.index("-i") + 1]
        out[side] = ([a.replace(tmp_wav, "<tmp>").replace(str(tmp_path / side), "<out>")
                      for a in call], Path(written).read_bytes())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ["ffmpeg", "-y", "-loglevel", "error", "-i", "<tmp>", "-b:a", "320k",
                               "<out>/seg_1.5.mp3"]


@pytest.mark.parametrize("case", ["decode", "export", "unknown"])
def test_without_ffmpeg_both_raise_alike(tmp_path, monkeypatch, case):
    from audio_cut_tpu.exceptions import AudioIOError as JaxError
    from audio_cut_tpu.io.audio import load_audio as jax_load
    from audio_cut_tpu.io.export import export_audio as jax_export
    from audio_cut_tpu_torch.exceptions import AudioIOError as TorchError
    from audio_cut_tpu_torch.io.audio import load_audio as torch_load
    from audio_cut_tpu_torch.io.export import export_audio as torch_export

    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    src = tmp_path / ("song.flac" if case != "unknown" else "song.xyz")
    src.write_bytes(b"\0" * 16)
    audio = np.zeros(100, np.float32)
    calls = {
        "decode": (lambda: jax_load(src), lambda: torch_load(src)),
        "unknown": (lambda: jax_load(src), lambda: torch_load(src)),
        "export": (lambda: jax_export(tmp_path / "a", audio, 44100, "mp3"),
                   lambda: torch_export(tmp_path / "b", audio, 44100, "mp3")),
    }[case]
    with pytest.raises(JaxError) as ej:
        calls[0]()
    with pytest.raises(TorchError) as et:
        calls[1]()
    assert str(et.value) == str(ej.value)
    assert "ffmpeg" in str(et.value)


def test_output_format_mp3_reaches_the_export(stub_ffmpeg, tmp_path):
    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.io import write_wav

    t = np.arange(8 * 44100) / 44100.0
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.5 * t) > -0.5)).astype(
        np.float32)
    write_wav(tmp_path / "song.wav", audio, 44100, subtype="FLOAT")
    m = separate_and_segment(input_uri=str(tmp_path / "song.wav"), export_dir=str(tmp_path / "out"),
                             mode="librosa_onset", device="cpu",
                             runtime_overrides={"output.format": "mp3",
                                                "librosa_onset.use_vocal_separation": False})
    assert m["success"]
    calls = stub_ffmpeg()
    paths = [s["mix_path"] for s in m["segments"]]
    assert paths and all(p.endswith(".mp3") for p in paths)
    assert sorted(Path(c[-1]).name for c in calls) == sorted(Path(p).name for p in paths)
    assert all(c[c.index("-b:a") + 1] == "320k" for c in calls)


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.name)
def test_yaml_subset_reads_the_config_files_as_pyyaml(path):
    from audio_cut_tpu_torch.config import yaml_subset

    assert yaml_subset.load_file(path) == yaml.safe_load(path.read_text(encoding="utf-8"))


@pytest.mark.parametrize("raw", ["yEs", "Off", "0x1F", "017", "0b11", "1:30", "1:30.5", "-.5",
                                 ".inf", "-.Inf", ".NaN", "1_0.5", "+1", "'it''s'",
                                 '"a\\tb\\u00e9"', "{a: [1, {b: c}], d: }", "[a, b, ]", "x #c",
                                 "a:b", "http://h:1/p"])
def test_yaml_subset_scalars_and_flows_as_pyyaml(raw):
    from audio_cut_tpu_torch.config import yaml_subset

    got, want = yaml_subset.loads(raw), yaml.safe_load(raw)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text, what", [
    ("a: 1\nb: &x 2\n", "an anchor"),
    ("a: 1\nb: |\n  text\n", "a block scalar"),
    ("a: 1\nb: !!str 2\n", "a tag"),
])
def test_yaml_subset_raises_outside_the_subset(text, what):
    from audio_cut_tpu_torch.config import yaml_subset

    with pytest.raises(ValueError, match=f"line 2: {what}"):
        yaml_subset.loads(text)


SITE = """# a site config
device_pipeline:
  piece_windows: 3     # wider pieces
  max_pieces: 4
vad:
  threshold: 0.35
output:
  format: 'mp3'
  naming: {pattern: "seg_{index:03d}"}
"""


def _configs(*args):
    """Both packages' whole config from fresh managers; the device key,
    the one packaged difference, popped."""
    from audio_cut_tpu.config.manager import ConfigManager as JaxManager
    from audio_cut_tpu_torch.config.manager import ConfigManager as TorchManager

    cj, ct = JaxManager(*args).config, TorchManager(*args).config
    assert ct["gpu_pipeline"].pop("prefer_device") == "cuda"
    assert cj["gpu_pipeline"].pop("prefer_device") == "tpu"
    return cj, ct


@pytest.mark.parametrize("var", ["AUDIO_CUT_TPU_CONFIG", "VSS_EXTERNAL_CONFIG_PATH"])
def test_config_file_layer_as_in_jax(tmp_path, monkeypatch, var):
    site = tmp_path / "site.yaml"
    site.write_text(SITE)
    for name in ("AUDIO_CUT_TPU_CONFIG", "VSS_EXTERNAL_CONFIG_PATH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(var, str(site))
    cj, ct = _configs()
    assert ct == cj
    assert ct["device_pipeline"]["piece_windows"] == 3 and ct["vad"]["threshold"] == 0.35
    # deep-merged: the defaults stay under the file's keys
    assert ct["output"]["naming"]["pattern"] == "seg_{index:03d}"
    assert ct["output"]["naming"]["include_duration"] is True
    assert ct["device_pipeline"]["pipelined_upload"] is True
    # an explicit file over the environment's, and VSS__ over both
    explicit = tmp_path / "explicit.yaml"
    explicit.write_text("device_pipeline:\n  max_pieces: 6\n")
    monkeypatch.setenv("VSS__device_pipeline__piece_windows", "5")
    cj, ct = _configs(str(explicit))
    assert ct == cj
    assert (ct["device_pipeline"]["piece_windows"], ct["device_pipeline"]["max_pieces"]) == (5, 6)


@pytest.mark.parametrize("text, error", [(None, FileNotFoundError), ("[1, 2]\n", ValueError)],
                         ids=["missing", "not_a_mapping"])
def test_config_file_errors_as_in_jax(tmp_path, monkeypatch, text, error):
    from audio_cut_tpu.config.manager import ConfigManager as JaxManager
    from audio_cut_tpu_torch.config.manager import ConfigManager as TorchManager

    path = tmp_path / "site.yaml"
    if text is not None:
        path.write_text(text)
    monkeypatch.setenv("AUDIO_CUT_TPU_CONFIG", str(path))
    with pytest.raises(error) as ej:
        JaxManager()
    with pytest.raises(error) as et:
        TorchManager()
    assert str(et.value) == str(ej.value)
