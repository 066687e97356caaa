"""The PyTorch port stands alone: no jax/flax/optax/orbax/yaml/msgpack and
nothing of audio_cut_tpu in its imports, CUDA by default, and its config
defaults equal the JAX package's YAML apart from the device."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "audio_cut_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "msgpack", "audio_cut_tpu")
SHELL = ("cli", "warmup", "quick_start", "config/migrate")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN


def test_port_sources_import_nothing_forbidden():
    files = _port_files()
    assert len(files) > 20 and (REPO / "chip_smoke.py").exists()
    # the modules of hybrid_mdd are among the files scanned
    assert {PORT / "analysis/beat_analyzer.py", PORT / "pipeline/strategies.py",
            PORT / "pipeline/modes/hybrid.py"} <= set(files)
    # and so are the lyrics providers of vpbd_asr
    assert {PORT / f"lyrics/{m}.py" for m in ("protocol", "providers", "sidecar",
                                               "cli_provider", "in_process")} <= set(files)
    # and the legacy detector's YIN/LPC analysis
    assert PORT / "ops/voice.py" in files
    # and the WaveUNet tier with its trainer
    assert {PORT / "models/waveunet.py", PORT / "training/wave_trainer.py"} <= set(files)
    # and the shell
    assert {PORT / f"{m}.py" for m in SHELL} <= set(files)
    bad = [(p.relative_to(REPO).as_posix(), m) for p in files for m in _imported_roots(p)
           if _forbidden(m)]
    assert bad == []


def test_import_leaves_forbidden_modules_unloaded():
    code = (
        "import sys, pkgutil, importlib, audio_cut_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(audio_cut_tpu_torch.__path__, "
        "'audio_cut_tpu_torch.')]\n"
        "assert 'audio_cut_tpu_torch.ops.voice' in names\n"
        "assert {'audio_cut_tpu_torch.models.waveunet', "
        "'audio_cut_tpu_torch.training.wave_trainer'} <= set(names)\n"
        f"assert {set('audio_cut_tpu_torch.' + m.replace('/', '.') for m in SHELL)!r} "
        "<= set(names)\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("verb", [[], ["warmup"]], ids=["cli", "warmup"])
def test_shell_help_runs_without_input(verb):
    out = subprocess.run([sys.executable, "-m", "audio_cut_tpu_torch.cli", *verb, "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: python -m audio_cut_tpu_torch.cli")
    assert ("--durations" if verb else "--compat-config") in out.stdout


def test_entry_point_raises_without_cuda_unless_cpu(tmp_path, monkeypatch):
    import numpy as np
    import torch

    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.io import write_wav

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    song = tmp_path / "song.wav"
    write_wav(song, np.zeros(4410, np.float32), 44100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        separate_and_segment(input_uri=str(song), export_dir=str(tmp_path / "out"),
                             mode="vocal_separation")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        separate_and_segment(input_uri=str(song), export_dir=str(tmp_path / "out"),
                             mode="vocal_separation", device="cuda")
    # the batch entry point and its mesh likewise
    from audio_cut_tpu_torch.api import separate_and_segment_batch
    from audio_cut_tpu_torch.parallel.mesh import make_mesh

    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            separate_and_segment_batch(input_uris=[str(song)], export_dir=str(tmp_path / "out"),
                                       mode="vocal_separation", device=device)
    for devices in (None, "cuda", ["cpu", "cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(devices)
    assert make_mesh("cpu").devices == (torch.device("cpu"),)
    with pytest.raises(NotImplementedError, match="Scale-out and shell"):
        make_mesh(["cpu", "cpu"], dp=1, sp=2)
    assert not (tmp_path / "out").exists()


def test_trainer_entry_point_raises_without_cuda_unless_cpu(monkeypatch):
    import torch

    from audio_cut_tpu_torch.training.train_separator import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--small", "--synthetic", "--steps", "1", *argv])


@pytest.mark.parametrize("argv, item", [
    # --family waveunet is in the port; an orbax checkpoint directory is not
    (["--family", "waveunet", "--small", "--synthetic", "--checkpoint", "orbax_dir"],
     "Other separator tiers"),
    (["--large", "--rich"], "queue 1, 'Training'"),
])
def test_trainer_options_outside_the_slice_raise(argv, item, tmp_path, monkeypatch):
    from audio_cut_tpu_torch.training.train_separator import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        main([*argv, "--steps", "1", "--device", "cpu"])
    assert not (tmp_path / "orbax_dir").exists()


def test_sharded_training_raises():
    from audio_cut_tpu_torch.models.convtdf import ConvTDFSeparator
    from audio_cut_tpu_torch.training.trainer import TrainConfig, Trainer, make_loss_fn

    sep = ConvTDFSeparator(44100, n_fft=512, hop=128, dim_f=128, dim_t=8, channels=8, depth=1,
                           tdf_bottleneck=8)
    with pytest.raises(NotImplementedError, match="Scale-out and shell"):
        Trainer(sep, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Scale-out and shell"):
        make_loss_fn(sep, TrainConfig(), mesh=object())


@pytest.mark.parametrize("backend", ["waveunet", "onnx"])
def test_backends_outside_the_slice_raise(backend, tmp_path, monkeypatch):
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.separation.backends import make_backend

    # both tiers are in the port; an orbax checkpoint directory is not, and
    # the onnx tier without a model file raises (no fallback)
    exc, match = {"waveunet": (NotImplementedError, "other separator tiers"),
                  "onnx": (FileNotFoundError, "no ONNX separation model found")}[backend]
    monkeypatch.delenv("AUDIO_CUT_ONNX_MODEL", raising=False)
    monkeypatch.chdir(tmp_path)
    set_runtime_config({"enhanced_separation.waveunet.checkpoint": str(tmp_path)})
    try:
        with pytest.raises(exc, match=match):
            make_backend(backend, 44100, "cpu")
    finally:
        reset_runtime_config()


def test_config_defaults_are_the_jax_yaml_but_for_the_device():
    yaml = pytest.importorskip("yaml")
    from audio_cut_tpu.config.manager import deep_merge

    merged = {}
    for name in ("expert.yaml", "unified.yaml"):
        deep_merge(merged, yaml.safe_load((REPO / "audio_cut_tpu" / "config" / name).read_text()))
    port = json.loads((PORT / "config" / "defaults.json").read_text())
    assert port["gpu_pipeline"].pop("prefer_device") == "cuda"
    assert merged["gpu_pipeline"].pop("prefer_device") == "tpu"
    assert port == merged


@pytest.mark.parametrize("raw", ["true", "off", "NO", "null", "~", "", "12", "-3", "1_000",
                                 "1.5", ".5", "1.", "1e3", "1.0e+3", "spectral", "[1, 2]",
                                 '{"a": 1}'])
def test_env_values_parse_as_yaml_scalars(raw):
    yaml = pytest.importorskip("yaml")
    from audio_cut_tpu_torch.config.manager import _coerce_env_value

    got, want = _coerce_env_value(raw), yaml.safe_load(raw)
    assert got == want and type(got) is type(want)
