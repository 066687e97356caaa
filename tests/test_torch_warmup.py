"""The port's ``warmup`` verb against the JAX package's, on the CPU.

1. Its parser has the options, destinations, types and defaults of the JAX
   package's ``warmup_main`` (help texts differ), and its synthetic track
   and fake timeline equal the JAX package's.
2. ``cli.main(["warmup", ...])`` under ``gpu_pipeline.prefer_device: cpu``
   (``VSS__gpu_pipeline__prefer_device``): rc 0, the JAX report's shape
   (``{"steps": [{name, ok, wall_s}], "total_s"}``), the JAX package's step
   names and no build step; with the extra modes, ``vocal_separation`` and
   ``vpbd_asr`` with the fake provider on the longest duration.
3. On CUDA, the build steps: one a ``csrc/*.cu`` library with its build
   seconds, then the kernel library check, through stand-ins of
   ``build_library`` and ``check_kernel_library`` (no nvcc here); with no
   CUDA and the default config, warmup raises before it builds anything.
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import audio_cut_tpu.warmup as jax_warmup  # noqa: E402
import audio_cut_tpu_torch.warmup as warmup  # noqa: E402
from test_torch_cli import _grab_parser, cpu_config, parser_options  # noqa: E402,F401


def test_parser_matches_jax():
    want = parser_options(_grab_parser(jax_warmup.warmup_main, []))
    assert parser_options(warmup.build_parser()) == want
    assert want["durations"][5] == "15,75,120,180,240"


@pytest.mark.parametrize("seconds", [3.0, 7.5])
def test_synthetic_inputs_match_jax(seconds):
    assert np.array_equal(warmup._synth_song(seconds), jax_warmup._synth_song(seconds))
    assert warmup._fake_timeline(seconds) == jax_warmup._fake_timeline(seconds)


@pytest.mark.parametrize("argv, names", [
    (["--durations", "8", "--skip-extra-modes"], ["v2.2_mdd_8s"]),
    (["--durations", "6,3"], ["v2.2_mdd_3s", "v2.2_mdd_6s", "vocal_separation", "vpbd_asr"]),
], ids=["default_mode", "extra_modes"])
def test_warmup_on_cpu(argv, names, cpu_config, monkeypatch, capsys):
    from audio_cut_tpu_torch import cli
    from audio_cut_tpu_torch.config import get_config
    from audio_cut_tpu_torch.ops import cuda

    def no_build(*_a):
        raise AssertionError("a build on the CPU")

    monkeypatch.setattr(cuda, "build_library", no_build)
    rc = cli.main(["warmup", *argv, "--json"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert set(report) == {"steps", "total_s"} and isinstance(report["total_s"], float)
    assert [s["name"] for s in report["steps"]] == names
    for step in report["steps"]:
        assert set(step) == {"name", "ok", "wall_s"} and step["ok"] is True
    # the fake provider's overrides are gone after the run
    assert get_config("lyrics_alignment.provider") != "fake"


def test_build_steps_on_cuda(monkeypatch):
    from audio_cut_tpu_torch.ops import cuda

    built, checked = [], []
    monkeypatch.setattr(cuda, "build_library", lambda name: built.append(name) or
                        (0.0 if name == "probe" else 1.25))
    monkeypatch.setattr(cuda, "check_kernel_library", checked.append)
    dev = torch.device("cuda", 0)
    steps = warmup.build_kernel_steps(dev)
    sources = sorted(p.stem for p in cuda.CSRC.glob("*.cu"))
    assert sorted(built) == sources and {"probe", "ola", "frame_stats"} <= set(sources)
    assert [s["name"] for s in steps] == [f"build_{n}.cu" for n in sources] + ["kernel_library_check"]
    assert [s["wall_s"] for s in steps[:-1]] == [0.0 if n == "probe" else 1.25 for n in sources]
    assert all(s["ok"] for s in steps) and checked == [dev]


def test_warmup_without_cuda_raises(monkeypatch):
    from audio_cut_tpu_torch import cli
    from audio_cut_tpu_torch.ops import cuda

    def no_build(*_a):
        raise AssertionError("a build before the device check")

    monkeypatch.setattr(cuda, "build_library", no_build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["warmup", "--durations", "3", "--json"])
