"""The port's kernel build (``audio_cut_tpu_torch/ops/cuda.py:build_library``)
is atomic: nvcc writes a name of its own process and thread, which is renamed
onto the library only when the build succeeds.

These tests need no nvcc and no card. A stand-in compiler (a Python script)
takes nvcc's place through ``_nvcc_command``: it writes its output file in
pieces with a pause between them, so that a build that wrote the library in
place would leave a half-written file for a while. ``BUILD_DIR`` points at
the test's own directory.
"""

import sys
import threading
import time

import pytest

from audio_cut_tpu_torch.ops import cuda

PIECES = 4
PIECE = b"0123456789abcdef" * 64  # 1 KiB
WHOLE = PIECE * PIECES

STAND_IN = """
import sys, time
out, status = sys.argv[1], int(sys.argv[2])
with open(out, "wb") as f:
    for _ in range({pieces}):
        f.write({piece!r})
        f.flush()
        time.sleep(0.05)
sys.exit(status)
""".format(pieces=PIECES, piece=PIECE)


@pytest.fixture()
def stand_in(tmp_path, monkeypatch):
    """Point the build at ``tmp_path/_build`` and nvcc at the stand-in;
    returns (library path, set of output paths the stand-in was given, a
    function that sets its exit status)."""
    script = tmp_path / "stand_in_nvcc.py"
    script.write_text(STAND_IN)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(cuda, "BUILD_DIR", build_dir)
    status = {"rc": 0}
    outputs = set()

    def command(source, target):
        outputs.add(target)
        return [sys.executable, str(script), str(target), str(status["rc"])]

    monkeypatch.setattr(cuda, "_nvcc_command", command)
    target = cuda._library_path(cuda.CSRC / "probe.cu")
    assert target.parent == build_dir

    def set_status(rc):
        status["rc"] = rc

    return target, outputs, set_status


def _leftovers(directory):
    return sorted(p.name for p in directory.glob("*.tmp*"))


def test_concurrent_builds_of_one_source_leave_one_whole_library(stand_in, monkeypatch):
    target, outputs, _ = stand_in
    start = threading.Barrier(3)
    results, errors, seen = [], [], []
    done = threading.Event()
    # neither build starts its compiler before both have found no library
    both_missed = threading.Barrier(2, timeout=30)
    stand_in_command = cuda._nvcc_command

    def after_both_missed(source, tmp):
        both_missed.wait()
        return stand_in_command(source, tmp)

    monkeypatch.setattr(cuda, "_nvcc_command", after_both_missed)

    def build():
        start.wait()
        try:
            results.append(cuda.build_library("probe"))
        except Exception as exc:  # reported below
            errors.append(exc)

    def watch():
        # whenever the library exists, it is the whole file
        start.wait()
        while not done.is_set():
            if target.exists():
                seen.append(target.read_bytes())
            time.sleep(0.005)

    threads = [threading.Thread(target=build) for _ in range(2)] + [threading.Thread(target=watch)]
    for th in threads:
        th.start()
    for th in threads[:2]:
        th.join(timeout=60)
    done.set()
    threads[2].join(timeout=60)

    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(results) == 2 and all(sec > 0.0 for sec in results)
    assert len(outputs) == 2 and target not in outputs  # each build wrote a name of its own
    assert target.read_bytes() == WHOLE
    assert all(content == WHOLE for content in seen)
    assert _leftovers(target.parent) == []
    assert sorted(p.name for p in target.parent.iterdir()) == [target.name]
    # built once, the library is not built again
    assert cuda.build_library("probe") == 0.0


def test_failed_build_raises_and_leaves_no_temporary_file(stand_in):
    target, outputs, set_status = stand_in
    set_status(1)
    with pytest.raises(RuntimeError, match="probe.cu: nvcc exit 1"):
        cuda.build_library("probe")
    assert len(outputs) == 1  # the stand-in wrote a whole temporary file, then failed
    assert not target.exists()
    assert _leftovers(target.parent) == []


def test_failed_build_leaves_a_library_another_process_finished(stand_in, monkeypatch):
    """Another process finishes the library while this build runs and fails:
    the failure removes only its own temporary file."""
    target, _, set_status = stand_in
    set_status(1)
    stand_in_command = cuda._nvcc_command
    other = b"built by another process"

    def finished_meanwhile(source, tmp):
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(other)
        return stand_in_command(source, tmp)

    monkeypatch.setattr(cuda, "_nvcc_command", finished_meanwhile)
    with pytest.raises(RuntimeError, match="nvcc exit 1"):
        cuda.build_library("probe")
    assert target.read_bytes() == other
    assert _leftovers(target.parent) == []
