"""Subprocess CLI ASR provider.

Counterpart of ``audio_cut_tpu/lyrics/cli_provider.py``: runs
``exe --input-json - --output <file> [--model-dir]`` with the JSON request on
stdin, reads the timeline JSON from the output file (or stdout), under a
timeout. A missing executable makes the provider unavailable.
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.exceptions import LyricsProviderError
from audio_cut_tpu_torch.lyrics.models import LyricsTimeline
from audio_cut_tpu_torch.lyrics.protocol import build_analyze_request, normalize_response
from audio_cut_tpu_torch.lyrics.providers import AlignRequest, LyricsProvider

logger = logging.getLogger(__name__)


class CliLyricsProvider(LyricsProvider):
    name = "cli"

    def __init__(
        self,
        executable: Optional[str] = None,
        model_dir: Optional[str] = None,
        timeout_s: Optional[float] = None,
    ):
        self.executable = executable or get_config("fire_red.cli.executable")
        self.model_dir = model_dir or get_config("fire_red.cli.model_dir")
        self.timeout_s = float(timeout_s or get_config("fire_red.cli.timeout_s", 120.0))

    def available(self) -> bool:
        return bool(self.executable) and shutil.which(str(self.executable)) is not None

    def align(self, request: AlignRequest) -> LyricsTimeline:
        if not self.available():
            raise LyricsProviderError(f"ASR CLI not available: {self.executable}")
        payload = build_analyze_request(request.audio_path, request.sample_rate, request.language)
        with tempfile.TemporaryDirectory() as td:
            out_path = Path(td) / "lyrics_timeline.json"
            cmd = [str(self.executable), "--input-json", "-", "--output", str(out_path)]
            if self.model_dir:
                cmd += ["--model-dir", str(self.model_dir)]
            try:
                proc = subprocess.run(
                    cmd,
                    input=json.dumps(payload).encode("utf-8"),
                    capture_output=True,
                    timeout=self.timeout_s,
                )
            except subprocess.TimeoutExpired as exc:
                raise LyricsProviderError(f"ASR CLI timed out after {self.timeout_s}s") from exc
            if proc.returncode != 0:
                raise LyricsProviderError(
                    f"ASR CLI exited {proc.returncode}: {proc.stderr.decode(errors='replace')[:500]}"
                )
            raw: Optional[str] = None
            if out_path.exists():
                raw = out_path.read_text(encoding="utf-8")
            elif proc.stdout.strip():
                raw = proc.stdout.decode("utf-8", errors="replace")
            if not raw:
                raise LyricsProviderError("ASR CLI produced no output")
            try:
                data = json.loads(raw)
            except json.JSONDecodeError as exc:
                raise LyricsProviderError(f"ASR CLI output is not JSON: {exc}") from exc
        timeline = normalize_response(data)
        timeline.source = self.name
        return timeline
