"""Lyrics/ASR providers.

Counterpart of ``audio_cut_tpu/lyrics/providers.py``: the abstract
``LyricsProvider.align(request) -> LyricsTimeline``; ``NullLyricsProvider``
(strict raises ``LyricsAlignmentUnavailable``); ``FakeLyricsProvider`` (a
JSON fixture); and ``build_lyrics_provider``, whose ``auto`` chain walks
``fire_red.provider_order`` (sidecar -> cli -> in_process -> null, then
fake) and takes the first available provider. A ``null`` entry ends the
chain before ``fake`` is tried.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.exceptions import LyricsAlignmentUnavailable, LyricsProviderError
from audio_cut_tpu_torch.lyrics.models import LyricsTimeline

logger = logging.getLogger(__name__)


@dataclass
class AlignRequest:
    audio_path: str                 # 16 kHz mono detection copy on disk
    sample_rate: int = 16000
    language: Optional[str] = None
    duration_s: Optional[float] = None
    meta: Dict[str, Any] = field(default_factory=dict)


class LyricsProvider:
    name = "abstract"

    def available(self) -> bool:
        return True

    def align(self, request: AlignRequest) -> LyricsTimeline:
        raise NotImplementedError


class NullLyricsProvider(LyricsProvider):
    name = "null"

    def __init__(self, strict: bool = False):
        self.strict = strict

    def align(self, request: AlignRequest) -> LyricsTimeline:
        if self.strict:
            raise LyricsAlignmentUnavailable("no lyrics provider available (strict mode)")
        return LyricsTimeline()


class FakeLyricsProvider(LyricsProvider):
    """Deterministic fixture-backed provider for tests/offline runs."""

    name = "fake"

    def __init__(self, fixture_path: Optional[str] = None):
        self.fixture_path = fixture_path or get_config("lyrics_alignment.fixture_path")

    def available(self) -> bool:
        return bool(self.fixture_path) and Path(str(self.fixture_path)).exists()

    def align(self, request: AlignRequest) -> LyricsTimeline:
        if not self.available():
            raise LyricsProviderError(f"fake fixture not found: {self.fixture_path}")
        data = json.loads(Path(str(self.fixture_path)).read_text(encoding="utf-8"))
        timeline = LyricsTimeline.from_dict(data, strict=False)
        timeline.source = self.name
        return timeline


def build_lyrics_provider(
    provider: Optional[str] = None,
    strict: Optional[bool] = None,
) -> LyricsProvider:
    """Resolve the configured provider with the auto fallback chain."""
    name = (provider or get_config("lyrics_alignment.provider", "disabled") or "disabled").lower()
    if strict is None:
        strict = bool(get_config("lyrics_alignment.strict", False))

    if name in ("disabled", "off", "none"):
        return NullLyricsProvider(strict=False)
    if name == "null":
        return NullLyricsProvider(strict=strict)
    if name == "fake":
        return FakeLyricsProvider()
    if name == "sidecar":
        from audio_cut_tpu_torch.lyrics.sidecar import SidecarLyricsProvider

        return SidecarLyricsProvider()
    if name == "cli":
        from audio_cut_tpu_torch.lyrics.cli_provider import CliLyricsProvider

        return CliLyricsProvider()
    if name == "in_process":
        from audio_cut_tpu_torch.lyrics.in_process import InProcessLyricsProvider

        return InProcessLyricsProvider()
    if name == "auto":
        order = get_config(
            "fire_red.provider_order", ["sidecar", "cli", "in_process", "null"]
        ) or []
        for entry in [*order, "fake"]:
            entry = str(entry).lower()
            if entry in ("null", "none"):
                # a "null" entry ends the chain
                break
            try:
                candidate = build_lyrics_provider(entry, strict=strict)
            except Exception:
                continue
            if candidate.available():
                logger.info("lyrics provider auto-selected: %s", candidate.name)
                return candidate
        return NullLyricsProvider(strict=strict)
    raise LyricsProviderError(f"unknown lyrics provider {name!r}")
