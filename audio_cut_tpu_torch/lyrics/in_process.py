"""In-process ASR provider slot.

Counterpart of ``audio_cut_tpu/lyrics/in_process.py``: the ``auto`` chain
probes an ``in_process`` slot between the CLI worker and the null
terminator. Configure ``fire_red.in_process.entrypoint`` as
``"package.module:callable"``; the callable gets the analyze-request payload
dict (the JSON the sidecar and CLI workers receive,
``protocol.build_analyze_request``) and returns a timeline-protocol response
dict (``protocol.normalize_response`` shapes it). Unconfigured, or a module
that does not import, is unavailable.
"""

from __future__ import annotations

import importlib
import logging
from typing import Any, Callable, Optional

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.exceptions import LyricsProviderError
from audio_cut_tpu_torch.lyrics.models import LyricsTimeline
from audio_cut_tpu_torch.lyrics.protocol import build_analyze_request, normalize_response
from audio_cut_tpu_torch.lyrics.providers import AlignRequest, LyricsProvider

logger = logging.getLogger(__name__)


def _load_entrypoint(spec: str) -> Callable[[dict], dict]:
    module_name, _, attr = str(spec).partition(":")
    if not module_name or not attr:
        raise LyricsProviderError(
            f"in_process entrypoint must be 'module:callable', got {spec!r}"
        )
    module = importlib.import_module(module_name)
    fn = module
    for part in attr.split("."):
        fn = getattr(fn, part)
    if not callable(fn):
        raise LyricsProviderError(f"in_process entrypoint {spec!r} is not callable")
    return fn  # type: ignore[return-value]


class InProcessLyricsProvider(LyricsProvider):
    name = "in_process"

    def __init__(self, entrypoint: Optional[str] = None):
        self.entrypoint = entrypoint or get_config("fire_red.in_process.entrypoint")
        self._fn: Optional[Callable[[dict], dict]] = None

    def available(self) -> bool:
        if not self.entrypoint:
            return False
        if self._fn is not None:
            return True
        try:
            self._fn = _load_entrypoint(str(self.entrypoint))
            return True
        except Exception as exc:
            logger.debug("in_process entrypoint unavailable: %s", exc)
            return False

    def align(self, request: AlignRequest) -> LyricsTimeline:
        if not self.available() or self._fn is None:
            raise LyricsProviderError(
                f"in_process provider not configured/loadable: {self.entrypoint!r}"
            )
        payload = build_analyze_request(
            request.audio_path, request.sample_rate, request.language
        )
        response: Any = self._fn(payload)
        if not isinstance(response, dict):
            raise LyricsProviderError(
                f"in_process entrypoint returned {type(response).__name__}, expected dict"
            )
        timeline = normalize_response(response)
        timeline.source = self.name
        return timeline
