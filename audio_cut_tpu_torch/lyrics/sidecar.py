"""HTTP sidecar ASR provider (stdlib urllib, JSON protocol).

Counterpart of ``audio_cut_tpu/lyrics/sidecar.py``: a GET health probe, a
POST of the protocol request, and the timeline from the normalized response.
The worker process itself is external. With no ``fire_red.endpoint`` the
provider is unavailable.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import Optional

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.exceptions import LyricsProviderError
from audio_cut_tpu_torch.lyrics.models import LyricsTimeline
from audio_cut_tpu_torch.lyrics.protocol import build_analyze_request, normalize_response
from audio_cut_tpu_torch.lyrics.providers import AlignRequest, LyricsProvider

logger = logging.getLogger(__name__)


class SidecarLyricsProvider(LyricsProvider):
    name = "sidecar"

    def __init__(
        self,
        endpoint: Optional[str] = None,
        health_path: Optional[str] = None,
        analyze_path: Optional[str] = None,
        timeout_s: float = 120.0,
    ):
        self.endpoint = (endpoint or get_config("fire_red.endpoint") or "").rstrip("/")
        self.health_path = health_path or str(get_config("fire_red.health_path", "/health"))
        self.analyze_path = analyze_path or str(get_config("fire_red.analyze_path", "/analyze"))
        self.timeout_s = timeout_s

    def available(self) -> bool:
        if not self.endpoint:
            return False
        try:
            with urllib.request.urlopen(self.endpoint + self.health_path, timeout=5.0) as resp:
                return 200 <= resp.status < 300
        except (urllib.error.URLError, OSError):
            return False

    def align(self, request: AlignRequest) -> LyricsTimeline:
        if not self.endpoint:
            raise LyricsProviderError("sidecar endpoint not configured (fire_red.endpoint)")
        payload = build_analyze_request(
            request.audio_path, request.sample_rate, request.language
        )
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            self.endpoint + self.analyze_path,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                data = json.loads(resp.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as exc:
            raise LyricsProviderError(f"sidecar analyze failed: {exc}") from exc
        timeline = normalize_response(data)
        timeline.source = self.name
        return timeline
