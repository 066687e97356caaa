"""Lyrics timelines, providers, candidates and the segment attach
(counterpart of ``audio_cut_tpu/lyrics``)."""

from audio_cut_tpu_torch.lyrics.models import LyricsTimeline, Sentence, VadRegion, Word
from audio_cut_tpu_torch.lyrics.providers import (
    FakeLyricsProvider,
    LyricsProvider,
    NullLyricsProvider,
    build_lyrics_provider,
)

__all__ = [
    "Word",
    "Sentence",
    "VadRegion",
    "LyricsTimeline",
    "LyricsProvider",
    "NullLyricsProvider",
    "FakeLyricsProvider",
    "build_lyrics_provider",
]
