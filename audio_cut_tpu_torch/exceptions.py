"""Exception hierarchy (parity: reference src/audio_cut/exceptions.py:9-26)."""


class AudioCutError(Exception):
    """Base class for all audio_cut_tpu_torch errors."""


class LyricsAlignmentUnavailable(AudioCutError):
    """Raised when strict lyrics alignment is requested but no provider works."""


class LyricsProviderError(AudioCutError):
    """A lyrics/ASR provider failed while producing a timeline."""


class TimelineValidationError(AudioCutError):
    """A lyrics timeline violated its structural invariants."""


class GlobalCutPlanningError(AudioCutError):
    """The global DP cut planner could not produce a feasible plan."""


class SeparationBackendError(AudioCutError):
    """A separation backend failed to load or run."""


class AudioIOError(AudioCutError):
    """Audio decode/encode failure."""
