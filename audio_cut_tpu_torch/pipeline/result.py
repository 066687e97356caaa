"""Precision-guard thresholds (counterpart of ``audio_cut_tpu/pipeline/result.py``:
avg shift <= 150 ms and p95 <= 220 ms). The ``ResultBuilder`` of the
cutting modes comes with them (ROADMAP.md, queue 1)."""

PRECISION_GUARD_AVG_MS = 150.0
PRECISION_GUARD_P95_MS = 220.0
