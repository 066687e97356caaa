"""Legacy v2 config -> schema v3 migration.

Counterpart of ``audio_cut_tpu/config/migrate.py``: maps the keys of an old
``config.yaml`` onto the 11-field schema v3 (``config/derive.SchemaV3Config``)
and warns, once per key, on the keys that schema v3 removed. The reader of
the legacy file is the caller's; the command line reads it with
``config/yaml_subset.load_file``.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Tuple

from audio_cut_tpu_torch.config.derive import SchemaV3Config

# legacy dotted key -> schema v3 field
_KEY_MAP: Dict[str, str] = {
    "audio.sample_rate": "sample_rate",
    "audio.channels": "channels",
    "pure_vocal_detection.min_pause_duration": "min_pause_s",
    "v2_mdd.pure_vocal_detection.min_pause_duration": "min_pause_s",
    "pure_vocal_detection.peak_relative_threshold_ratio": "threshold_base_ratio",
    "v2_mdd.pure_vocal_detection.peak_relative_threshold_ratio": "threshold_base_ratio",
    "quality_control.min_split_gap": "min_gap_s",
    "v2_mdd.quality_control.min_split_gap": "min_gap_s",
    "quality_control.nms_topk_per_10s": "nms_topk",
    "quality_control.enforce_quiet_cut.search_right_ms": "guard_max_shift_ms",
    "v2_mdd.quality_control.enforce_quiet_cut.search_right_ms": "guard_max_shift_ms",
    "quality_control.enforce_quiet_cut.floor_db_override": "guard_floor_db",
}

# keys that schema v3 dropped on purpose: a warning each, then ignored
_REMOVED_KEYS = (
    "pure_vocal_detection.f0_weight",
    "pure_vocal_detection.formant_weight",
    "vocal_pause_splitting.voice_threshold",
    "advanced_vad.bpm_adaptive_thresholds",
    "quality_control.validate_split_points",
)


def _flatten(prefix: str, node: Any):
    if isinstance(node, Mapping):
        for key, value in node.items():
            yield from _flatten(f"{prefix}.{key}" if prefix else str(key), value)
    else:
        yield prefix, node


def migrate_v2_config(legacy: Mapping[str, Any]) -> Tuple[SchemaV3Config, Dict[str, Any]]:
    """Returns (schema, report); report = {mapped: {legacy key: field},
    removed: [...], ignored: [the first 50, sorted]}."""
    flat = dict(_flatten("", legacy))
    fields: Dict[str, Any] = {}
    mapped: Dict[str, str] = {}
    removed = []
    ignored = []

    for dotted, value in flat.items():
        if dotted in _KEY_MAP:
            if value is not None:
                fields[_KEY_MAP[dotted]] = value
                mapped[dotted] = _KEY_MAP[dotted]
        elif any(dotted.endswith(r) for r in _REMOVED_KEYS):
            removed.append(dotted)
        else:
            ignored.append(dotted)

    for key in removed:
        warnings.warn(
            f"legacy config key {key!r} was removed in schema v3 and is ignored",
            DeprecationWarning, stacklevel=2,
        )

    schema = SchemaV3Config.from_mapping({"name": "migrated_v2", **fields})
    return schema, {"mapped": mapped, "removed": removed, "ignored": sorted(ignored)[:50]}
