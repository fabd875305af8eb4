"""Defaults of the settings the port reads.

Copied from ``trex_tpu/config/params_table.json`` (the ``default``
column) for the keys that the device tracker's ``params_from_settings``
and ``_detect_kwargs``, the host ``FastTracker`` (``check_supported``,
its constructor, the prefilter and the start-frame split),
``DeviceTracker``, the posture chain (``ops/device_posture.py``,
``track/posture.py``), the per-individual archives
(``track/archive.py``, ``track/individual.py``) and the object
``Tracker`` (``track/tracker.py`` with its prefilter and history split)
read. The port's
functions take ``settings`` as any mapping (a plain ``dict`` works) and
fall back to these values.
"""
from __future__ import annotations

from collections.abc import Mapping

DEFAULTS: dict = {
    "frame_rate": 0,
    "cm_per_pixel": 0.0,
    "track_max_individuals": 1024,
    "track_max_speed": 0.0,
    "track_max_reassign_time": 0.5,
    "track_time_probability_enabled": True,
    "track_size_filter": [],
    "detect_size_filter": [],
    "match_min_probability": 0.1,
    "match_mode": "automatic",
    "track_do_history_split": True,
    "calculate_posture": True,
    "track_speed_decay": 1.0,
    "track_trusted_probability": 0.25,
    "detect_threshold": 15,
    "detect_threshold_is_absolute": True,
    "track_threshold": 0,
    "track_background_subtraction": False,
    "track_threshold_is_absolute": True,
    # host FastTracker
    "manual_matches": {},
    "manual_splits": {},
    "track_ignore": [],
    "track_include": [],
    "track_ignore_bdx": {},
    "posture_closing_steps": 0,
    "track_threshold_2": 0,
    "threshold_ratio_range": [0.5, 1.0],
    "match_topk": None,
    "track_only_categories": [],
    "track_consistent_categories": False,
    "closed_loop_enable": False,
    "tags_recognize": False,
    "tags_enable": False,
    "auto_train": False,
    "auto_apply": False,
    "auto_categorize": False,
    "auto_tags": False,
    "tracklet_punish_timedelta": True,
    "tracklet_punish_speeding": True,
    "tracklet_max_length": 0.0,
    "tags_dont_track": True,
    "blob_split_algorithm": "threshold",
    "track_posture_threshold": 0,
    "blob_split_max_shrink": 0.2,
    "blob_split_global_shrink_limit": 0.2,
    # posture (ops/device_posture.py, track/posture.py)
    "outline_resample": 1.0,
    "outline_smooth_samples": 4,
    "outline_smooth_step": 1,
    "outline_approximate": 3,
    "outline_curvature_range_ratio": 0.03,
    "midline_walk_offset": 0.025,
    "midline_stiff_percentage": 0.15,
    "midline_resolution": 25,
    "midline_invert": False,
    "midline_start_with_head": False,
    # the per-blob python posture chain and the archives
    # (track/posture.py, track/archive.py, track/individual.py)
    "peak_mode": "pointy",
    "posture_closing_size": 2,
    "posture_head_percentage": 0.1,
    "pose_midline_indexes": [],
    "outline_compression": 0.0,
    "huge_timestamp_seconds": 0.2,
}


class SettingsView(Mapping):
    """Read-only view: the caller's values over :data:`DEFAULTS`."""

    def __init__(self, settings: Mapping | None = None):
        self._s = settings if settings is not None else {}

    def __getitem__(self, key):
        try:
            return self._s[key]
        except KeyError:
            return DEFAULTS[key]

    def __iter__(self):
        return iter(DEFAULTS)

    def __len__(self):
        return len(DEFAULTS)
