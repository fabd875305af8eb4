"""Typed global settings registry.

Re-creates the behavior of the reference's `GlobalSettings`/`sprite::Map`
settings system (commons submodule; usage e.g. reference
Application/src/tracker/main.cpp:711-714 and
Application/src/tracker/core/default_config.cpp): a single typed key→value
store with

- access levels gating when a parameter may change
  (PUBLIC < LOAD < INIT < STARTUP < SYSTEM; default_config.cpp access args)
- deprecated-name auto-migration (default_config.cpp:280-360)
- change callbacks
- provenance ("who set this") tracking for layered config resolution

The parameter inventory itself lives in ``params_table.json`` (374 params:
321 tracker + grabber extras), generated by tools/extract_params.py from
the reference registries.
"""
from __future__ import annotations

import copy
import enum
import json
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

from .metaparse import format_value, parse_value


class AccessLevel(enum.IntEnum):
    PUBLIC = 0
    LOAD = 1
    INIT = 2
    STARTUP = 3
    SYSTEM = 4


@dataclass
class Parameter:
    name: str
    type: str
    default: Any
    doc: str = ""
    access: AccessLevel = AccessLevel.PUBLIC
    category: str = "tracker"


# Parameters this framework adds beyond the reference's registries
# (registered after the reference table loads).
_FRAMEWORK_PARAMS: list["Parameter"] = []


def _framework_param(*args, **kwargs):
    _FRAMEWORK_PARAMS.append(Parameter(*args, **kwargs))


_framework_param(
    "track_engine", "str", "auto",
    doc="Tracking engine: 'auto' picks the struct-of-arrays fast "
        "engine (track/engine.py) when the configuration supports it "
        "(gray bgsub, no posture, no manual overrides, speed decay 1) "
        "and falls back to the object tracker otherwise; 'object' "
        "forces the full tracker; 'fast' requires the fast engine and "
        "errors when unsupported; 'device' runs the tracking "
        "recurrence on the accelerator (track/device_engine.py) with "
        "per-frame host replay for frames needing history splits, "
        "byte-matching the fast engine.",
    access=AccessLevel.STARTUP, category="framework")

_framework_param(
    "detect_engine", "str", "host",
    doc="Background-subtraction detection engine: 'host' runs the "
        "native CPU labeler per frame; 'device' batches frames "
        "through the accelerator run-based CC (ops/runcc), sharding "
        "the batch over all available devices, with host fallback for "
        "frames that overflow the device capacity caps. 'host' is the "
        "right choice when the accelerator is remote or busy with "
        "inference; 'device' scales detection across chips.",
    access=AccessLevel.STARTUP, category="framework")

_framework_param(
    "timing_stats_file", "str", "",
    doc="When set, the convert/track pipeline's per-stage timing "
        "records (decode, detect, serialize, track) are written to "
        "this path as Chrome trace-event JSON at the end of the task "
        "(the reference's TimingStatsCollector lane chart, viewable "
        "in chrome://tracing or Perfetto).",
    access=AccessLevel.STARTUP, category="framework")

_framework_param(
    "vi_train_augment", "bool", False,
    doc="Apply the reference's training-batch augmentation (random "
        "affine + brightness/contrast jitter, "
        "visual_recognition_torch.py:1301-1337) to every VI training "
        "batch. Off by default: on the small fixture-scale crop sets "
        "this was measured to slow convergence without improving "
        "validation accuracy; enable for large real datasets where "
        "the reference's generalization behavior matters.",
    access=AccessLevel.STARTUP, category="framework")


def _coerce(param_type: str, value: Any) -> Any:
    """Coerce a parsed value to the declared parameter type."""
    t = param_type
    if value is None and t != "bool":
        return value
    if t == "bool":
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "on")
        return bool(value)
    if t == "int":
        if isinstance(value, str):
            value = parse_value(value)
        return int(value)
    if t == "float":
        if isinstance(value, str):
            value = parse_value(value)
        return float(value)
    if t in ("str", "path", "path_array") or t.startswith("enum:"):
        return value if isinstance(value, str) else format_value(value)
    if t in ("vec2", "range", "vec4", "color"):
        if isinstance(value, str):
            value = parse_value(value)
        if isinstance(value, (int, float)):
            # scalar broadcast to the type's arity
            value = [value] * (4 if t in ("vec4", "color") else 2)
        return [float(x) for x in value]
    if t in ("list", "size_filters", "tuple"):
        if isinstance(value, str):
            value = parse_value(value)
        return list(value) if value is not None else []
    if t == "dict":
        if isinstance(value, str):
            value = parse_value(value)
        return dict(value) if value is not None else {}
    return value


class Settings:
    """One settings map. Thread-safe; registered params are typed."""

    def __init__(self, table_path: Optional[str] = None):
        self._lock = threading.RLock()
        self._params: dict[str, Parameter] = {}
        self._values: dict[str, Any] = {}
        self._source: dict[str, str] = {}
        self._callbacks: list[Callable[[str, Any], None]] = []
        self._deprecations: dict[str, Optional[str]] = {}
        if table_path is None:
            table_path = str(Path(__file__).parent / "params_table.json")
        self._load_table(table_path)
        for p in _FRAMEWORK_PARAMS:
            self.register(p)

    # -- registration ------------------------------------------------
    def _load_table(self, path: str):
        with open(path) as f:
            table = json.load(f)
        for row in table["parameters"]:
            self.register(
                Parameter(
                    name=row["name"],
                    type=row["type"],
                    default=row["default"],
                    doc=row.get("doc", ""),
                    access=AccessLevel[row.get("access", "PUBLIC")],
                    category=row.get("category", "tracker"),
                )
            )
        self._deprecations = dict(table.get("deprecations", {}))

    def register(self, param: Parameter, value: Any = None):
        with self._lock:
            self._params[param.name] = param
            self._values[param.name] = copy.deepcopy(
                param.default if value is None else value
            )
            self._source.setdefault(param.name, "default")

    # -- access ------------------------------------------------------
    def has(self, name: str) -> bool:
        if name in self._params or name in self._values:
            return True
        repl = self._deprecations.get(name)  # deprecated names resolve
        return bool(repl) and repl in self._values

    def __contains__(self, name: str) -> bool:
        return self.has(name)

    # reads are lock-free: single dict lookups are atomic under the GIL
    # and the registry lock only guards compound updates (set/register).
    # The tracking hot path reads settings ~3k times per frame.
    def get(self, name: str, default: Any = None) -> Any:
        try:
            return self._values[name]
        except KeyError:
            pass
        repl = self._deprecations.get(name)
        if repl:
            return self._values.get(repl, default)
        return default

    def __getitem__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            pass
        repl = self._deprecations.get(name)
        if repl:
            return self._values[repl]
        raise KeyError(name)

    def set(self, name: str, value: Any, source: str = "code",
            max_access: AccessLevel = AccessLevel.SYSTEM):
        """Set one value; resolves deprecated names, coerces to the declared
        type, enforces access level, fires callbacks."""
        with self._lock:
            if name in self._deprecations:
                repl = self._deprecations[name]
                if not repl:
                    return  # deprecated & dropped: ignore
                name = repl
            if name in self._params:
                p = self._params[name]
                if p.access > max_access:
                    raise PermissionError(
                        f"parameter {name!r} (access {p.access.name}) cannot "
                        f"be set from a {max_access.name}-level source"
                    )
                value = _coerce(p.type, value)
            self._values[name] = value
            self._source[name] = source
            cbs = list(self._callbacks)
        for cb in cbs:
            cb(name, value)

    def __setitem__(self, name: str, value: Any):
        self.set(name, value)

    def set_from_string(self, name: str, text: str, source: str = "string",
                        max_access: AccessLevel = AccessLevel.SYSTEM):
        self.set(name, parse_value(text), source=source, max_access=max_access)

    def source_of(self, name: str) -> str:
        return self._source.get(name, "default")

    def doc(self, name: str) -> str:
        p = self._params.get(name)
        return p.doc if p else ""

    def param(self, name: str) -> Optional[Parameter]:
        return self._params.get(name)

    def names(self) -> list[str]:
        return sorted(self._params.keys())

    def on_change(self, cb: Callable[[str, Any], None]):
        self._callbacks.append(cb)

    def is_default(self, name: str) -> bool:
        p = self._params.get(name)
        if p is None:
            return False
        return self._values.get(name) == p.default

    # -- (de)serialization --------------------------------------------
    def to_dict(self, only_non_default: bool = False) -> dict[str, Any]:
        with self._lock:
            if not only_non_default:
                return dict(self._values)
            return {
                k: v for k, v in self._values.items()
                if k not in self._params or v != self._params[k].default
            }

    def format(self, name: str) -> str:
        return format_value(self[name])

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {"values": copy.deepcopy(self._values),
                    "source": dict(self._source)}

    def restore(self, snap: dict[str, Any]):
        with self._lock:
            if "values" in snap and "source" in snap:
                # full snapshot: values AND provenance replace wholesale
                # (update() kept keys added after the snapshot, and
                # stale sources made layered resolution skip pv
                # metadata on the next video)
                self._values = copy.deepcopy(snap["values"])
                self._source = dict(snap["source"])
            else:  # legacy values-only dict
                self._values.update(copy.deepcopy(snap))


_global: Optional[Settings] = None
_global_lock = threading.Lock()


def global_settings() -> Settings:
    global _global
    with _global_lock:
        if _global is None:
            _global = Settings()
        return _global


def reset_global_settings() -> Settings:
    global _global
    with _global_lock:
        _global = Settings()
        return _global


def setting(name: str) -> Any:
    """READ_SETTING equivalent."""
    return global_settings()[name]


def set_setting(name: str, value: Any, source: str = "code"):
    global_settings().set(name, value, source=source)
