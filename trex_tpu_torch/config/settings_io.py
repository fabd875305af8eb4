"""`.settings` file parsing + layered config resolution.

Mirrors the reference's SettingsInitializer semantics
(Application/src/tracker/core/SettingsInitializer.cpp, usage
main.cpp:326-376): values are resolved in layers, later layers win:

    compiled defaults -> pv metadata JSON -> .settings file(s) -> command line

Each layer records provenance so "who set this" can be reported.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Optional

from .metaparse import format_value, parse_value
from .registry import AccessLevel, Settings

_LINE = re.compile(r"^\s*([A-Za-z_][\w]*)\s*=\s*(.*?)\s*$")


def parse_settings_text(text: str) -> dict[str, Any]:
    """Parse the `name = value` settings text format."""
    out: dict[str, Any] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        out[m.group(1)] = parse_value(m.group(2))
    return out


def load_settings_file(settings: Settings, path: str | Path,
                       source: Optional[str] = None,
                       max_access: AccessLevel = AccessLevel.STARTUP) -> dict[str, Any]:
    path = Path(path)
    values = parse_settings_text(path.read_text())
    applied = {}
    for name, value in values.items():
        try:
            if name not in settings and name not in \
                    settings._deprecations:
                import sys

                print(f"[settings] unknown parameter {name!r} in "
                      f"{path} (typo?)", file=sys.stderr)
            settings.set(name, value, source=source or str(path), max_access=max_access)
            applied[name] = value
        except PermissionError as e:
            import sys

            print(f"[settings] {name!r} not applied from {path}: {e}",
                  file=sys.stderr)
        except (ValueError, TypeError, KeyError) as e:
            # one bad line must not abort the load mid-file (the
            # reference SettingsInitializer warns and continues)
            import sys

            print(f"[settings] cannot apply {name!r} from {path}: {e}",
                  file=sys.stderr)
    return applied


def settings_to_text(settings: Settings,
                     only_non_default: bool = True,
                     exclude_access: AccessLevel = AccessLevel.SYSTEM) -> str:
    lines = []
    for name in settings.names():
        p = settings.param(name)
        if p and p.access >= exclude_access:
            continue
        if only_non_default and settings.is_default(name):
            continue
        value = settings[name]
        if p and p.type.startswith("enum:") and isinstance(value, str):
            # the reference writes enum values bare (e.g. `meta_encoding = gray`)
            lines.append(f"{name} = {value}")
        else:
            lines.append(f"{name} = {format_value(value)}")
    return "\n".join(lines) + "\n"


def write_settings_file(settings: Settings, path: str | Path,
                        only_non_default: bool = True,
                        exclude_access: AccessLevel = AccessLevel.SYSTEM):
    Path(path).write_text(
        settings_to_text(settings, only_non_default, exclude_access))


def apply_dict(settings: Settings, values: dict[str, Any], source: str,
               max_access: AccessLevel = AccessLevel.STARTUP) -> dict[str, Any]:
    applied = {}
    for name, value in values.items():
        try:
            settings.set(name, value, source=source, max_access=max_access)
            applied[name] = value
        except PermissionError as e:
            import sys

            print(f"[settings] {name!r} not applied from {source}: "
                  f"{e}", file=sys.stderr)
        except (ValueError, TypeError, KeyError) as e:
            # one malformed pv-metadata value must not abort the whole
            # layered resolution (SettingsInitializer warns + continues)
            import sys

            print(f"[settings] cannot apply {name!r} from {source}: "
                  f"{e}", file=sys.stderr)
    return applied


def load_layered(settings: Settings,
                 pv_metadata: Optional[dict[str, Any]] = None,
                 settings_files: Optional[list[str | Path]] = None,
                 cmdline: Optional[dict[str, Any]] = None):
    """Full layered resolution (defaults are already in the registry)."""
    if pv_metadata:
        apply_dict(settings, pv_metadata, source="pv-metadata")
    for f in settings_files or []:
        if f and Path(f).exists():
            load_settings_file(settings, f)
    if cmdline:
        apply_dict(settings, cmdline, source="cmdline",
                   max_access=AccessLevel.SYSTEM)
