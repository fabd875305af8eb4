"""PathArray: the reference's multi-file source pattern resolution
(commons file/PathArray.h; semantics pinned by the reference's
Application/Tests/test_patharray.cpp, ported in
tests/test_reference_vectors.py):

- ``%3d`` / ``%03d``      zero-padded counter, from 0 while files exist
- ``%10.3d``              start.digits — from 10 while files exist
- ``%10.100.6d``          start.end.digits — inclusive range
- ``*``/``?`` globs       direct children of the parent directory, sorted
- ``["a","b"]``           explicit array of paths
- anything else           a single path

plus ``find_basename`` (the default output name for a source array)
and ``sanitize_filename``.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Iterable

_PRINTF = re.compile(r"%(?:(\d+)\.)?(?:(\d+)\.)?0?(\d+)?d")


class RealFilesystem:
    def find_files(self, parent: str) -> list[str]:
        try:
            return [str(Path(parent) / n) for n in os.listdir(parent or ".")]
        except OSError:
            return []

    def is_folder(self, path: str) -> bool:
        return os.path.isdir(path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)


REAL_FS = RealFilesystem()


def has_pattern(source: str) -> bool:
    s = str(source)
    return bool(_PRINTF.search(s)) or any(c in s for c in "*?") \
        or (s.strip().startswith("[") and s.strip().endswith("]"))


def resolve_paths(source: str, fs=REAL_FS) -> list[str]:
    s = str(source).strip()
    if s.startswith("[") and s.endswith("]"):
        # quote-aware split: a quoted path may itself contain commas
        parts, cur, quote = [], [], None
        for ch in s[1:-1]:
            if quote:
                if ch == quote:
                    quote = None
                else:
                    cur.append(ch)
            elif ch in "'\"":
                quote = ch
            elif ch == ",":
                if "".join(cur).strip():
                    parts.append("".join(cur).strip())
                cur = []
            else:
                cur.append(ch)
        if "".join(cur).strip():
            parts.append("".join(cur).strip())
        return parts
    m = _PRINTF.search(s)
    if m:
        return _resolve_printf(s, m, fs)
    if any(c in s for c in "*?"):
        parent = str(Path(s).parent)
        pat = Path(s).name
        import fnmatch

        out = []
        for f in fs.find_files(parent):
            # direct children only (subdirectory contents never match)
            if str(Path(f).parent) != parent:
                continue
            if fnmatch.fnmatch(Path(f).name, pat):
                out.append(f)
        return sorted(out)
    return [s]


def _resolve_printf(pattern: str, m: re.Match, fs) -> list[str]:
    g1, g2, digits = m.groups()
    if g2 is not None:            # %start.end.digits d
        start, end = int(g1), int(g2)
    elif g1 is not None:          # %start.digits d
        start, end = int(g1), None
    else:                         # %digits d (or bare %d)
        start, end = 0, None
    width = int(digits) if digits else 0

    def path_for(i: int) -> str:
        rep = str(i).zfill(width) if width else str(i)
        return pattern[:m.start()] + rep + pattern[m.end():]

    out = []
    if end is not None:
        for i in range(start, end + 1):
            p = path_for(i)
            if fs.exists(p):
                out.append(p)
        return out
    i = start
    while True:
        p = path_for(i)
        if not fs.exists(p):
            # tolerate a 1-based sequence when asked to start at 0
            if i == start == 0:
                i = 1
                continue
            break
        out.append(p)
        i += 1
    return out


def find_basename(paths: Iterable[str]) -> str:
    """Default output name for a source array (test_patharray.cpp:
    849-881): one file -> its stem; several files sharing a parent ->
    the parent directory's name; same filename across directories ->
    the common stem."""
    paths = [str(p) for p in paths]
    if not paths:
        return ""
    if len(paths) == 1:
        return Path(paths[0]).stem
    stems = {Path(p).stem for p in paths}
    if len(stems) == 1:
        return stems.pop()
    parents = {str(Path(p).parent) for p in paths}
    if len(parents) == 1:
        return Path(parents.pop()).name
    # mixed: fall back to the first file's stem
    return Path(paths[0]).stem


_BAD = set('/\\*:?|<>"')


def sanitize_filename(name: str) -> str:
    """Drop filesystem-hostile characters and trailing spaces
    (test_patharray.cpp:883-901)."""
    return "".join(c for c in str(name) if c not in _BAD).rstrip()
