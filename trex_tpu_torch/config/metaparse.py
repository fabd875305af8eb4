"""Parse/format values in the TRex "Meta" string format.

The reference serializes setting values to strings in a JSON-like format
(see usage in the reference's `.settings` files, e.g. its
videos/test.settings, and pv metadata JSON). We accept
JSON plus the lenient variants the reference emits/accepts:

- bare strings for enums (``mp4``, ``automatic``)
- single-quoted strings
- ``[[70,420]]`` style nested arrays
- ``{"a": 1}`` maps
- true/false, numbers
"""
from __future__ import annotations

import json
import re
from typing import Any

_NUM = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def parse_value(text: str) -> Any:
    """Parse one meta-format value string into a Python value."""
    s = text.strip()
    if s == "":
        return ""
    try:
        return json.loads(s)
    except (json.JSONDecodeError, ValueError):
        pass
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("null", "none"):
        return None
    if _NUM.match(s):
        f = float(s)
        return int(f) if f.is_integer() and ("." not in s and "e" not in low) else f
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        # process backslash escapes like the container tokenizer so the
        # same literal parses identically at top level and nested
        body = s[1:-1]
        if "\\" in body:
            out, i = [], 0
            while i < len(body):
                if body[i] == "\\" and i + 1 < len(body):
                    out.append(body[i + 1])
                    i += 2
                else:
                    out.append(body[i])
                    i += 1
            body = "".join(out)
        return body
    if s.startswith("[") or s.startswith("{"):
        return _parse_container(s)
    # bare word: enum value / unquoted string
    return s


def _tokenize(s: str):
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
        elif c in "[]{},:":
            yield c, c
            i += 1
        elif c in "'\"":
            j = i + 1
            buf = []
            while j < n and s[j] != c:
                if s[j] == "\\" and j + 1 < n:
                    buf.append(s[j + 1])
                    j += 2
                    continue
                buf.append(s[j])
                j += 1
            yield "str", "".join(buf)
            i = j + 1
        else:
            j = i
            while j < n and s[j] not in "[]{},:" and not s[j].isspace():
                j += 1
            yield "word", s[i:j]
            i = j


def _parse_container(s: str) -> Any:
    toks = list(_tokenize(s))
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else (None, None)

    def advance():
        t = toks[pos[0]]
        pos[0] += 1
        return t

    def value():
        kind, tok = peek()
        if kind == "[":
            advance()
            out = []
            while True:
                k, _ = peek()
                if k == "]":
                    advance()
                    return out
                if k == ",":
                    advance()
                    continue
                if k is None:
                    return out
                out.append(value())
        if kind == "{":
            advance()
            out = {}
            while True:
                k, _ = peek()
                if k == "}":
                    advance()
                    return out
                if k == ",":
                    advance()
                    continue
                if k is None:
                    return out
                _, key = advance()
                k2, _ = peek()
                if k2 == ":":
                    advance()
                    out[key] = value()
                else:
                    out[key] = None
            return out
        if kind == "str":
            advance()
            return tok
        if kind == "word":
            advance()
            low = tok.lower()
            if low == "true":
                return True
            if low == "false":
                return False
            if low in ("null", "none"):
                return None
            if _NUM.match(tok):
                f = float(tok)
                return int(f) if f.is_integer() and "." not in tok and "e" not in low else f
            return tok
        advance()
        return None

    return value()


def format_value(v: Any) -> str:
    """Format a Python value in meta format (JSON-compatible output)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, float):
        if v.is_integer():
            return str(int(v))
        return repr(v)
    if isinstance(v, (int,)):
        return str(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(format_value(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{json.dumps(str(k))}:{format_value(x)}" for k, x in v.items()) + "}"
    return json.dumps(v, default=str)
