"""A minimal TOML-subset reader for campaign specs.

The container's Python 3.10 predates stdlib ``tomllib`` and the repo
bakes in no third-party TOML package, so campaign specs are parsed by
this deliberately small reader.  The supported subset — everything
``examples/campaigns/*.toml`` and docs/campaigns.md use:

  * ``[table]`` and ``[[array-of-tables]]`` headers, dotted names;
  * ``key = value`` with bare or dotted keys;
  * values: basic ``"strings"`` (``\\" \\\\ \\n \\t`` escapes),
    integers, floats (incl. ``1e-3``), booleans, and (nested) arrays —
    arrays may span lines with trailing commas;
  * ``#`` comments anywhere outside a string.

Unsupported TOML (literal strings, dates, inline tables, multi-line
strings) raises :class:`TomlError` with a line number rather than
misparsing.  Not a validator — the campaign spec layer does schema
checks; this only guarantees the value tree is what the file says.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple


class TomlError(ValueError):
    """A campaign spec file is not in the supported TOML subset."""


def loads(text: str) -> Dict[str, Any]:
    """Parse TOML-subset ``text`` into nested dicts/lists."""
    root: Dict[str, Any] = {}
    current = root
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        lineno = i + 1
        line = _strip_comment(lines[i], lineno).strip()
        i += 1
        if not line:
            continue
        if line.startswith("[["):
            if not line.endswith("]]"):
                raise TomlError(f"line {lineno}: malformed table-array "
                                f"header: {line!r}")
            parent, leaf = _descend(root, line[2:-2].strip(), lineno)
            arr = parent.setdefault(leaf, [])
            if not isinstance(arr, list):
                raise TomlError(f"line {lineno}: {leaf!r} is not an "
                                "array of tables")
            current = {}
            arr.append(current)
        elif line.startswith("["):
            if not line.endswith("]"):
                raise TomlError(f"line {lineno}: malformed table header: "
                                f"{line!r}")
            parent, leaf = _descend(root, line[1:-1].strip(), lineno)
            current = parent.setdefault(leaf, {})
            if not isinstance(current, dict):
                raise TomlError(f"line {lineno}: {leaf!r} redefined as "
                                "a table")
        else:
            if "=" not in line:
                raise TomlError(f"line {lineno}: expected 'key = value', "
                                f"got {line!r}")
            key, _, rhs = line.partition("=")
            key = key.strip()
            rhs = rhs.strip()
            # arrays may continue over following lines until brackets close
            while _open_brackets(rhs, lineno):
                if i >= len(lines):
                    raise TomlError(f"line {lineno}: unterminated array")
                rhs += " " + _strip_comment(lines[i], i + 1).strip()
                i += 1
            parent, leaf = _descend(current, key, lineno)
            if leaf in parent:
                raise TomlError(f"line {lineno}: duplicate key {key!r}")
            value, rest = _parse_value(rhs, lineno)
            if rest.strip():
                raise TomlError(f"line {lineno}: trailing garbage "
                                f"{rest.strip()!r}")
            parent[leaf] = value
    return root


def load(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())


def _strip_comment(line: str, lineno: int) -> str:
    """Drop a ``#`` comment, honoring string quoting."""
    out = []
    in_str = False
    escaped = False
    for ch in line:
        if in_str:
            out.append(ch)
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_str = False
        elif ch == "#":
            break
        else:
            if ch == '"':
                in_str = True
            out.append(ch)
    if in_str:
        raise TomlError(f"line {lineno}: unterminated string")
    return "".join(out)


def _open_brackets(s: str, lineno: int) -> bool:
    """True while an array value still has unclosed ``[``."""
    depth = 0
    in_str = False
    escaped = False
    for ch in s:
        if in_str:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
    return depth > 0


def _descend(tree: Dict[str, Any], dotted: str, lineno: int
             ) -> Tuple[Dict[str, Any], str]:
    """Walk ``a.b.c`` creating intermediate tables; return (parent, leaf)."""
    parts = [p.strip() for p in dotted.split(".")]
    if not parts or any(not p for p in parts):
        raise TomlError(f"line {lineno}: bad key {dotted!r}")
    for p in parts[:-1]:
        nxt = tree.setdefault(p, {})
        if isinstance(nxt, list):  # [[x]] then [x.y]: attach to last entry
            nxt = nxt[-1]
        if not isinstance(nxt, dict):
            raise TomlError(f"line {lineno}: {p!r} is not a table")
        tree = nxt
    return tree, parts[-1]


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}


def _parse_value(s: str, lineno: int) -> Tuple[Any, str]:
    """Parse one value at the head of ``s``; return (value, remainder)."""
    s = s.lstrip()
    if not s:
        raise TomlError(f"line {lineno}: missing value")
    if s[0] == '"':
        out = []
        i = 1
        while i < len(s):
            ch = s[i]
            if ch == "\\":
                if i + 1 >= len(s) or s[i + 1] not in _ESCAPES:
                    raise TomlError(f"line {lineno}: unsupported escape "
                                    f"in string: {s[i:i+2]!r}")
                out.append(_ESCAPES[s[i + 1]])
                i += 2
            elif ch == '"':
                return "".join(out), s[i + 1:]
            else:
                out.append(ch)
                i += 1
        raise TomlError(f"line {lineno}: unterminated string")
    if s[0] == "[":
        items: List[Any] = []
        rest = s[1:].lstrip()
        while True:
            if not rest:
                raise TomlError(f"line {lineno}: unterminated array")
            if rest[0] == "]":
                return items, rest[1:]
            item, rest = _parse_value(rest, lineno)
            items.append(item)
            rest = rest.lstrip()
            if rest.startswith(","):
                rest = rest[1:].lstrip()
            elif not rest.startswith("]"):
                raise TomlError(f"line {lineno}: expected ',' or ']' in "
                                f"array, got {rest[:10]!r}")
    # bare scalar: boolean / integer / float
    token = s
    for stop in (",", "]"):
        cut = token.find(stop)
        if cut != -1:
            token = token[:cut]
    token = token.strip()
    if not token:
        raise TomlError(f"line {lineno}: missing value")
    rest = s[len(token):]  # s is lstripped, so the token is its prefix
    if token == "true":
        return True, rest
    if token == "false":
        return False, rest
    try:
        if any(c in token for c in ".eE") and not token.startswith("0x"):
            return float(token), rest
        return int(token, 0), rest
    except ValueError:
        raise TomlError(f"line {lineno}: unsupported value {token!r} "
                        "(subset: strings, numbers, booleans, arrays)"
                        ) from None
