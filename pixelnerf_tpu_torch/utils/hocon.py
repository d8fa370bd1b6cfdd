"""Minimal HOCON parser covering the subset used by pixelNeRF-style configs.

The reference framework configures experiments with PyHocon `.conf` trees
(reference: src/util/args.py:99-106, conf/*.conf). pyhocon is not available
in this environment, and we only need a small, well-defined subset:

* ``#`` and ``//`` comments (including trailing comments after values)
* ``include required("relative/path.conf")`` — file inheritance, resolved
  relative to the including file (reference: conf/default_mv.conf:2)
* nested objects ``key { ... }`` with deep-merge on repeated keys
* ``key = value`` / ``key : value`` / ``key=value``
* scalars: bool (true/false/True/False), int, float, bare or quoted strings
* lists ``[1, 2, 3]`` incl. nested lists and the empty list ``[]``

Later assignments deep-merge into earlier ones (objects merge recursively,
scalars/lists overwrite), matching HOCON semantics for the subset above.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["load", "loads", "ConfigTree"]

_INCLUDE_RE = re.compile(
    r"""^include\s+(?:required\s*\(\s*)?(?:file\s*\(\s*)?"([^"]+)"\s*\)?\s*\)?\s*$"""
)


class ConfigTree(dict):
    """A dict with pyhocon-compatible typed getters.

    Mirrors the access API the reference uses throughout
    (``conf.get_int/get_bool/get_float/get_string/get_list``,
    e.g. src/render/nerf.py:340-352, src/model/resnetfc.py:186-198) so
    our ``from_conf`` constructors read identically.
    """

    def _get(self, key: str, default: Any) -> Any:
        node: Any = self
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_config(self, key: str, default: Optional["ConfigTree"] = None):
        val = self._get(key, default)
        if isinstance(val, dict) and not isinstance(val, ConfigTree):
            val = ConfigTree(val)
        return val

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        val = self._get(key, default)
        return int(val) if val is not None else val

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        val = self._get(key, default)
        return float(val) if val is not None else val

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        val = self._get(key, default)
        if isinstance(val, str):
            return val.lower() in ("true", "1", "yes")
        return bool(val) if val is not None else val

    def get_string(self, key: str, default: Optional[str] = None) -> str:
        val = self._get(key, default)
        return str(val) if val is not None else val

    def get_list(self, key: str, default: Optional[list] = None) -> list:
        val = self._get(key, default)
        return list(val) if val is not None else val

    def __getitem__(self, key: str) -> Any:
        if "." in key:
            val = self._get(key, _MISSING := object())
            if val is _MISSING:
                raise KeyError(key)
        else:
            val = dict.__getitem__(self, key)
        if isinstance(val, dict) and not isinstance(val, ConfigTree):
            val = ConfigTree(val)
        return val

    def get(self, key: str, default: Any = None) -> Any:
        val = self._get(key, default)
        if isinstance(val, dict) and not isinstance(val, ConfigTree):
            val = ConfigTree(val)
        return val


def _strip_comment(line: str) -> str:
    """Remove # / // comments, respecting double-quoted strings."""
    out = []
    in_str = False
    i = 0
    while i < len(line):
        ch = line[i]
        if ch == '"':
            in_str = not in_str
        if not in_str:
            if ch == "#":
                break
            if ch == "/" and i + 1 < len(line) and line[i + 1] == "/":
                break
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        val, rest = _parse_list(text)
        if rest.strip():
            raise ValueError(f"Trailing content after list: {rest!r}")
        return val
    return _parse_scalar(text)


def _parse_list(text: str) -> Tuple[list, str]:
    """Parse a bracketed list from the start of text; return (list, remainder)."""
    assert text[0] == "["
    items: list = []
    i = 1
    buf = ""

    def flush():
        nonlocal buf
        if buf.strip():
            items.append(_parse_scalar(buf))
        buf = ""

    while i < len(text):
        ch = text[i]
        if ch == "[":
            sub, rest = _parse_list(text[i:])
            items.append(sub)
            text = text[:i] + rest
            # after nested list, skip separators until , or ]
            continue
        if ch == "]":
            flush()
            return items, text[i + 1 :]
        if ch == ",":
            flush()
        else:
            buf += ch
        i += 1
    raise ValueError("Unterminated list in config")


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _tokenize_lines(text: str) -> List[str]:
    """Split into logical lines; multi-line lists are joined."""
    raw_lines = [_strip_comment(ln).strip() for ln in text.splitlines()]
    lines: List[str] = []
    buf = ""
    depth = 0
    for ln in raw_lines:
        if not ln and depth == 0:
            continue
        buf = (buf + " " + ln).strip() if buf else ln
        depth = buf.count("[") - buf.count("]")
        if depth <= 0:
            if buf:
                lines.append(buf)
            buf = ""
            depth = 0
    if buf:
        lines.append(buf)
    return lines


def loads(text: str, base_dir: Optional[str] = None) -> ConfigTree:
    """Parse HOCON-subset text into a ConfigTree."""
    root: Dict[str, Any] = {}
    stack: List[Dict[str, Any]] = [root]
    for line in _tokenize_lines(text):
        while line:
            line = line.strip()
            if not line:
                break
            m = _INCLUDE_RE.match(line)
            if m:
                if base_dir is None:
                    raise ValueError("include found but no base_dir given")
                inc_path = os.path.join(base_dir, m.group(1))
                included = load(inc_path)
                _deep_merge(stack[-1], included)
                line = ""
                continue
            if line == "}":
                if len(stack) == 1:
                    raise ValueError("Unbalanced '}' in config")
                stack.pop()
                line = ""
                continue
            # key { ... — open nested object (possibly with inline contents)
            m_obj = re.match(r"^([\w.\-]+)\s*\{(.*)$", line)
            if m_obj:
                key, rest = m_obj.group(1), m_obj.group(2)
                parent = stack[-1]
                child = parent.setdefault(key, {})
                if not isinstance(child, dict):
                    child = {}
                    parent[key] = child
                stack.append(child)
                line = rest
                continue
            # key = value  |  key : value
            m_kv = re.match(r"^([\w.\-]+)\s*[=:]\s*(.+)$", line)
            if m_kv:
                key, val_text = m_kv.group(1), m_kv.group(2).strip()
                if val_text.startswith("{"):
                    parent = stack[-1]
                    child = parent.setdefault(key, {})
                    stack.append(child)
                    line = val_text[1:]
                    continue
                if val_text.startswith("["):
                    # list value; anything after the closing ']' (e.g. '}'
                    # braces on the same line) is re-processed as line input
                    val, rest = _parse_list(val_text)
                    stack[-1][key] = val
                    line = rest
                    continue
                # value may be followed by '}' closing brace(s) on same line
                closes = 0
                while val_text.endswith("}"):
                    val_text = val_text[:-1].rstrip()
                    closes += 1
                stack[-1][key] = _parse_value(val_text)
                for _ in range(closes):
                    if len(stack) == 1:
                        raise ValueError("Unbalanced '}' in config")
                    stack.pop()
                line = ""
                continue
            raise ValueError(f"Cannot parse config line: {line!r}")

    def _to_tree(d: Dict[str, Any]) -> ConfigTree:
        out = ConfigTree()
        for k, v in d.items():
            out[k] = _to_tree(v) if isinstance(v, dict) else v
        return out

    return _to_tree(root)


def load(path: str) -> ConfigTree:
    """Load a .conf file, resolving includes relative to the file."""
    with open(path, "r") as f:
        text = f.read()
    return loads(text, base_dir=os.path.dirname(os.path.abspath(path)))
