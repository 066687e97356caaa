"""A reader for the subset of YAML that the config files use, without PyYAML.

What it reads, as PyYAML's ``safe_load`` reads it:

* block mappings nested by indentation (spaces only), one ``key: value`` a
  line, and comments, whole-line or after a value;
* plain scalars, resolved by YAML 1.1's rules for bool, null, int and float
  (``scalar``); single- and double-quoted scalars, always strings;
* flow sequences ``[a, b]`` and flow mappings ``{k: v}`` on one line, nested.

Anything else raises ``ValueError`` naming its line: anchors, aliases, tags,
block scalars (``|``, ``>``), block sequences (``- item``), several
documents, directives, plain scalars that continue on the next line,
multi-line flow collections, timestamps and merge keys. A file that uses
them needs PyYAML; the packaged configs do not.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

# YAML 1.1's implicit types, as PyYAML's resolver writes them
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:$|[Tt \t])")
# characters that cannot start a plain scalar, and what they would start
_INDICATORS = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
               ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
               "`": "a reserved indicator", "?": "a complex key", "-": "a block sequence"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast) -> Any:
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def scalar(text: str) -> Any:
    """A plain scalar's value by YAML 1.1's rules, as PyYAML resolves it:
    bool, null, int (binary, octal, decimal, hex, base 60), float (with a
    dot; ``.inf``, ``.nan``, base 60), else the string itself. Raises
    ``ValueError`` on a timestamp, which PyYAML turns into a date."""
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        return sign * (_sexagesimal(value, float) if ":" in value else float(value))
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * (_sexagesimal(value, int) if ":" in value else int(value))
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamp {text!r} is outside the YAML subset")
    return text


class _Line:
    """A cursor over one line's text, for the error's line number."""

    def __init__(self, text: str, lineno: int, pos: int = 0):
        self.text, self.lineno, self.pos = text, lineno, pos

    def error(self, what: str) -> ValueError:
        return ValueError(f"line {self.lineno}: {what} is outside the YAML subset: "
                          f"{self.text.strip()!r}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() in (" ", "\t"):
            self.pos += 1

    def at_end(self) -> bool:
        """Only spaces and a comment (a '#' after a space) are left."""
        self.skip_spaces()
        return not self.peek() or (self.peek() == "#" and self.text[self.pos - 1] in " \t")

    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        out: List[str] = []
        while True:
            ch = self.peek()
            if not ch:
                raise self.error("a quoted scalar over several lines")
            self.pos += 1
            if ch == quote:
                if quote == "'" and self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if ch == "\\" and quote == '"':
                esc = self.peek()
                self.pos += 1
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                elif esc in _HEX_ESCAPES:
                    digits = self.text[self.pos:self.pos + _HEX_ESCAPES[esc]]
                    if len(digits) != _HEX_ESCAPES[esc] or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                        raise self.error(f"the escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += len(digits)
                else:
                    raise self.error(f"the escape \\{esc}")
                continue
            out.append(ch)

    def plain(self, flow: bool) -> str:
        """A plain scalar up to a comment, the line's end, a ``: `` (a key's
        end) and, in a flow collection, ``,``, ``]``, ``}``."""
        ch = self.peek()
        nxt = self.text[self.pos + 1:self.pos + 2]
        if ch in _INDICATORS and not (ch in "-?" and nxt not in ("", " ", "\t")):
            raise self.error(_INDICATORS[ch])
        if ch in ",[]{}#" or (ch == ":" and nxt in ("", " ", "\t")):
            raise self.error(f"a plain scalar starting with {ch!r}")
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            nxt = self.text[self.pos + 1:self.pos + 2]
            if ch == "#" and self.text[self.pos - 1] in " \t":
                break
            if ch == ":" and (nxt in ("", " ", "\t") or (flow and nxt in ",[]{}")):
                break
            if flow and ch in ",[]{}":
                break
            self.pos += 1
        return self.text[start:self.pos].rstrip(" \t")

    def flow_value(self) -> Any:
        self.skip_spaces()
        ch = self.peek()
        if ch == "[":
            return self.flow_sequence()
        if ch == "{":
            return self.flow_mapping()
        if ch in ("'", '"'):
            return self.quoted()
        if not ch:
            raise self.error("a flow collection over several lines")
        return scalar(self.plain(flow=True))

    def flow_sequence(self) -> List[Any]:
        self.pos += 1
        out: List[Any] = []
        while True:
            self.skip_spaces()
            if self.peek() == "]":
                self.pos += 1
                return out
            out.append(self.flow_value())
            self.skip_spaces()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != "]":
                raise self.error("a flow collection over several lines" if not ch
                                 else f"{ch!r} in a flow sequence")

    def flow_mapping(self) -> Dict[Any, Any]:
        self.pos += 1
        out: Dict[Any, Any] = {}
        while True:
            self.skip_spaces()
            if self.peek() == "}":
                self.pos += 1
                return out
            key = self.quoted() if self.peek() in ("'", '"') else scalar(self.plain(flow=True))
            self.skip_spaces()
            value = None
            if self.peek() == ":":
                self.pos += 1
                self.skip_spaces()
                if self.peek() not in (",", "}"):
                    value = self.flow_value()
            out[key] = value
            self.skip_spaces()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != "}":
                raise self.error("a flow collection over several lines" if not ch
                                 else f"{ch!r} in a flow mapping")

    def value(self) -> Any:
        """The rest of the line as one value: a flow collection, a quoted or
        a plain scalar, followed by nothing but a comment."""
        self.skip_spaces()
        ch = self.peek()
        if ch in ("[", "{", "'", '"'):
            out = self.flow_value()
        else:
            text = self.plain(flow=False)
            if self.peek() == ":":
                raise self.error("a mapping inside a plain scalar")
            out = scalar(text)
        if not self.at_end():
            raise self.error("text after a value")
        return out


def _content_lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indentation, text) of every line that is not blank or a
    comment; raises on document markers, directives and tab indentation."""
    out = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        body = line.lstrip(" ")
        if not body.strip() or body.lstrip("\t").startswith("#"):
            continue
        if body[0] == "\t":
            raise _Line(line, lineno).error("indentation by tabs")
        if line.startswith(("---", "...")) and line[3:4] in ("", " ", "\t"):
            raise _Line(line, lineno).error("a document marker")
        if line.startswith("%"):
            raise _Line(line, lineno).error("a directive")
        out.append((lineno, len(line) - len(body), line))
    return out


_NO_KEY = object()


def _key(cur: _Line) -> Any:
    """The mapping key at the cursor, its ':' consumed; ``_NO_KEY``, with
    the cursor where it was, when the line holds no ``key:``."""
    start = cur.pos
    if cur.peek() in ("[", "{"):
        return _NO_KEY
    key = cur.quoted() if cur.peek() in ("'", '"') else scalar(cur.plain(flow=False))
    cur.skip_spaces()
    if cur.peek() != ":":
        cur.pos = start
        return _NO_KEY
    cur.pos += 1
    if key == "<<":
        raise cur.error("a merge key")
    return key


def _mapping(lines, i: int, indent: int) -> Tuple[Dict[Any, Any], int]:
    out: Dict[Any, Any] = {}
    while i < len(lines):
        lineno, ind, text = lines[i]
        if ind < indent:
            break
        cur = _Line(text, lineno, ind)
        if ind > indent:
            raise cur.error("a line indented deeper than its mapping")
        if cur.peek() == "-" and text[ind + 1:ind + 2] in ("", " ", "\t"):
            raise cur.error("a block sequence")
        key = _key(cur)
        if key is _NO_KEY:
            raise cur.error("a line that is no 'key: value'")
        i += 1
        if cur.at_end():
            if i < len(lines) and lines[i][1] > indent:
                out[key], i = _mapping(lines, i, lines[i][1])
            else:
                out[key] = None
            continue
        out[key] = cur.value()
        if i < len(lines) and lines[i][1] > indent:
            raise _Line(lines[i][2], lines[i][0]).error("a plain scalar continued on the next line")
    return out, i


def loads(text: str) -> Any:
    """The value of one YAML document in the subset; None for an empty one."""
    lines = _content_lines(text)
    if not lines:
        return None
    lineno, indent, first = lines[0]
    cur = _Line(first, lineno, indent)
    if _key(cur) is _NO_KEY:
        # a document that is one scalar or flow collection
        value = cur.value()
        if len(lines) > 1:
            raise _Line(lines[1][2], lines[1][0]).error("a second value")
        return value
    out, i = _mapping(lines, 0, indent)
    if i < len(lines):
        raise _Line(lines[i][2], lines[i][0]).error("a line outdented below the document's mapping")
    return out


def load_file(path: Union[str, Path]) -> Any:
    """``loads`` of a UTF-8 file; the error names the file too."""
    p = Path(path)
    try:
        return loads(p.read_text(encoding="utf-8"))
    except ValueError as exc:
        raise ValueError(f"{p}: {exc}") from None
