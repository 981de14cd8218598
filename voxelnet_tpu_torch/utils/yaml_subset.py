"""The subset of YAML that config override files and the `config.yaml`
snapshot use, read and written without pyyaml (the card's machine has
none).

Read: block mappings nested by indentation, block sequences of scalars or
flow collections, flow mappings and sequences (`object: {x_max: 12.8}`,
`[1.0, 2.0]`, nested), plain and quoted scalars, `#` comments. Plain
scalars resolve as pyyaml's `safe_load` resolves them: null (`~`, `null`,
empty), YAML 1.1 booleans (`true`, `yes`, `on`, ...), decimal integers,
floats with a dot (`0.5`, `1.0e-05`, `.inf`, `.nan`), else strings. Anything
else raises ValueError: anchors, aliases, tags, block scalars (`|`, `>`),
complex keys, mappings inside block sequences, and plain scalars that
look like numbers or dates in any other form (`017`, `0x1f`, `1_000`,
`1:30`, `2024-01-02`, and `1e-3`, which pyyaml reads as a string).

Written: block mappings, flow sequences, single-quoted strings, floats
as pyyaml writes them, so `yaml.safe_load` of the text gives the same
value.
"""

from __future__ import annotations

import math
import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?\Z")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)\Z")
# plain scalars that start like a number but are none of the forms above
# (octal, hex, underscores, sexagesimal, dates, exponent without a dot):
# refused, not read as strings
_NUMBER_LIKE = re.compile(r"[-+]?\.?[0-9]")
_RESERVED = "&*!|>%@`?"
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_.\-]*|'[^']*'|\"[^\"]*\"):(?: |$)")


class _Cursor:
    """A flow-context scanner over one value's text."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def error(self, what: str) -> ValueError:
        return ValueError(f"{self.where}: {what} (outside the YAML subset "
                          f"this reader takes): {self.text!r}")

    def skip_space(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def expect(self, ch: str) -> None:
        self.skip_space()
        if self.peek() != ch:
            raise self.error(f"expected {ch!r}")
        self.pos += 1


def _resolve(plain: str, where: str):
    if plain in _NULL:
        return None
    if plain in _TRUE:
        return True
    if plain in _FALSE:
        return False
    if _INT.match(plain):
        return int(plain)
    if _FLOAT.match(plain):
        return float(plain)
    m = _INF.match(plain)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(plain):
        return math.nan
    if _NUMBER_LIKE.match(plain):
        raise ValueError(f"{where}: plain scalar {plain!r} is a number or "
                         "date form outside the YAML subset this reader "
                         "takes; quote it if it is a string")
    if plain[0] in _RESERVED or plain.startswith(("- ", "---", "...")):
        raise ValueError(f"{where}: {plain!r} is outside the YAML subset "
                         "this reader takes")
    return plain


def _quoted(cur: _Cursor) -> str:
    quote = cur.peek()
    cur.pos += 1
    out = []
    while True:
        if cur.pos >= len(cur.text):
            raise cur.error("unterminated quoted scalar")
        ch = cur.text[cur.pos]
        cur.pos += 1
        if ch == quote:
            if quote == "'" and cur.peek() == "'":
                out.append("'")
                cur.pos += 1
                continue
            return "".join(out)
        if quote == '"' and ch == "\\":
            esc = cur.peek()
            cur.pos += 1
            if esc not in ("\\", '"', "n", "t"):
                raise cur.error(f"escape \\{esc}")
            out.append({"n": "\n", "t": "\t"}.get(esc, esc))
            continue
        out.append(ch)


def _flow_value(cur: _Cursor, flow: bool):
    """One value at the cursor; `flow` is True inside [] or {}."""
    cur.skip_space()
    ch = cur.peek()
    if ch == "[":
        cur.pos += 1
        items = []
        cur.skip_space()
        if cur.peek() == "]":
            cur.pos += 1
            return items
        while True:
            items.append(_flow_value(cur, True))
            cur.skip_space()
            if cur.peek() == ",":
                cur.pos += 1
                continue
            cur.expect("]")
            return items
    if ch == "{":
        cur.pos += 1
        out = {}
        cur.skip_space()
        if cur.peek() == "}":
            cur.pos += 1
            return out
        while True:
            key = _flow_value(cur, True)
            if isinstance(key, (dict, list)):
                raise cur.error("a collection as a key")
            cur.expect(":")
            out[key] = _flow_value(cur, True)
            cur.skip_space()
            if cur.peek() == ",":
                cur.pos += 1
                continue
            cur.expect("}")
            return out
    if ch in "'\"":
        return _quoted(cur)
    start = cur.pos
    stops = ",[]{}" if flow else ""
    while cur.pos < len(cur.text):
        c = cur.text[cur.pos]
        if c in stops:
            break
        if flow and c == ":" and (cur.pos + 1 == len(cur.text)
                                  or cur.text[cur.pos + 1] in " ,]}"):
            break
        cur.pos += 1
    return _resolve(cur.text[start:cur.pos].strip(), cur.where)


def _inline(text: str, where: str):
    """A whole value written on one line (flow collection or scalar)."""
    cur = _Cursor(text, where)
    value = _flow_value(cur, False)
    cur.skip_space()
    if cur.pos != len(text):
        raise cur.error("trailing text")
    return value


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str, where: str) -> tuple[str, str]:
    """'key: rest' or 'key:' -> (key, rest); raises for anything else."""
    m = _KEY.match(text)
    if not m:
        raise ValueError(f"{where}: expected 'key: value' in the YAML "
                         f"subset this reader takes: {text!r}")
    key = m.group(1)
    if key[0] in "'\"":
        key = key[1:-1]
    return key, text[m.end():].strip()


def _block(lines, i: int, indent: int):
    """The block collection whose first line is lines[i] at `indent`
    -> (value, index of the first line after it)."""
    if lines[i][2].startswith("-"):
        items = []
        while i < len(lines) and lines[i][1] == indent:
            num, _, text = lines[i]
            where = f"line {num}"
            if not (text == "-" or text.startswith("- ")):
                break
            rest = text[1:].strip()
            if not rest:
                raise ValueError(f"{where}: a nested block inside a "
                                 "sequence is outside the YAML subset")
            if _KEY.match(rest):
                raise ValueError(f"{where}: a mapping inside a sequence is "
                                 "outside the YAML subset")
            items.append(_inline(rest, where))
            i += 1
        return items, i
    out = {}
    while i < len(lines) and lines[i][1] == indent:
        num, _, text = lines[i]
        where = f"line {num}"
        key, rest = _split_key(text, where)
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = _inline(rest, where)
        elif i < len(lines) and (lines[i][1] > indent or (
                lines[i][1] == indent and lines[i][2].startswith("- "))):
            out[key], i = _block(lines, i, lines[i][1])
        else:
            out[key] = None
    if i < len(lines) and lines[i][1] > indent:
        raise ValueError(f"line {lines[i][0]}: unexpected indentation")
    return out, i


def load(text: str):
    """Parse one document of the subset -> dict, list, scalar or None."""
    lines = []
    for num, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {num}: tab indentation")
        body = _strip_comment(raw)
        if body.strip():
            lines.append((num, len(body) - len(body.lstrip()),
                          body.strip()))
    if not lines:
        return None
    if lines[0][2] in ("---", "...") or lines[0][2].startswith("%"):
        raise ValueError(f"line {lines[0][0]}: document markers and "
                         "directives are outside the YAML subset")
    num, indent, first = lines[0]
    if not (first == "-" or first.startswith("- ") or _KEY.match(first)):
        if len(lines) > 1:
            raise ValueError(f"line {lines[1][0]}: a multi-line scalar is "
                             "outside the YAML subset")
        return _inline(first, f"line {num}")
    value, i = _block(lines, 0, indent)
    if i != len(lines):
        raise ValueError(f"line {lines[i][0]}: unexpected indentation")
    return value


def _scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if "\n" in value:
            raise ValueError(f"multi-line string {value!r} is outside the "
                             "YAML subset")
        return "'" + value.replace("'", "''") + "'"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_scalar(v) for v in value) + "]"
    if isinstance(value, dict) and not value:
        return "{}"
    raise ValueError(f"{type(value).__name__} value {value!r} is outside "
                     "the YAML subset")


def dump(mapping: dict, indent: int = 0) -> str:
    """A nested dict of scalars and lists -> block-mapping text, keys in
    their order."""
    lines = []
    pad = " " * indent
    for key, value in mapping.items():
        if not isinstance(key, str) or not re.fullmatch(
                r"[A-Za-z_][A-Za-z0-9_]*", key):
            raise ValueError(f"key {key!r} is outside the YAML subset")
        if isinstance(value, dict) and value:
            lines.append(f"{pad}{key}:\n" + dump(value, indent + 2))
        else:
            lines.append(f"{pad}{key}: {_scalar(value)}\n")
    return "".join(lines)
