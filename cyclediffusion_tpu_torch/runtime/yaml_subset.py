"""A reader for the subset of YAML that model spec files use, in place of
``yaml.safe_load`` (the card's machine has no ``yaml``).

It reads what the reference's OmegaConf specs hold (SD's
``v1-inference.yaml``, the LDMs' ``config.yaml``, the SDEdit /
DiffusionCLIP ``.yml`` files): block mappings and sequences (a sequence
may sit at its parent key's indentation), flow sequences and mappings on
one line or several (``[1, 2, 4]``, ``[16, ]``, ``{}``), comments, and
plain, single-quoted and double-quoted scalars.

Plain scalars resolve as PyYAML's YAML 1.1 resolver resolves them, which
is where a reader goes wrong: ``1.0e-04`` and ``1.e-6`` are floats but
``1e-4`` (no dot) and ``1.0e4`` (no exponent sign) are strings;
``yes/no/on/off/true/false`` in their three casings are bools; ``~``,
``null`` and an empty value are None; ``0x1f``, ``0b101``, ``017``
(octal), ``1_000`` and ``1:30`` (base 60) are ints, while ``0o17`` is a
string; ``.inf`` and ``.nan`` are floats.  Keys resolve the same way, and
a repeated key keeps its last value, as in PyYAML.

Anchors, aliases, tags, block scalars (``|``, ``>``), complex keys,
merge keys, directives, timestamps, several documents and plain or quoted
scalars that continue over several lines raise :class:`YAMLSubsetError`
with the line number.
"""

from __future__ import annotations

import dataclasses
import re

_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"),
                          True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                          False)}
_NULLS = ("~", "null", "Null", "NULL", "")
# PyYAML's implicit resolvers (yaml/resolver.py)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"


class YAMLSubsetError(ValueError):
    """A file outside the subset, or not YAML; names the line."""

    def __init__(self, msg: str, lineno: int):
        super().__init__(f"line {lineno}: {msg}")
        self.lineno = lineno


class _Unclosed(YAMLSubsetError):
    """A flow collection whose text ends before it closes."""


def _sexagesimal(text: str, cast):
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def resolve_plain(text: str, lineno: int = 0):
    """A plain scalar -> its value under PyYAML's YAML 1.1 resolver."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"timestamp {text!r} is not read", lineno)
    if text in ("<<", "="):
        raise YAMLSubsetError(f"{text!r} (a merge or value key) is not read", lineno)
    return text


def _quoted(text: str, pos: int, lineno: int):
    """The quoted scalar starting at ``text[pos]`` -> (its string, the
    position after the closing quote)."""
    q = text[pos]
    out, i, n = [], pos + 1, len(text)
    while i < n:
        c = text[i]
        if q == "'":
            if c == "'":
                if i + 1 < n and text[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            if i + 1 >= n:
                break
            e = text[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                k = _HEX_ESCAPES[e]
                digits = text[i + 2:i + 2 + k]
                if len(digits) != k or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise YAMLSubsetError(f"bad escape \\{e}{digits}", lineno)
                out.append(chr(int(digits, 16)))
                i += 2 + k
            else:
                raise YAMLSubsetError(f"unknown escape \\{e}", lineno)
            continue
        out.append(c)
        i += 1
    raise YAMLSubsetError("a quoted scalar that does not close on its line is not read",
                          lineno)


def _strip_comment(text: str, lineno: int) -> str:
    """``text`` without its comment (``#`` at the start or after a space,
    outside quotes), right-stripped."""
    i, n, token_start = 0, len(text), True
    while i < n:
        c = text[i]
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        if c in "'\"" and token_start:
            _, i = _quoted(text, i, lineno)
            token_start = False
            continue
        if c in "[{,":
            token_start = True
        elif c in ":-?":
            token_start = i + 1 == n or text[i + 1] in " \t"
        elif c not in " \t":
            token_start = False
        i += 1
    return text.rstrip()


def _check_plain(text: str, lineno: int) -> None:
    if text[0] in "&*!|>%@`":
        what = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                ">": "block scalars"}.get(text[0], "reserved indicators")
        raise YAMLSubsetError(f"{what} are not read ({text!r})", lineno)
    if text.startswith("? "):
        raise YAMLSubsetError("complex keys are not read", lineno)


@dataclasses.dataclass
class _Line:
    lineno: int
    indent: int
    text: str


def _flow(text: str, pos: int, lineno: int):
    """One flow node at ``text[pos]`` -> (value, position after it)."""
    n = len(text)
    while pos < n and text[pos] in " \t\n":
        pos += 1
    if pos >= n:
        raise _Unclosed("a flow collection that does not close", lineno)
    c = text[pos]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items = [] if c == "[" else {}
        pos += 1
        while True:
            while pos < n and text[pos] in " \t\n":
                pos += 1
            if pos >= n:
                raise _Unclosed("a flow collection that does not close", lineno)
            if text[pos] == close:
                return items, pos + 1
            if c == "[":
                value, pos = _flow(text, pos, lineno)
                while pos < n and text[pos] in " \t\n":
                    pos += 1
                if pos < n and text[pos] == ":":
                    raise YAMLSubsetError("single-pair mappings inside a flow sequence "
                                          "are not read", lineno)
                items.append(value)
            else:
                key, pos = _flow(text, pos, lineno)
                while pos < n and text[pos] in " \t\n":
                    pos += 1
                if pos < n and text[pos] == ":":
                    value, pos = (None, pos + 1) if pos + 1 < n and text[pos + 1] in ",}" \
                        else _flow(text, pos + 1, lineno)
                else:
                    value = None
                items[key] = value
            while pos < n and text[pos] in " \t\n":
                pos += 1
            if pos < n and text[pos] == ",":
                pos += 1
            elif pos >= n:
                raise _Unclosed("a flow collection that does not close", lineno)
            elif text[pos] != close:
                raise YAMLSubsetError(f"expected ',' or {close!r} in a flow collection",
                                      lineno)
    if c in "'\"":
        return _quoted(text, pos, lineno)
    if c in "]}":
        raise YAMLSubsetError(f"unexpected {c!r}", lineno)
    _check_plain(text[pos:], lineno)
    end = pos
    while end < n and text[end] not in _FLOW_END and not (
            text[end] == ":" and (end + 1 == n or text[end + 1] in " \t\n,[]{}")):
        end += 1
    return resolve_plain(re.sub(r"[ \t]*\n[ \t]*", " ", text[pos:end].strip()), lineno), end


class _Parser:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    @staticmethod
    def is_seq(line: _Line) -> bool:
        return line.text == "-" or line.text.startswith("- ")

    @staticmethod
    def split_key(line: _Line):
        """A mapping entry ``key: rest`` -> (key, rest), or None."""
        text = line.text
        if text[0] in "'\"":
            key, end = _quoted(text, 0, line.lineno)
            rest = text[end:].lstrip(" \t")
            if rest == ":" or rest.startswith(": ") or rest.startswith(":\t"):
                return key, rest[1:].strip()
            return None
        if text[0] in "[{":
            return None
        _check_plain(text, line.lineno)
        m = re.search(r":(?:[ \t]|$)", text)
        if m is None:
            return None
        return (resolve_plain(text[:m.start()].rstrip(), line.lineno),
                text[m.end():].strip())

    def block(self):
        """The block node at the current line: a sequence, a mapping or a
        scalar / flow node."""
        line = self.peek()
        if self.is_seq(line):
            return self.sequence(line.indent)
        if self.split_key(line) is not None:
            return self.mapping(line.indent)
        self.i += 1
        return self.inline(line.text, line)

    def nested(self, indent: int, seq_at_same: bool):
        """The value of a key or dash with nothing after it on its line."""
        line = self.peek()
        if line is None or line.indent < indent:
            return None
        if line.indent > indent:
            return self.block()
        if seq_at_same and self.is_seq(line):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while (line := self.peek()) is not None and line.indent == indent:
            kv = self.split_key(line)
            if kv is None:
                raise YAMLSubsetError(f"expected a 'key: value' entry, got {line.text!r}",
                                      line.lineno)
            key, rest = kv
            self.i += 1
            out[key] = self.nested(indent, True) if rest == "" else self.inline(rest, line)
            nxt = self.peek()
            if nxt is not None and nxt.indent > indent:
                raise YAMLSubsetError("unexpected indentation (multi-line plain scalars "
                                      "are not read)", nxt.lineno)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while (line := self.peek()) is not None and line.indent == indent \
                and self.is_seq(line):
            rest = line.text[1:].lstrip(" ")
            if rest == "":
                self.i += 1
                out.append(self.nested(indent, False))
                continue
            # the item's text becomes a line of its own at its column
            col = indent + len(line.text) - len(rest)
            self.lines[self.i] = _Line(line.lineno, col, rest)
            out.append(self.block())
            nxt = self.peek()
            if nxt is not None and nxt.indent > indent:
                raise YAMLSubsetError("unexpected indentation", nxt.lineno)
        return out

    def inline(self, text: str, line: _Line):
        """A value that starts on ``line`` after its key or dash."""
        if text[0] in "[{":
            while True:         # a flow collection may run over the next lines
                try:
                    value, end = _flow(text, 0, line.lineno)
                    break
                except _Unclosed:
                    nxt = self.peek()
                    if nxt is None:
                        raise
                    text += "\n" + nxt.text
                    self.i += 1
            if text[end:].strip():
                raise YAMLSubsetError(f"text after a flow collection: "
                                      f"{text[end:].strip()!r}", line.lineno)
            return value
        if text[0] in "'\"":
            value, end = _quoted(text, 0, line.lineno)
            if text[end:].strip():
                raise YAMLSubsetError(f"text after a quoted scalar: {text[end:]!r}",
                                      line.lineno)
            return value
        _check_plain(text, line.lineno)
        if re.search(r":(?:[ \t]|$)", text):
            raise YAMLSubsetError(f"mapping values are not allowed here ({text!r})",
                                  line.lineno)
        return resolve_plain(text, line.lineno)


def safe_load(text: str):
    """YAML text in the subset -> its Python value, as ``yaml.safe_load``
    gives it."""
    lines, started = [], False
    for lineno, raw in enumerate(text.splitlines(), start=1):
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        if raw[indent:indent + 1] == "\t":
            raise YAMLSubsetError("a tab in the indentation", lineno)
        if indent == 0 and raw.startswith("%"):
            raise YAMLSubsetError("directives are not read", lineno)
        if indent == 0 and (raw.rstrip() == "---" or raw.startswith("--- ")):
            if started or lines:
                raise YAMLSubsetError("several documents are not read", lineno)
            started = True
            if _strip_comment(raw[3:], lineno).strip():
                raise YAMLSubsetError("content after '---' is not read", lineno)
            continue
        if indent == 0 and raw.rstrip() == "...":
            break
        lines.append(_Line(lineno, indent, _strip_comment(raw[indent:], lineno)))
    lines = [ln for ln in lines if ln.text]
    if not lines:
        return None
    parser = _Parser(lines)
    value = parser.block()
    rest = parser.peek()
    if rest is not None:
        raise YAMLSubsetError(f"unexpected content {rest.text!r}", rest.lineno)
    return value


def load_file(path: str):
    """:func:`safe_load` of a file's text."""
    with open(path, encoding="utf-8") as f:
        return safe_load(f.read())
