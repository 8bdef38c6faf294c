"""A YAML reader and writer for configs (the port imports no ``yaml``).

``load(text, name)`` reads the subset of YAML that config files and
dumped configs use:

* block mappings and sequences (sequences under a key may sit at the
  key's own indentation), and flow ``{...}`` / ``[...]`` collections
  over one or more lines;
* plain, single-quoted and double-quoted scalars, over one or more lines
  (folded as YAML folds them), with every escape of double quotes;
* comments, one optional ``---`` and ``...``, anchors ``&a`` and
  aliases ``*a``; line breaks LF, CR LF, CR and NEL.

Plain scalars resolve as PyYAML's ``SafeLoader`` resolves them (YAML
1.1): ``1e-3`` stays a string while ``1.0e-3``, ``.5`` and ``1_000`` are
numbers, ``0x10`` is 16 and ``010`` is 8, ``yes``, ``on`` and ``True``
are true, ``~``, ``null`` and an empty value are ``None``, a date is a
``datetime.date``.  Whatever lies outside the subset raises
``YamlError`` naming the line: tags, directives, several documents,
merge keys ``<<``, complex keys ``?``, block scalars ``|`` and ``>``,
the separators U+2028 and U+2029 written raw.

``dump(data)`` writes dicts, lists, strings, numbers, bools and None in
block style; what it writes reads back equal, here and with PyYAML.
"""

from __future__ import annotations

import datetime
import math
import re
from typing import Any, Dict, List

__all__ = ["YamlError", "load", "load_file", "dump"]


class YamlError(ValueError):
    """Input outside the subset, or not YAML."""


# --------------------------------------------------------------------------- #
# Scalar resolution (PyYAML's implicit resolvers of the SafeLoader)
# --------------------------------------------------------------------------- #

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
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
_TIMESTAMP = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)
    -(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])
    :(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]$")


def _sexagesimal(value: str, kind):
    out = kind(0)
    for part in value.split(":"):
        out = out * 60 + kind(part)
    return out


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _timestamp(value: str):
    m = _TIMESTAMP.match(value)
    year, month, day = (int(m[k]) for k in ("year", "month", "day"))
    if not m["hour"]:
        return datetime.date(year, month, day)
    frac = 0
    if m["fraction"]:
        frac = int(m["fraction"][:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]),
                                   minutes=int(m["tz_minute"] or 0))
        tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m["hour"]),
                             int(m["minute"]), int(m["second"]), frac,
                             tzinfo=tz)


def resolve_plain(value: str) -> Any:
    """The value of the plain scalar ``value`` under YAML 1.1's implicit
    types, as PyYAML's ``SafeLoader`` gives it."""
    if value in _BOOL:
        return _BOOL[value]
    if value in _NULL:
        return None
    if _FLOAT.match(value):
        return _float(value)
    if _INT.match(value):
        return _int(value)
    m = _TIMESTAMP.match(value)
    if m and (m["hour"] or _DATE.match(value)):
        return _timestamp(value)
    if value == "<<":
        raise YamlError("merge keys '<<' are outside the subset")
    if value == "=":
        raise YamlError("the value key '=' is outside the subset")
    return value


# --------------------------------------------------------------------------- #
# Reader
# --------------------------------------------------------------------------- #

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"
_END = "\0"  # what ``_Reader.ch`` reads past the end


class _Reader:
    def __init__(self, text: str, name: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        # YAML 1.1's line breaks: CR LF, CR and NEL read as LF
        self.s = text.replace("\r\n", "\n").replace("\r", "\n").replace(
            "\x85", "\n")
        self.n = len(self.s)
        self.i = 0
        self.name = name
        self.anchors: Dict[str, Any] = {}
        if _END in self.s:
            self.error("a NUL character", self.s.index(_END))
        for sep in ("\u2028", "\u2029"):
            if sep in self.s:
                self.error("unicode line and paragraph separators are "
                           "outside the subset", self.s.index(sep))

    # -- positions ---------------------------------------------------------- #
    def error(self, msg: str, at=None):
        at = self.i if at is None else at
        line = self.s.count("\n", 0, at) + 1
        raise YamlError(f"{self.name}, line {line}: {msg}")

    def col(self, at=None) -> int:
        at = self.i if at is None else at
        return at - (self.s.rfind("\n", 0, at) + 1)

    def ch(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < self.n else _END

    def sep(self, k: int = 0) -> bool:
        """The character at offset k ends a token: blank, newline or end."""
        return self.ch(k) in (_END, " ", "\t", "\n")

    def marker(self) -> bool:
        """A document marker ``---`` or ``...`` at the start of a line."""
        return self.col() == 0 and self.s[self.i:self.i + 3] in (
            "---", "...") and self.sep(3)

    def skip_inline(self):
        while self.ch() in (" ", "\t"):
            self.i += 1

    def at_line_end(self) -> bool:
        """Only blanks and a comment are left on this line."""
        self.skip_inline()
        return self.ch() in (_END, "\n", "#")

    def next_content(self) -> int:
        """Move to the next character that is not blank, a line break or
        in a comment; its column, or -1 at the end."""
        while self.i < self.n:
            c = self.s[self.i]
            if c == " ":
                self.i += 1
            elif c == "\t":
                start = self.s.rfind("\n", 0, self.i) + 1
                j = self.i
                while j < self.n and self.s[j] in " \t":
                    j += 1
                if self.s[start:self.i].strip(" \t") == "" and j < self.n \
                        and self.s[j] not in "\n#":
                    self.error("a tab in indentation")
                self.i += 1
            elif c == "\n":
                self.i += 1
            elif c == "#":
                end = self.s.find("\n", self.i)
                self.i = self.n if end < 0 else end
            else:
                return self.col()
        return -1

    def end_line(self):
        if not self.at_line_end():
            self.error(f"unexpected {self.ch()!r} after a value")

    # -- document ----------------------------------------------------------- #
    def document(self) -> Any:
        col = self.next_content()
        if col == 0 and self.ch() == "%":
            self.error("directives are outside the subset")
        value = None
        if col >= 0 and self.marker() and self.s.startswith("---", self.i):
            self.i += 3
            value = self.after_indicator(-1)
        elif col >= 0 and not self.marker():
            value = self.node_at(col, -1)
        col = self.next_content()
        if col == 0 and self.marker() and self.s.startswith("...", self.i):
            self.i += 3
            col = self.next_content()
        if col >= 0:
            if self.marker():
                self.error("several documents are outside the subset")
            self.error(f"unexpected {self.ch()!r}")
        return value

    def after_indicator(self, parent: int) -> Any:
        """The node after ``---``, ``key:`` or ``-`` (the indicator
        consumed): on this line, or on later lines indented past
        ``parent``; ``None`` when there is none."""
        if not self.at_line_end():
            return self.node_at(self.col(), parent)
        col = self.next_content()
        if col > parent and not self.marker():
            return self.node_at(col, parent)
        return None

    # -- block nodes -------------------------------------------------------- #
    def node_at(self, col: int, parent: int) -> Any:
        """The node starting here, at column ``col`` (the indentation of a
        block collection that starts here), inside a block of indentation
        ``parent``."""
        c = self.ch()
        if c == "&":
            name = self.anchor_name()
            if self.at_line_end():
                value = self.after_indicator(parent)
                if value is None and self.next_content() == parent \
                        and self.seq_entry():
                    value = self.block_sequence(parent)
            else:
                if self.mapping_key_here():
                    self.error("an anchor on a block mapping's first key is "
                               "outside the subset")
                value = self.node_at(self.col(), parent)
            self.anchors[name] = value
            return value
        if c == "!":
            self.error("tags are outside the subset")
        if c == "?" and self.sep(1):
            self.error("complex keys '?' are outside the subset")
        if self.seq_entry():
            return self.block_sequence(col)
        if self.mapping_key_here():
            return self.block_mapping(col)
        value = self.flow_node(parent, flow=False)
        self.end_line()
        return value

    def seq_entry(self) -> bool:
        return self.ch() == "-" and self.sep(1)

    def block_sequence(self, col: int) -> List[Any]:
        out = []
        while True:
            self.i += 1  # '-'
            out.append(self.after_indicator(col))
            nxt = self.next_content()
            if nxt == col and self.seq_entry() and not self.marker():
                continue
            if nxt > col:
                self.error("bad indentation of a sequence entry")
            return out

    def mapping_key_here(self) -> bool:
        """A simple key and ``:`` start here (without moving)."""
        start = self.i
        try:
            c = self.ch()
            if c in "'\"":
                line = self.s.count("\n", 0, self.i)
                self.quoted(-1)
                if self.s.count("\n", 0, self.i) != line:
                    return False
            elif c in "[{*&!|>%@`" or (c in "-?:" and self.sep(1)) or c in (
                    _END, "\n", "#"):
                return False
            else:
                self.plain_line(flow=False)
            self.skip_inline()
            return self.ch() == ":" and self.sep(1)
        except YamlError:
            return False
        finally:
            self.i = start

    def block_mapping(self, col: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while True:
            at = self.i
            if self.ch() == "?" and self.sep(1):
                self.error("complex keys '?' are outside the subset")
            if not self.mapping_key_here():
                self.error("expected a mapping key")
            if self.ch() in "'\"":
                key = self.quoted(-1)
            else:
                key = self.plain_value(self.plain_line(flow=False), at)
            self.skip_inline()
            self.i += 1  # ':'
            out[self.hashable(key, at)] = self.map_value(col)
            nxt = self.next_content()
            if nxt == col and not self.marker():
                if self.seq_entry():
                    self.error("a sequence entry where a mapping key was "
                               "expected")
                continue
            if nxt > col:
                self.error("bad indentation of a mapping entry")
            return out

    def map_value(self, col: int) -> Any:
        """A mapping value: on the key's line, indented past the key on
        later lines, or a sequence at the key's own indentation."""
        if not self.at_line_end():
            if self.seq_entry():
                self.error("a block sequence cannot start on its key's line")
            if self.ch() == "&":
                return self.node_at(self.col(), col)
            value = self.flow_node(col, flow=False)
            self.end_line()
            return value
        nxt = self.next_content()
        if nxt == col and self.seq_entry() and not self.marker():
            return self.block_sequence(col)
        if nxt > col:
            return self.node_at(nxt, col)
        return None

    def hashable(self, key, at):
        try:
            hash(key)
        except TypeError:
            self.error("a mapping key that is a collection", at)
        return key

    # -- flow nodes --------------------------------------------------------- #
    def anchor_name(self) -> str:
        self.i += 1
        start = self.i
        while self.ch() not in (_END, " ", "\t", "\n") \
                and self.ch() not in _FLOW_END:
            self.i += 1
        if self.i == start:
            self.error("an anchor or alias without a name")
        return self.s[start:self.i]

    def flow_node(self, parent: int, flow: bool) -> Any:
        """A scalar, alias or flow collection (``flow``: inside one)."""
        c = self.ch()
        if c == "&":
            name = self.anchor_name()
            self.skip_flow_space(parent) if flow else self.skip_inline()
            value = self.flow_node(parent, flow)
            self.anchors[name] = value
            return value
        if c == "*":
            at = self.i
            name = self.anchor_name()
            if name not in self.anchors:
                self.error(f"alias *{name} names no anchor", at)
            return self.anchors[name]
        if c == "!":
            self.error("tags are outside the subset")
        if c in "|>":
            self.error("block scalars '|' and '>' are outside the subset")
        if c == "[":
            return self.flow_sequence(parent)
        if c == "{":
            return self.flow_mapping(parent)
        if c in "'\"":
            return self.quoted(parent)
        if c in "%@`" or (c in "-?:" and self.sep(1)) or (flow and c in
                                                           "]},"):
            self.error(f"unexpected {c!r}")
        at = self.i
        return self.plain_value(self.plain(parent, flow), at)

    def plain_value(self, text: str, at: int) -> Any:
        try:
            return resolve_plain(text)
        except YamlError as e:
            self.error(str(e), at)

    def skip_flow_space(self, parent: int):
        """Blanks, line breaks and comments inside a flow collection."""
        if self.next_content() < 0:
            self.error("a flow collection is not closed")
        if self.marker():
            self.error("a document marker inside a flow collection")

    def flow_sequence(self, parent: int) -> List[Any]:
        self.i += 1
        out = []
        while True:
            self.skip_flow_space(parent)
            if self.ch() == "]":
                self.i += 1
                return out
            at = self.i
            if self.ch() == "?" and self.sep(1):
                self.error("complex keys '?' are outside the subset")
            item = self.flow_node(parent, flow=True)
            self.skip_flow_space(parent)
            if self.ch() == ":":  # a single-pair mapping
                self.i += 1
                self.skip_flow_space(parent)
                value = None if self.ch() in ",]" \
                    else self.flow_node(parent, flow=True)
                item = {self.hashable(item, at): value}
                self.skip_flow_space(parent)
            out.append(item)
            if self.ch() == ",":
                self.i += 1
            elif self.ch() != "]":
                self.error(f"expected ',' or ']', found {self.ch()!r}")

    def flow_mapping(self, parent: int) -> Dict[Any, Any]:
        self.i += 1
        out: Dict[Any, Any] = {}
        while True:
            self.skip_flow_space(parent)
            if self.ch() == "}":
                self.i += 1
                return out
            at = self.i
            if self.ch() == "?" and self.sep(1):
                self.error("complex keys '?' are outside the subset")
            key = None if self.ch() == ":" else self.flow_node(parent,
                                                               flow=True)
            self.skip_flow_space(parent)
            value = None
            if self.ch() == ":":
                self.i += 1
                self.skip_flow_space(parent)
                if self.ch() not in ",}":
                    value = self.flow_node(parent, flow=True)
                    self.skip_flow_space(parent)
            out[self.hashable(key, at)] = value
            if self.ch() == ",":
                self.i += 1
            elif self.ch() != "}":
                self.error(f"expected ',' or '}}', found {self.ch()!r}")

    # -- scalars ------------------------------------------------------------ #
    def plain_line(self, flow: bool) -> str:
        """The part of a plain scalar on this line, from here."""
        start = end = self.i
        while True:
            c = self.ch()
            if c in (_END, "\n"):
                break
            if c in " \t":
                self.i += 1
                continue
            if c == "#" and self.s[self.i - 1] in " \t":
                break
            if c == ":" and (self.sep(1) or (flow and self.ch(1)
                                              in _FLOW_END)):
                break
            if flow and c in ",?[]{}":
                break
            self.i += 1
            end = self.i
        self.i = end
        return self.s[start:end]

    def plain(self, parent: int, flow: bool) -> str:
        """A plain scalar with its continuation lines (in a block, those
        indented past ``parent``), folded: one line break is a space, each further
        one a newline."""
        text = self.plain_line(flow)
        if not text:
            self.error(f"unexpected {self.ch()!r}")
        while True:
            save = self.i
            self.skip_inline()
            if self.ch() != "\n":
                self.i = save
                return text
            breaks = 0
            while self.ch() == "\n":
                self.i += 1
                breaks += 1
                while self.ch() in " \t":
                    self.i += 1
            c = self.ch()
            if (c in (_END, "#") or (not flow and self.col() <= parent)
                    or (self.col() == 0 and self.s[self.i:self.i + 3] in (
                        "---", "...") and self.sep(3))):
                self.i = save
                return text
            line = self.plain_line(flow)
            if not line:
                self.i = save
                return text
            text += (" " if breaks == 1 else "\n" * (breaks - 1)) + line

    def quoted(self, parent: int) -> str:
        """A single- or double-quoted scalar, folded over line breaks."""
        q = self.ch()
        at = self.i
        self.i += 1
        out: List[str] = []
        while True:
            c = self.ch()
            if c == _END:
                self.error("a quoted scalar is not closed", at)
            if c == q:
                if q == "'" and self.ch(1) == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if c == "\\" and q == '"':
                e = self.ch(1)
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    k = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + k]
                    if len(digits) != k or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.error("a bad hexadecimal escape")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + k
                elif e == "\n":
                    self.i += 2
                    self.fold_breaks(out, escaped=True)
                else:
                    self.error(f"an unknown escape \\{e}")
                continue
            if c in " \t":
                j = self.i
                while self.ch() in " \t":
                    self.i += 1
                if self.ch() != "\n":
                    out.append(self.s[j:self.i])
                continue
            if c == "\n":
                self.fold_breaks(out, escaped=False)
                continue
            out.append(c)
            self.i += 1

    def fold_breaks(self, out: List[str], escaped: bool):
        """At a line break inside a quoted scalar (after an escaped one
        when ``escaped``): the breaks and the next line's indentation."""
        breaks = 0
        while True:
            while self.ch() in " \t":
                self.i += 1
            if self.ch() != "\n":
                break
            self.i += 1
            breaks += 1
            if self.col() == 0 and self.s[self.i:self.i + 3] in (
                    "---", "...") and self.sep(3):
                self.error("a document marker inside a quoted scalar")
        if escaped:
            out.append("\n" * breaks)
        else:
            out.append(" " if breaks == 1 else "\n" * (breaks - 1))


def load(text: str, name: str = "<string>") -> Any:
    """The value of the YAML document ``text`` (one document, the subset
    in the module docstring); ``name`` appears in errors."""
    return _Reader(text, name).document()


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return load(f.read(), str(path))


# --------------------------------------------------------------------------- #
# Writer
# --------------------------------------------------------------------------- #

_PLAIN = re.compile(r"^[A-Za-z0-9_./$(~][A-Za-z0-9_./+$(){}~@=%^-]*"
                    r"(?: [A-Za-z0-9_./+$(){}~@=%^-]+)*$")


def _plain_ok(s: str) -> bool:
    if not _PLAIN.match(s) or s.startswith(("...", "---")):
        return False
    try:
        return resolve_plain(s) == s and isinstance(resolve_plain(s), str)
    except YamlError:
        return False


def _quote(s: str) -> str:
    out = ['"']
    for c in s:
        o = ord(c)
        if c == '"' or c == "\\":
            out.append("\\" + c)
        elif 0x20 <= o < 0x7f:
            out.append(c)
        elif o <= 0xff:
            out.append(f"\\x{o:02X}")
        elif o <= 0xffff:
            out.append(f"\\u{o:04X}")
        else:
            out.append(f"\\U{o:08X}")
    out.append('"')
    return "".join(out)


def scalar(v: Any) -> str:
    """``v`` (str, int, float, bool or None) as a one-line YAML scalar."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return v if _plain_ok(v) else _quote(v)
    raise TypeError(f"cannot write a {type(v).__name__} as YAML: {v!r}")


def _emit(v: Any, indent: int, out: List[str]):
    """``v`` after a key's ':' or a sequence's '-' (already written
    without a line break)."""
    pad = " " * indent
    if isinstance(v, dict) and v:
        for k, item in v.items():
            out.append(f"\n{pad}{scalar(k)}:")
            _emit(item, indent + 2, out)
    elif isinstance(v, (list, tuple)) and v:
        for item in v:
            out.append(f"\n{pad}-")
            _emit(item, indent + 2, out)
    elif isinstance(v, dict):
        out.append(" {}")
    elif isinstance(v, (list, tuple)):
        out.append(" []")
    else:
        out.append(" " + scalar(v))


def dump(data: Any) -> str:
    """``data`` (dicts with scalar keys, lists, tuples, strings, ints,
    floats, bools, None) as a YAML document in block style, keys in
    their order."""
    out: List[str] = []
    _emit(data, 0, out)
    text = "".join(out)
    return (text[1:] if text.startswith(("\n", " ")) else text) + "\n"
