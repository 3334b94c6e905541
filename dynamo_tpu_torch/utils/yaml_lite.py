"""The port's YAML reader: ``safe_load`` for the subset of YAML this repo
writes (deployment recipes, chaos plans, runtime configs), where the JAX
package calls PyYAML, which the card's machine lacks.

What it reads, with the results ``yaml.safe_load`` gives for them:

* block mappings and block sequences (a sequence may sit at its parent
  key's indentation), flow mappings and flow sequences (``{tp: 8}``,
  ``[a, b]``, a trailing comma, a ``key`` without a value, a single pair
  inside a flow sequence, and a flow collection over several lines);
* plain, single-quoted and double-quoted scalars on one line; plain
  scalars resolve as YAML 1.1's resolver resolves them (null, bool, int
  in base 2, 8, 10, 16 and sexagesimal, float with ``.inf`` / ``.nan``),
  quoted ones stay strings;
* comments: on a line of their own, and after a value (a ``#`` after a
  space);
* one ``---`` before the document.

What it refuses, by name (``YamlError``): anchors, aliases, tags, block
scalars (``|``, ``>``), several documents in one stream, directives,
complex keys (``?``), merge keys, timestamps, plain or quoted scalars
over several lines, and tabs in indentation.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["YamlError", "safe_load"]


class YamlError(ValueError):
    """A document this reader refuses or cannot parse."""


# YAML 1.1's implicit resolvers, as PyYAML's SafeLoader registers them;
# the first that matches a plain scalar decides its type.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",]}"
#: YAML's white space inside a line (str.strip would also take "\xa0" and the
#: other Unicode spaces, which YAML reads as content)
_WS = " \t"


def _sexagesimal(value: str, cast) -> Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _resolve(s: str) -> Any:
    """A plain scalar's value, as YAML 1.1's resolver and SafeLoader's
    constructors give it."""
    if _BOOL.match(s):
        return _BOOLS[s.lower()]
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
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
    if s == "<<":
        raise YamlError("merge keys ('<<') are not read")
    if _NULL.match(s):
        return None
    if _TIMESTAMP.match(s):
        raise YamlError(f"timestamps are not read: {s!r}; quote the value")
    if s == "=":
        raise YamlError("value keys ('=') are not read")
    return s


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int):
        self.indent, self.text, self.no = indent, text, no


def _comment_at(text: str, i: int) -> bool:
    return text[i] == "#" and (i == 0 or text[i - 1] in " \t\n")


def _refuse_indicator(c: str, no: int) -> None:
    if c == "&":
        raise YamlError(f"line {no}: anchors are not read")
    if c == "*":
        raise YamlError(f"line {no}: aliases are not read")
    if c == "!":
        raise YamlError(f"line {no}: tags are not read")
    if c in "|>":
        raise YamlError(f"line {no}: block scalars ('|', '>') are not read")
    if c in "@`":
        raise YamlError(f"line {no}: {c!r} cannot start a plain scalar")


class _Parser:
    def __init__(self, text: str):
        self.lines: list[_Line] = []
        started = False
        for no, raw in enumerate(text.replace("\r\n", "\n").split("\n"), 1):
            body = raw.lstrip(" ")
            if not body.strip(_WS) or body.startswith("#"):
                continue
            if body[0] == "\t" or (raw[:len(raw) - len(body)].count("\t")):
                raise YamlError(f"line {no}: tabs in indentation are not read")
            indent = len(raw) - len(body)
            body = body.rstrip(_WS)
            if indent == 0 and body.startswith("%"):
                raise YamlError(f"line {no}: directives are not read")
            if indent == 0 and (body == "..." or body.startswith("... ")):
                raise YamlError(f"line {no}: several documents in one stream are not read")
            if indent == 0 and (body == "---" or body.startswith("--- ")
                                or body.startswith("---\t")):
                rest = body[3:].strip(_WS)
                if started or self.lines:
                    raise YamlError(f"line {no}: several documents in one stream "
                                    "are not read")
                started = True
                if rest and not rest.startswith("#"):
                    raise YamlError(f"line {no}: content on the '---' line is not read")
                continue
            self.lines.append(_Line(indent, body, no))

    # -- block context ---------------------------------------------------
    def document(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0].indent)
        if i < len(self.lines):
            ln = self.lines[i]
            raise YamlError(f"line {ln.no}: unexpected content at indentation {ln.indent}")
        return value

    @staticmethod
    def _is_seq(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def block(self, i: int, indent: int) -> tuple[Any, int]:
        ln = self.lines[i]
        if self._is_seq(ln.text):
            return self.sequence(i, ln.indent)
        if ln.text[0] == "?" and (len(ln.text) == 1 or ln.text[1] == " "):
            raise YamlError(f"line {ln.no}: complex keys ('?') are not read")
        if ln.text[0] not in "[{" and self._key(ln) is not None:
            return self.mapping(i, ln.indent)
        value, i = self.inline(ln.text, i)
        return value, i

    def sequence(self, i: int, indent: int) -> tuple[list, int]:
        out: list = []
        while i < len(self.lines):
            ln = self.lines[i]
            if ln.indent < indent:
                break
            if ln.indent > indent or not self._is_seq(ln.text):
                if ln.indent == indent:
                    break
                raise YamlError(f"line {ln.no}: bad indentation of a sequence entry")
            rest = ln.text[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                i += 1
                if i < len(self.lines) and self.lines[i].indent > indent:
                    value, i = self.block(i, self.lines[i].indent)
                else:
                    value = None
                out.append(value)
                continue
            # the entry's node starts on this line, at the column of ``rest``
            self.lines[i] = _Line(ln.indent + len(ln.text) - len(rest), rest, ln.no)
            value, i = self.block(i, self.lines[i].indent)
            out.append(value)
        return out, i

    def _key(self, ln: _Line) -> tuple[Any, str] | None:
        """(key, the text after ``: ``) when the line opens a mapping entry."""
        text = ln.text
        if text[0] in "\"'":
            key, end = _quoted(text, 0, ln.no)
            rest = text[end:].lstrip(" ")
            if rest == ":" or rest.startswith(": "):
                return key, rest[1:].strip(_WS)
            return None
        for j, c in enumerate(text):
            if _comment_at(text, j):
                return None
            if c == ":" and (j + 1 == len(text) or text[j + 1] in " \t"):
                raw = text[:j].rstrip(_WS)
                if raw:
                    _refuse_indicator(raw[0], ln.no)
                return _resolve(raw), text[j + 1:].strip(_WS)
        return None

    def mapping(self, i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines):
            ln = self.lines[i]
            if ln.indent < indent:
                break
            if ln.indent > indent:
                raise YamlError(f"line {ln.no}: bad indentation of a mapping entry")
            if self._is_seq(ln.text):
                break
            kv = self._key(ln)
            if kv is None:
                raise YamlError(f"line {ln.no}: expected 'key: value'")
            key, rest = kv
            if rest and not rest.startswith("#"):
                value, i = self.inline(rest, i)
            else:
                i += 1
                nxt = self.lines[i] if i < len(self.lines) else None
                if nxt is not None and (nxt.indent > indent or (
                        nxt.indent == indent and self._is_seq(nxt.text))):
                    value, i = self.block(i, nxt.indent)
                else:
                    value = None
            out[key] = value
        return out, i

    def inline(self, text: str, i: int) -> tuple[Any, int]:
        """The node that ``text`` (the end of line ``i``) starts: a flow
        collection, possibly over the next lines, or a scalar. Returns the
        index of the first line after it."""
        ln = self.lines[i]
        c = text[0]
        _refuse_indicator(c, ln.no)
        if self._is_seq(text):
            raise YamlError(f"line {ln.no}: sequence entries are not allowed here")
        if c in "[{":
            # join this line and every one after it; the flow parser reports
            # how far it read
            rest = [text] + [self.lines[k].text for k in range(i + 1, len(self.lines))]
            flow = _Flow("\n".join(rest), ln.no)
            value = flow.node()
            used = flow.s.count("\n", 0, flow.pos)
            tail = flow.s[flow.pos:].split("\n", 1)[0]
            if tail.strip(_WS) and not tail.strip(_WS).startswith("#"):
                raise YamlError(f"line {ln.no + used}: unexpected {tail.strip(_WS)!r} "
                                "after a flow collection")
            return value, self._after_node(i + used + 1, ln)
        if c in "\"'":
            value, end = _quoted(text, 0, ln.no)
            tail = text[end:].strip(_WS)
            if tail and not tail.startswith("#"):
                raise YamlError(f"line {ln.no}: unexpected {tail!r} after a quoted scalar")
            return value, self._after_node(i + 1, ln)
        end = len(text)
        for j in range(len(text)):
            if _comment_at(text, j):
                end = j
                break
            if text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " \t"):
                raise YamlError(f"line {ln.no}: mapping values are not allowed here")
        return _resolve(text[:end].rstrip(_WS)), self._after_node(i + 1, ln)

    def _after_node(self, i: int, ln: _Line) -> int:
        if i < len(self.lines) and self.lines[i].indent > ln.indent:
            raise YamlError(f"line {self.lines[i].no}: scalars over several lines "
                            "are not read")
        return i


def _quoted(s: str, i: int, no: int) -> tuple[str, int]:
    """The quoted scalar at ``s[i]``, and the index after its closing quote."""
    q = s[i]
    out: list[str] = []
    j = i + 1
    while True:
        if j >= len(s) or s[j] == "\n":
            raise YamlError(f"line {no}: quoted scalars over several lines are not read")
        c = s[j]
        if q == "'":
            if c == "'":
                if j + 1 < len(s) and s[j + 1] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(c)
            j += 1
            continue
        if c == '"':
            return "".join(out), j + 1
        if c == "\\":
            e = s[j + 1] if j + 1 < len(s) else ""
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[j + 2:j + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise YamlError(f"line {no}: bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
            else:
                raise YamlError(f"line {no}: unknown escape \\{e}"
                                if e not in ("", "\n") else
                                f"line {no}: quoted scalars over several lines are not read")
            continue
        out.append(c)
        j += 1


class _Flow:
    """A flow collection over a string (lines joined by newlines)."""

    def __init__(self, s: str, no: int):
        self.s, self.pos, self.no0 = s, 0, no

    @property
    def no(self) -> int:
        return self.no0 + self.s.count("\n", 0, self.pos)

    def skip(self) -> None:
        s = self.s
        while self.pos < len(s):
            c = s[self.pos]
            if c in " \t\n":
                self.pos += 1
            elif _comment_at(s, self.pos):
                nl = s.find("\n", self.pos)
                self.pos = len(s) if nl < 0 else nl
            else:
                break

    def peek(self) -> str:
        self.skip()
        return self.s[self.pos] if self.pos < len(self.s) else ""

    def node(self) -> Any:
        c = self.peek()
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in "\"'":
            value, self.pos = _quoted(self.s, self.pos, self.no)
            return value
        if not c:
            raise YamlError(f"line {self.no}: unclosed flow collection")
        _refuse_indicator(c, self.no)
        return _resolve(self.plain())

    def plain(self) -> str:
        s, start = self.s, self.pos
        j = start
        while j < len(s):
            c = s[j]
            if c in _FLOW_END or c == "\n":
                break
            if c == ":" and (j + 1 == len(s) or s[j + 1] in " \t\n" + _FLOW_END):
                break
            if _comment_at(s, j):
                break
            j += 1
        self.pos = j
        return s[start:j].rstrip(" \t")

    def _value_after_key(self, quoted: bool) -> tuple[bool, Any]:
        """After a key: (True, value) when ``:`` follows, else (False, None)."""
        c = self.peek()
        if c != ":":
            return False, None
        nxt = self.s[self.pos + 1] if self.pos + 1 < len(self.s) else ""
        if not (quoted or nxt in " \t\n" + _FLOW_END or nxt == ""):
            return False, None
        self.pos += 1
        if self.peek() in (",", "}", "]"):
            return True, None
        return True, self.node()

    def _key(self) -> tuple[Any, bool]:
        c = self.peek()
        if c == "?" and self.s[self.pos + 1:self.pos + 2] in (" ", "\n"):
            raise YamlError(f"line {self.no}: complex keys ('?') are not read")
        quoted = c in "\"'"
        return self.node(), quoted

    def seq(self) -> list:
        self.pos += 1
        out: list = []
        while True:
            c = self.peek()
            if c == "]":
                self.pos += 1
                return out
            if not c:
                raise YamlError(f"line {self.no}: unclosed flow sequence")
            item, quoted = self._key()
            paired, value = self._value_after_key(quoted)
            out.append({item: value} if paired else item)
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif not c:
                raise YamlError(f"line {self.no}: unclosed flow sequence")
            elif c != "]":
                raise YamlError(f"line {self.no}: expected ',' or ']' in a flow sequence")

    def map(self) -> dict:
        self.pos += 1
        out: dict = {}
        while True:
            c = self.peek()
            if c == "}":
                self.pos += 1
                return out
            if not c:
                raise YamlError(f"line {self.no}: unclosed flow mapping")
            key, quoted = self._key()
            _, value = self._value_after_key(quoted)
            out[key] = value
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif not c:
                raise YamlError(f"line {self.no}: unclosed flow mapping")
            elif c != "}":
                raise YamlError(f"line {self.no}: expected ',' or '}}' in a flow mapping")


def safe_load(stream: str | bytes) -> Any:
    """``yaml.safe_load`` for the subset in the module docstring."""
    if hasattr(stream, "read"):
        stream = stream.read()
    if isinstance(stream, bytes):
        stream = stream.decode("utf-8")
    if stream.startswith("\ufeff"):
        stream = stream[1:]
    return _Parser(stream).document()
