"""Structured output: token-level constrained decoding for JSON — copy of
``dynamo_tpu/engine/guided.py``.

The model program stays untouched: the grammar lives on the HOST as a
JSON pushdown automaton; each step it emits an allow-mask over the vocab,
which rides the dispatch as one bool operand (the JAX engine's additive
0 / -1e30 mask, engine/engine.py) — the step program keeps its static
shapes and its model path.

Two request modes (protocols/openai.py ``response_format``):
- ``json_object`` — any syntactically valid JSON value.
- ``json_schema`` — additionally enforces a schema SUBSET: ``type`` on
  every node, object ``properties`` (key membership + per-key value
  schemas) with ``required`` completion gating, ``items`` for arrays,
  and string ``enum``. Unsupported keywords are ignored (the output is
  then a superset of the schema's language — never an invalid JSON).

Mechanics: ``JsonMachine`` consumes characters; a token is allowed iff
feeding its decoded text keeps the machine alive. ``TokenMasker`` builds
the per-step [V] allow-mask by trial-feeding every vocab piece, memoized
by the machine's state signature — the signature collapses equivalent
states (e.g. any position inside an unconstrained string), so steady-state
masking is a dict hit. EOS is allowed exactly when the machine is in an
accepting state (a complete top-level value).

Guided sequences decode UNPIPELINED (the mask for token t needs token
t-1 on the host) and are excluded from fused windows and speculative
verify — the engine partitions them into their own masked batches.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("guided")

_WS = " \t\n\r"
_DIGITS = "0123456789"
# Structural whitespace is bounded per run (progress forcing): a random
# model under a grammar that admits unlimited inter-token whitespace would
# happily spend its whole budget on newlines and never complete a document.
# Two consecutive blanks cover every sane emission style; pretty-printers
# with deeper indentation are outside the guided-decode contract.
_MAX_WS = 2
# Modes where whitespace is structural (between tokens) rather than string
# content — only these count against the run bound.
_WS_MODES = frozenset(
    ("done", "value", "obj_open", "colon", "obj_post", "key_open", "arr_post"))
# ONE canonical empty schema: signatures key sub-schemas by object identity
# (the schema tree is shared across machine clones), so the fallback must
# be a stable singleton — a fresh {} per transition would defeat the mask
# cache and risk id-reuse collisions.
_EMPTY: dict = {}


class Reject(Exception):
    pass


class _Frame:
    """One container on the stack: an object or array, plus its schema."""

    __slots__ = ("kind", "schema", "seen", "pending_key")

    def __init__(self, kind: str, schema: dict | None):
        self.kind = kind                  # "obj" | "arr"
        self.schema = schema if schema else _EMPTY
        self.seen: tuple[str, ...] = ()   # object keys already emitted
        self.pending_key: str | None = None

    def clone(self) -> "_Frame":
        f = _Frame(self.kind, self.schema)
        f.seen, f.pending_key = self.seen, self.pending_key
        return f


def _value_starts(schema: dict | None) -> str:
    """Characters that may start a value of the schema's type(s)."""
    t = (schema or {}).get("type")
    if isinstance(t, list):
        return "".join(_value_starts({**schema, "type": x}) for x in t)
    if (schema or {}).get("enum") is not None:
        # string enums only (subset); values start with a quote
        return '"'
    return {
        None: '{["-0123456789tfn',
        "object": "{",
        "array": "[",
        "string": '"',
        "number": "-" + _DIGITS,
        "integer": "-" + _DIGITS,
        "boolean": "tf",
        "null": "n",
    }.get(t, '{["-0123456789tfn')


class JsonMachine:
    """Character-level JSON automaton with optional schema constraints.

    mode ∈ value | str | str_esc | key | key_esc | colon | obj_open |
    obj_post | arr_post | num | lit | done. ``feed`` mutates; use
    ``clone`` for trial runs.
    """

    __slots__ = ("mode", "stack", "schema", "partial", "lit_rest", "num_state",
                 "ws_run")

    def __init__(self, schema: dict | None = None):
        self.mode = "value"
        self.stack: list[_Frame] = []
        self.schema = schema if schema else _EMPTY  # schema of the value being read
        self.partial = ""                 # current string/key content
        self.lit_rest = ""                # remaining literal chars
        self.num_state = ""               # coarse number validity state
        self.ws_run = 0                   # consecutive structural whitespace

    def clone(self) -> "JsonMachine":
        m = JsonMachine.__new__(JsonMachine)
        m.mode, m.schema = self.mode, self.schema
        m.partial, m.lit_rest, m.num_state = self.partial, self.lit_rest, self.num_state
        m.ws_run = self.ws_run
        m.stack = [f.clone() for f in self.stack]
        return m

    # -- signature for mask memoization ---------------------------------
    def signature(self) -> tuple:
        """Collapses states with identical allowed-token sets. The partial
        string matters only under prefix constraints (keys / enums). Every
        frame on the stack contributes (kind, schema, seen): two stacks that
        agree only at the top can still differ on which closers are legal
        (e.g. an outer object with pending required keys vs. one without) —
        keying by the top frame alone reused wrong masks across them."""
        frames = tuple((f.kind, id(f.schema), f.seen) for f in self.stack)
        partial = self.partial if self._candidates() is not None else ""
        return (self.mode, id(self.schema), frames, partial,
                self.lit_rest, self.num_state, self.ws_run)

    # -- constraints ----------------------------------------------------
    def _candidates(self) -> list[str] | None:
        """Full-string candidates constraining the current string, if any."""
        if self.mode in ("key", "key_esc"):
            props = (self.stack[-1].schema or {}).get("properties")
            if isinstance(props, dict):
                seen = self.stack[-1].seen
                return [k for k in props if k not in seen]
            return None
        if self.mode in ("str", "str_esc"):
            enum = (self.schema or {}).get("enum")
            if isinstance(enum, list) and all(isinstance(x, str) for x in enum):
                return list(enum)
        return None

    def _key_value_schema(self, key: str) -> dict:
        props = (self.stack[-1].schema or _EMPTY).get("properties") or _EMPTY
        sub = props.get(key)
        return sub if isinstance(sub, dict) else _EMPTY

    # -- feeding --------------------------------------------------------
    def feed(self, ch: str) -> None:
        """Consume one character or raise Reject."""
        if ch in _WS and self.mode in _WS_MODES:
            if self.ws_run >= _MAX_WS:
                raise Reject
            self.ws_run += 1
            return
        self.ws_run = 0
        m = self.mode
        if m == "done":
            if ch in _WS:
                return
            raise Reject
        if m == "value":
            if ch in _WS:
                return
            if ch not in _value_starts(self.schema):
                raise Reject
            if ch == "{":
                self.stack.append(_Frame("obj", self.schema))
                self.mode = "obj_open"
            elif ch == "[":
                self.stack.append(_Frame("arr", self.schema))
                self.mode = "value"
                # empty array: ']' is legal where a first element may start
                self.schema = self._items_schema()
            elif ch == '"':
                self.mode, self.partial = "str", ""
            elif ch in "-" + _DIGITS:
                self.mode = "num"
                self.num_state = "int" if ch in _DIGITS else "sign"
            elif ch == "t":
                self.mode, self.lit_rest = "lit", "rue"
            elif ch == "f":
                self.mode, self.lit_rest = "lit", "alse"
            elif ch == "n":
                self.mode, self.lit_rest = "lit", "ull"
            return
        if m in ("str", "key"):
            cands = self._candidates()
            if ch == '"':
                if cands is not None and self.partial not in cands:
                    raise Reject
                if m == "key":
                    self.stack[-1].pending_key = self.partial
                    self.mode = "colon"
                else:
                    self._value_done()
                return
            if ch == "\\":
                # Constrained strings (keys / enums) exclude escapes (see
                # *_esc below); rejecting the backslash HERE keeps the next
                # mask non-empty — deferring to the esc mode would be a
                # dead end where every escape char is rejected.
                if cands is not None:
                    raise Reject
                self.mode = m + "_esc"
                return
            if ord(ch) < 0x20:
                raise Reject
            nxt = self.partial + ch
            if cands is not None and not any(c.startswith(nxt) for c in cands):
                raise Reject
            self.partial = nxt
            return
        if m in ("str_esc", "key_esc"):
            # \u escapes are excluded in v1 (validating the 4-hex tail
            # would need more states; a truncated \u would emit invalid
            # JSON) — the simple escapes cover the machine's guarantees.
            if ch not in '"\\/bfnrt':
                raise Reject
            # escapes inside constrained strings would need decoding to
            # match candidates — disallow there, allow in free strings
            if self._candidates() is not None:
                raise Reject
            self.mode = m[:-4]
            self.partial += "?"  # decoded char; content is free-form
            return
        if m == "obj_open":
            if ch in _WS:
                return
            if ch == "}":
                self._object_close()
                return
            if ch == '"':
                self.mode, self.partial = "key", ""
                return
            raise Reject
        if m == "colon":
            if ch in _WS:
                return
            if ch == ":":
                frame = self.stack[-1]
                frame.seen = (*frame.seen, frame.pending_key or "")
                self.schema = self._key_value_schema(frame.pending_key or "")
                frame.pending_key = None
                self.mode = "value"
                return
            raise Reject
        if m == "obj_post":
            if ch in _WS:
                return
            if ch == ",":
                # A keyed object with every property already emitted has no
                # legal next key — the comma itself is the dead end, reject
                # it so the mask still contains the closing brace.
                props = (self.stack[-1].schema or _EMPTY).get("properties")
                if isinstance(props, dict) and \
                        all(k in self.stack[-1].seen for k in props):
                    raise Reject
                self.mode = "key_open"
                return
            if ch == "}":
                self._object_close()
                return
            raise Reject
        if m == "key_open":
            if ch in _WS:
                return
            if ch == '"':
                self.mode, self.partial = "key", ""
                return
            raise Reject
        if m == "arr_post":
            if ch in _WS:
                return
            if ch == ",":
                self.mode = "value"
                self.schema = self._items_schema()
                return
            if ch == "]":
                self.stack.pop()
                self._value_done()
                return
            raise Reject
        if m == "num":
            ns = self.num_state
            if ch in _DIGITS:
                self.num_state = {"sign": "int", "dot": "frac", "exp": "expd",
                                  "expsign": "expd"}.get(ns, ns)
                return
            if ch == "." and ns == "int":
                self.num_state = "dot"
                return
            if ch in "eE" and ns in ("int", "frac"):
                self.num_state = "exp"
                return
            if ch in "+-" and ns == "exp":
                self.num_state = "expsign"
                return
            if ns in ("int", "frac", "expd"):
                # number complete; the delimiter belongs to the parent
                self._value_done()
                self.feed(ch)
                return
            raise Reject
        if m == "lit":
            if self.lit_rest and ch == self.lit_rest[0]:
                self.lit_rest = self.lit_rest[1:]
                if not self.lit_rest:
                    self._value_done()
                return
            raise Reject
        raise Reject  # pragma: no cover — unknown mode

    # ``]`` closes an empty array from "value" mode; special-case it.
    def _items_schema(self) -> dict:
        top = self.stack[-1] if self.stack else None
        if top is not None and top.kind == "arr":
            items = (top.schema or _EMPTY).get("items")
            return items if isinstance(items, dict) else _EMPTY
        return _EMPTY

    def _object_close(self) -> None:
        frame = self.stack[-1]
        req = (frame.schema or {}).get("required") or []
        if any(k not in frame.seen for k in req):
            raise Reject
        self.stack.pop()
        self._value_done()

    def _value_done(self) -> None:
        """A value finished; return to the parent context. Scalar scratch
        state is reset here: a stale num_state/lit_rest would otherwise leak
        into the signature of every later state at the same stack shape and
        alias distinct grammar states in the mask cache."""
        self.num_state = ""
        self.lit_rest = ""
        if not self.stack:
            self.mode = "done"
            return
        top = self.stack[-1]
        self.mode = "obj_post" if top.kind == "obj" else "arr_post"
        self.schema = top.schema

    def feed_str(self, s: str) -> None:
        for ch in s:
            # "]" while expecting a first array element closes the array
            if ch == "]" and self.mode == "value" and self.stack \
                    and self.stack[-1].kind == "arr":
                self.ws_run = 0
                self.stack.pop()
                self._value_done()
                continue
            self.feed(ch)

    @property
    def complete(self) -> bool:
        if self.mode == "done":
            return True
        # a bare top-level number can only complete at EOS
        return (self.mode == "num" and not self.stack
                and self.num_state in ("int", "frac", "expd"))


class TokenMasker:
    """Per-sequence grammar state + vocab mask computation.

    ``pieces`` is the engine-wide token-id → text table; masks are
    memoized per machine signature across ALL sequences via the shared
    ``cache`` (states recur heavily — e.g. every position inside a free
    string shares one signature)."""

    def __init__(self, pieces: list[str], eos_ids: list[int],
                 schema: dict | None, cache: dict | None = None):
        self.pieces = pieces
        self.eos_ids = [e for e in eos_ids if e is not None]
        self.machine = JsonMachine(schema)
        self.cache = cache if cache is not None else {}

    @classmethod
    def parse_schema(cls, response_format: dict | None) -> dict | None:
        """OpenAI response_format → schema dict (None = unconstrained)."""
        if not response_format:
            return None
        kind = response_format.get("type")
        if kind == "json_object":
            return {}
        if kind == "json_schema":
            js = response_format.get("json_schema") or {}
            schema = js.get("schema") if isinstance(js, dict) else None
            return schema if isinstance(schema, dict) else {}
        return None

    def mask(self) -> np.ndarray:
        """bool[V] — True where the token keeps the grammar alive."""
        sig = self.machine.signature()
        hit = self.cache.get(sig)
        if hit is not None:
            return hit
        v = len(self.pieces)
        out = np.zeros((v,), bool)
        complete = self.machine.complete
        for tid, piece in enumerate(self.pieces):
            if not piece:
                continue
            trial = self.machine.clone()
            try:
                trial.feed_str(piece)
            except Reject:
                continue
            out[tid] = True
        for e in self.eos_ids:
            if 0 <= e < v:
                out[e] = complete
        if not out.any():
            # Dead end (shouldn't happen for valid grammars): allow EOS so
            # the stream terminates instead of sampling from -inf logits.
            log.warning("guided mask is empty; allowing EOS")
            for e in self.eos_ids:
                if 0 <= e < v:
                    out[e] = True
        self.cache[sig] = out
        return out

    def advance(self, token_id: int) -> None:
        if token_id in self.eos_ids:
            return
        piece = self.pieces[token_id] if 0 <= token_id < len(self.pieces) else ""
        try:
            self.machine.feed_str(piece)
        except Reject:
            # The mask should have prevented this; log and freeze (all
            # further masks will allow EOS only via the dead-end path).
            log.error("guided decode emitted a rejected token %d %r",
                      token_id, piece)

    @property
    def complete(self) -> bool:
        return self.machine.complete


def validate_json_output(text: str, schema: dict | None = None) -> Any:
    """Test helper: parse and (subset-)check an emitted document."""
    doc = json.loads(text)

    def check(node, sch):
        if not isinstance(sch, dict):
            return
        t = sch.get("type")
        if t == "object":
            assert isinstance(node, dict)
            for k in sch.get("required") or []:
                assert k in node, f"missing required {k}"
            props = sch.get("properties") or {}
            for k, v in node.items():
                assert not props or k in props, f"unexpected key {k}"
                check(v, props.get(k, {}))
        elif t == "array":
            assert isinstance(node, list)
            for item in node:
                check(item, sch.get("items", {}))
        elif t == "string":
            assert isinstance(node, str)
            if sch.get("enum"):
                assert node in sch["enum"]
        elif t in ("number", "integer"):
            assert isinstance(node, (int, float)) and not isinstance(node, bool)
        elif t == "boolean":
            assert isinstance(node, bool)
        elif t == "null":
            assert node is None

    check(doc, schema)
    return doc
