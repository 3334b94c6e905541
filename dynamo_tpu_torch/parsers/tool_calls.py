"""Tool-call parsing: model-family formats → OpenAI tool_calls.

Fills the reference's tool-calling parser subsystem (reference:
lib/parsers/src/tool_calling/{parsers,config,json,pythonic}.rs) with the
same parser-name registry, redesigned as data-driven Python: each named
config describes the wire format a model family emits (start/end markers,
JSON key variants, or pythonic call syntax) and two generic engines (JSON,
pythonic) do the parsing.

Complete-message parsing (aggregate responses) and streaming detection
primitives (for the jail, parsers/jail.py) share the same configs:

- ``parse_tool_calls(text, cfg)`` → (calls, normal_text)
- ``match_start(text, cfg)``      → index where a call starts, or -1
- ``possible_start(text, cfg)``   → True if the text's tail could be the
  beginning of a start marker (the jail must withhold it)

Copy of ``dynamo_tpu/parsers/tool_calls.py``.
"""

from __future__ import annotations

import ast
import json
import re
import uuid
from dataclasses import dataclass, field

from dynamo_tpu_torch.utils.text import longest_partial_suffix


@dataclass
class ToolCall:
    """One parsed call; arguments is a JSON-encoded string (OpenAI shape)."""

    name: str
    arguments: str
    id: str = field(default_factory=lambda: f"call-{uuid.uuid4().hex[:24]}")

    def to_openai(self, index: int | None = None) -> dict:
        out = {
            "id": self.id,
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }
        if index is not None:
            out["index"] = index
        return out


@dataclass(frozen=True)
class ToolCallConfig:
    format: str = "json"                      # "json" | "pythonic"
    start_tokens: tuple[str, ...] = ()        # markers that open a call block
    # Matching closers, parallel to start_tokens ("" = to end of stream;
    # "]" with a start ending in "[" = bracket-balanced JSON array payload).
    end_tokens: tuple[str, ...] = ()
    name_keys: tuple[str, ...] = ("name",)
    args_keys: tuple[str, ...] = ("arguments", "parameters")
    # Accept a bare JSON object/array at the start of the message (no marker).
    bare_json: bool = False
    # Protocol framing removed from released normal text (harmony: stray
    # message terminators outside any channel segment). Withheld while a
    # partial match could still grow.
    strip_tokens: tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.start_tokens) != len(self.end_tokens):
            raise ValueError(
                "start_tokens and end_tokens must pair up "
                f"({len(self.start_tokens)} vs {len(self.end_tokens)})")


# Parser registry — same names as the reference's get_tool_parser_map()
# (lib/parsers/src/tool_calling/parsers.rs:24-39).
TOOL_PARSERS: dict[str, ToolCallConfig] = {
    "hermes": ToolCallConfig(
        start_tokens=("<tool_call>",), end_tokens=("</tool_call>",)),
    "nemotron_deci": ToolCallConfig(
        start_tokens=("<TOOLCALL>",), end_tokens=("</TOOLCALL>",)),
    "llama3_json": ToolCallConfig(
        start_tokens=("<|python_tag|>",), end_tokens=("<|eom_id|>",),
        bare_json=True),
    "mistral": ToolCallConfig(
        start_tokens=("[TOOL_CALLS]",), end_tokens=("",), bare_json=True),
    "phi4": ToolCallConfig(
        start_tokens=("functools[",), end_tokens=("]",)),
    "deepseek_v3_1": ToolCallConfig(
        start_tokens=("<｜tool▁calls▁begin｜>",),
        end_tokens=("<｜tool▁calls▁end｜>",)),
    "pythonic": ToolCallConfig(format="pythonic"),
    # gpt-oss harmony (reference: lib/parsers/src/tool_calling/harmony/):
    # commentary channels addressed to functions.NAME carry one JSON body
    # terminated by <|call|>. Pair with reasoning parser "gpt_oss", which
    # owns the analysis channel and strips final-channel framing.
    "harmony": ToolCallConfig(
        start_tokens=("<|channel|>commentary",), end_tokens=("<|call|>",),
        format="harmony",
        # a final-channel message may terminate with <|end|> outside any
        # commentary segment — framing, never content
        strip_tokens=("<|end|>", "<|return|>")),
    "default": ToolCallConfig(
        start_tokens=("<TOOLCALL>", "<|python_tag|>"), end_tokens=("</TOOLCALL>", ""),
        bare_json=True),
}


def get_tool_parser(name: str) -> ToolCallConfig:
    try:
        return TOOL_PARSERS[name]
    except KeyError:
        raise ValueError(
            f"unknown tool parser {name!r} (have: {sorted(TOOL_PARSERS)})"
        ) from None


# ---------------------------------------------------------------------------
# Streaming detection primitives
# ---------------------------------------------------------------------------

_PYTHONIC_RE = re.compile(r"\[\s*[A-Za-z_][\w.]*\s*\(")
# A string that could still grow into "[name(" — the jail must withhold it.
_PYTHONIC_PREFIX_RE = re.compile(r"\[\s*([A-Za-z_][\w.]*)?\s*\Z")


def match_start(text: str, cfg: ToolCallConfig) -> int:
    """Index of the first tool-call start in ``text``, or -1."""
    best = -1
    for tok in cfg.start_tokens:
        i = text.find(tok)
        if i >= 0 and (best < 0 or i < best):
            best = i
    if cfg.format == "pythonic":
        m = _PYTHONIC_RE.search(text)
        if m and (best < 0 or m.start() < best):
            best = m.start()
    if cfg.bare_json and best < 0:
        stripped = text.lstrip()
        if stripped[:1] in ("{", "["):
            return len(text) - len(stripped)
    return best


def strip_framing(text: str, cfg: ToolCallConfig) -> str:
    """Remove stray protocol framing tokens from normal text."""
    for t in cfg.strip_tokens:
        if t:
            text = text.replace(t, "")
    return text


def possible_start(text: str, cfg: ToolCallConfig) -> int:
    """Length of the trailing fragment of ``text`` that could be the prefix
    of a start marker OR of a strip token (0 = tail is definitely normal
    text). The jail withholds exactly this suffix."""
    longest = longest_partial_suffix(text, cfg.start_tokens + cfg.strip_tokens)
    if cfg.format == "pythonic":
        # "[", "[get", "[ get_weather " ... can still become "[name(" —
        # find the earliest such viable tail.
        for j in range(max(0, len(text) - 80), len(text)):
            if text[j] == "[" and _PYTHONIC_PREFIX_RE.fullmatch(text, j):
                longest = max(longest, len(text) - j)
                break
    return longest


def _balanced_end(text: str, open_pos: int) -> int:
    """Index just past the bracket that closes text[open_pos] ('[' or '{'),
    string-literal aware; -1 while unbalanced."""
    depth = 0
    in_str = False
    i = open_pos
    while i < len(text):
        c = text[i]
        if in_str:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    return -1


def find_call_end(text: str, start: int, cfg: ToolCallConfig) -> int:
    """Position just past a complete call that starts at ``start``; -1 if
    the call is still incomplete (stream must keep buffering)."""
    if cfg.format == "pythonic":
        m = _PYTHONIC_RE.match(text, start)
        return _balanced_end(text, start) if m else -1
    if cfg.format == "harmony":
        end, tok = _harmony_segment_end(text, start)
        return -1 if end < 0 else end + len(tok)
    for s_tok, e_tok in zip(cfg.start_tokens, cfg.end_tokens):
        if not text.startswith(s_tok, start):
            continue
        if s_tok.endswith("[") and e_tok == "]":
            # phi4-style: the payload is the JSON array opened by the
            # marker's own '[' — balance brackets, don't find() a ']'
            # that may belong to a nested array argument.
            return _balanced_end(text, start + len(s_tok) - 1)
        if e_tok:
            j = text.find(e_tok, start + len(s_tok))
            if j >= 0:
                return j + len(e_tok)
        return -1
    # Marker-to-EOF / bare JSON: complete only when the stream ends.
    return -1


# ---------------------------------------------------------------------------
# Complete parsing
# ---------------------------------------------------------------------------

def _calls_from_obj(obj, cfg: ToolCallConfig) -> list[ToolCall]:
    if isinstance(obj, list):
        out: list[ToolCall] = []
        for o in obj:
            out.extend(_calls_from_obj(o, cfg))
        return out
    if not isinstance(obj, dict):
        return []
    name = next((obj[k] for k in cfg.name_keys if k in obj), None)
    if not isinstance(name, str):
        # nested {"function": {...}} shape
        fn = obj.get("function")
        return _calls_from_obj(fn, cfg) if isinstance(fn, dict) else []
    args = next((obj[k] for k in cfg.args_keys if k in obj), {})
    if isinstance(args, str):
        arg_str = args
    else:
        arg_str = json.dumps(args or {})
    return [ToolCall(name=name, arguments=arg_str)]


def _parse_json_stream(segment: str, cfg: ToolCallConfig) -> tuple[list[ToolCall], int]:
    """Parse one-or-more JSON values from ``segment`` (objects, arrays, or
    whitespace/,;-separated sequences of them). Returns (calls, stop) where
    ``segment[stop:]`` was not consumed (trailing normal text)."""
    dec = json.JSONDecoder()
    calls: list[ToolCall] = []
    i, n = 0, len(segment)
    while i < n:
        j = i
        while j < n and segment[j] in " \t\r\n,;":
            j += 1
        if j >= n or segment[j] not in "{[":
            break
        try:
            obj, end = dec.raw_decode(segment, j)
        except json.JSONDecodeError:
            break
        found = _calls_from_obj(obj, cfg)
        if not found:
            break  # JSON but not a tool call: leave it (and the rest) alone
        calls.extend(found)
        i = end
    return calls, i


def _parse_pythonic(text: str) -> tuple[list[ToolCall], str | None]:
    m = _PYTHONIC_RE.search(text)
    if not m:
        return [], text or None
    end = _balanced_end(text, m.start())  # string-aware bracket matching
    if end < 0:
        return [], text or None
    try:
        tree = ast.parse(text[m.start():end].strip(), mode="eval")
    except SyntaxError:
        return [], text or None
    if not isinstance(tree.body, ast.List):
        return [], text or None
    calls: list[ToolCall] = []
    for node in tree.body.elts:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else ast.unparse(fn)
        args: dict = {}
        for kw in node.keywords:
            try:
                args[kw.arg] = ast.literal_eval(kw.value)
            except ValueError:
                args[kw.arg] = ast.unparse(kw.value)
        calls.append(ToolCall(name=name, arguments=json.dumps(args)))
    normal = (text[: m.start()] + text[end:]).strip()
    return calls, normal or None


# Commentary header: optional "to=RECIPIENT" — functions.* recipients are
# client tool calls; other recipients (python, browser.*) are builtin-tool
# traffic; absent = a user-visible preamble. Optional "<|constrain|>json".
_HARMONY_HEADER_RE = re.compile(
    r"<\|channel\|>commentary(?:\s+to=([\w.-]+))?\s*"
    r"(?:<\|constrain\|>\w+)?\s*<\|message\|>")

_HARMONY_TERMINATORS = ("<|call|>", "<|end|>")


def _harmony_segment_end(text: str, start: int) -> tuple[int, str]:
    """(index, token) of the earliest segment terminator at/after ``start``;
    (-1, "") if none — ONE copy of the scan, used by both the streaming
    jail (find_call_end) and the complete parser."""
    ends = [(j, t) for t in _HARMONY_TERMINATORS
            if (j := text.find(t, start)) >= 0]
    return min(ends) if ends else (-1, "")


def _parse_harmony(text: str) -> tuple[list[ToolCall], str | None]:
    """Harmony commentary channels: ``to=functions.X`` segments become
    client tool calls; other recipients (python, browser.*) are builtin
    tool traffic this server cannot execute — dropped, never surfaced as
    fake function calls; segments without ``to=`` are user-visible
    preambles (framing stripped, body kept). Segments terminate at
    <|call|> or <|end|>; stray terminators outside segments are framing.
    The gpt_oss reasoning parser already consumed the analysis channel and
    final-channel headers upstream."""
    calls: list[ToolCall] = []
    normal_parts: list[str] = []
    pos = 0
    while pos < len(text):
        m = _HARMONY_HEADER_RE.search(text, pos)
        if not m:
            normal_parts.append(text[pos:])
            break
        normal_parts.append(text[pos:m.start()])
        end, tok = _harmony_segment_end(text, m.end())
        if end < 0:
            end, tok = len(text), ""
        body = text[m.end():end].strip()
        recipient = m.group(1)
        if recipient and recipient.startswith("functions."):
            calls.append(ToolCall(name=recipient[len("functions."):],
                                  arguments=body or "{}"))
        elif recipient:
            log_dropped_builtin(recipient)
        elif body:
            normal_parts.append(body)
        pos = end + len(tok)
        if not tok:
            break
    cfg = TOOL_PARSERS["harmony"]
    normal = strip_framing("".join(normal_parts), cfg).strip()
    return calls, (normal or None)


def log_dropped_builtin(recipient: str) -> None:  # pragma: no cover - logging
    from dynamo_tpu_torch.utils.logging import get_logger

    get_logger("parsers").debug(
        "dropping harmony builtin-tool segment to=%s (not a client function)",
        recipient)


def parse_tool_calls(text: str, cfg: ToolCallConfig) -> tuple[list[ToolCall], str | None]:
    """Parse every tool call in a complete message.

    Returns (calls, normal_text) — normal_text is the content outside call
    markers (None if empty), mirroring the reference's
    try_tool_call_parse → (Vec<ToolCallResponse>, Option<String>).
    """
    if cfg.format == "pythonic":
        return _parse_pythonic(text)
    if cfg.format == "harmony":
        return _parse_harmony(text)

    calls: list[ToolCall] = []
    normal_parts: list[str] = []
    rest = text
    while rest:
        i = match_start(rest, cfg)
        if i < 0:
            normal_parts.append(rest)
            break
        normal_parts.append(rest[:i])
        matched = next(
            ((s, e) for s, e in zip(cfg.start_tokens, cfg.end_tokens)
             if rest.startswith(s, i)),
            None,
        )
        if matched is None:  # bare JSON at i
            found, stop = _parse_json_stream(rest[i:], cfg)
            if not found:  # JSON but not a tool call: normal text
                normal_parts.append(rest[i:])
                break
            calls.extend(found)
            rest = rest[i + stop:]
            continue
        s_tok, e_tok = matched
        if s_tok.endswith("[") and e_tok == "]":
            # phi4-style: the payload is the bracket-balanced JSON array
            # opened by the marker itself.
            seg_start = i + len(s_tok) - 1
            end = _balanced_end(rest, seg_start)
            seg_end = consumed_to = end if end >= 0 else len(rest)
        elif e_tok:
            seg_start = i + len(s_tok)
            j = rest.find(e_tok, seg_start)
            seg_end = j if j >= 0 else len(rest)
            consumed_to = seg_end + len(e_tok) if j >= 0 else len(rest)
        else:  # marker to end-of-stream payload
            seg_start, seg_end, consumed_to = i + len(s_tok), len(rest), None
        found, stop = _parse_json_stream(rest[seg_start:seg_end], cfg)
        calls.extend(found)
        if consumed_to is None:
            # Consume only the parsed JSON; what follows is normal text
            # (e.g. "[TOOL_CALLS] [..] thanks!").
            if not found:
                normal_parts.append(rest[seg_start:])
                break
            consumed_to = seg_start + stop
        rest = rest[consumed_to:]
    normal = "".join(normal_parts).strip()
    return calls, (normal or None)
