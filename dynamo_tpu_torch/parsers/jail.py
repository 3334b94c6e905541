"""Streaming jail: withhold text while a tool call may be forming.

Fills the role of the reference's chat-completions jail (reference:
lib/llm/src/protocols/openai/chat_completions/jail.rs): an operator over
streamed text deltas that

1. routes reasoning-block text to ``reasoning`` (never jailed — clients
   may render it live),
2. releases normal text immediately **except** a trailing fragment that
   could be the start of a tool-call marker,
3. once a marker is confirmed, withholds everything and buffers until the
   call's end marker (or stream end), then parses,
4. at ``finish()`` returns the parsed tool calls + any leftover text.

The per-request pipeline is: detokenizer → reasoning parser → tool jail →
delta generator (frontend/service.py wires this per request).

Copy of ``dynamo_tpu/parsers/jail.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dynamo_tpu_torch.parsers.reasoning import ReasoningParser
from dynamo_tpu_torch.parsers.tool_calls import (
    ToolCall,
    ToolCallConfig,
    find_call_end,
    match_start,
    parse_tool_calls,
    possible_start,
    strip_framing,
)


@dataclass
class JailDelta:
    """What a feed() releases to the client now."""

    content: str = ""
    reasoning: str = ""
    tool_calls: list[ToolCall] = field(default_factory=list)


class StreamJail:
    """Stateful per-request stream processor (reasoning + tool-call jail)."""

    def __init__(
        self,
        tool_cfg: ToolCallConfig | None = None,
        reasoning: ReasoningParser | None = None,
    ):
        self.tool_cfg = tool_cfg
        self.reasoning = reasoning
        self._pending = ""       # normal text not yet released (maybe-marker tail)
        self._call_buf = ""      # confirmed tool-call text being buffered
        self._in_call = False
        self.tool_calls: list[ToolCall] = []
        # Bare-JSON rule: only counts at message start — i.e. before any
        # non-whitespace normal text has been released.
        self._nonws_seen = False

    # ------------------------------------------------------------------
    def _feed_normal(self, text: str) -> str:
        """Run the tool jail over normal (non-reasoning) text; returns what
        can be released."""
        if self.tool_cfg is None:
            return text
        self._pending += text
        released: list[str] = []
        while self._pending:
            if self._in_call:
                self._call_buf += self._pending
                self._pending = ""
                end = find_call_end(self._call_buf, 0, self.tool_cfg)
                if end < 0:
                    break  # call still forming — keep buffering
                calls, normal = parse_tool_calls(self._call_buf[:end], self.tool_cfg)
                self.tool_calls.extend(calls)
                if normal:
                    released.append(normal)
                # text after the call end goes back through the jail
                self._pending = self._call_buf[end:]
                self._call_buf = ""
                self._in_call = False
                continue
            i = match_start(self._pending, self.tool_cfg)
            # Strip stray framing from the text BEFORE the first call
            # marker (only — a terminator past the marker belongs to that
            # segment); must happen pre-release or a strip token and a call
            # start arriving in one delta leak the token to the client.
            head = self._pending if i < 0 else self._pending[:i]
            stripped_head = strip_framing(head, self.tool_cfg)
            if stripped_head != head:
                self._pending = stripped_head + (
                    "" if i < 0 else self._pending[i:])
                continue
            if self.tool_cfg.bare_json and i >= 0 and not self._pending[i:].startswith(
                tuple(self.tool_cfg.start_tokens) or ("\0",)
            ):
                # Bare-JSON start only counts at the very beginning of the
                # message (leading whitespace allowed) — mid-text braces
                # are normal content.
                if self._nonws_seen or self._pending[:i].strip():
                    i = -1
            if i >= 0:
                released.append(self._pending[:i])
                if self._pending[:i].strip():
                    self._nonws_seen = True
                self._call_buf = self._pending[i:]
                self._pending = ""
                self._in_call = True
                continue
            k = possible_start(self._pending, self.tool_cfg)
            if k:
                release, self._pending = self._pending[:-k], self._pending[-k:]
            else:
                release, self._pending = self._pending, ""
            released.append(release)
            if release.strip():
                self._nonws_seen = True
            break
        return "".join(released)

    def feed(self, delta: str) -> JailDelta:
        out = JailDelta()
        if self.reasoning is not None:
            r = self.reasoning.step(delta)
            out.reasoning = r.reasoning_text
            normal = r.normal_text
        else:
            normal = delta
        out.content = self._feed_normal(normal)
        return out

    def finish(self) -> JailDelta:
        """Stream ended: flush partial-marker tails and parse any buffered
        (unterminated) call."""
        out = JailDelta()
        if self.reasoning is not None:
            r = self.reasoning.finish()
            out.reasoning = r.reasoning_text
            out.content = self._feed_normal(r.normal_text)
        tail = self._pending + self._call_buf
        self._pending = self._call_buf = ""
        if tail and self.tool_cfg is not None:
            calls, normal = parse_tool_calls(tail, self.tool_cfg)
            self.tool_calls.extend(calls)
            if normal:
                out.content += normal
        elif tail:
            out.content += tail
        out.tool_calls = list(self.tool_calls)
        return out

    @property
    def has_tool_calls(self) -> bool:
        return bool(self.tool_calls)
