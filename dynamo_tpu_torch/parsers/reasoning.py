"""Reasoning (think-block) parsing, complete and streaming-incremental.

Fills the reference's reasoning parser registry (reference:
lib/parsers/src/reasoning/{mod,base_parser}.rs) — same parser names, one
data-driven implementation: a config names the open/close markers and
whether the model starts *inside* reasoning (deepseek-r1 emits no opening
tag after its chat template).

Streaming rules (mirroring BasicReasoningParser's semantics):
- text inside open..close accumulates as ``reasoning_text``;
- a partial marker at the end of the buffer is withheld until it either
  completes or diverges;
- a missing close tag means everything from open to stream end is
  reasoning.

Copy of ``dynamo_tpu/parsers/reasoning.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ParserResult:
    normal_text: str = ""
    reasoning_text: str = ""


@dataclass(frozen=True)
class ReasoningConfig:
    open_token: str = "<think>"
    close_token: str = "</think>"
    # Model is already "thinking" at generation start (no open marker emitted).
    force_reasoning: bool = False
    # Structural markers DROPPED from normal text (harmony channel headers:
    # they are protocol framing, not content). Withheld while a partial
    # match could still grow, like the open/close markers.
    strip_tokens: tuple[str, ...] = ()
    # After the open token matches, framing continues up to this terminator
    # (harmony: '<|channel|>analysis[ to=python][ <|constrain|>..]<|message|>'
    # — the variable recipient part must be consumed, not emitted).
    open_header_terminator: str | None = None
    # Additional reasoning terminators (harmony analysis tool calls end with
    # '<|call|>' instead of '<|end|>').
    extra_close_tokens: tuple[str, ...] = ()


# Same registry names as the reference (reasoning/mod.rs:18-31; gpt_oss:
# reasoning/gpt_oss_parser.rs — the harmony channel structure).
REASONING_PARSERS: dict[str, ReasoningConfig] = {
    "basic": ReasoningConfig(),
    "deepseek_r1": ReasoningConfig(force_reasoning=True),
    "qwen3": ReasoningConfig(),
    "nemotron_deci": ReasoningConfig(force_reasoning=False),
    "kimi": ReasoningConfig(open_token="◁think▷", close_token="◁/think▷"),
    "step3": ReasoningConfig(force_reasoning=True),
    "mistral": ReasoningConfig(open_token="[THINK]", close_token="[/THINK]"),
    "granite": ReasoningConfig(
        open_token="Here is my thought process:",
        close_token="Here is my response:"),
    # gpt-oss harmony: the analysis channel (any recipient — 'to=python'
    # headers included) is reasoning; final-channel headers and message
    # terminators are framing to strip. Commentary channels pass through
    # untouched — the harmony TOOL parser owns them (incl. their '<|end|>'
    # terminators, which is why '<|end|>' is not stripped HERE; the tool
    # layer strips strays).
    "gpt_oss": ReasoningConfig(
        open_token="<|channel|>analysis",
        open_header_terminator="<|message|>",
        close_token="<|end|>",
        extra_close_tokens=("<|call|>",),
        strip_tokens=(
            "<|start|>assistant<|channel|>final<|message|>",
            "<|channel|>final<|message|>",
            "<|start|>assistant",
            "<|return|>",
        )),
}


def get_reasoning_parser(name: str) -> "ReasoningParser":
    try:
        return ReasoningParser(REASONING_PARSERS[name])
    except KeyError:
        raise ValueError(
            f"unknown reasoning parser {name!r} (have: {sorted(REASONING_PARSERS)})"
        ) from None


from dynamo_tpu_torch.utils.text import longest_partial_suffix


def _partial_suffix(text: str, token: str) -> int:
    """Length of the longest proper prefix of ``token`` that ends ``text``."""
    return longest_partial_suffix(text, (token,))


class ReasoningParser:
    """Stateful streaming parser; ``parse`` is the one-shot form."""

    def __init__(self, cfg: ReasoningConfig):
        self.cfg = cfg
        self.in_reasoning = cfg.force_reasoning
        self.in_header = False  # consuming open-header framing (harmony)
        self._buf = ""  # withheld partial-marker fragment

    # -- one-shot ----------------------------------------------------------
    @classmethod
    def parse_complete(cls, text: str, cfg: ReasoningConfig) -> ParserResult:
        p = cls(cfg)
        res = p.step(text)
        tail = p.finish()
        return ParserResult(
            normal_text=(res.normal_text + tail.normal_text),
            reasoning_text=(res.reasoning_text + tail.reasoning_text),
        )

    # -- streaming ---------------------------------------------------------
    def step(self, delta: str) -> ParserResult:
        """Consume a delta; returns the text that can be released now."""
        text = self._buf + delta
        self._buf = ""
        normal: list[str] = []
        reasoning: list[str] = []
        while text:
            if self.in_header:
                # open-header framing: consume (emit nowhere) through the
                # terminator; withhold a possible partial terminator
                term = self.cfg.open_header_terminator or ""
                i = text.find(term)
                if i >= 0:
                    text = text[i + len(term):]
                    self.in_header = False
                    continue
                k = _partial_suffix(text, term)
                self._buf = text[-k:] if k else ""
                break
            if self.in_reasoning:
                closes = (self.cfg.close_token, *self.cfg.extra_close_tokens)
                hits = sorted(
                    ((i, -len(t), t) for t in closes
                     if (i := text.find(t)) >= 0))
                if hits:
                    i, _, tok = hits[0]
                    reasoning.append(text[:i])
                    text = text[i + len(tok):]
                    self.in_reasoning = False
                    continue
                k = longest_partial_suffix(text, closes)
                if k:
                    reasoning.append(text[:-k])
                    self._buf = text[-k:]
                else:
                    reasoning.append(text)
                break
            # normal mode: the earliest of the open marker or any strip
            # marker wins (longest match on a tie, so a more specific
            # header beats its own prefix)
            tokens = (self.cfg.open_token, *self.cfg.strip_tokens)
            hits = sorted(
                ((i, -len(t), t) for t in tokens if (i := text.find(t)) >= 0))
            if hits:
                i, _, tok = hits[0]
                normal.append(text[:i])
                text = text[i + len(tok):]
                if tok == self.cfg.open_token:
                    self.in_reasoning = True
                    if self.cfg.open_header_terminator:
                        self.in_header = True
                continue
            k = longest_partial_suffix(text, tokens)
            if k:
                normal.append(text[:-k])
                self._buf = text[-k:]
            else:
                normal.append(text)
            break
        return ParserResult("".join(normal), "".join(reasoning))

    def finish(self) -> ParserResult:
        """Flush the withheld fragment at stream end (an unfinished marker
        is literal text of whichever side we are on; an unfinished open
        header is framing — dropped)."""
        buf, self._buf = self._buf, ""
        if not buf or self.in_header:
            return ParserResult()
        if self.in_reasoning:
            return ParserResult(reasoning_text=buf)
        return ParserResult(normal_text=buf)
