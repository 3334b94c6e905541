"""Backend output → OpenAI response assembly (streaming deltas + aggregates).

Fills the role of the reference's DeltaGenerator + aggregators
(reference: lib/llm/src/protocols/openai/*/aggregator.rs and the
preprocessor's response edge).

Copy of ``dynamo_tpu/frontend/delta.py``.
"""

from __future__ import annotations

import uuid

from dynamo_tpu_torch.protocols.common import BackendOutput
from dynamo_tpu_torch.protocols.openai import (
    ChatChoice,
    ChatChoiceDelta,
    ChatChunkChoice,
    ChatCompletionChunk,
    ChatCompletionResponse,
    ChatMessage,
    CompletionChoice,
    CompletionResponse,
    Usage,
)


def chat_logprob_content(outs: list[BackendOutput], tokenizer) -> list[dict]:
    """OpenAI chat ``logprobs.content`` entries for the sampled tokens
    (reference shape: lib/async-openai chat logprobs; analysis consumers:
    lib/llm/src/perf/logprobs.rs). ``top_logprobs`` is empty — the engine
    samples without materializing alternatives (requests asking for
    top_logprobs > 0 are rejected up front at the HTTP layer). A backend
    that measured no logprob (mocker, old wire peers) yields ``null``, not
    a fabricated certainty — same contract as the completions shape."""
    content: list[dict] = []
    for o in outs:
        lps = o.log_probs or [None] * len(o.token_ids)
        for tok, lp in zip(o.token_ids, lps):
            piece = tokenizer.decode([tok]) if tokenizer is not None else ""
            content.append({
                "token": piece,
                "logprob": lp,
                "bytes": list(piece.encode("utf-8")),
                "top_logprobs": [],
            })
    return content


def completion_logprobs(outs: list[BackendOutput], tokenizer,
                        start_offset: int = 0) -> dict:
    """OpenAI completions ``logprobs`` object (tokens / token_logprobs /
    text_offset; top_logprobs omitted — see chat_logprob_content).
    ``start_offset`` continues cumulative text positions across streamed
    chunks so stream and aggregate report identical offsets."""
    tokens: list[str] = []
    token_logprobs: list[float | None] = []
    text_offset: list[int] = []
    offset = start_offset
    for o in outs:
        lps = o.log_probs or [None] * len(o.token_ids)
        for tok, lp in zip(o.token_ids, lps):
            piece = tokenizer.decode([tok]) if tokenizer is not None else ""
            tokens.append(piece)
            token_logprobs.append(lp)
            text_offset.append(offset)
            offset += len(piece)
    return {"tokens": tokens, "token_logprobs": token_logprobs,
            "text_offset": text_offset, "top_logprobs": None}


class ChatDeltaGenerator:
    """Builds chat.completion.chunk SSE events from backend deltas."""

    def __init__(self, model: str, request_id: str | None = None,
                 logprobs: bool = False, tokenizer=None):
        self.id = f"chatcmpl-{request_id or uuid.uuid4().hex}"
        self.model = model
        self._first = True
        self.completion_tokens = 0
        self.prompt_tokens = 0
        self.logprobs = logprobs
        self.tokenizer = tokenizer
        self._pending_lp: list[BackendOutput] = []

    def role_chunk(self) -> ChatCompletionChunk:
        return ChatCompletionChunk(
            id=self.id, model=self.model,
            choices=[ChatChunkChoice(delta=ChatChoiceDelta(role="assistant", content=""))],
        )

    def chunk(self, out: BackendOutput) -> ChatCompletionChunk | None:
        self.completion_tokens += len(out.token_ids)
        if not out.text and out.finish_reason is None:
            # jailed/empty delta — emit nothing, but HOLD its tokens'
            # logprobs: they ride the next emitted chunk so the stream's
            # logprob entries stay complete (equal to completion_tokens).
            if self.logprobs and out.token_ids:
                self._pending_lp.append(out)
            return None
        lp = None
        if self.logprobs:
            carried = self._pending_lp + ([out] if out.token_ids else [])
            self._pending_lp = []
            if carried:
                lp = {"content": chat_logprob_content(carried, self.tokenizer)}
        return ChatCompletionChunk(
            id=self.id, model=self.model,
            choices=[ChatChunkChoice(
                delta=ChatChoiceDelta(content=out.text or None),
                finish_reason=str(out.finish_reason) if out.finish_reason else None,
                logprobs=lp,
            )],
        )

    def reasoning_chunk(self, reasoning: str) -> ChatCompletionChunk:
        return ChatCompletionChunk(
            id=self.id, model=self.model,
            choices=[ChatChunkChoice(delta=ChatChoiceDelta(reasoning_content=reasoning))],
        )

    def tool_calls_chunk(self, calls: list,
                         out: BackendOutput | None = None) -> ChatCompletionChunk:
        """Terminal chunk carrying the parsed calls (the jail withheld their
        text) with finish_reason=tool_calls. ``out`` (the final backend
        delta, when its tokens weren't emitted by a preceding text chunk)
        plus any held jailed-delta logprobs ride here, keeping streamed
        logprob entries == completion_tokens even on the tool-call path.
        Token accounting happens at the call site — this never bumps
        completion_tokens."""
        lp = None
        if self.logprobs:
            carried = self._pending_lp + (
                [out] if out is not None and out.token_ids else [])
            self._pending_lp = []
            if carried:
                lp = {"content": chat_logprob_content(carried, self.tokenizer)}
        return ChatCompletionChunk(
            id=self.id, model=self.model,
            choices=[ChatChunkChoice(
                delta=ChatChoiceDelta(
                    tool_calls=[c.to_openai(index=i) for i, c in enumerate(calls)]),
                finish_reason="tool_calls",
                logprobs=lp,
            )],
        )

    def usage_chunk(self) -> ChatCompletionChunk:
        """Final stream chunk carrying token usage (OpenAI include_usage
        shape: empty choices + usage) — load generators read exact token
        counts from it instead of counting content chunks, which undercount
        under fused decode windows and parser jails."""
        return ChatCompletionChunk(
            id=self.id, model=self.model, choices=[], usage=self.usage())

    def usage(self) -> Usage:
        return Usage(
            prompt_tokens=self.prompt_tokens,
            completion_tokens=self.completion_tokens,
            total_tokens=self.prompt_tokens + self.completion_tokens,
        )


def aggregate_chat(model: str, outs: list[BackendOutput], prompt_tokens: int,
                   jail=None, logprobs: bool = False,
                   tokenizer=None) -> ChatCompletionResponse:
    """Aggregate deltas into one chat response; with a ``jail``
    (parsers.StreamJail), tool calls and reasoning are parsed out of the
    text and finish_reason becomes tool_calls when calls were made."""
    text = "".join(o.text for o in outs)
    finish = next((str(o.finish_reason) for o in outs if o.finish_reason), None)
    completion_tokens = sum(len(o.token_ids) for o in outs)
    message = ChatMessage(role="assistant", content=text)
    if jail is not None:
        fed = jail.feed(text)
        fin = jail.finish()
        content = fed.content + fin.content
        reasoning = fed.reasoning + fin.reasoning
        message = ChatMessage(
            role="assistant",
            content=content or None,
            reasoning_content=reasoning or None,
            tool_calls=[c.to_openai() for c in fin.tool_calls] or None,
        )
        if fin.tool_calls:
            finish = "tool_calls"
    return ChatCompletionResponse(
        model=model,
        choices=[ChatChoice(
            message=message, finish_reason=finish,
            logprobs=({"content": chat_logprob_content(outs, tokenizer)}
                      if logprobs else None),
        )],
        usage=Usage(
            prompt_tokens=prompt_tokens,
            completion_tokens=completion_tokens,
            total_tokens=prompt_tokens + completion_tokens,
        ),
    )


def aggregate_completion(model: str, outs: list[BackendOutput], prompt_tokens: int,
                         logprobs: bool = False,
                         tokenizer=None) -> CompletionResponse:
    text = "".join(o.text for o in outs)
    finish = next((str(o.finish_reason) for o in outs if o.finish_reason), None)
    completion_tokens = sum(len(o.token_ids) for o in outs)
    return CompletionResponse(
        model=model,
        choices=[CompletionChoice(
            text=text, finish_reason=finish,
            logprobs=(completion_logprobs(outs, tokenizer) if logprobs else None),
        )],
        usage=Usage(
            prompt_tokens=prompt_tokens,
            completion_tokens=completion_tokens,
            total_tokens=prompt_tokens + completion_tokens,
        ),
    )
