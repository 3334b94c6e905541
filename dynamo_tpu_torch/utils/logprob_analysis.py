"""Logprob analysis: confidence/perplexity statistics over served streams.

Fills the role of the reference's logprob perf tooling
(reference: lib/llm/src/perf/logprobs.rs — 1.6k LoC of logprob
extraction + analysis over recorded response streams). Consumes either
live OpenAI response objects (chat `logprobs.content` /
completions `logprobs.token_logprobs`, as emitted by frontend/delta.py)
or a stream-recorder JSONL (utils/recorder.py), and computes per-sequence
statistics:

- total/mean logprob, perplexity (`exp(-mean lp)`)
- surprisal extremes and low-confidence positions (candidate
  hallucination / derail points — the reference's analysis use case)
- sliding-window perplexity to localize where a generation went bad

Pure stdlib; no engine dependency, so it runs on recorded artifacts
anywhere. Copy of ``dynamo_tpu/utils/logprob_analysis.py``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Iterable


@dataclass
class TokenLogprob:
    token: str
    logprob: float
    position: int


@dataclass
class SequenceStats:
    """Statistics for one generated sequence."""

    request_id: str = ""
    tokens: list[TokenLogprob] = field(default_factory=list)

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)

    @property
    def total_logprob(self) -> float:
        return sum(t.logprob for t in self.tokens)

    @property
    def mean_logprob(self) -> float:
        return self.total_logprob / len(self.tokens) if self.tokens else 0.0

    @property
    def perplexity(self) -> float:
        return math.exp(-self.mean_logprob) if self.tokens else 1.0

    def min_logprob(self) -> TokenLogprob | None:
        return min(self.tokens, key=lambda t: t.logprob, default=None)

    def low_confidence(self, threshold: float = -4.0) -> list[TokenLogprob]:
        """Tokens sampled with logprob below ``threshold`` (p < ~1.8% at
        the default) — the positions worth human review."""
        return [t for t in self.tokens if t.logprob < threshold]

    def window_perplexity(self, window: int = 16) -> list[float]:
        """Sliding-window perplexity; a spike localizes where the
        generation lost the plot."""
        if len(self.tokens) < window:
            return [self.perplexity] if self.tokens else []
        out = []
        lps = [t.logprob for t in self.tokens]
        acc = sum(lps[:window])
        out.append(math.exp(-acc / window))
        for i in range(window, len(lps)):
            acc += lps[i] - lps[i - window]
            out.append(math.exp(-acc / window))
        return out

    def summary(self) -> dict:
        worst = self.min_logprob()
        return {
            "request_id": self.request_id,
            "num_tokens": self.num_tokens,
            "total_logprob": round(self.total_logprob, 4),
            "mean_logprob": round(self.mean_logprob, 4),
            "perplexity": round(self.perplexity, 4),
            "min_logprob": round(worst.logprob, 4) if worst else None,
            "min_logprob_token": worst.token if worst else None,
            "min_logprob_position": worst.position if worst else None,
            "low_confidence_count": len(self.low_confidence()),
        }


# ---------------------------------------------------------------------------
# Extraction from OpenAI response shapes (what frontend/delta.py emits)
# ---------------------------------------------------------------------------

def from_chat_response(resp: dict, request_id: str = "") -> SequenceStats:
    """Chat response/chunk: choices[0].logprobs.content[*].{token,logprob}.
    Accepts a full response or any chunk carrying logprobs content."""
    stats = SequenceStats(request_id=request_id or resp.get("id", ""))
    _extend_from_chat(stats, resp)
    return stats


def _extend_from_chat(stats: SequenceStats, resp: dict) -> None:
    for choice in resp.get("choices") or []:
        content = (choice.get("logprobs") or {}).get("content") or []
        for entry in content:
            lp = entry.get("logprob")
            if lp is None:
                continue  # unmeasured (mocker/legacy peer) — not certainty
            stats.tokens.append(TokenLogprob(
                token=entry.get("token", ""),
                logprob=float(lp),
                position=len(stats.tokens)))


def from_chat_stream(chunks: Iterable[dict], request_id: str = "") -> SequenceStats:
    """Aggregate chat.completion.chunk events (SSE stream) into one
    sequence's stats."""
    stats = SequenceStats(request_id=request_id)
    for chunk in chunks:
        if not stats.request_id:
            stats.request_id = chunk.get("id", "")
        _extend_from_chat(stats, chunk)
    return stats


def from_completion_response(resp: dict, request_id: str = "") -> SequenceStats:
    """Completions response: choices[0].logprobs.{tokens,token_logprobs}."""
    stats = SequenceStats(request_id=request_id or resp.get("id", ""))
    for choice in resp.get("choices") or []:
        lp = choice.get("logprobs") or {}
        for tok, l in zip(lp.get("tokens") or [], lp.get("token_logprobs") or []):
            if l is None:
                continue  # unmeasured — same skip rule as the chat shape
            stats.tokens.append(TokenLogprob(
                token=tok, logprob=float(l), position=len(stats.tokens)))
    return stats


def from_engine_outputs(outputs: Iterable[Any], request_id: str = "") -> SequenceStats:
    """Directly from LLMEngineOutput/BackendOutput deltas (token_ids +
    log_probs) — the in-process path, no HTTP shape required."""
    stats = SequenceStats(request_id=request_id)
    for out in outputs:
        lps = getattr(out, "log_probs", None) or []
        for lp in lps:
            stats.tokens.append(TokenLogprob(
                token="", logprob=float(lp), position=len(stats.tokens)))
    return stats


# ---------------------------------------------------------------------------
# Recorded artifacts (utils/recorder.py JSONL)
# ---------------------------------------------------------------------------

def analyze_recording(path: str) -> list[dict]:
    """Each JSONL record holding an OpenAI response (chat or completion)
    becomes one summary; records without logprobs are skipped."""
    summaries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            body = rec.get("payload", rec)
            if isinstance(body, str):
                try:
                    body = json.loads(body)
                except json.JSONDecodeError:
                    continue
            if not isinstance(body, dict):
                continue
            if body.get("object", "").startswith("chat.completion"):
                stats = from_chat_response(body)
            elif body.get("object") == "text_completion":
                stats = from_completion_response(body)
            else:
                continue
            if stats.num_tokens:
                summaries.append(stats.summary())
    return summaries
