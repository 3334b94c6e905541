"""Streaming detokenizer backend with stop-sequence jail.

Fills the role of the reference's ``Backend`` operator
(reference: lib/llm/src/backend.rs:4-60): sits between the engine's token
stream and the OpenAI response path, incrementally detokenizes, and
implements the *hidden stop sequence jail* — when the tail of the generated
text could be the start of a stop string, output is withheld ("jailed")
until the ambiguity resolves, so a stop sequence never leaks to the client
and partial matches stream correctly.

Copy of ``dynamo_tpu/backend/detokenizer.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from dynamo_tpu_torch.protocols.common import BackendOutput, FinishReason, LLMEngineOutput
from dynamo_tpu_torch.tokenizer import BaseTokenizer, DecodeStream


from dynamo_tpu_torch.utils.text import longest_partial_suffix as _longest_partial_suffix


@dataclass
class _StreamState:
    decode: DecodeStream
    jailed: str = ""       # emitted-by-decoder but withheld text
    finished: bool = False


class DetokenizerBackend:
    """Per-request streaming state machine. Feed ``LLMEngineOutput`` deltas,
    receive ``BackendOutput`` text deltas with stop handling applied."""

    def __init__(self, tokenizer: BaseTokenizer, stops: list[str] | None = None):
        self.tokenizer = tokenizer
        self.stops = [s for s in (stops or []) if s]
        self._st = _StreamState(decode=DecodeStream(tokenizer))
        # Cumulative wall time spent detokenizing; the frontend folds it
        # into one aggregate frontend.detokenize span at stream end
        # (obs/tracer.py — a per-delta span would be pure overhead).
        self.elapsed_s = 0.0

    def step(self, out: LLMEngineOutput) -> BackendOutput:
        t0 = time.perf_counter()
        try:
            return self._step(out)
        finally:
            self.elapsed_s += time.perf_counter() - t0

    def _step(self, out: LLMEngineOutput) -> BackendOutput:
        st = self._st
        if st.finished:
            return BackendOutput(finish_reason=out.finish_reason)
        new_text = "".join(st.decode.step(t) for t in out.token_ids)
        buf = st.jailed + new_text

        # 1. full stop-string match → truncate there, finish
        if self.stops:
            hit_at = None
            for stop in self.stops:
                idx = buf.find(stop)
                if idx != -1 and (hit_at is None or idx < hit_at):
                    hit_at = idx
            if hit_at is not None:
                st.finished = True
                st.jailed = ""
                return BackendOutput(
                    text=buf[:hit_at],
                    token_ids=list(out.token_ids),
                    finish_reason=FinishReason.STOP,
                    cum_log_probs=out.cum_log_probs,
                    log_probs=out.log_probs,
                )

        # 2. stream end → flush the jail (no stop hit)
        if out.finish_reason is not None:
            tail = st.decode.flush()
            st.finished = True
            st.jailed = ""
            return BackendOutput(
                text=buf + tail,
                token_ids=list(out.token_ids),
                finish_reason=out.finish_reason,
                cum_log_probs=out.cum_log_probs,
                log_probs=out.log_probs,
            )

        # 3. jail any suffix that could grow into a stop string
        k = _longest_partial_suffix(buf, self.stops) if self.stops else 0
        st.jailed = buf[len(buf) - k :] if k else ""
        emit = buf[: len(buf) - k] if k else buf
        return BackendOutput(text=emit, token_ids=list(out.token_ids),
                             cum_log_probs=out.cum_log_probs,
                             log_probs=out.log_probs)

    @property
    def hit_stop(self) -> bool:
        return self._st.finished
