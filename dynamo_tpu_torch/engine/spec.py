"""N-gram speculative decoding (prompt-lookup) proposals — copy of
``dynamo_tpu/engine/spec.py``.

A decode step's cost is dominated by reading every parameter byte once,
so verifying k proposed tokens in ONE forward pass multiplies tokens per
weight read by the acceptance rate. Proposals come from the sequence
itself: the trailing n-gram is matched against earlier positions and the
continuation after the most recent match is proposed (the "prompt
lookup" scheme; strong on code, summaries, RAG — any output that
re-quotes its context). Verification is exact for greedy decoding: the
emitted streams are the step-by-step decode's (the engine's "verify"
batches, engine/engine.py; tests/test_torch_spec.py).
"""

from __future__ import annotations

from dynamo_tpu_torch.qos.deadline import NO_SPEC_KEY


def greedy_eligible(so) -> bool:
    """Verify steps are argmax-exact only for greedy, penalty-free
    sampling options."""
    return (
        so.temperature is not None and so.temperature <= 0
        and not so.frequency_penalty and not so.presence_penalty
        and (so.repetition_penalty or 1.0) == 1.0
    )


def spec_eligible(seq) -> bool:
    """THE verify rule, shared by the scheduler's block-growth sizing and
    the engine's verify planner, so a seq never verifies without the
    lookahead blocks the scheduler reserves for exactly this rule.
    Eligible: greedy and penalty-free, not guided (a mask needs the
    previous token on the host), and not degraded by QoS (``qos.no_spec``:
    under pressure speculative width is the first throughput knob to go)."""
    ann = getattr(seq.req, "annotations", None)
    if ann and ann.get(NO_SPEC_KEY):
        return False
    return seq.guided is None and greedy_eligible(seq.req.sampling_options)


def propose(tokens: list[int], ngram: int, k: int) -> list[int]:
    """Up to ``k`` continuation tokens after the most recent earlier
    occurrence of the trailing ``ngram``-gram; [] when no match.

    The scan walks backwards so the MOST RECENT prior occurrence wins —
    repetitive generation (the common acceptance case) matches its own
    immediately-preceding copy."""
    n = len(tokens)
    if ngram <= 0 or k <= 0 or n < ngram + 1:
        return []
    tail = tokens[n - ngram:]
    # last position where a match could START, leaving >=1 continuation
    # token before the tail itself
    for start in range(n - ngram - 1, -1, -1):
        if tokens[start:start + ngram] == tail:
            return tokens[start + ngram: start + ngram + k]
    return []


def accept(chunk: list[int], argmax_out: list[int]) -> list[int]:
    """Greedy acceptance walk.

    ``chunk`` = [current_token, p1..pk] (the verify step's inputs);
    ``argmax_out[j]`` = the model's next-token prediction at position j.
    Position j's output is on the true decode path iff every earlier
    proposal matched: p_j == argmax_out[j-1]. Returns the emitted tokens
    (>=1: position 0's output is always valid — it is exactly what a
    plain decode step would have produced)."""
    emitted = [argmax_out[0]]
    for j in range(1, len(chunk)):
        if chunk[j] != argmax_out[j - 1]:
            break
        emitted.append(argmax_out[j])
    return emitted
