"""Batched token sampling — port of ``dynamo_tpu/engine/sampling.py``.

All sampling params are per-row tensors so one call serves a mixed batch
(greedy + temperature + top-k/p + penalties). Greedy is
``temperature <= 0``; greedy tokens and logprobs are the JAX package's.

JAX draws from per-slot threefry keys, which have no torch counterpart.
Here each slot carries a 64-bit seed and a draw counter, and the noise of
one draw is a counter-based hash of (seed, draw, token id) computed on the
device. A seeded stream therefore repeats exactly, whatever the batch
composition or the row it lands in, and resuming at draw n needs only n —
but its bits are not JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


@dataclass
class SamplingState:
    """Per-row sampling params (batch-indexed)."""

    temperature: torch.Tensor        # [B] f32; <=0 → greedy
    top_k: torch.Tensor              # [B] i32; 0 → disabled
    top_p: torch.Tensor              # [B] f32; 1.0 → disabled
    frequency_penalty: torch.Tensor  # [B] f32
    presence_penalty: torch.Tensor   # [B] f32
    repetition_penalty: torch.Tensor  # [B] f32; 1.0 → disabled
    seeds: torch.Tensor              # [B] i64 per-stream seed
    draws: torch.Tensor              # [B] i64 draws this stream already made
    token_counts: torch.Tensor       # [B, V] i32 counts of emitted tokens (penalties)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x < 2^32, in int64 without overflow."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xorshift-multiply, 'lowbias32')."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_noise(seeds: torch.Tensor, draws: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] uniforms in (0, 1), a pure function of (seed, draw, token id)."""
    s = seeds.long()
    k1 = _hash32(_hash32(s & _M32) ^ ((s >> 32) & _M32))
    k2 = _hash32(k1 ^ (draws.long() & _M32))
    tok = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = _hash32(_hash32(tok[None, :] ^ k1[:, None]) ^ k2[:, None])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def apply_penalties(logits: torch.Tensor, st: SamplingState) -> torch.Tensor:
    counts = st.token_counts.float()
    seen = counts > 0
    logits = logits - st.frequency_penalty[:, None] * counts
    logits = logits - st.presence_penalty[:, None] * seen
    rp = st.repetition_penalty[:, None]
    rep = torch.where(logits > 0, logits / rp, logits * rp)
    return torch.where(seen & (rp != 1.0), rep, logits)


def top_k_top_p_keep(scaled: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort each row descending and mark the ranks top-k and top-p keep
    (the top rank always survives). Returns (sorted logits, sort index,
    keep mask), all [B, V] in rank order."""
    v = scaled.shape[-1]
    sorted_logits, sort_idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs  # mass strictly before this rank
    rank = torch.arange(v, device=scaled.device)[None, :]
    k = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k)[:, None]
    keep = (rank < k) & (cum < top_p[:, None])
    keep[:, 0] = True
    return sorted_logits, sort_idx, keep


def sample(logits: torch.Tensor, st: SamplingState) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one token per row: Gumbel-max over the kept ranks, with the
    noise of each token id taken from :func:`uniform_noise`.
    Returns (tokens [B] i32, logprobs [B] f32)."""
    logits = apply_penalties(logits.float(), st)
    greedy = st.temperature <= 0.0
    scaled = logits / st.temperature.clamp(min=1e-6)[:, None]
    sorted_logits, sort_idx, keep = top_k_top_p_keep(scaled, st.top_k, st.top_p)
    masked = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, NEG_INF))
    u = uniform_noise(st.seeds, st.draws, logits.shape[-1]).gather(1, sort_idx)
    sampled_rank = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    sampled = sort_idx.gather(1, sampled_rank[:, None])[:, 0]
    tokens = torch.where(greedy, torch.argmax(logits, dim=-1), sampled).to(torch.int32)
    lp = torch.log_softmax(logits, dim=-1).gather(1, tokens.long()[:, None])[:, 0]
    return tokens, lp


def greedy_sample(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All-greedy, penalty-free batch: argmax + its logprob — identical to
    :func:`sample` for such a batch, without its sort and noise."""
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    lp = torch.log_softmax(logits, dim=-1).gather(1, toks.long()[:, None])[:, 0]
    return toks, lp


def record_tokens(token_counts: torch.Tensor, tokens: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """Add sampled tokens into the penalty counts (inactive rows skipped)."""
    out = token_counts.clone()
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    out[rows, tokens.long()] += active.to(out.dtype)
    return out
