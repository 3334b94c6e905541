"""Ring attention: causal attention with the sequence split over the seq
ranks — port of ``dynamo_tpu/ops/ring_attention.py``.

For a prefill of fresh whole prompts, seq rank ``q`` of ``sp`` holds
query, key and value positions ``[q T/sp, (q+1) T/sp)`` of every row. It
attends its query chunk to its own K/V chunk, then passes the K/V chunk it
holds to seq rank ``q + 1`` and takes the one ``q - 1`` held, ``sp - 1``
hops in all (JAX's ``lax.ppermute``; here ``TPGroup.ring_pass``: point to
point, through host memory on gloo). At step ``s`` the rank holds the
chunk of rank ``(q - s) mod sp`` and merges it in that order into the
online-softmax state (acc, row max, row sum), so the result is dense
causal attention over the whole sequence, up to the order of the f32
sums. Causality goes by global positions: query chunk i sees K/V chunk j
whole if j < i, its lower triangle if j == i, nothing if j > i (such
steps still pass their chunk on and merge nothing).

Not a kernel (JAX's is plain ``jnp.einsum`` inside a ``shard_map``, no
``pallas_call``): plain torch ops, as the rest of the model math around
the attention kernel. Numerics are JAX's: q scaled by ``D^-0.5`` in its
own dtype, scores and the accumulator in f32, masked scores at
``NEG_INF = -1e30`` (not ``-inf``), GQA as grouped einsums (no repeated
KV heads), a row with nothing visible (padding) divided by 1. A hop's
scores are made a tile of query positions at a time and freed inside it:
one f32 buffer of at most :data:`RING_TILE_BYTES` (a whole [B, T/sp, KH,
rep, T/sp] hop is 16 GiB for 8 rows of an 8192-token step at sp=2 with 32
heads), which the merge of the online-softmax state, elementwise, does
not see.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import torch

if TYPE_CHECKING:
    from dynamo_tpu_torch.parallel.collectives import TPGroup

NEG_INF = -1e30

#: bytes of the f32 scores of one tile of query positions against a held
#: chunk (the second product may copy them once more)
RING_TILE_BYTES = 1 << 30

#: a hop: the K/V chunk this rank holds in, the next rank's out
Hop = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _chunk_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                k_pos: torch.Tensor, kv_len: torch.Tensor | None):
    """One blockwise piece (JAX: ``_chunk_attn``): returns (unnormalized
    out, row max, row sum). q: [B, Tq, KH, rep, D] (scaled); k/v: [B, Tk,
    KH, D]; q_pos: [B, Tq]; k_pos: [B, Tk]; kv_len: [B] or None. The
    scores become ``p`` in place."""
    scores = torch.einsum("btkrd,bskd->btkrs", q.float(), k.float())
    visible = q_pos[:, :, None] >= k_pos[:, None, :]             # [B, Tq, Tk]
    if kv_len is not None:
        visible &= k_pos[:, None, :] < kv_len[:, None, None]
    hidden = ~visible[:, :, None, None, :]
    scores.masked_fill_(hidden, NEG_INF)
    m = scores.amax(dim=-1)                                       # [B, Tq, KH, rep]
    p = scores.sub_(m[..., None]).exp_().masked_fill_(hidden, 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("btkrs,bskd->btkrd", p, v.float())
    return out, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, seq_rank: int,
                   sp: int, hop: Hop, kv_len: torch.Tensor | None = None,
                   keep: list | None = None) -> torch.Tensor:
    """Causal ring attention of seq rank ``seq_rank`` of ``sp`` (JAX:
    ``ring_attention``): q [B, T/sp, H, D], k/v [B, T/sp, KH, D] are this
    rank's chunk; ``hop(k, v)`` passes the held chunk on and returns the
    previous rank's; ``kv_len`` [B] is each row's valid length (None:
    all). Returns [B, T/sp, H, D] in q's dtype. With ``keep``, every chunk
    the rank held is appended to it as ``(src, k, v)``, ``src`` the seq
    rank it came from."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    rep = h // kh
    dev = q.device
    qg = (q * (d ** -0.5)).reshape(b, t, kh, rep, d)
    ar = torch.arange(t, device=dev)
    my_pos = (seq_rank * t + ar)[None, :].expand(b, t)
    acc = torch.zeros((b, t, kh, rep, d), dtype=torch.float32, device=dev)
    m = torch.full((b, t, kh, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, t, kh, rep), dtype=torch.float32, device=dev)
    tile = max(1, min(t, RING_TILE_BYTES // (4 * b * h * t)))
    kc, vc = k, v
    for s in range(sp):
        if s:
            kc, vc = hop(kc, vc)
        src = (seq_rank - s) % sp
        if keep is not None:
            keep.append((src, kc, vc))
        k_pos = (src * t + ar)[None, :].expand(b, t)
        for lo in range(0, t, tile):
            rows = slice(lo, min(lo + tile, t))
            out_c, m_c, l_c = _chunk_attn(qg[:, rows], kc, vc, my_pos[:, rows], k_pos, kv_len)
            m_old = m[:, rows]
            m_new = torch.maximum(m_old, m_c)
            alpha = torch.exp(m_old - m_new)
            beta = torch.exp(m_c - m_new)
            acc[:, rows] = acc[:, rows] * alpha[..., None] + out_c * beta[..., None]
            l[:, rows] = l[:, rows] * alpha + l_c * beta
            m[:, rows] = m_new
            del out_c
    l = torch.where(l == 0.0, torch.ones_like(l), l)              # fully-masked rows
    out = acc / l[..., None]
    return out.reshape(b, t, h, d).to(q.dtype)


def ring_attention_prefill(group: "TPGroup", q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor,
                           keep: list | None = None) -> torch.Tensor:
    """The serving step's ring (JAX: ``ring_attention_prefill``): this
    rank's chunk of a step of fresh whole prompts (q_start = 0, so the
    chunk's context is the chunk itself and the paged cache is not read),
    its rows and its heads; the chunks rotate over ``group``'s seq ranks
    by ``TPGroup.ring_pass``, K and V in one message a hop. ``kv_len``
    [B] is each row's prompt length."""

    def hop(kc: torch.Tensor, vc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        kv = group.ring_pass(torch.stack([kc, vc]))
        return kv[0], kv[1]

    return ring_attention(q, k, v, seq_rank=group.seq_rank, sp=group.sp, hop=hop,
                          kv_len=kv_len, keep=keep)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sp: int,
                           kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """The global view (JAX: ``ring_attention_sharded``): q [B, T, H, D],
    k/v [B, T, KH, D] split into ``sp`` chunks of T, each seq rank's ring
    run in this process in turn (a hop hands a rank the chunk its
    predecessor held at that step), the outputs joined along T."""
    t = q.shape[1] // sp
    chunks = [(k[:, i * t:(i + 1) * t], v[:, i * t:(i + 1) * t]) for i in range(sp)]
    if kv_len is None:
        kv_len = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32, device=q.device)
    outs = []
    for idx in range(sp):
        held = [idx]

        def hop(kc, vc, held=held):
            held[0] = (held[0] - 1) % sp
            return chunks[held[0]]

        outs.append(ring_attention(q[:, idx * t:(idx + 1) * t], *chunks[idx], seq_rank=idx,
                                   sp=sp, hop=hop, kv_len=kv_len))
    return torch.cat(outs, dim=1)
