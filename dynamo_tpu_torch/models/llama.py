"""Llama-family transformer in PyTorch over a paged KV cache — port of
``dynamo_tpu/models/llama.py``: the dense MLP and the MoE FFN in the JAX
package's dense-dispatch form (``moe_mlp``, every expert computed; its
``moe_impl="dense"``, what JAX runs at ep = 1) or its dropless and
capacity dispatch (models/moe.py), over plain or weight-only int8 leaves
(models/quant.py).

- **One forward for prefill and decode.** A step processes ``T`` query
  tokens per row (T = chunk for prefill, T = 1 for decode) against a paged
  KV cache addressed by per-request block tables.
- **Layers are stacked** ``[L, ...]`` as in the JAX params; ``lax.scan``
  becomes a Python loop over the layer index, which slices each leaf
  (both tensors of an int8 leaf) to the layer.
- **The cache is updated in place.** JAX donates the cache to the step
  program and gets a new array back; here ``_scatter_kv`` writes the new
  K/V into the layer's cache slice with ``index_copy_``, and ``forward``
  returns only the hidden state. A quantized cache (``{"q": payload
  [L, NB, BS, KH, Dp], "s": f32 scales [L, NB, KH]}``, engine/cache.py) is
  quantized at scatter time, in place on the layer's payload and scales.
- **Block 0 is the trash block**: padding tokens scatter their KV to flat
  slot 0, so ragged batches need no control flow. Duplicate indices there
  are harmless because no row ever reads block 0 below its kv_len.
- **Attention** goes through ``ops.paged_attention``: the CUDA kernel on
  the card, its plain version on the CPU. The large products stay
  ``torch.matmul``, as the JAX package left them to XLA.
- **Tensor parallelism** (a ``TPGroup``, parallel/collectives.py): each
  rank holds its shard of the params (parallel/mesh.py) and of the cache
  (its kv heads); the local head counts come from the weights' shapes.
  Every rank launches the attention kernel over its own heads — the
  port's ``paged_attention_sharded`` — and the partial products of ``wo``
  and the dense ``w_down`` are summed across ranks where GSPMD puts
  JAX's psum. A MoE layer's partial (its width over tp, its experts over
  ep) is summed once in f32 over the MoE group. The embedding and the
  logits are vocab-parallel. Data replicas (the group's ``dp``) and
  expert ranks (its ``ep``) hold the same attention shards and the whole
  cache; at tp > 1 a data replica launches the kernel on its rows of the
  batch, gathered before ``wo``. With no group the code is the
  one-device forward.
- **Sequence parallelism** (a group of ``sp > 1`` seq ranks,
  :func:`forward_ring`): params and cache are replicated over the seq
  ranks; a ring prefill step splits its positions over them, the K/V
  chunks passed round the ring (ops/ring_attention.py), and every other
  step runs on each seq rank as on one rank.
- **Pipeline parallelism** (a group of ``pp > 1`` stages,
  :func:`forward_pp`): each stage holds its layers and their cache, and a
  step runs JAX's GPipe schedule over microbatches, the activations
  passed stage to stage and the last stage's hidden brought back to
  stage 0, which samples.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.cache import cache_payload
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import layer_leaf, leaf_shape
from dynamo_tpu_torch.obs.profiler import phase as _perf_phase
from dynamo_tpu_torch.ops.paged_attention import (
    INT4_QMAX,
    pack_int4,
    unpack_int4,
)
from dynamo_tpu_torch.ops.paged_attention import paged_attention as paged_attention_kernel
from dynamo_tpu_torch.utils.device import lasting_empty, resolve_device

if TYPE_CHECKING:
    from dynamo_tpu_torch.parallel.collectives import TPGroup

Params = dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

#: f32 elements one draw of an MoE expert stack makes at a time (256 MiB):
#: a full-width stack drawn at once would need an f32 temporary of its
#: whole size (17 GB for gpt-oss-120b's ``w_gate`` at 4 layers)
EXPERT_SLAB_ELEMS = 1 << 26


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None, rank: int = 0, tp: int = 1,
                expert: int = 0, ep: int = 1, stage: int = 0, pp: int = 1) -> Params:
    """Random-init params with the JAX package's shapes and law (scaled
    normal: N(0, 1) · fan_in^-0.5, cast to ``cfg.dtype``; norms at 1),
    drawn from a ``torch.Generator`` on the target device seeded with
    ``seed``. The bits differ from JAX's threefry draws. An MoE model's
    expert stacks ``[L, E, in, out]`` are drawn a slab of experts at a
    time (:data:`EXPERT_SLAB_ELEMS`), from the same generator.

    With ``tp``, ``ep`` or ``pp`` > 1, the shard of the rank at (model
    ``rank``, expert ``expert``, stage ``stage``), equal to
    ``parallel.mesh.shard_params`` of the full tree: every draw is made as
    for the full tree and only the rank's slice of it is kept, so the rank
    never holds the whole tree (a leaf's f32 draw, or a slab of experts,
    at most). A stage past the first draws no ``embed`` or ``lm_head``:
    they come after every layer's draw, so skipping them leaves the
    layers' bits as they are."""
    from dynamo_tpu_torch.parallel.mesh import (
        check_pp,
        check_tp,
        rank_logical_axes,
        shard_leaf,
        stage_layers,
    )

    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, L = cfg.hidden_size, cfg.num_layers
    sharded = tp > 1 or ep > 1 or pp > 1
    if sharded:
        check_tp(cfg, tp, ep)
        check_pp(cfg, pp)
    axes = rank_logical_axes(cfg)
    cut = (rank, tp, expert, ep, stage, pp)
    l_lo, l_hi = stage_layers(cfg, stage, pp)

    def draw(out, fan_in):
        w = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.float32)
        out.copy_(w.mul_(fan_in ** -0.5))

    def dense(shape, fan_in, leaf_axes=()):
        if sharded and leaf_axes:
            w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
            w = shard_leaf(w, leaf_axes, *cut)
            out = lasting_empty(w.shape, dt, dev)
            out.copy_(w.mul_(fan_in ** -0.5))
            return out
        out = lasting_empty(shape, dt, dev)
        draw(out, fan_in)
        return out

    def expert_stack(shape, fan_in, key):
        step = max(1, EXPERT_SLAB_ELEMS // (shape[-2] * shape[-1]))
        if not sharded:
            out = lasting_empty(shape, dt, dev)
            mats = out.view(-1, *shape[-2:])
            for i in range(0, mats.shape[0], step):
                draw(mats[i: i + step], fan_in)
            return out
        # the full tree's slabs, drawn in order; the rank keeps its
        # experts' slice of each matrix
        e = shape[1]
        e_local = e // ep
        mat_axes = axes["layers"][key][2:]
        out = None
        for i in range(0, L * e, step):
            w = torch.randn((min(step, L * e - i), *shape[-2:]), generator=gen, device=dev,
                            dtype=torch.float32).mul_(fan_in ** -0.5)
            for j in range(w.shape[0]):
                li, ei = divmod(i + j, e)
                if ei // e_local != expert or not l_lo <= li < l_hi:
                    continue
                mat = shard_leaf(w[j], mat_axes, *cut)
                if out is None:
                    out = lasting_empty((l_hi - l_lo, e_local, *mat.shape), dt, dev)
                out[li - l_lo, ei - expert * e_local] = mat
        return out

    la = axes["layers"]
    layer: Params = {
        "wq": dense((L, h, cfg.q_size), h, la["wq"]),
        "wk": dense((L, h, cfg.kv_size), h, la["wk"]),
        "wv": dense((L, h, cfg.kv_size), h, la["wv"]),
        "wo": dense((L, cfg.q_size, h), cfg.q_size, la["wo"]),
        "attn_norm": torch.ones((l_hi - l_lo, h), dtype=dt, device=dev),
        "mlp_norm": torch.ones((l_hi - l_lo, h), dtype=dt, device=dev),
    }
    if cfg.is_moe:
        e, m = cfg.num_experts, cfg.moe_intermediate_size
        layer.update(
            router=dense((L, h, e), h, la["router"]),
            w_gate=expert_stack((L, e, h, m), h, "w_gate"),
            w_up=expert_stack((L, e, h, m), h, "w_up"),
            w_down=expert_stack((L, e, m, h), m, "w_down"),
        )
        if cfg.num_shared_experts:
            sm = m * cfg.num_shared_experts
            layer.update(
                shared_gate=dense((L, h, sm), h, la["shared_gate"]),
                shared_up=dense((L, h, sm), h, la["shared_up"]),
                shared_down=dense((L, sm, h), sm, la["shared_down"]),
            )
    else:
        i = cfg.intermediate_size
        layer.update(
            w_gate=dense((L, h, i), h, la["w_gate"]),
            w_up=dense((L, h, i), h, la["w_up"]),
            w_down=dense((L, i, h), i, la["w_down"]),
        )
    if stage > 0:
        return {"layers": layer}
    params: Params = {
        "embed": dense((cfg.vocab_size, h), h, axes["embed"]),
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
        "layers": layer,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((h, cfg.vocab_size), h, axes["lm_head"])
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-rotate (HF llama) convention.
    x: [B, T, H, D]; positions: [B, T]."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                              device=x.device) / d))
    angles = positions[..., None].float() * inv_freq            # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


#: floor for quantization scales — avoids div-by-zero on all-zero updates
#: (e.g. trash-block padding writes) while keeping real scales untouched.
_KV_SCALE_EPS = 1e-8

Cache = torch.Tensor | dict[str, torch.Tensor]


def _scatter_kv(cache: Cache, new: torch.Tensor, slot_idx: torch.Tensor) -> None:
    """Write new KV [B, T, KH, D] into one layer's paged cache
    [NB, BS, KH, D] at flat slots [B, T] (block * block_size + offset), in
    place. Padding tokens point at flat slot 0 of the trash block. A
    quantized cache (``{"q", "s"}``) goes through :func:`_scatter_kv_quant`."""
    if isinstance(cache, dict):
        _scatter_kv_quant(cache, new, slot_idx)
        return
    nb, bs, kh, d = cache.shape
    cache.view(nb * bs, kh, d).index_copy_(
        0, slot_idx.reshape(-1).long(), new.reshape(-1, kh, d).to(cache.dtype))


def _scatter_kv_quant(cache: dict[str, torch.Tensor], new: torch.Tensor,
                      slot_idx: torch.Tensor) -> None:
    """Int8/int4 scatter, in place on the layer's payload [NB, BS, KH, Dp]
    and scales [NB, KH]: the abs-max over the block update sets or merges
    the block's per-head scale, the rows already in touched blocks are
    requantized to the new scale, then the new rows are quantized and
    written over them.

    A write at block offset 0 marks the block as freshly (re)tenanted and
    resets its scale; mid-block writes merge by max so committed rows never
    lose range. A uint8 payload is packed int4 (±7, two nibbles a byte).

    Same arithmetic as the JAX function, bit for bit: everything new (the
    scales, the requantized rows) is computed from the OLD payload and
    scales before anything is written. Shapes are static — the requant
    gathers each token's whole block (duplicates write identical bytes) —
    so nothing here waits for the device."""
    q, s = cache["q"], cache["s"]
    int4 = q.dtype == torch.uint8
    qmax = INT4_QMAX if int4 else 127.0
    nb, bs, kh, _dp = q.shape
    d = new.shape[-1]
    idx = slot_idx.reshape(-1).long()                            # [N]
    vals = new.reshape(-1, kh, d).float()                        # [N, KH, D]
    blk = (idx // bs).clamp(0, nb - 1)
    off = idx % bs

    row_amax = vals.abs().amax(dim=-1)                           # [N, KH]
    upd_amax = torch.zeros((nb, kh), dtype=torch.float32, device=q.device).scatter_reduce_(
        0, blk[:, None].expand(-1, kh), row_amax, "amax")
    resets = torch.zeros((nb,), dtype=torch.int32, device=q.device).scatter_reduce_(
        0, blk, (off == 0).to(torch.int32), "amax") > 0          # fresh tenant
    # A divisor that is a Python scalar becomes a multiply by its reciprocal
    # on CUDA (another rounding than the CPU's and XLA's true division).
    s_cand = upd_amax / torch.full_like(upd_amax, qmax)
    s_new = torch.where(resets[:, None], s_cand, torch.maximum(s, s_cand))
    s_new = torch.maximum(s_new, torch.where(upd_amax > 0, _KV_SCALE_EPS, s_new))

    # Requantize the already-written rows of every touched block.
    ratio = torch.where(s_new > 0, s / s_new.clamp_min(_KV_SCALE_EPS), 0.0)
    old = q.index_select(0, blk)                                 # [N, BS, KH, Dp]
    old = (unpack_int4(old) if int4 else old).float()            # [N, BS, KH, D]
    requant = torch.clamp(torch.round(old * ratio.index_select(0, blk)[:, None, :, None]),
                          -qmax, qmax).to(torch.int32)
    requant = pack_int4(requant) if int4 else requant.to(torch.int8)

    # Quantize the new rows.
    s_rows = s_new.index_select(0, blk).clamp_min(_KV_SCALE_EPS)  # [N, KH]
    q_rows = torch.clamp(torch.round(vals / s_rows[:, :, None]), -qmax, qmax)
    q_rows = pack_int4(q_rows.to(torch.int32)) if int4 else q_rows.to(torch.int8)

    q.index_copy_(0, blk, requant)
    q.view(nb * bs, kh, -1).index_copy_(0, idx, q_rows)          # over the rescaled slots
    s.copy_(s_new)


def _gather_kv(cache: Cache, block_tables: torch.Tensor) -> torch.Tensor:
    """cache [NB, BS, KH, D], block_tables [B, NBLK] → [B, NBLK*BS, KH, D]
    in position order. A quantized cache is dequantized to f32 (a packed
    int4 payload unpacks its nibbles first)."""
    idx = block_tables.long()
    if isinstance(cache, dict):
        g = cache["q"][idx]                                      # [B, NBLK, BS, KH, Dp]
        if g.dtype == torch.uint8:
            g = unpack_int4(g)
        g = g.float() * cache["s"][idx][:, :, None, :, None]
    else:
        g = cache[idx]
    b, nblk, bs, kh, d = g.shape
    return g.reshape(b, nblk * bs, kh, d)


def _cache_block_size(cache: Cache) -> int:
    """block_size of a per-layer-stacked cache (tensor or ``{"q", "s"}``)."""
    return cache_payload(cache).shape[2]


def _layer_cache(cache: Cache, li: int) -> Cache:
    """Layer ``li``'s slice of a stacked cache: contiguous views, so the
    scatter writes through to the cache."""
    if isinstance(cache, dict):
        return {"q": cache["q"][li], "s": cache["s"][li]}
    return cache[li]


def paged_attention(q: torch.Tensor, ctx_k: torch.Tensor, ctx_v: torch.Tensor,
                    q_positions: torch.Tensor, kv_lens: torch.Tensor) -> torch.Tensor:
    """Dense attention over gathered paged context with the causal position
    mask — the JAX package's portable path (q scaled in f32; an all-masked
    row attends uniformly). The engine attends through the kernel
    (``ops.paged_attention``); this is kept as the JAX counterpart."""
    b, t, h, d = q.shape
    s = ctx_k.shape[1]
    kh = ctx_k.shape[2]
    rep = h // kh
    qf = (q.float() * d ** -0.5).reshape(b, t, kh, rep, d)
    scores = torch.einsum("btkrd,bskd->btkrs", qf, ctx_k.float())
    ctx_idx = torch.arange(s, device=q.device)[None, None, :]
    visible = ((ctx_idx <= q_positions[:, :, None].long())
               & (ctx_idx < kv_lens[:, None, None].long()))
    scores = torch.where(visible[:, :, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkrs,bskd->btkrd", probs, ctx_v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` over a plain or int8 (``{"q", "so"}``, models/quant.py)
    matrix. The int8 values are widened to x's dtype and the per-column
    scale, cast to x's dtype, applies after the contraction — the JAX
    package's two roundings."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["so"].to(x.dtype)
    return x @ w


def _embed_rows(embed, idx: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Rows ``idx`` of a plain or row-quantized (``{"q", "sr"}``) table at
    ``dt``: the int8 rows and their scales are each cast to ``dt`` before
    they multiply, as in the JAX package."""
    if isinstance(embed, dict):
        return embed["q"][idx].to(dt) * embed["sr"][idx][..., None].to(dt)
    return embed[idx].to(dt)


def embed_lookup(embed, token_ids: torch.Tensor,
                 dt: torch.dtype, tp: "TPGroup | None" = None,
                 vocab: int | None = None) -> torch.Tensor:
    """Embedding rows of ``token_ids`` from a plain or row-quantized table.
    Vocab-parallel under ``tp``: this rank's piece of the table holds rows
    ``[rank * per, (rank + 1) * per)``; a token outside it looks up zeros,
    and the sum over ranks is the one rank's row, bit for bit. An id past
    the vocabulary (``vocab``, the global one; else the table's rows over
    every rank) reads its last row, as the JAX package's gather clamps
    (an unclamped index would be a device-side fault on the card, and at
    tp > 1 no rank's piece would hold it)."""
    per = leaf_shape(embed)[0]
    last = (vocab if vocab is not None else per * (tp.size if tp is not None else 1)) - 1
    ids = token_ids.long().clamp(0, last)
    if tp is None:
        return _embed_rows(embed, ids, dt)
    local = ids - tp.rank * per
    mine = (local >= 0) & (local < per)
    rows = _embed_rows(embed, local.clamp(0, per - 1), dt)
    return tp.all_reduce_sum(torch.where(mine[..., None], rows, torch.zeros_like(rows)))


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of the last axis and their indices, equal
    values in index order — ``lax.top_k``'s order (``torch.topk`` promises
    none): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


#: bytes one f32 intermediate of a slab of experts may take in
#: :func:`moe_mlp` (the all-expert product at gpt-oss-120b width is
#: 1.5 GB of bf16 a tensor for 2048 rows, and its f32 combine twice that)
MOE_SLAB_BYTES = 1 << 30


def moe_mlp(x: torch.Tensor, lp: Params, cfg: ModelConfig,
            tp: "TPGroup | None" = None) -> torch.Tensor:
    """MoE FFN, the JAX package's dense-dispatch formulation: every expert
    computed for every token, combined by the top-k router weights. x:
    [B, T, H].

    Router logits in f32, ``top_k`` in ``lax.top_k``'s tie order, softmax
    over the top values, an f32 gate mask [N, E]. Each expert's output is
    rounded to the model dtype and summed in f32 with its gate weight, as
    JAX's ``per_expert.astype(f32)`` einsum does; the experts go a slab at
    a time so that the [slab, N, M] and [slab, N, H] intermediates stay
    under :data:`MOE_SLAB_BYTES` (the f32 sum visits the slabs in order).
    The shared expert, if any, adds through :func:`swiglu`.

    Under ``tp`` with more than one rank in the MoE group (tp x ep), the
    expert stacks are the rank's shard: its experts (``ep``) and its slice
    of their width M (TEP, ``tp``), so each rank's f32 sum is a partial
    over both. The shared expert's partial (its width split too) joins it
    in f32, over ep, and one f32 all-reduce over the MoE group completes
    the layer before its one cast: a model-dtype partial would round once
    a rank."""
    b, t, h = x.shape
    xt = x.reshape(-1, h)                                       # [N, H]
    n = xt.shape[0]
    logits = xt.float() @ lp["router"].float()                  # [N, E]
    e = cfg.num_experts
    topv, topi = top_k(logits, cfg.num_experts_per_tok)
    weights = torch.softmax(topv, dim=-1)                       # [N, k]
    gate_mask = torch.zeros((n, e), dtype=torch.float32, device=x.device)
    gate_mask.scatter_add_(1, topi, weights)                    # [N, E]
    w_gate, w_up, w_down = lp["w_gate"], lp["w_up"], lp["w_down"]
    e_local, m_local = w_gate.shape[0], w_gate.shape[-1]
    e_lo = tp.expert_rank * e_local if tp is not None else 0
    slab = max(1, min(e_local, MOE_SLAB_BYTES // (4 * n * max(h, m_local))))
    out = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    for lo in range(0, e_local, slab):
        hi = min(lo + slab, e_local)
        gate = torch.matmul(xt, w_gate[lo:hi])                  # [S, N, M]
        up = torch.matmul(xt, w_up[lo:hi])
        per_expert = torch.matmul(F.silu(gate) * up, w_down[lo:hi])   # [S, N, H]
        out += torch.einsum("snh,ns->nh", per_expert.float(), gate_mask[:, e_lo + lo:e_lo + hi])
    shared = ((lp["shared_gate"], lp["shared_up"], lp["shared_down"])
              if cfg.num_shared_experts else None)
    if tp is not None and tp.moe_size > 1:
        if shared is not None:
            out += swiglu(xt, *shared).float() / tp.ep
        return tp.all_reduce_moe(out).to(x.dtype).reshape(b, t, h)
    out = out.to(x.dtype)
    if shared is not None:
        out = out + swiglu(xt, *shared)
    return out.reshape(b, t, h)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _step_statics(q_start: torch.Tensor, q_len: torch.Tensor, block_tables: torch.Tensor,
                  t: int, bs: int):
    """A step's positions [B, T], flat cache slots [B, T] (padding → slot
    0 of the trash block), and the kernel's int32 block tables, q_start
    and kv_lens."""
    dev = q_start.device
    ar = torch.arange(t, device=dev)
    positions = q_start[:, None].long() + ar[None, :]                 # [B, T]
    valid = ar[None, :] < q_len[:, None]                              # [B, T]
    blk = torch.gather(block_tables.long(), 1,
                       (positions // bs).clamp(0, block_tables.shape[1] - 1))
    slot = torch.where(valid, blk * bs + positions % bs, torch.zeros_like(blk))
    return (positions, slot, block_tables.to(torch.int32).contiguous(),
            q_start.to(torch.int32).contiguous(), (q_start + q_len).to(torch.int32))


def _layer(lp: Params, hid: torch.Tensor, ck: Cache, cv: Cache, positions: torch.Tensor,
           slot: torch.Tensor, bt32: torch.Tensor, qs32: torch.Tensor, kv_lens: torch.Tensor,
           cfg: ModelConfig, attn_num_splits: int = 0, tp: "TPGroup | None" = None,
           moe_impl: str = "dense", split_rows: bool = False) -> torch.Tensor:
    """One layer of the forward on hid [B, T, H] over the layer's cache
    slices ``ck``, ``cv``: attention through the kernel (over this data
    replica's rows with ``split_rows``), then the FFN. Returns the new
    hidden state; the step's K/V are written into the cache."""
    b = positions.shape[0]
    q, k, v = _qkv(lp, hid, positions, cfg)
    # Phase hooks (obs/profiler.py): host-side labels for torch.profiler
    # traces, no device op; under a graph capture they run at capture
    # time only.
    with _perf_phase("scatter"):
        _scatter_kv(ck, k, slot)
        _scatter_kv(cv, v, slot)
    with _perf_phase("attention"):
        if split_rows:
            # this data replica's rows, gathered over the data group
            r = slice(tp.data_rank * (b // tp.dp), (tp.data_rank + 1) * (b // tp.dp))
            attn = tp.gather_rows(
                paged_attention_kernel(q[r].contiguous(), ck, cv, bt32[r].contiguous(),
                                       qs32[r].contiguous(), kv_lens[r].contiguous(),
                                       num_splits=attn_num_splits), b)
        else:
            attn = paged_attention_kernel(q.contiguous(), ck, cv, bt32, qs32, kv_lens,
                                          num_splits=attn_num_splits)
    return _ffn(lp, _attn_out(lp, hid, attn, tp), cfg, tp, moe_impl)


def _qkv(lp: Params, hid: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A layer's attention prologue on hid [B, T, H] at ``positions`` [B,
    T]: the attention norm, the q, k and v projections split into heads
    (this rank's, under tp), and rope on q and k. Returns q [B, T, heads,
    D], k and v [B, T, kv_heads, D]."""
    b, t = positions.shape
    d = cfg.head_dim
    heads, kv_heads = leaf_shape(lp["wq"])[-1] // d, leaf_shape(lp["wk"])[-1] // d
    x = rms_norm(hid, lp["attn_norm"], cfg.rms_norm_eps)
    q = mm(x, lp["wq"]).reshape(b, t, heads, d)
    k = mm(x, lp["wk"]).reshape(b, t, kv_heads, d)
    v = mm(x, lp["wv"]).reshape(b, t, kv_heads, d)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _attn_out(lp: Params, hid: torch.Tensor, attn: torch.Tensor,
              tp: "TPGroup | None" = None) -> torch.Tensor:
    """``hid`` plus the attention's output projection of attn [B, T,
    heads, D] (its ``wo`` partial summed over the model group)."""
    out = mm(attn.reshape(*hid.shape[:2], -1), lp["wo"])
    return hid + (out if tp is None else tp.all_reduce_sum(out))


def _ffn(lp: Params, hid: torch.Tensor, cfg: ModelConfig, tp: "TPGroup | None" = None,
         moe_impl: str = "dense") -> torch.Tensor:
    """A layer's second half on hid [B, T, H]: the MLP norm, then the dense
    MLP (its ``w_down`` partial summed over the model group) or the MoE
    FFN that ``moe_impl`` names, added to ``hid``."""
    x = rms_norm(hid, lp["mlp_norm"], cfg.rms_norm_eps)
    if cfg.is_moe:
        # each reduces over the MoE group itself, in f32
        if moe_impl == "ep":
            from dynamo_tpu_torch.models.moe import moe_mlp_dropless

            return hid + moe_mlp_dropless(x, lp, cfg, tp)
        if moe_impl == "ep_capacity":
            if tp is not None and tp.moe_size > 1:
                raise ValueError("moe_impl='ep_capacity' runs on one device")
            from dynamo_tpu_torch.models.moe import moe_mlp_ep

            return hid + moe_mlp_ep(x, lp, cfg)
        if moe_impl == "dense":
            return hid + moe_mlp(x, lp, cfg, tp)
        raise ValueError(f"unknown moe_impl {moe_impl!r} (dense, ep, ep_capacity)")
    out = swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    return hid + (out if tp is None else tp.all_reduce_sum(out))


def forward(params: Params, cfg: ModelConfig,
            token_ids: torch.Tensor,      # [B, T] int32
            q_start: torch.Tensor,        # [B] position of first query token
            q_len: torch.Tensor,          # [B] valid query tokens (≤ T)
            block_tables: torch.Tensor,   # [B, NBLK] int32 block ids
            cache_k: Cache,               # [L, NB, BS, KH, D] or {"q", "s"}, updated in place
            cache_v: Cache,
            attn_num_splits: int = 0,     # split-K: 0 auto, 1 off, N forced
            return_all_hidden: bool = False,
            embed_override: torch.Tensor | None = None,  # [B, T, H] multimodal embeds
            embed_mask: torch.Tensor | None = None,      # [B, T] True → use override
            tp: "TPGroup | None" = None,                 # this rank's group
            moe_impl: str = "dense",                     # "dense", "ep" or "ep_capacity"
            pp_microbatches: int = 0,                    # pp > 1: schedule depth (0 = auto)
            sp_prefill: bool = False,                    # sp > 1: a ring prefill step
            ) -> torch.Tensor | None:
    """One engine step. Returns the final-norm hidden state at each row's
    last valid query token [B, H] (or at every token [B, T, H] with
    ``return_all_hidden``: the speculative verify step), and writes the
    step's K/V into the caches. Where ``embed_mask`` is True the token's
    embedding is ``embed_override``'s row, cast to the hidden dtype
    (multimodal positions carry encoder outputs).

    Query token t of row b sits at position q_start[b] + t; its KV goes to
    the cache slot its block table names; attention sees every cache
    position ≤ its own and < q_start + q_len. Under ``tp`` the params and
    the caches are this rank's shards; a data replica (``tp.dp > 1``)
    computes every row but, at ``tp.size > 1``, attends only its share of
    them (the cache is replicated: every replica scatters every row). An
    expert rank (``tp.ep > 1``) computes its model shard's attention, as
    every expert rank of that shard does (JAX replicates attention over
    "expert"), and its part of each MoE layer. A group of more than one
    pipeline stage (``tp.pp > 1``) runs :func:`forward_pp`.

    ``moe_impl`` picks a MoE model's FFN, as JAX's ``forward`` does:
    ``"dense"`` (:func:`moe_mlp`, the width split over tp), ``"ep"``
    (``models/moe.moe_mlp_dropless``, the experts split over ep too) or
    ``"ep_capacity"`` (``models/moe.moe_mlp_ep``, one device).

    ``sp_prefill`` (the engine's flag for a step of fresh whole prompts
    past the ring threshold) takes the ring (:func:`forward_ring`) where
    JAX's forward takes it: more than one seq rank, T > 1 dividing over
    them, the kv heads over tp and the rows over dp. Anything else runs
    the step below on every seq rank, as on one rank."""
    if tp is not None and tp.pp > 1:
        if return_all_hidden:
            raise ValueError("forward_pp has no all-positions output")
        if embed_override is not None:
            raise ValueError("forward_pp has no embedding-override input")
        return forward_pp(params, cfg, token_ids, q_start, q_len, block_tables, cache_k,
                          cache_v, tp, microbatches=pp_microbatches,
                          attn_num_splits=attn_num_splits)
    b, t = token_ids.shape
    if (sp_prefill and tp is not None and tp.sp > 1 and t > 1 and t % tp.sp == 0
            and cfg.num_kv_heads % tp.size == 0 and b % tp.dp == 0):
        return forward_ring(params, cfg, token_ids, q_len, block_tables, cache_k, cache_v,
                            tp, moe_impl)
    positions, slot, bt32, qs32, kv_lens = _step_statics(
        q_start, q_len, block_tables, t, _cache_block_size(cache_k))
    # Data parallelism with tensor parallelism (JAX: paged_attention_sharded's
    # P("data", ...) batch): each replica attends its b/dp rows, when they
    # divide; otherwise (JAX's dense fallback) every replica the whole
    # batch, through the same kernel.
    split_rows = tp is not None and tp.dp > 1 and tp.size > 1 and b % tp.dp == 0

    hid = embed_lookup(params["embed"], token_ids, torch_dtype(cfg.dtype), tp,
                       cfg.vocab_size)  # [B, T, H]
    if embed_override is not None:
        hid = torch.where(embed_mask[..., None], embed_override.to(hid.dtype), hid)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        lp = {key: layer_leaf(leaf, li) for key, leaf in layers.items()}
        hid = _layer(lp, hid, _layer_cache(cache_k, li), _layer_cache(cache_v, li),
                     positions, slot, bt32, qs32, kv_lens, cfg, attn_num_splits, tp,
                     moe_impl, split_rows)
    h = rms_norm(hid, params["final_norm"], cfg.rms_norm_eps)
    if return_all_hidden:
        return h
    last_idx = (q_len.long() - 1).clamp(0, t - 1)                     # [B]
    return h[torch.arange(b, device=token_ids.device), last_idx]      # [B, H]


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------

def forward_ring(params: Params, cfg: ModelConfig, token_ids: torch.Tensor,
                 q_len: torch.Tensor, block_tables: torch.Tensor, cache_k: Cache,
                 cache_v: Cache, tp: "TPGroup", moe_impl: str = "dense") -> torch.Tensor:
    """A ring prefill step (JAX: ``forward`` with ``sp_prefill``, which
    swaps the paged kernel for ``ring_attention_prefill``): every row is a
    fresh whole prompt (q_start = 0), so its attention context is the step
    itself. Seq rank ``q`` of ``sp`` carries positions ``[q T/sp, (q+1)
    T/sp)`` of every row through every layer: the embedding, the norms,
    the projections, rope at the global positions, the ring over the seq
    group (ops/ring_attention.py, on the raw K and V as in JAX), ``wo``
    with the model group's sum and the MLP or MoE FFN, so the matmul work
    splits sp ways. Every K/V chunk the rank held in the ring is kept, and
    the whole [B, T, KH, D] is written into the rank's cache once a layer
    after the ring: a quantized block sees all of its rows at once, as in
    JAX's one scatter a layer (the cache stays replicated over seq). A
    row's last prompt token lies on one seq rank; its final-norm hidden
    [B, H] reaches every rank as the sum of each rank's rows (zeros for
    the rows it does not hold) over the seq group.

    A padding row (q_len 0: a row of the step's bucket that no prompt
    fills) is left out of the step: its hidden is zeros, its K/V are not
    written and do not hop. JAX computes it and scatters its K/V into the
    trash block, which nothing reads; no other row depends on it."""
    from dynamo_tpu_torch.ops.ring_attention import ring_attention_prefill

    b, t = token_ids.shape
    live = torch.nonzero(q_len > 0).flatten()     # the same rows on every rank
    if live.numel() < b:
        out = torch.zeros((b, cfg.hidden_size), dtype=torch_dtype(cfg.dtype),
                          device=token_ids.device)
        if live.numel():
            out[live] = forward_ring(params, cfg, token_ids[live], q_len[live],
                                     block_tables[live], cache_k, cache_v, tp, moe_impl)
        return out
    sp, q = tp.sp, tp.seq_rank
    tl = t // sp
    mine = slice(q * tl, (q + 1) * tl)
    positions, slot, _, _, kv_lens = _step_statics(
        torch.zeros_like(q_len), q_len, block_tables, t, _cache_block_size(cache_k))
    pos = positions[:, mine]
    hid = embed_lookup(params["embed"], token_ids[:, mine], torch_dtype(cfg.dtype), tp,
                       cfg.vocab_size)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        lp = {key: layer_leaf(leaf, li) for key, leaf in layers.items()}
        qh, k, v = _qkv(lp, hid, pos, cfg)
        held: list = []
        with _perf_phase("attention"):
            attn = ring_attention_prefill(tp, qh, k, v, kv_lens, keep=held)
        held.sort(key=lambda c: c[0])
        with _perf_phase("scatter"):
            _scatter_kv(_layer_cache(cache_k, li), torch.cat([c[1] for c in held], dim=1), slot)
            _scatter_kv(_layer_cache(cache_v, li), torch.cat([c[2] for c in held], dim=1), slot)
        del held
        hid = _ffn(lp, _attn_out(lp, hid, attn, tp), cfg, tp, moe_impl)
    h = rms_norm(hid, params["final_norm"], cfg.rms_norm_eps)          # [B, T/sp, H]
    last = (q_len.long() - 1).clamp(0, t - 1) - q * tl                  # [B]
    here = (last >= 0) & (last < tl)
    rows = h[torch.arange(b, device=h.device), last.clamp(0, tl - 1)]
    return tp.sum_seq(torch.where(here[:, None], rows, torch.zeros_like(rows)))


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------

def pp_microbatch_count(b: int, t: int, pp: int, microbatches: int = 0) -> int:
    """The microbatches of a [b, t] step over ``pp`` stages, as JAX's
    ``forward_pp`` counts them: the largest divisor of the split axis (t
    for a prefill chunk, b for decode) that is at most the target
    (``microbatches``, or 2·pp when 0)."""
    target = microbatches if microbatches > 0 else 2 * pp
    axis = t if t > 1 else b
    m = min(target, axis)
    while m > 1 and axis % m:
        m -= 1
    return m


def forward_pp(params: Params, cfg: ModelConfig, token_ids: torch.Tensor,
               q_start: torch.Tensor, q_len: torch.Tensor, block_tables: torch.Tensor,
               cache_k: Cache, cache_v: Cache, tp: "TPGroup", microbatches: int = 0,
               attn_num_splits: int = 0) -> torch.Tensor | None:
    """Pipeline-parallel forward (JAX: ``forward_pp``): this rank is stage
    ``tp.stage`` of ``tp.pp`` and holds layers ``[s L/pp, (s+1) L/pp)`` and
    their cache. Every stage has the step's inputs (the leader broadcast
    them); stage 0 embeds.

    GPipe's schedule over ``m`` microbatches (:func:`pp_microbatch_count`):
    a prefill chunk (T > 1) splits along T — sub-chunk c sits at ``q_start
    + c·T/m`` and sees the cache up to ``q_start + min(q_len, (c+1)·T/m)``,
    which the sub-chunks before it wrote: a stage runs them in index
    order, which is the causal order — and decode (T = 1) splits along B.
    A stage takes microbatch c from the stage before it (stage 0 from its
    embeddings), runs its layers on it (:func:`_pp_stage_block`, the
    kernel in every layer) and hands it on, so stage s works on
    microbatch c while stage s + 1 works on c - 1. JAX's bubble ticks
    compute on stale activations and write to trash block 0; here a stage
    idles instead, which leaves every block but the trash block as JAX's
    stage leaves it. Fewer than 2 microbatches take the sequential
    schedule (JAX: ``_forward_pp_sequential``, a lone decode row): the
    whole batch goes through the stages one after the other. JAX's runs
    every stage every round and keeps stage i's result in round i,
    through dense attention; the port runs each stage once, through the
    kernel.

    The last stage picks each row's last valid token and sends those rows
    [B, H] to stage 0 (JAX's psum over "pipe" of a buffer only the last
    stage fills, before its pick), which applies the final norm and
    returns them; the other stages return None. The MoE FFN is the dense
    dispatch in every stage, as in JAX's stage block."""
    b, t = token_ids.shape
    positions, slot, bt32, qs32, kv_lens = _step_statics(
        q_start, q_len, block_tables, t, _cache_block_size(cache_k))
    h0 = (embed_lookup(params["embed"], token_ids, torch_dtype(cfg.dtype))
          if tp.stage == 0 else None)
    m = pp_microbatch_count(b, t, tp.pp, microbatches)
    parts = []
    if m < 2:     # the sequential schedule
        parts.append(((slice(None),), positions, slot, bt32, qs32, kv_lens))
    elif t > 1:   # sub-chunks of T
        tm = t // m
        for c in range(m):
            cols = slice(c * tm, (c + 1) * tm)
            kl = (q_start + torch.clamp(q_len, max=(c + 1) * tm)).to(torch.int32)
            parts.append(((slice(None), cols), positions[:, cols], slot[:, cols], bt32,
                          qs32 + c * tm, kl))
    else:       # rows of B
        bm = b // m
        for c in range(m):
            rows = slice(c * bm, (c + 1) * bm)
            parts.append(((rows,), positions[rows], slot[rows], bt32[rows], qs32[rows],
                          kv_lens[rows]))
    return _pp_schedule(params, cfg, parts, cache_k, cache_v, tp, h0, q_len, attn_num_splits)


def _pp_schedule(params, cfg, parts, cache_k, cache_v, tp, h0, q_len, attn_num_splits):
    """Run this stage's part of the schedule over ``parts`` (a
    microbatch's index into [B, T] — rows, or all rows and a range of T —
    and its positions, slots, block tables, q_start and kv_lens), in
    order, and bring the last stage's hidden to stage 0 (see
    :func:`forward_pp`)."""
    pp, s = tp.pp, tp.stage
    dt = torch_dtype(cfg.dtype)
    outs = []
    for index, pos, slot, bt, qs, kl in parts:
        shape = (*pos.shape, cfg.hidden_size)
        h = h0[index] if s == 0 else tp.recv_stage(shape, dt, s - 1)
        h = _pp_stage_block(cfg, params["layers"], cache_k, cache_v, h, pos, slot, bt, qs, kl,
                            attn_num_splits)
        tp.microbatches += 1
        if s < pp - 1:
            tp.send_stage(h, s + 1)
        else:
            outs.append(h)
    b = q_len.shape[0]
    if s == pp - 1:
        h = torch.cat(outs, dim=len(parts[0][0]) - 1)                  # [B, T, H]
        last_idx = (q_len.long() - 1).clamp(0, h.shape[1] - 1)
        tp.send_stage(h[torch.arange(b, device=h.device), last_idx], 0)
        return None
    if s > 0:
        return None
    last_h = tp.recv_stage((b, cfg.hidden_size), dt, pp - 1)
    return rms_norm(last_h, params["final_norm"], cfg.rms_norm_eps)


def _pp_stage_block(cfg: ModelConfig, layers: Params, cache_k: Cache, cache_v: Cache,
                    h: torch.Tensor, positions: torch.Tensor, slot: torch.Tensor,
                    bt32: torch.Tensor, qs32: torch.Tensor, kv_lens: torch.Tensor,
                    attn_num_splits: int = 0) -> torch.Tensor:
    """One stage's layer block (JAX: ``_pp_stage_block``) on one
    microbatch: :func:`_layer` over the stage's layers, local layer ``li``
    on the stage's cache slice ``li``; the MoE FFN is the dense dispatch."""
    for li in range(leaf_shape(layers["attn_norm"])[0]):
        lp = {key: layer_leaf(leaf, li) for key, leaf in layers.items()}
        h = _layer(lp, h, _layer_cache(cache_k, li), _layer_cache(cache_v, li), positions,
                   slot, bt32, qs32, kv_lens, cfg, attn_num_splits)
    return h


def logits_from_hidden(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
                       tp: "TPGroup | None" = None) -> torch.Tensor:
    """Project hidden [..., H] → logits [..., V] (tied or separate lm head).
    Under ``tp`` each rank projects onto its vocab piece and the pieces are
    gathered (``TPGroup.gather_vocab``)."""
    with _perf_phase("logits"):
        e = params["embed"]
        if cfg.tie_word_embeddings and isinstance(e, dict):
            # a row-quantized table: its row scale is the logit column's,
            # applied after the contraction
            logits = (hidden @ e["q"].to(hidden.dtype).T) * e["sr"].to(hidden.dtype)
        elif cfg.tie_word_embeddings:
            logits = hidden @ e.T
        else:
            logits = mm(hidden, params["lm_head"])
        return logits if tp is None else tp.gather_vocab(logits, cfg.vocab_size)
