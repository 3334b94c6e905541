"""Llama-family transformer in PyTorch over a paged KV cache — port of
``dynamo_tpu/models/llama.py``: the dense MLP and the MoE FFN in the JAX
package's dense-dispatch form (``moe_mlp``, every expert computed; its
``moe_impl="dense"``, what JAX runs at ep = 1), over plain or weight-only
int8 leaves (models/quant.py).

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
  and ``w_down`` are summed across ranks where GSPMD puts JAX's psum. The
  embedding and the logits are vocab-parallel. With no group the code is
  the one-device forward.
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
                device: str | torch.device | None = None) -> Params:
    """Random-init params with the JAX package's shapes and law (scaled
    normal: N(0, 1) · fan_in^-0.5, cast to ``cfg.dtype``; norms at 1),
    drawn from a ``torch.Generator`` on the target device seeded with
    ``seed``. The bits differ from JAX's threefry draws. An MoE model's
    expert stacks ``[L, E, in, out]`` are drawn a slab of experts at a
    time (:data:`EXPERT_SLAB_ELEMS`), from the same generator."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, L = cfg.hidden_size, cfg.num_layers

    def draw(out, fan_in):
        w = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.float32)
        out.copy_(w.mul_(fan_in ** -0.5))

    def dense(shape, fan_in):
        out = lasting_empty(shape, dt, dev)
        draw(out, fan_in)
        return out

    def expert_stack(shape, fan_in):
        out = lasting_empty(shape, dt, dev)
        mats = out.view(-1, *shape[-2:])
        step = max(1, EXPERT_SLAB_ELEMS // (shape[-2] * shape[-1]))
        for i in range(0, mats.shape[0], step):
            draw(mats[i: i + step], fan_in)
        return out

    layer: Params = {
        "wq": dense((L, h, cfg.q_size), h),
        "wk": dense((L, h, cfg.kv_size), h),
        "wv": dense((L, h, cfg.kv_size), h),
        "wo": dense((L, cfg.q_size, h), cfg.q_size),
        "attn_norm": torch.ones((L, h), dtype=dt, device=dev),
        "mlp_norm": torch.ones((L, h), dtype=dt, device=dev),
    }
    if cfg.is_moe:
        e, m = cfg.num_experts, cfg.moe_intermediate_size
        layer.update(
            router=dense((L, h, e), h),
            w_gate=expert_stack((L, e, h, m), h),
            w_up=expert_stack((L, e, h, m), h),
            w_down=expert_stack((L, e, m, h), m),
        )
        if cfg.num_shared_experts:
            sm = m * cfg.num_shared_experts
            layer.update(
                shared_gate=dense((L, h, sm), h),
                shared_up=dense((L, h, sm), h),
                shared_down=dense((L, sm, h), sm),
            )
    else:
        i = cfg.intermediate_size
        layer.update(
            w_gate=dense((L, h, i), h),
            w_up=dense((L, h, i), h),
            w_down=dense((L, i, h), i),
        )
    params: Params = {
        "embed": dense((cfg.vocab_size, h), h),
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
        "layers": layer,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((h, cfg.vocab_size), h)
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
                 dt: torch.dtype, tp: "TPGroup | None" = None) -> torch.Tensor:
    """Embedding rows of ``token_ids`` from a plain or row-quantized table.
    Vocab-parallel under ``tp``: this rank's piece of the table holds rows
    ``[rank * per, (rank + 1) * per)``; a token outside it looks up zeros,
    and the sum over ranks is the one rank's row, bit for bit. An id past
    the vocabulary reads its last row, as the JAX package's gather clamps
    (an unclamped index would be a device-side fault on the card)."""
    if tp is None:
        return _embed_rows(embed, token_ids.long().clamp(0, leaf_shape(embed)[0] - 1), dt)
    per = leaf_shape(embed)[0]
    local = token_ids.long() - tp.rank * per
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


def moe_mlp(x: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    """MoE FFN, the JAX package's dense-dispatch formulation: every expert
    computed for every token, combined by the top-k router weights. x:
    [B, T, H].

    Router logits in f32, ``top_k`` in ``lax.top_k``'s tie order, softmax
    over the top values, an f32 gate mask [N, E]. Each expert's output is
    rounded to the model dtype and summed in f32 with its gate weight, as
    JAX's ``per_expert.astype(f32)`` einsum does; the experts go a slab at
    a time so that the [slab, N, M] and [slab, N, H] intermediates stay
    under :data:`MOE_SLAB_BYTES` (the f32 sum visits the slabs in order).
    The shared expert, if any, adds through :func:`swiglu`."""
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
    slab = max(1, min(e, MOE_SLAB_BYTES // (4 * n * max(h, cfg.moe_intermediate_size))))
    out = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    for lo in range(0, e, slab):
        hi = min(lo + slab, e)
        gate = torch.matmul(xt, w_gate[lo:hi])                  # [S, N, M]
        up = torch.matmul(xt, w_up[lo:hi])
        per_expert = torch.matmul(F.silu(gate) * up, w_down[lo:hi])   # [S, N, H]
        out += torch.einsum("snh,ns->nh", per_expert.float(), gate_mask[:, lo:hi])
    out = out.to(x.dtype)
    if cfg.num_shared_experts:
        out = out + swiglu(xt, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
    return out.reshape(b, t, h)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

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
            ) -> torch.Tensor:
    """One engine step. Returns the final-norm hidden state at each row's
    last valid query token [B, H] (or at every token [B, T, H] with
    ``return_all_hidden``: the speculative verify step), and writes the
    step's K/V into the caches. Where ``embed_mask`` is True the token's
    embedding is ``embed_override``'s row, cast to the hidden dtype
    (multimodal positions carry encoder outputs).

    Query token t of row b sits at position q_start[b] + t; its KV goes to
    the cache slot its block table names; attention sees every cache
    position ≤ its own and < q_start + q_len. Under ``tp`` the params and
    the caches are this rank's shards."""
    b, t = token_ids.shape
    bs = _cache_block_size(cache_k)
    dev = token_ids.device
    ar = torch.arange(t, device=dev)
    positions = q_start[:, None].long() + ar[None, :]                 # [B, T]
    valid = ar[None, :] < q_len[:, None]                              # [B, T]
    kv_lens = (q_start + q_len).to(torch.int32)                       # [B]
    blk = torch.gather(block_tables.long(), 1,
                       (positions // bs).clamp(0, block_tables.shape[1] - 1))
    slot = torch.where(valid, blk * bs + positions % bs, torch.zeros_like(blk))
    bt32 = block_tables.to(torch.int32).contiguous()
    qs32 = q_start.to(torch.int32).contiguous()

    hid = embed_lookup(params["embed"], token_ids, torch_dtype(cfg.dtype), tp)  # [B, T, H]
    if embed_override is not None:
        hid = torch.where(embed_mask[..., None], embed_override.to(hid.dtype), hid)
    layers = params["layers"]
    d = cfg.head_dim
    heads, kv_heads = leaf_shape(layers["wq"])[-1] // d, leaf_shape(layers["wk"])[-1] // d
    for li in range(cfg.num_layers):
        lp = {key: layer_leaf(leaf, li) for key, leaf in layers.items()}
        x = rms_norm(hid, lp["attn_norm"], cfg.rms_norm_eps)
        q = mm(x, lp["wq"]).reshape(b, t, heads, d)
        k = mm(x, lp["wk"]).reshape(b, t, kv_heads, d)
        v = mm(x, lp["wv"]).reshape(b, t, kv_heads, d)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        ck, cv = _layer_cache(cache_k, li), _layer_cache(cache_v, li)
        # Phase hooks (obs/profiler.py): host-side labels for torch.profiler
        # traces, no device op; under a graph capture they run at capture
        # time only.
        with _perf_phase("scatter"):
            _scatter_kv(ck, k, slot)
            _scatter_kv(cv, v, slot)
        with _perf_phase("attention"):
            attn = paged_attention_kernel(q.contiguous(), ck, cv, bt32, qs32, kv_lens,
                                          num_splits=attn_num_splits)
        out = mm(attn.reshape(b, t, heads * d), lp["wo"])
        hid = hid + (out if tp is None else tp.all_reduce_sum(out))
        x = rms_norm(hid, lp["mlp_norm"], cfg.rms_norm_eps)
        if cfg.is_moe:
            out = moe_mlp(x, lp, cfg)       # one device: the engine refuses MoE at tp > 1
        else:
            out = swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
        hid = hid + (out if tp is None else tp.all_reduce_sum(out))
    h = rms_norm(hid, params["final_norm"], cfg.rms_norm_eps)
    if return_all_hidden:
        return h
    last_idx = (q_len.long() - 1).clamp(0, t - 1)                     # [B]
    return h[torch.arange(b, device=dev), last_idx]                   # [B, H]


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
