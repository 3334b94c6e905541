"""Llama-family transformer in PyTorch over a paged KV cache — port of
``dynamo_tpu/models/llama.py`` for one device and a dense MLP.

- **One forward for prefill and decode.** A step processes ``T`` query
  tokens per row (T = chunk for prefill, T = 1 for decode) against a paged
  KV cache addressed by per-request block tables.
- **Layers are stacked** ``[L, ...]`` as in the JAX params; ``lax.scan``
  becomes a Python loop over the layer index.
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
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.cache import cache_payload
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.obs.profiler import phase as _perf_phase
from dynamo_tpu_torch.ops.paged_attention import (
    INT4_QMAX,
    pack_int4,
    unpack_int4,
)
from dynamo_tpu_torch.ops.paged_attention import paged_attention as paged_attention_kernel
from dynamo_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> Params:
    """Random-init params with the JAX package's shapes and law (scaled
    normal: N(0, 1) · fan_in^-0.5, cast to ``cfg.dtype``; norms at 1),
    drawn from a ``torch.Generator`` on the target device seeded with
    ``seed``. The bits differ from JAX's threefry draws."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP: MoE slice)")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, L, i = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dt)

    layer: Params = {
        "wq": dense((L, h, cfg.q_size), h),
        "wk": dense((L, h, cfg.kv_size), h),
        "wv": dense((L, h, cfg.kv_size), h),
        "wo": dense((L, cfg.q_size, h), cfg.q_size),
        "attn_norm": torch.ones((L, h), dtype=dt, device=dev),
        "mlp_norm": torch.ones((L, h), dtype=dt, device=dev),
        "w_gate": dense((L, h, i), h),
        "w_up": dense((L, h, i), h),
        "w_down": dense((L, i, h), i),
    }
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


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def embed_lookup(embed: torch.Tensor, token_ids: torch.Tensor,
                 dt: torch.dtype) -> torch.Tensor:
    return embed[token_ids.long()].to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


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
            ) -> torch.Tensor:
    """One engine step. Returns the final-norm hidden state at each row's
    last valid query token [B, H] (or at every token [B, T, H] with
    ``return_all_hidden``: the speculative verify step), and writes the
    step's K/V into the caches. Where ``embed_mask`` is True the token's
    embedding is ``embed_override``'s row, cast to the hidden dtype
    (multimodal positions carry encoder outputs).

    Query token t of row b sits at position q_start[b] + t; its KV goes to
    the cache slot its block table names; attention sees every cache
    position ≤ its own and < q_start + q_len."""
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

    hid = embed_lookup(params["embed"], token_ids, torch_dtype(cfg.dtype))  # [B, T, H]
    if embed_override is not None:
        hid = torch.where(embed_mask[..., None], embed_override.to(hid.dtype), hid)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        x = rms_norm(hid, layers["attn_norm"][li], cfg.rms_norm_eps)
        q = mm(x, layers["wq"][li]).reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = mm(x, layers["wk"][li]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = mm(x, layers["wv"][li]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
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
        hid = hid + mm(attn.reshape(b, t, cfg.q_size), layers["wo"][li])
        x = rms_norm(hid, layers["mlp_norm"][li], cfg.rms_norm_eps)
        hid = hid + swiglu(x, layers["w_gate"][li], layers["w_up"][li],
                           layers["w_down"][li])
    h = rms_norm(hid, params["final_norm"], cfg.rms_norm_eps)
    if return_all_hidden:
        return h
    last_idx = (q_len.long() - 1).clamp(0, t - 1)                     # [B]
    return h[torch.arange(b, device=dev), last_idx]                   # [B, H]


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       hidden: torch.Tensor) -> torch.Tensor:
    """Project hidden [B, H] → logits [B, V] (tied or separate lm head)."""
    with _perf_phase("logits"):
        if cfg.tie_word_embeddings:
            return hidden @ params["embed"].T
        return mm(hidden, params["lm_head"])
