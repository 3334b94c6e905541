"""Paged attention over a block-table KV cache: the hand-written CUDA
kernel (``csrc/paged_attention_mma.cu``), its plain PyTorch version, the
split-K sizing and the int4 nibble packing.

Port of ``dynamo_tpu/ops/paged_attention.py`` (``paged_attention_kernel``)
for its three caches: model precision (bf16/f32 tensor ``[NB, BS, KH, D]``),
int8 (``{"q": int8 [NB, BS, KH, D], "s": f32 [NB, KH]}``) and packed int4
(``{"q": uint8 [NB, BS, KH, D/2], "s": f32 [NB, KH]}``); the payload dtype
is the variant marker, as in JAX. :func:`paged_attention` is the one entry:
on a CUDA tensor it launches the kernel that :data:`ROUTES` names for (q
dtype, cache kind) — or raises, there is no fallback — and on a CPU tensor
it runs :func:`paged_attention_plain`. Every route is an instantiation of
one tensor-core design (``mma``: pipelined cp.async page loads,
``mma.sync`` products): bf16 q over every cache, and f32 q over every
cache, whose f32 products it keeps by splitting q and p — and the f32
cache's K and V — into three bf16 terms each.

Conventions kept from the TPU kernel, so both versions agree with it:
- q is scaled by ``D^-0.5`` in q's own dtype before attention
  (:func:`scale_query`; the kernel does the same rounded multiply as it
  loads q), not in f32 as the dense path of ``models/llama`` does — in bf16
  the two differ by a rounding;
- a row whose context is all masked outputs 0;
- split-K emits each split's f32 ``(acc, m, l)`` and
  :func:`combine_splits` merges them outside the kernel.

Tensor parallelism: JAX's ``paged_attention_sharded`` is a ``shard_map``
of the kernel over the "model" (head) axis. In the port every rank is a
process that launches :func:`paged_attention` on its own q heads and its
own cache heads (the engine's ranks hold only those); no collective
runs here, the sum comes in ``wo``; under data parallelism each data
replica launches it on its rows of the batch. :func:`paged_attention_sharded`
is its single-controller twin, which the tests and the chip smoke hold
against the unsharded launch: one launch a rank on that rank's rows and
heads (:func:`shard_heads`), put back together.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

NEG_INF = -1e30

#: f32 per-split partial-state budget: the split-K prefill gate (see
#: :func:`resolve_num_splits`).
_SPLIT_STATE_CAP_BYTES = 8 * 2**20

#: the JAX cost model's default core count (a TPU's); the CPU path uses it
#: so its split choice matches the JAX kernel's.
TPU_CORE_COUNT = 8

#: query rows one warp holds (the MMA's M, csrc/paged_attention_mma.cu); a
#: thread block has 4 warps
MMA_WARP_ROWS = 16

#: int4 payloads clip to ±7 (not -8): a symmetric range keeps dequant a pure
#: scale multiply, mirroring int8's ±127.
INT4_QMAX = 7.0

#: the kernel's cache variants, by the ``cache_kind`` code it takes
CACHE_KINDS = ("float", "int8", "int4")

#: the kernel's query dtypes, by the ``q_dtype`` code it takes
MMA_Q_DTYPES = (torch.bfloat16, torch.float32)

#: (q dtype, cache kind) -> the kernel instantiation that serves it on the
#: card
ROUTES = {
    (torch.bfloat16, "float"): "mma_bf16",
    (torch.bfloat16, "int8"): "mma_int8",
    (torch.bfloat16, "int4"): "mma_int4",
    (torch.float32, "float"): "mma_f32",
    (torch.float32, "int8"): "mma_int8_f32q",
    (torch.float32, "int4"): "mma_int4_f32q",
}
ROUTE_KERNELS = tuple(dict.fromkeys(ROUTES.values()))


def mma_row_groups(rows: int) -> int:
    """Row groups of :data:`MMA_WARP_ROWS` query rows a thread block
    holds: decode (<= 16 rows) puts all 4 warps on one group,
    each walking every 4th unit of the context; 2 groups of 2 warps up to
    32 rows; else 4 groups of one warp."""
    return 1 if rows <= MMA_WARP_ROWS else 2 if rows <= 2 * MMA_WARP_ROWS else 4


def programs_per_row(route: str, rows: int, kv_heads: int) -> int:
    """Thread blocks the route's kernel runs for one batch row and split:
    kv heads x tiles of query rows. Every route of :data:`ROUTES` tiles
    rows alike (:func:`mma_row_groups`); a name that is no route raises."""
    if route not in ROUTE_KERNELS:
        raise KeyError(f"{route!r} is not a paged-attention route")
    return kv_heads * -(-rows // (MMA_WARP_ROWS * mma_row_groups(rows)))


def pack_int4(vals: torch.Tensor) -> torch.Tensor:
    """Pack signed nibbles [-8..7] (any int dtype) into uint8 along the
    trailing axis, split-half layout: byte j of a length-D/2 packed row
    holds element j in its low nibble and element j + D/2 in its high one."""
    d = vals.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even trailing dim, got {d}")
    w = vals.to(torch.int32)
    lo = w[..., : d // 2] & 0xF
    hi = w[..., d // 2:] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 [..., D/2] → int32 [..., D],
    each nibble sign-extended."""
    w = packed.to(torch.int32)
    lo = w & 0xF
    hi = (w >> 4) & 0xF
    lo = lo - ((lo & 0x8) << 1)
    hi = hi - ((hi & 0x8) << 1)
    return torch.cat([lo, hi], dim=-1)


def cache_kind(cache) -> str:
    """The cache variant: ``float`` for a tensor, ``int8`` / ``int4`` for a
    ``{"q", "s"}`` dict by its payload dtype (uint8 = packed int4)."""
    if not isinstance(cache, dict):
        return "float"
    return "int4" if cache["q"].dtype == torch.uint8 else "int8"


def auto_num_splits(num_blocks: int, *, batch: int, q_chunks: int = 1,
                    core_count: int = TPU_CORE_COUNT,
                    min_blocks_per_split: int = 4, max_splits: int = 16) -> int:
    """Split-K split count (copy of ``obs/costmodel.auto_num_splits``):
    the smallest count that fills ``core_count`` parallel streams given the
    ``batch × q_chunks`` programs that already exist, without shrinking a
    split below ``min_blocks_per_split`` context blocks."""
    if num_blocks <= min_blocks_per_split:
        return 1
    streams = max(1, batch * q_chunks)
    want = -(-core_count // streams)
    cap = max(1, num_blocks // min_blocks_per_split)
    return max(1, min(want, cap, max_splits))


def resolve_num_splits(num_splits: int, *, nblk: int, batch: int,
                       q_chunks: int, q_tokens: int,
                       state_rows: int = 0, kv_heads: int = 0,
                       head_dim: int = 0,
                       core_count: int = TPU_CORE_COUNT) -> int:
    """Resolve a ``num_splits`` request to the split count used (copy of
    the JAX function, with ``core_count`` passed through).

    0 ("auto") defers to :func:`auto_num_splits`. Decode (q_tokens == 1)
    engages whenever the batch underfills the cores. Chunked prefill engages
    under the same signal but only while the f32 per-split partial state
    fits ``_SPLIT_STATE_CAP_BYTES``; without the state geometry it stays
    sequential. Explicit values are clamped to [1, nblk]."""
    if num_splits <= 0:
        want = auto_num_splits(nblk, batch=batch, q_chunks=q_chunks,
                               core_count=core_count)
        if q_tokens != 1 and want > 1:
            if not (state_rows and kv_heads and head_dim):
                return 1
            bytes_per_split = (batch * kv_heads * state_rows
                               * (head_dim + 256) * 4)
            want = min(want, max(
                _SPLIT_STATE_CAP_BYTES // max(bytes_per_split, 1), 1))
        return max(1, min(want, nblk))
    return max(1, min(num_splits, nblk))


def num_splits_for(q: torch.Tensor, kv_heads: int, nblk: int, num_splits: int,
                   kind: str) -> int:
    """The split count :func:`paged_attention` uses for these shapes and
    cache kind. On the card the parallel programs per row are those of the
    route's kernel (:func:`programs_per_row`) and the cores are its SMs; on
    the CPU it is the JAX kernel's choice."""
    b, t, h, d = q.shape
    r = t * (h // kv_heads)
    if q.is_cuda:
        cores = torch.cuda.get_device_properties(q.device).multi_processor_count
        chunks = programs_per_row(ROUTES[(q.dtype, kind)], r, kv_heads)
    else:
        cores, chunks = TPU_CORE_COUNT, 1
    return resolve_num_splits(num_splits, nblk=nblk, batch=b, q_chunks=chunks,
                              q_tokens=t, state_rows=r, kv_heads=kv_heads,
                              head_dim=d, core_count=cores)


@functools.cache
def _query_scale(head_dim: int, dtype: torch.dtype) -> float:
    """D^-0.5 rounded to ``dtype`` on the host, as JAX rounds a weak-typed
    Python scalar. A Python float: a device scalar would cost a pageable
    host-to-device copy, which synchronises the stream, at every launch."""
    return torch.tensor(head_dim ** -0.5, dtype=dtype).item()


def scale_query(q: torch.Tensor) -> torch.Tensor:
    """q · D^-0.5 in q's own dtype, the scale itself rounded to that dtype."""
    return q * _query_scale(q.shape[-1], q.dtype)


def combine_splits(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Merge per-split flash state — acc [B, NS, KH, R, D], m and l
    [B, NS, KH, R] — into rows [B, KH, R, D]: the logsumexp-weighted merge
    of ``_combine_splits``. A row whose every split is empty has l_tot 0
    and yields 0. With one split it is the kernel's own normalisation."""
    m_tot = m.amax(dim=1, keepdim=True)
    w = torch.exp(m - m_tot)
    l_tot = (w * l).sum(dim=1)
    out = (acc * w[..., None]).sum(dim=1)
    l_tot = torch.where(l_tot == 0.0, torch.ones_like(l_tot), l_tot)
    return (out / l_tot[..., None]).to(out_dtype)


def _rows_to_bthd(rows: torch.Tensor, t: int) -> torch.Tensor:
    """[B, KH, T*REP, D] (row r ↔ token r // rep, head r % rep) → [B, T, H, D]."""
    b, kh, r, d = rows.shape
    rep = r // t
    return rows.reshape(b, kh, t, rep, d).permute(0, 2, 1, 3, 4).reshape(b, t, kh * rep, d)


def _context(cache, idx: torch.Tensor, d: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The rows' context [B, NBLK*BS, KH, D] in f32 — int-valued for a
    quantized cache (int4 unpacked), whose per-(block, kv head) scales come
    back beside it as [B, NBLK, KH] (None for a model-precision cache)."""
    if isinstance(cache, dict):
        g = cache["q"][idx]                                   # [B, NBLK, BS, KH, Dp]
        if g.dtype == torch.uint8:
            g = unpack_int4(g)
        scale = cache["s"].float()[idx]                       # [B, NBLK, KH]
    else:
        g, scale = cache[idx], None
    b, nblk, bs, kh = g.shape[:4]
    return g.reshape(b, nblk * bs, kh, d).float(), scale


def split_state_plain(q: torch.Tensor, k_cache, v_cache, block_tables: torch.Tensor,
                      q_start: torch.Tensor, kv_lens: torch.Tensor,
                      num_splits: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each split's raw flash state, computed densely: the function the
    kernel computes before normalising. q is already scaled. Split s covers
    context blocks [s·spb, (s+1)·spb). Returns f32 acc [B, NS, KH, R, D],
    m and l [B, NS, KH, R].

    A quantized cache follows the TPU kernel's order: scores are the
    products with the int-valued context times the block's K scale, and
    each block's p·v over the int-valued context is times its V scale."""
    b, t, h, d = q.shape
    payload = k_cache["q"] if isinstance(k_cache, dict) else k_cache
    bs, kh = payload.shape[1], payload.shape[2]
    nblk = block_tables.shape[1]
    rep = h // kh
    ns = num_splits
    spb = -(-nblk // ns)
    span = spb * bs
    s_pad = ns * span
    idx = block_tables.long()
    ctx_k, k_scale = _context(k_cache, idx, d)
    ctx_v, v_scale = _context(v_cache, idx, d)
    pad = s_pad - nblk * bs
    if pad:
        ctx_k = torch.nn.functional.pad(ctx_k, (0, 0, 0, 0, 0, pad))
        ctx_v = torch.nn.functional.pad(ctx_v, (0, 0, 0, 0, 0, pad))
    qf = q.float().reshape(b, t, kh, rep, d)
    scores = torch.einsum("btkrd,bskd->btkrs", qf, ctx_k)
    if k_scale is not None:
        ks = torch.nn.functional.pad(k_scale, (0, 0, 0, ns * spb - nblk))
        ks = ks.repeat_interleave(bs, dim=1).permute(0, 2, 1)          # [B, KH, S]
        scores = scores * ks[:, None, :, None, :]
    ctx = torch.arange(s_pad, device=q.device)
    pos = q_start.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    visible = ((ctx[None, None, :] <= pos[:, :, None])
               & (ctx[None, None, :] < kv_lens.long()[:, None, None])
               & (ctx[None, None, :] < nblk * bs))                     # [B, T, S]
    visible = visible[:, :, None, None, :].reshape(b, t, 1, 1, ns, span)
    scores = scores.reshape(b, t, kh, rep, ns, span)
    scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)                                            # [B,T,KH,REP,NS]
    p = torch.where(visible, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    l = p.sum(dim=-1)
    if v_scale is None:
        acc = torch.einsum("btkrns,bnskd->btkrnd", p, ctx_v.reshape(b, ns, span, kh, d))
    else:
        pv = torch.einsum("btkrngc,bngckd->btkrngd", p.reshape(b, t, kh, rep, ns, spb, bs),
                          ctx_v.reshape(b, ns, spb, bs, kh, d))
        vs = torch.nn.functional.pad(v_scale, (0, 0, 0, ns * spb - nblk))
        vs = vs.reshape(b, ns, spb, kh).permute(0, 3, 1, 2)            # [B, KH, NS, SPB]
        acc = (pv * vs[:, None, :, None, :, :, None]).sum(dim=-2)
    # [B, T, KH, REP, NS, ...] → [B, NS, KH, T*REP, ...]
    acc = acc.permute(0, 4, 2, 1, 3, 5).reshape(b, ns, kh, t * rep, d)
    m = m.permute(0, 4, 2, 1, 3).reshape(b, ns, kh, t * rep)
    l = l.permute(0, 4, 2, 1, 3).reshape(b, ns, kh, t * rep)
    return acc, m, l


def paged_attention_plain(q: torch.Tensor, k_cache, v_cache, block_tables: torch.Tensor,
                          q_start: torch.Tensor, kv_lens: torch.Tensor, *,
                          num_splits: int = 1) -> torch.Tensor:
    """The kernel's plain PyTorch version: gather the context, attend
    densely with the kernel's mask, scaling and split-K combine.
    Returns [B, T, H, D] in q's dtype."""
    t = q.shape[1]
    acc, m, l = split_state_plain(scale_query(q), k_cache, v_cache,
                                  block_tables, q_start, kv_lens, num_splits)
    return _rows_to_bthd(combine_splits(acc, m, l, q.dtype), t)


def _check_cuda_inputs(q, k_cache, v_cache, block_tables, q_start, kv_lens) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged attention takes float32 or bfloat16 q, got {q.dtype}")
    b, t, h, d = q.shape
    kind = cache_kind(k_cache)
    if cache_kind(v_cache) != kind:
        raise TypeError(f"k_cache is a {kind} cache, v_cache a {cache_kind(v_cache)} one")
    if kind == "float":
        payloads, scales = (k_cache, v_cache), ()
        want_dtype, dp = q.dtype, d
    else:
        payloads, scales = (k_cache["q"], v_cache["q"]), (k_cache["s"], v_cache["s"])
        want_dtype = torch.uint8 if kind == "int4" else torch.int8
        if kind == "int4" and d % 2:
            raise ValueError(f"a packed int4 cache needs an even head_dim, got {d}")
        dp = d // 2 if kind == "int4" else d
    for name, x in zip(("k_cache", "v_cache"), payloads):
        if x.dtype != want_dtype:
            raise TypeError(f"{name} payload dtype {x.dtype} != {want_dtype} "
                            f"({kind} cache, q {q.dtype})")
    for name, x in (("block_tables", block_tables), ("q_start", q_start),
                    ("kv_lens", kv_lens)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    kp, vp = payloads
    if kp.dim() != 4 or kp.shape != vp.shape or kp.shape[3] != dp:
        raise ValueError(f"{kind} cache payloads must be [NB, BS, KH, {dp}], got "
                         f"{tuple(kp.shape)} / {tuple(vp.shape)}")
    nb, _, kh, _ = kp.shape
    for name, x in zip(("k_cache scales", "v_cache scales"), scales):
        if x.dtype != torch.float32 or tuple(x.shape) != (nb, kh):
            raise TypeError(f"{name} must be float32 [{nb}, {kh}], got "
                            f"{x.dtype} {tuple(x.shape)}")
    tensors = (q, *payloads, *scales, block_tables, q_start, kv_lens)
    if any(x.device != q.device for x in tensors):
        raise ValueError("paged attention inputs must share one CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged attention inputs must be contiguous")
    if h % kh:
        raise ValueError(f"{h} query heads do not divide over {kh} kv heads")
    if d > 256:
        raise ValueError(f"head_dim {d} > 256 is not supported by the kernel")
    route = ROUTES[(q.dtype, kind)]
    bs = kp.shape[1]
    if d % 16 or bs % 16:
        raise ValueError(f"the {route} kernel takes head_dim and block_size multiples "
                         f"of 16, got head_dim {d}, block_size {bs}")
    if any(x.data_ptr() % 16 for x in (q, *payloads)):
        raise ValueError(f"the {route} kernel reads q and payload rows in vectors of up "
                         "to 16 bytes: q and the cache payloads must be 16-byte aligned")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be [{b}, NBLK], got {tuple(block_tables.shape)}")
    if q_start.shape != (b,) or kv_lens.shape != (b,):
        raise ValueError("q_start and kv_lens must be [B]")


def _ptr(x: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr() if x is not None else 0)


@functools.cache
def _kernel_fn():
    """The kernel's ctypes entry, ``dyn_paged_attention_mma`` (q dtype
    code, cache kind, ..., row groups, q scale)."""
    from dynamo_tpu_torch.ops.build import load_library

    fn = load_library("paged_attention_mma").dyn_paged_attention_mma
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def paged_attention(q: torch.Tensor, k_cache, v_cache, block_tables: torch.Tensor,
                    q_start: torch.Tensor, kv_lens: torch.Tensor, *,
                    num_splits: int = 0) -> torch.Tensor:
    """Flash paged attention. q [B, T, H, D]; caches [NB, BS, KH, D] in q's
    dtype, or quantized ``{"q": payload, "s": f32 [NB, KH]}`` dicts (int8
    [NB, BS, KH, D] or packed-int4 uint8 [NB, BS, KH, D/2]); block_tables
    [B, NBLK] int32; q_start, kv_lens [B] int32. Returns [B, T, H, D] in
    q's dtype.

    ``num_splits``: 0 = auto (:func:`num_splits_for`), 1 = sequential walk,
    N = forced (clamped to NBLK). On a CUDA tensor this launches the
    ``sm_90a`` kernel that :data:`ROUTES` names for (q dtype, cache kind)
    and counts it in ``paged_attention.launches_by_kernel`` (under CUDA
    graph capture, see :func:`launches_made`); on a CPU tensor it runs
    :func:`paged_attention_plain`."""
    kind = cache_kind(k_cache)
    payload = k_cache if kind == "float" else k_cache["q"]
    nblk = block_tables.shape[1]
    ns = num_splits_for(q, payload.shape[2], nblk, num_splits, kind)
    if not q.is_cuda:
        return paged_attention_plain(q, k_cache, v_cache, block_tables, q_start,
                                     kv_lens, num_splits=ns)
    _check_cuda_inputs(q, k_cache, v_cache, block_tables, q_start, kv_lens)
    route = ROUTES[(q.dtype, kind)]
    b, t, h, d = q.shape
    _, bs, kh, _ = payload.shape
    r = t * (h // kh)
    if ns == 1:
        out = torch.empty_like(q)
        acc = m = l = None
    else:
        out = None
        acc = torch.empty((b, ns, kh, r, d), dtype=torch.float32, device=q.device)
        m = torch.empty((b, ns, kh, r), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if kind == "float":
        kp, vp, ks, vs = k_cache, v_cache, None, None
    else:
        kp, vp, ks, vs = k_cache["q"], v_cache["q"], k_cache["s"], v_cache["s"]
    ptrs = (_ptr(q), _ptr(kp), _ptr(vp), _ptr(ks), _ptr(vs), _ptr(block_tables),
            _ptr(q_start), _ptr(kv_lens), _ptr(out), _ptr(acc), _ptr(m), _ptr(l))
    dims = (b, t, h, kh, d, bs, nblk, ns, -(-nblk // ns))
    qscale = _query_scale(d, q.dtype)   # the kernel scales q as it loads it
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    rc = _kernel_fn()(MMA_Q_DTYPES.index(q.dtype), CACHE_KINDS.index(kind), *ptrs, *dims,
                      mma_row_groups(r), qscale, stream)
    if rc != 0:
        raise RuntimeError(f"paged-attention kernel {route} launch failed ({kind} cache, "
                           f"q {q.dtype}): CUDA error {rc}")
    paged_attention.launches_by_kernel[route] += 1
    if ns == 1:
        return out
    return _rows_to_bthd(combine_splits(acc, m, l, q.dtype), t)


def shard_heads(cache, rank: int, tp: int):
    """Rank ``rank``'s kv heads of a per-layer cache, contiguous: the
    payload [NB, BS, KH, Dp] on KH, a quantized cache's scales [NB, KH] on
    theirs (each rank dequantizes its own heads; packed int4 packs along
    D, so it shards alike)."""
    if isinstance(cache, dict):
        return {"q": shard_heads(cache["q"], rank, tp),
                "s": cache["s"].chunk(tp, dim=1)[rank].contiguous()}
    kh = cache.shape[2]
    if kh % tp:
        raise ValueError(f"{kh} kv heads do not divide over tp={tp}")
    return cache.chunk(tp, dim=2)[rank].contiguous()


def paged_attention_sharded(q: torch.Tensor, k_cache, v_cache, block_tables: torch.Tensor,
                            q_start: torch.Tensor, kv_lens: torch.Tensor, *, tp: int,
                            dp: int = 1, num_splits: int = 0) -> torch.Tensor:
    """Paged attention split over ``dp`` x ``tp`` ranks, as JAX's
    ``paged_attention_sharded`` on a ("data", "model") mesh: rank (d, m)
    takes batch rows ``[d B/dp, (d+1) B/dp)`` (the "data" axis; the cache
    is replicated over it), q heads ``[m H/tp, (m+1) H/tp)`` and kv heads
    ``[m KH/tp, (m+1) KH/tp)`` (GQA groups stay whole), and
    :func:`paged_attention` runs on those — one kernel launch a rank on
    the card, its split count chosen from the rank's own rows and heads
    (:func:`num_splits_for`), as the shard_map'd call chooses it. Returns
    [B, T, H, D]."""
    h = q.shape[2]
    kh = (k_cache["q"] if isinstance(k_cache, dict) else k_cache).shape[2]
    if h % tp or kh % tp:
        raise ValueError(f"{h} query heads and {kh} kv heads must divide over tp={tp}")
    if q.shape[0] % dp:
        raise ValueError(f"a batch of {q.shape[0]} rows does not divide over dp={dp}")
    rows = [slice(d * (q.shape[0] // dp), (d + 1) * (q.shape[0] // dp)) for d in range(dp)]
    ks = [shard_heads(k_cache, m, tp) for m in range(tp)]
    vs = [shard_heads(v_cache, m, tp) for m in range(tp)]
    return torch.cat([
        torch.cat([paged_attention(q[r].chunk(tp, dim=2)[m].contiguous(), ks[m], vs[m],
                                   block_tables[r].contiguous(), q_start[r].contiguous(),
                                   kv_lens[r].contiguous(), num_splits=num_splits)
                   for m in range(tp)], dim=2)
        for r in rows], dim=0)


def reset_launches() -> None:
    """Set the kernels' launch counts to 0."""
    paged_attention.launches_by_kernel = dict.fromkeys(ROUTE_KERNELS, 0)


@contextlib.contextmanager
def launches_made():
    """Keep the launches made inside the block out of the counts; yields a
    dict that holds them, by kernel, once the block exits. A CUDA graph's
    capture records launches without running them, and its replays run
    them without Python: the step program counts each replay with
    :func:`count_launches` of what its capture recorded."""
    saved = paged_attention.launches_by_kernel
    reset_launches()
    made: dict[str, int] = {}
    try:
        yield made
    finally:
        made.update(paged_attention.launches_by_kernel)
        paged_attention.launches_by_kernel = saved


def count_launches(made: dict[str, int]) -> None:
    """Add ``made`` (launches by kernel, as :func:`launches_made` yields
    them) to the counts: one replay of a captured graph."""
    for route, n in made.items():
        paged_attention.launches_by_kernel[route] += n


#: launches of each CUDA kernel of :data:`ROUTES` since the counts were last
#: set to 0 (``launches_by_kernel``), eager launches and the launches of
#: replayed graphs alike; a total or a count per cache kind is a sum over it
reset_launches()
