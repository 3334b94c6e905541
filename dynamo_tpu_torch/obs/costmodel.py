"""Analytic roofline cost model: expected FLOPs and HBM bytes per kernel —
copy of ``dynamo_tpu/obs/costmodel.py`` over the port's ``ModelConfig``.

Every hot path the engine dispatches — paged attention (bf16, int8 or
int4 KV), ring-attention prefill, and the dense matmuls around them — gets
a closed-form cost as a function of the call's shapes and dtypes. The step
profiler (obs/profiler.py) folds these into per-step MFU / HBM-bandwidth
counters, the scheduling ledger (obs/sched_ledger.py) prices live against
padded work with them, and ``prefill_chunk=0`` sizes prefill chunks from
``auto_prefill_chunk``.

Conventions (the JAX copy's, unchanged):

* FLOPs count matmul work only (2·M·N·K per dense contraction), the
  standard MFU accounting — softmax/normalization vector work is noise
  against the matmul terms for every real shape.
* Attention is charged for whole KV blocks (``ceil(kv_len / bs) · bs``
  context positions): that is what the kernel reads and multiplies —
  masked in-block positions still burn the hardware.
* HBM bytes count reads + writes of tensors that round-trip device memory
  under the serving access pattern: weights stream once per step,
  activations are assumed resident, KV blocks stream per step.
* int8 KV halves the KV payload, packed int4 quarters it (two nibbles per
  byte — 0.5 bytes/elem), and both add the per-(block, head) f32 scales;
  int8 weights count 1 byte/elem.
* split-K (``num_splits > 1``) adds the combine step's traffic: each split
  writes f32 partial state (acc rows of head_dim plus the lane-padded m
  and l columns, 128 each) that the combine reads back, plus its
  elementwise merge FLOPs.

The hardware table gains the H100 SXM (``"h100 80gb hbm3"``: 989e12 dense
bf16 FLOP/s, 3.35e12 B/s, NVIDIA data sheet) and is keyed by
``torch.cuda.get_device_name()`` (``"cpu"`` for the CPU). Where the JAX
copy prices an unknown device at the CPU row, :func:`hw_spec_for` raises
naming it: a card priced at CPU rates would size chunks for another
device. This module imports nothing but the port's model config.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from dynamo_tpu_torch.models.config import ModelConfig

__all__ = [
    "HardwareSpec",
    "KernelCost",
    "HW_SPECS",
    "KV_DTYPES",
    "hw_spec_for",
    "auto_num_splits",
    "paged_attention_cost",
    "ring_attention_cost",
    "dense_matmul_cost",
    "model_step_cost",
    "decode_step_cost",
    "prefill_cost",
    "total_cost",
    "analytic_param_bytes",
    "predicted_decode_perf",
    "mfu",
    "bw_util",
    "roofline_fraction",
    "PrefixCacheCost",
    "kv_block_wire_bytes",
    "prefix_cache_cost",
    "RingPrefillDecision",
    "chunked_prefill_seconds",
    "mixed_step_cost",
    "mixed_step_seconds",
    "auto_prefill_chunk",
    "QOS_ITL_SLO_SCALE",
    "ring_prefill_seconds",
    "ring_vs_chunked_prefill",
    "ring_prefill_break_even_tokens",
    "SessionRetentionCost",
    "session_retention_cost",
]


#: Bytes/s one ring hop sustains on a row that names no rate of its own:
#: the JAX copy's value for the TPU rows' inter-chip link (the CPU row
#: keeps it too, so that both packages price the CPU alike). The ring
#: overlaps the hop with the block matmuls, so this binds only when the
#: shard is large.
ICI_BYTES_PER_S = 4.5e10


@dataclass(frozen=True)
class HardwareSpec:
    """Peak numbers one chip can theoretically sustain."""

    name: str
    peak_flops: float   # bf16 matmul FLOP/s
    hbm_bw: float       # HBM bytes/s
    #: bytes/s of one ring hop to the next chip (one direction of its link)
    ring_bytes_per_s: float = ICI_BYTES_PER_S

    @property
    def ridge_intensity(self) -> float:
        """FLOPs/byte where the roofline bends: below it you are
        bandwidth-bound, above it compute-bound."""
        return self.peak_flops / self.hbm_bw


# Keyed by a lowercase substring of the device's name; first match wins
# (dict order), so the more specific "tpu v5p" precedes "tpu v5". The TPU
# rows are the JAX copy's (jax ``device_kind`` strings, which no torch
# device name matches). The H100 row is the SXM card's data sheet (NVIDIA
# H100 Tensor Core GPU datasheet): dense bf16 tensor FLOP/s, HBM3 bytes/s,
# and for a ring hop half of its 900 GB/s of NVLink 4 (both directions
# together): 450 GB/s, one direction to the next card. Ranks that share
# one card hop through host memory instead, which no row describes. Its
# key needs the "80GB HBM3" of ``torch.cuda.get_device_name()``, so the
# PCIe and NVL cards (other memory rates) do not match it. The CPU entry
# is a deliberately rough stand-in — a few AVX cores and one DDR
# channel-ish — that the CPU engines of both packages resolve alike.
HW_SPECS: dict[str, HardwareSpec] = {
    "tpu v6": HardwareSpec("tpu-v6e", 918e12, 1638e9),
    "tpu v5p": HardwareSpec("tpu-v5p", 459e12, 2765e9),
    "tpu v5": HardwareSpec("tpu-v5e", 197e12, 819e9),
    "tpu v4": HardwareSpec("tpu-v4", 275e12, 1228e9),
    "h100 80gb hbm3": HardwareSpec("h100-sxm", 989e12, 3.35e12, ring_bytes_per_s=450e9),
    "cpu": HardwareSpec("cpu", 200e9, 50e9),
}


def hw_spec_for(device_name: str) -> HardwareSpec:
    """Resolve a device name (``torch.cuda.get_device_name()``, e.g.
    "NVIDIA H100 80GB HBM3"; "cpu" or "" for the CPU) to its spec. A name
    no row matches raises ``LookupError`` naming it — the JAX copy's
    fallback to the CPU row would price a card at CPU rates."""
    kind = (device_name or "cpu").lower()
    for key, spec in HW_SPECS.items():
        if key in kind:
            return spec
    raise LookupError(
        f"no HW_SPECS row matches device {device_name!r} (rows: "
        f"{', '.join(HW_SPECS)}); add the card's data-sheet rates to "
        "dynamo_tpu_torch/obs/costmodel.py")


@dataclass(frozen=True)
class KernelCost:
    """Expected work of one kernel invocation (or a sum of them)."""

    name: str
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0  # interconnect traffic (ring attention hops)

    def __add__(self, other: "KernelCost") -> "KernelCost":
        return KernelCost(
            name=self.name if self.name == other.name else "total",
            flops=self.flops + other.flops,
            hbm_bytes=self.hbm_bytes + other.hbm_bytes,
            ici_bytes=self.ici_bytes + other.ici_bytes,
        )

    def scaled(self, k: float) -> "KernelCost":
        return replace(self, flops=self.flops * k,
                       hbm_bytes=self.hbm_bytes * k,
                       ici_bytes=self.ici_bytes * k)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOPs per HBM byte."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else float("inf")

    def time_bound(self, hw: HardwareSpec) -> float:
        """Roofline-bound execution time: max of the compute and bandwidth
        lower bounds (perfect overlap assumed — this is the floor)."""
        return max(self.flops / hw.peak_flops if hw.peak_flops else 0.0,
                   self.hbm_bytes / hw.hbm_bw if hw.hbm_bw else 0.0)

    def bound(self, hw: HardwareSpec) -> str:
        return "compute" if self.intensity >= hw.ridge_intensity else "bandwidth"


#: every KV storage mode the cache supports (engine/cache.py), in scoreboard
#: order — perf_report rows and the bench kv_dtype sweep iterate this.
KV_DTYPES = ("bfloat16", "int8", "int4")


def _kv_itemsize(kv_dtype: str) -> float:
    """KV payload bytes per element: bf16 2, int8 1, packed int4 0.5."""
    if kv_dtype == "int8":
        return 1.0
    if kv_dtype == "int4":
        return 0.5
    return 2.0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def auto_num_splits(num_blocks: int, *, batch: int, q_chunks: int = 1,
                    core_count: int = 8, min_blocks_per_split: int = 4,
                    max_splits: int = 16) -> int:
    """Split-K split count for one paged-attention call (deterministic,
    dependency-free; the JAX package's kernel calls it at trace time).

    Picks the smallest split count that fills ``core_count`` parallel grid
    streams given the ``batch × q_chunks`` programs that already exist,
    without shrinking any split below ``min_blocks_per_split`` context
    blocks (below that the combine's extra HBM round-trip outweighs the
    latency win — each split's partial state costs ~(D + 256) f32 per row
    against the ~BS·KH·D·itemsize bytes a block walk reads).
    """
    if num_blocks <= min_blocks_per_split:
        return 1
    streams = max(1, batch * q_chunks)
    want = _ceil_div(core_count, streams)
    cap = max(1, num_blocks // min_blocks_per_split)
    return max(1, min(want, cap, max_splits))


def paged_attention_cost(
    *,
    batch: int,
    q_tokens: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    kv_len: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    act_bytes: int = 2,
    num_splits: int = 1,
) -> KernelCost:
    """One paged-attention invocation (the kernel and its plain version
    execute the same matmul volume over the same KV blocks).

    FLOPs: the QK^T and PV matmuls — ``4 · B · T · H · D · S`` with S the
    block-rounded context. HBM: Q read + output write (activation dtype),
    plus both K and V caches streamed once per invocation; int8 caches move
    half the payload, packed int4 a quarter, both plus the per-(block,
    kv-head) f32 scales.

    ``num_splits > 1`` (split-K flash decode) adds the combine step:
    per split and per query row (B·T·H of them) the kernel writes f32
    partial state — acc (head_dim) plus the lane-padded m and l columns
    (128 each) — which the combine reads back, so
    ``combine_bytes = 8 · NS · B · T · H · (D + 256)`` (4-byte elems,
    write + read). The merge's elementwise work is charged as
    ``combine_flops = NS · B · T · H · (2 · D + 8)`` (scale + sum of acc,
    plus the exp/max/l bookkeeping per row).
    """
    nblk = _ceil_div(max(kv_len, 1), block_size)
    s = nblk * block_size
    flops = 4.0 * batch * q_tokens * num_heads * head_dim * s
    q_bytes = batch * q_tokens * num_heads * head_dim * act_bytes
    kv_block = block_size * num_kv_heads * head_dim * _kv_itemsize(kv_dtype)
    if kv_dtype in ("int8", "int4"):
        kv_block += num_kv_heads * 4  # per-(block, head) f32 scale
    kv_bytes = 2.0 * batch * nblk * kv_block
    out_bytes = q_bytes
    hbm = q_bytes + kv_bytes + out_bytes
    if num_splits > 1:
        rows = batch * q_tokens * num_heads
        hbm += 8.0 * num_splits * rows * (head_dim + 256)
        flops += num_splits * rows * (2.0 * head_dim + 8)
    return KernelCost("paged_attention", flops, hbm)


def ring_attention_cost(
    *,
    batch: int,
    seq_len: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    sp: int = 1,
    act_bytes: int = 2,
) -> KernelCost:
    """Sequence-parallel prefill self-attention (ops/ring_attention.py):
    full causal-masked matmul volume over the chunk, KV shards rotating
    ``sp - 1`` hops over the interconnect."""
    flops = 4.0 * batch * seq_len * seq_len * num_heads * head_dim
    qkv = batch * seq_len * (num_heads + 2 * num_kv_heads) * head_dim * act_bytes
    out = batch * seq_len * num_heads * head_dim * act_bytes
    kv_shard = 2.0 * batch * seq_len * num_kv_heads * head_dim * act_bytes / max(sp, 1)
    ici = kv_shard * max(sp - 1, 0)
    return KernelCost("ring_attention", flops, qkv + out, ici_bytes=ici)


def dense_matmul_cost(m: int, n: int, k: int, *, act_bytes: int = 2,
                      weight_bytes: int = 2, name: str = "matmul") -> KernelCost:
    """[M,K] @ [K,N]: 2MNK FLOPs; activations + streamed weight + output."""
    flops = 2.0 * m * n * k
    hbm = m * k * act_bytes + k * n * weight_bytes + m * n * act_bytes
    return KernelCost(name, flops, hbm)


def _weight_itemsize(quantization: str) -> int:
    return 1 if quantization == "int8" else 2


def model_step_cost(
    cfg: ModelConfig,
    *,
    tokens: int,
    logit_rows: int,
    attn_q_ctx: float,
    kv_blocks: float,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    attn_num_splits: int = 1,
) -> dict[str, KernelCost]:
    """Aggregate cost of ONE dispatched engine step, by phase.

    Aggregated inputs let the profiler charge a ragged batch in O(rows)
    host work (engine hot path):

    * ``tokens`` — total query tokens across rows (N),
    * ``logit_rows`` — rows projected to logits and sampled,
    * ``attn_q_ctx`` — Σ over rows of ``t_row · S_row`` with S_row the
      block-rounded context (the attention matmul volume per head-dim),
    * ``kv_blocks`` — Σ over rows of ``ceil(kv_len / bs)`` (blocks DMA'd
      per layer).

    Phase keys mirror the profiler's hooks: embed, scatter, attention,
    proj, mlp, logits, sampling. All per-layer terms are multiplied by
    ``cfg.num_layers``.
    """
    h, L = cfg.hidden_size, cfg.num_layers
    wb = _weight_itemsize(quantization)
    ab = 2  # bf16 activations
    n = tokens

    embed = KernelCost("embed", 0.0, n * h * (wb + ab))

    # Attention projections: wq, wk, wv, wo per layer; weights stream once
    # per step regardless of batch (the bandwidth-roofline assumption the
    # bench normalizes against).
    proj_flops = 2.0 * n * h * (2 * cfg.q_size + 2 * cfg.kv_size) * L
    proj_w = (h * cfg.q_size * 2 + h * cfg.kv_size * 2) * wb * L
    proj_act = (n * h * 2 + n * (cfg.q_size + 2 * cfg.kv_size)) * ab * L
    proj = KernelCost("proj", proj_flops, proj_w + proj_act)

    # KV scatter: the step's new K/V rows written at cache dtype; a
    # quantized cache (int8/int4) additionally re-reads + re-writes each
    # touched block to requant committed rows against the merged scale
    # (llama._scatter_kv_quant).
    kvb = _kv_itemsize(kv_dtype)
    scatter_bytes = 2.0 * n * cfg.kv_size * kvb * L
    if kv_dtype in ("int8", "int4"):
        blocks_touched = _ceil_div(n, block_size) + 1
        scatter_bytes += (2.0 * 2.0 * blocks_touched * block_size
                          * cfg.kv_size * kvb * L)
    scatter = KernelCost("scatter", 0.0, scatter_bytes)

    # Rebuild from the aggregated volumes: flops scale with attn_q_ctx,
    # KV bytes with kv_blocks, Q/out bytes with tokens.
    kv_block_bytes = block_size * cfg.num_kv_heads * cfg.head_dim * kvb
    if kv_dtype in ("int8", "int4"):
        kv_block_bytes += cfg.num_kv_heads * 4
    attn_flops = 4.0 * cfg.num_heads * cfg.head_dim * attn_q_ctx * L
    attn_bytes = (2.0 * n * cfg.q_size * ab
                  + 2.0 * kv_blocks * kv_block_bytes) * L
    if attn_num_splits > 1:
        # Split-K combine (same per-row formula as paged_attention_cost):
        # each query row's per-split f32 partial state round-trips HBM.
        rows = n * cfg.num_heads
        attn_bytes += 8.0 * attn_num_splits * rows * (cfg.head_dim + 256) * L
        attn_flops += attn_num_splits * rows * (2.0 * cfg.head_dim + 8) * L
    attention = KernelCost("paged_attention", attn_flops, attn_bytes)

    if cfg.is_moe:
        m = cfg.moe_intermediate_size
        k = max(cfg.num_experts_per_tok, 1)
        mlp_flops = (2.0 * n * h * cfg.num_experts  # router
                     + 6.0 * n * h * m * k) * L
        experts_touched = min(n * k, cfg.num_experts)
        mlp_w = (h * cfg.num_experts + 3 * h * m * experts_touched) * wb * L
        if cfg.num_shared_experts:
            sm = m * cfg.num_shared_experts
            mlp_flops += 6.0 * n * h * sm * L
            mlp_w += 3 * h * sm * wb * L
        mlp_act = n * h * 2 * ab * L
    else:
        i = cfg.intermediate_size
        mlp_flops = 6.0 * n * h * i * L
        mlp_w = 3 * h * i * wb * L
        mlp_act = (n * h * 2 + n * i) * ab * L
    mlp = KernelCost("mlp", mlp_flops, mlp_w + mlp_act)

    logits = dense_matmul_cost(logit_rows, cfg.vocab_size, h,
                               weight_bytes=wb, name="logits")
    # Sampling: vector work over [rows, V] logits — no matmul FLOPs, one
    # f32 read of the logits (argmax / top-k masking).
    sampling = KernelCost("sampling", 0.0, logit_rows * cfg.vocab_size * 4.0)

    return {"embed": embed, "scatter": scatter, "attention": attention,
            "proj": proj, "mlp": mlp, "logits": logits, "sampling": sampling}


def total_cost(phases: dict[str, KernelCost]) -> KernelCost:
    out = KernelCost("total")
    for c in phases.values():
        out = out + c
    return out


def decode_step_cost(
    cfg: ModelConfig,
    *,
    batch: int,
    kv_len: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    attn_num_splits: int = 1,
) -> dict[str, KernelCost]:
    """Uniform-batch decode step (every row: 1 query token, same context) —
    the bench / perf_report / prediction entry point."""
    nblk = _ceil_div(max(kv_len, 1), block_size)
    return model_step_cost(
        cfg, tokens=batch, logit_rows=batch,
        attn_q_ctx=float(batch * nblk * block_size),
        kv_blocks=float(batch * nblk), block_size=block_size,
        kv_dtype=kv_dtype, quantization=quantization,
        attn_num_splits=attn_num_splits)


def prefill_cost(
    cfg: ModelConfig,
    *,
    batch: int,
    chunk: int,
    kv_len: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
) -> dict[str, KernelCost]:
    """Uniform prefill chunk: ``chunk`` query tokens per row attending a
    ``kv_len`` context (chunk end for fresh prompts)."""
    nblk = _ceil_div(max(kv_len, 1), block_size)
    return model_step_cost(
        cfg, tokens=batch * chunk, logit_rows=batch,
        attn_q_ctx=float(batch * chunk * nblk * block_size),
        kv_blocks=float(batch * nblk), block_size=block_size,
        kv_dtype=kv_dtype, quantization=quantization)


def analytic_param_bytes(cfg: ModelConfig, quantization: str = "none") -> int:
    """Model parameter bytes from shapes alone (mirrors models/llama.py
    init_params structure; matmul weights at the quantized itemsize, norms
    at bf16). The runtime twin is models/quant.py param_bytes(params)."""
    h, L = cfg.hidden_size, cfg.num_layers
    wb = _weight_itemsize(quantization)
    matmul = h * cfg.q_size * 2 + h * cfg.kv_size * 2  # wq wk wv wo
    norms = 2 * h
    if cfg.is_moe:
        m = cfg.moe_intermediate_size
        matmul += h * cfg.num_experts + cfg.num_experts * 3 * h * m
        if cfg.num_shared_experts:
            matmul += 3 * h * m * cfg.num_shared_experts
    else:
        matmul += 3 * h * cfg.intermediate_size
    total = L * (matmul * wb + norms * 2)
    total += cfg.vocab_size * h * wb   # embed
    total += h * 2                      # final norm
    if not cfg.tie_word_embeddings:
        total += h * cfg.vocab_size * wb
    return total


def predicted_decode_perf(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    batch: int,
    kv_len: int,
    block_size: int = 16,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    attn_num_splits: int = 1,
) -> dict:
    """Roofline prediction for a decode config on ``hw`` — what bench.py
    attaches as the device forecast when only the CPU fallback could run."""
    phases = decode_step_cost(cfg, batch=batch, kv_len=kv_len,
                              block_size=block_size, kv_dtype=kv_dtype,
                              quantization=quantization,
                              attn_num_splits=attn_num_splits)
    cost = total_cost(phases)
    step_s = cost.time_bound(hw)
    tok_s = batch / step_s if step_s > 0 else 0.0
    return {
        "device": hw.name,
        "tok_s": round(tok_s, 1),
        "step_flops": cost.flops,
        "step_hbm_bytes": cost.hbm_bytes,
        "arithmetic_intensity": round(cost.intensity, 2),
        "bound": cost.bound(hw),
        "mfu_at_roofline": round(mfu(cost.flops, step_s, hw), 4),
        "bw_util_at_roofline": round(bw_util(cost.hbm_bytes, step_s, hw), 4),
    }


# ---------------------------------------------------------------------------
# Fleet-wide prefix cache: route-vs-pull break-even
# ---------------------------------------------------------------------------

#: Effective per-stream DCN bandwidth for pod-to-pod KV block pulls. One TCP
#: stream over the data-center network sustains far less than the NIC line
#: rate; this is the conservative planning number the router arbitrates
#: against (overridable per deployment via KvRouterConfig).
DCN_BYTES_PER_S = 12.5e9

#: Achieved MFU assumed for recompute-prefill when converting FLOPs to
#: seconds. Prefill runs compute-bound near the roofline on real batches;
#: 0.4 matches the scoreboard's achieved numbers rather than the peak.
PREFILL_MFU = 0.4


def kv_block_wire_bytes(*, num_layers: int, block_size: int,
                        num_kv_heads: int, head_dim: int,
                        kv_dtype: str = "bfloat16") -> float:
    """Bytes one KV block occupies on the wire in kvbm's host format
    (kvbm/transfer.py): K and V payload at the cache itemsize, plus the
    per-(layer, kv-head) f32 scale sidecar for quantized caches — the same
    accounting paged_attention_cost charges for the HBM stream."""
    elems = 2.0 * num_layers * block_size * num_kv_heads * head_dim
    nbytes = elems * _kv_itemsize(kv_dtype)
    if kv_dtype in ("int8", "int4"):
        nbytes += 2.0 * num_layers * num_kv_heads * 4
    return nbytes


@dataclass(frozen=True)
class PrefixCacheCost:
    """Route-vs-pull arbiter inputs for the fleet-wide prefix cache.

    Two ways to satisfy a shared prefix on a worker that doesn't hold it:

    * **recompute** — run prefill over the prefix tokens:
      ``tokens · flops_per_token / (peak_flops · prefill_mfu)`` seconds;
    * **pull** — fetch the packed KV blocks from the remote tier:
      ``overhead + blocks · wire_bytes_per_block / dcn_bytes_per_s``.

    Everything is plain floats so the router can arbitrate without a model
    runtime; build one from a ModelConfig with :func:`prefix_cache_cost`.
    """

    flops_per_token: float
    wire_bytes_per_block: float
    block_size: int
    peak_flops: float
    prefill_mfu: float = PREFILL_MFU
    dcn_bytes_per_s: float = DCN_BYTES_PER_S
    #: fixed per-import cost: remote-tier RTTs + the device scatter dispatch.
    import_overhead_s: float = 2e-3

    @property
    def seconds_per_token(self) -> float:
        eff = self.peak_flops * self.prefill_mfu
        return self.flops_per_token / eff if eff > 0 else 0.0

    def recompute_seconds(self, tokens: float) -> float:
        return max(tokens, 0.0) * self.seconds_per_token

    def pull_seconds(self, blocks: int) -> float:
        if blocks <= 0:
            return 0.0
        return (self.import_overhead_s
                + blocks * self.wire_bytes_per_block
                / max(self.dcn_bytes_per_s, 1.0))

    def break_even_blocks(self) -> float:
        """Prefix depth (blocks) above which pulling beats recomputing on an
        otherwise idle worker — the docs/PERF.md formula:
        ``pull_s(n) < recompute_s(n · bs)``."""
        per_block_pull = self.wire_bytes_per_block / max(self.dcn_bytes_per_s, 1.0)
        per_block_recompute = self.block_size * self.seconds_per_token
        gain = per_block_recompute - per_block_pull
        if gain <= 0:
            return float("inf")
        return self.import_overhead_s / gain


def prefix_cache_cost(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    rep_prefix_tokens: int = 1024,
    dcn_bytes_per_s: float = DCN_BYTES_PER_S,
    prefill_mfu: float = PREFILL_MFU,
) -> PrefixCacheCost:
    """Linearized PrefixCacheCost for a model/device pair. Per-token prefill
    FLOPs are taken at a representative shared-prefix length (the attention
    term grows with context, so this slightly undercharges very long
    prefixes — i.e. the arbiter errs toward recompute, the safe side)."""
    n = max(rep_prefix_tokens, block_size)
    phases = prefill_cost(cfg, batch=1, chunk=n, kv_len=n,
                          block_size=block_size, kv_dtype=kv_dtype,
                          quantization=quantization)
    flops_per_token = total_cost(phases).flops / n
    return PrefixCacheCost(
        flops_per_token=flops_per_token,
        wire_bytes_per_block=kv_block_wire_bytes(
            num_layers=cfg.num_layers, block_size=block_size,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            kv_dtype=kv_dtype),
        block_size=block_size,
        peak_flops=hw.peak_flops,
        prefill_mfu=prefill_mfu,
        dcn_bytes_per_s=dcn_bytes_per_s,
    )


# ---------------------------------------------------------------------------
# Context-parallel ring prefill: ring-vs-chunked break-even
# ---------------------------------------------------------------------------

#: Fixed cost of taking the ring path for one prompt: the whole-prompt
#: dispatch (one bucketed step fn at the full sequence length), the
#: seq-axis scatter of the prompt, and the paged-cache writeback gather.
RING_PREFILL_OVERHEAD_S = 1e-3


@dataclass(frozen=True)
class RingPrefillDecision:
    """Priced comparison of the two ways an sp>1 engine can prefill one
    prompt: ``ring`` (one seq-sharded whole-prompt chunk, hops between
    chips) vs ``chunked`` (the sequential prefill_chunk walk with the seq
    axis idle). ``use_ring`` is the auto-select verdict the engine applies when
    ``ring_prefill_threshold == 0``."""

    prompt_tokens: int
    sp: int
    ring_seconds: float
    chunked_seconds: float

    @property
    def use_ring(self) -> bool:
        return self.ring_seconds < self.chunked_seconds

    @property
    def speedup(self) -> float:
        return (self.chunked_seconds / self.ring_seconds
                if self.ring_seconds > 0 else float("inf"))


def chunked_prefill_seconds(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    prompt_tokens: int,
    chunk: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    prefill_mfu: float = PREFILL_MFU,
) -> float:
    """Sequential chunked prefill of one prompt with the mesh's seq axis
    idle (every device repeats the same chunk): total FLOPs over the chunk
    walk at achieved prefill MFU on ONE device's peak."""
    eff = hw.peak_flops * prefill_mfu
    if eff <= 0 or prompt_tokens <= 0:
        return 0.0
    chunk = max(chunk, 1)
    flops = 0.0
    done = 0
    while done < prompt_tokens:
        c = min(chunk, prompt_tokens - done)
        phases = prefill_cost(cfg, batch=1, chunk=c, kv_len=done + c,
                              block_size=block_size, kv_dtype=kv_dtype,
                              quantization=quantization)
        flops += total_cost(phases).flops
        done += c
    return flops / eff


# ---------------------------------------------------------------------------
# Unified ragged mixed-phase steps: decode + prefill chunk in one launch
# ---------------------------------------------------------------------------

#: Per-QoS-class scale applied to the decode-ITL SLO budget that
#: auto_prefill_chunk sizes against — the same 1x/2x/4x degradation ladder
#: the stream-checkpoint cadence uses. Interactive streams tolerate the
#: smallest prefill-induced ITL inflation, batch the largest (so batch
#: traffic prefills in bigger, more efficient chunks).
QOS_ITL_SLO_SCALE = {"interactive": 1.0, "standard": 2.0, "batch": 4.0}


def mixed_step_cost(
    cfg: ModelConfig,
    *,
    decode_rows: int,
    decode_kv_len: int,
    chunk: int,
    chunk_kv_len: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    attn_num_splits: int = 1,
) -> dict[str, KernelCost]:
    """One unified ragged mixed step: ``decode_rows`` decode rows (one live
    query token attending ``decode_kv_len`` context each) packed with one
    prefill-chunk row (``chunk`` live tokens attending ``chunk_kv_len``
    context — the chunk end for fresh prompts) in a SINGLE program. The
    ragged grid early-exits padded positions, so the live volume is exactly
    the sum of the two phases' volumes; the aggregate inputs below are the
    hand-checkable expansion (tests/test_perf_obs.py)."""
    nblk_d = _ceil_div(max(decode_kv_len, 1), block_size)
    nblk_p = _ceil_div(max(chunk_kv_len, 1), block_size)
    return model_step_cost(
        cfg,
        tokens=decode_rows + chunk,
        logit_rows=decode_rows + (1 if chunk > 0 else 0),
        attn_q_ctx=float(decode_rows * nblk_d * block_size
                         + chunk * nblk_p * block_size),
        kv_blocks=float(decode_rows * nblk_d + (nblk_p if chunk > 0 else 0)),
        block_size=block_size, kv_dtype=kv_dtype,
        quantization=quantization, attn_num_splits=attn_num_splits)


def mixed_step_seconds(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    decode_rows: int,
    decode_kv_len: int,
    chunk: int,
    chunk_kv_len: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    attn_num_splits: int = 1,
    prefill_mfu: float = PREFILL_MFU,
) -> float:
    """Predicted wall time of one unified mixed step — decode ITL when a
    chunk rides along. Compute is derated to achieved prefill MFU (the
    chunk's matmuls dominate the FLOP side, consistent with
    chunked_prefill_seconds); bandwidth stays at peak (the decode side is
    a streaming KV read, consistent with the decode roofline). chunk=0
    prices the pure-decode step, so ``mixed - pure`` is the chunk's
    marginal ITL inflation the HOL attribution charges."""
    cost = total_cost(mixed_step_cost(
        cfg, decode_rows=decode_rows, decode_kv_len=decode_kv_len,
        chunk=chunk, chunk_kv_len=chunk_kv_len, block_size=block_size,
        kv_dtype=kv_dtype, quantization=quantization,
        attn_num_splits=attn_num_splits))
    eff = hw.peak_flops * prefill_mfu
    return max(cost.flops / eff if eff > 0 else 0.0,
               cost.hbm_bytes / hw.hbm_bw if hw.hbm_bw > 0 else 0.0)


def auto_prefill_chunk(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    itl_slo_s: float,
    decode_rows: int,
    decode_kv_len: int,
    block_size: int,
    max_chunk: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    qos_class: str = "interactive",
    min_chunk: int = 16,
) -> int:
    """SLO-driven chunk sizing: the largest power-of-two chunk (the compile
    ledger's 16-doubling t ladder, so auto never mints new buckets) whose
    predicted mixed-step time stays inside the decode-ITL SLO budget for
    ``qos_class`` (budget × QOS_ITL_SLO_SCALE). Returns ``min_chunk`` even
    when the SLO is already blown by the pure-decode step — prefill must
    keep making forward progress."""
    budget = itl_slo_s * QOS_ITL_SLO_SCALE.get(qos_class, 1.0)
    best = min_chunk
    chunk = min_chunk
    while chunk <= max(max_chunk, min_chunk):
        predicted = mixed_step_seconds(
            cfg, hw, decode_rows=decode_rows, decode_kv_len=decode_kv_len,
            chunk=chunk, chunk_kv_len=chunk, block_size=block_size,
            kv_dtype=kv_dtype, quantization=quantization)
        if predicted <= budget:
            best = chunk
        chunk *= 2
    return min(best, max(max_chunk, min_chunk))


def ring_prefill_seconds(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    prompt_tokens: int,
    sp: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    prefill_mfu: float = PREFILL_MFU,
    ici_bytes_per_s: float | None = None,
) -> float:
    """One seq-sharded whole-prompt ring prefill: the same matmul volume
    split ``sp`` ways, overlapped with the per-layer KV shard rotation
    between chips (at ``ici_bytes_per_s``, by default the row's
    ``ring_bytes_per_s``), plus the fixed dispatch/writeback overhead."""
    if ici_bytes_per_s is None:
        ici_bytes_per_s = hw.ring_bytes_per_s
    eff = hw.peak_flops * prefill_mfu
    if eff <= 0 or prompt_tokens <= 0:
        return 0.0
    phases = prefill_cost(cfg, batch=1, chunk=prompt_tokens,
                          kv_len=prompt_tokens, block_size=block_size,
                          kv_dtype=kv_dtype, quantization=quantization)
    compute_s = total_cost(phases).flops / max(sp, 1) / eff
    ring = ring_attention_cost(
        batch=1, seq_len=prompt_tokens, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, sp=sp)
    ici_s = ring.ici_bytes * cfg.num_layers / max(ici_bytes_per_s, 1.0)
    return RING_PREFILL_OVERHEAD_S + max(compute_s, ici_s)


def ring_vs_chunked_prefill(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    prompt_tokens: int,
    sp: int,
    chunk: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
) -> RingPrefillDecision:
    """Price both prefill modes for one prompt; the engine's auto-select
    and tools/perf_report.py both read this one verdict."""
    return RingPrefillDecision(
        prompt_tokens=prompt_tokens,
        sp=sp,
        ring_seconds=ring_prefill_seconds(
            cfg, hw, prompt_tokens=prompt_tokens, sp=sp,
            block_size=block_size, kv_dtype=kv_dtype,
            quantization=quantization),
        chunked_seconds=chunked_prefill_seconds(
            cfg, hw, prompt_tokens=prompt_tokens, chunk=chunk,
            block_size=block_size, kv_dtype=kv_dtype,
            quantization=quantization),
    )


def ring_prefill_break_even_tokens(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    sp: int,
    chunk: int,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    max_tokens: int = 1 << 20,
) -> int:
    """Smallest block-aligned prompt length where the ring path beats the
    chunked walk (the engine's auto threshold). Returns ``max_tokens`` when
    ring never wins in range (sp=1, or overhead dominates throughout) —
    callers treat that as "effectively off"."""
    if sp <= 1:
        return max_tokens

    def _ring_wins(tokens: int) -> bool:
        return ring_vs_chunked_prefill(
            cfg, hw, prompt_tokens=tokens, sp=sp, chunk=chunk,
            block_size=block_size, kv_dtype=kv_dtype,
            quantization=quantization).use_ring

    # Doubling probe for the first winning length, then bisect down to
    # block granularity (the verdict is monotone in tokens: the ring's
    # fixed overhead amortizes while its compute advantage grows).
    hi = block_size
    while hi < max_tokens and not _ring_wins(hi):
        hi *= 2
    if hi >= max_tokens:
        return max_tokens
    lo = hi // 2
    while hi - lo > block_size:
        mid = (lo + hi) // 2 // block_size * block_size
        if _ring_wins(mid):
            hi = mid
        else:
            lo = mid
    return hi


# ---------------------------------------------------------------------------
# Session-sticky KV retention: retained bytes vs re-prefill seconds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SessionRetentionCost:
    """The session-retention trade: holding one conversation's KV costs
    ``bytes_per_token`` of cache capacity per retained context token and
    buys back ``seconds_per_token`` of turn-N+1 prefill per token NOT
    recomputed. ``seconds_per_gb`` is the docs/PERF.md break-even figure:
    prefill seconds one retained gigabyte saves at achieved MFU."""

    bytes_per_token: float
    seconds_per_token: float

    def retained_bytes(self, tokens: float) -> float:
        return max(tokens, 0.0) * self.bytes_per_token

    def recompute_seconds(self, tokens: float) -> float:
        return max(tokens, 0.0) * self.seconds_per_token

    @property
    def seconds_per_gb(self) -> float:
        if self.bytes_per_token <= 0:
            return 0.0
        return self.seconds_per_token * (1 << 30) / self.bytes_per_token


def session_retention_cost(
    cfg: ModelConfig,
    hw: HardwareSpec,
    *,
    block_size: int,
    kv_dtype: str = "bfloat16",
    quantization: str = "none",
    rep_context_tokens: int = 1024,
    prefill_mfu: float = PREFILL_MFU,
) -> SessionRetentionCost:
    """Linearized retention trade for a model/device pair: per-token KV
    bytes from the cache layout (kv_block_wire_bytes over a block) and
    per-token prefill seconds at a representative context (same
    linearization — and the same err-toward-recompute bias — as
    prefix_cache_cost)."""
    per_block = kv_block_wire_bytes(
        num_layers=cfg.num_layers, block_size=block_size,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        kv_dtype=kv_dtype)
    n = max(rep_context_tokens, block_size)
    phases = prefill_cost(cfg, batch=1, chunk=n, kv_len=n,
                          block_size=block_size, kv_dtype=kv_dtype,
                          quantization=quantization)
    eff = hw.peak_flops * prefill_mfu
    return SessionRetentionCost(
        bytes_per_token=per_block / block_size,
        seconds_per_token=(total_cost(phases).flops / n / eff
                           if eff > 0 else 0.0),
    )


def mfu(flops: float, wall_s: float, hw: HardwareSpec) -> float:
    """Model-FLOPs utilization: achieved matmul FLOP/s over peak."""
    if wall_s <= 0 or hw.peak_flops <= 0:
        return 0.0
    return flops / wall_s / hw.peak_flops


def bw_util(hbm_bytes: float, wall_s: float, hw: HardwareSpec) -> float:
    """Achieved HBM bytes/s over peak bandwidth."""
    if wall_s <= 0 or hw.hbm_bw <= 0:
        return 0.0
    return hbm_bytes / wall_s / hw.hbm_bw


def roofline_fraction(cost: KernelCost, wall_s: float, hw: HardwareSpec) -> float:
    """Achieved fraction of the roofline floor: bound-time / wall (1.0 =
    running exactly at the roofline; > 1 means the model undercounts)."""
    if wall_s <= 0:
        return 0.0
    return cost.time_bound(hw) / wall_s
