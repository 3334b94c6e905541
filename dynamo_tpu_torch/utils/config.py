"""Engine configuration — copy of ``EngineConfig`` from
``dynamo_tpu/utils/config.py``, cut to the fields the port reads.

A field of the JAX engine's config that the port would accept and then
ignore is left out, so setting it fails at construction; it comes back
with the slice that reads it. The kept fields whose non-default values
this slice does not carry yet make the engine raise, naming that slice
(``engine.engine.check_supported``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EngineConfig:
    """Engine settings (the role vLLM's EngineArgs plays for the reference)."""

    model: str = "tiny-llama"           # model name or local path
    block_size: int = 16                  # KV cache tokens per block
    num_blocks: int = 0                   # 0 = auto-size from free device memory
    max_batch_size: int = 64
    max_model_len: int = 8192
    max_tokens_per_step: int = 8192       # prefill token budget per step
    # Chunked-prefill bucket (tokens). 0 = auto: costmodel.auto_prefill_chunk
    # picks, per QoS class, the largest chunk whose predicted mixed-step
    # time keeps decode ITL inside itl_slo_ms (resolved to a concrete cap at
    # engine construction, so bucket enumeration and warmup see real shapes).
    prefill_chunk: int = 512
    decode_bucket: tuple[int, ...] = (8, 16, 32, 64)
    # Unified ragged mixed-phase steps: decode rows and prefill-chunk rows
    # in ONE step per iteration. False = legacy two-launch path (decode
    # step, then prefill step) for bisection.
    unified_step: bool = True
    # Decode inter-token-latency SLO budget (milliseconds) that
    # costmodel.auto_prefill_chunk sizes chunks against when
    # prefill_chunk=0. Per-QoS ladder scales it: interactive 1x,
    # standard 2x, batch 4x.
    itl_slo_ms: float = 50.0
    # Mesh axes sizes; 1 = unsharded. (data, pipe, seq, model, expert)
    dp: int = 1
    pp: int = 1
    tp: int = 1
    ep: int = 1
    sp: int = 1
    # Weight-only quantization: "none" | "int8".
    quantization: str = "none"
    # KV-cache storage: "bfloat16" or "" (model precision: the cache is
    # stored at the model's dtype) | "int8" | "int4" (quantized payload +
    # per-(layer, block, kv head) f32 scales; int4 packs two nibbles a byte).
    kv_dtype: str = "bfloat16"
    enable_prefix_caching: bool = True
    # KVBM tiers: G2 host blocks, G3 disk, G4 remote store.
    host_kv_blocks: int = 0
    disk_kv_path: str | None = None
    remote_kv_addr: str | None = None
    global_prefix_cache: bool = False
    # N-gram speculative decoding: 0 = off; spec_k = max proposed tokens
    # a verify step checks.
    spec_ngram: int = 0
    spec_k: int = 4
    seed: int = 0
    # A checkpoint PATH without loadable weights fails engine construction
    # unless this is set — a typo'd path must not silently serve garbage.
    # (Named presets always random-init; they exist for tests/benches.)
    allow_random_weights: bool = False
    # Split-K paged attention: 0 = auto (from context length and the SM
    # count), 1 = sequential walk, N>1 = forced split count.
    attn_num_splits: int = 0
    # Fused decode window (decode steps per dispatch).
    decode_window: int = 1
    # Step-program warmup (obs/compile_ledger.py): "off" disables the
    # ledger, "lazy" captures each bucket's CUDA graph on first use,
    # "full" captures the whole enumerated lattice before serving.
    warmup_mode: str = "lazy"
    # Wall-seconds budget for full warmup (0 = unbounded); buckets past it
    # stay cold and count against coverage.
    warmup_deadline: float = 120.0
    # Session-sticky KV retention seconds (0 = off).
    session_ttl: float = 0.0
    # Crash-consistent stream checkpoint cadence (0 = off).
    stream_ckpt_blocks: int = 0

    def mesh_shape(self) -> dict[str, int]:
        return {"data": self.dp, "pipe": self.pp, "model": self.tp,
                "expert": self.ep, "seq": self.sp}
