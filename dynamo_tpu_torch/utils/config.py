"""Runtime and engine configuration — copies of ``RuntimeConfig`` and
``EngineConfig`` from ``dynamo_tpu/utils/config.py``; the engine's cut to
the fields the port reads.

A field of the JAX engine's config that the port would accept and then
ignore is left out, so setting it fails at construction; it comes back
with the slice that reads it. The kept fields whose non-default values
this slice does not carry yet make the engine raise, naming that slice
(``engine.engine.check_supported``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

ENV_PREFIX = "DYN_"


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


@dataclass
class RuntimeConfig:
    """Process-level runtime settings (reference: lib/runtime/src/config.rs).
    Values resolve, in order of precedence: explicit kwargs > ``DYN_*``
    environment variables > a JSON config file > defaults."""

    # Worker threads for the compute pool (reference: compute/pool.rs).
    num_worker_threads: int = 0  # 0 = os.cpu_count()
    # Coordination service address (our consolidated etcd/NATS equivalent).
    coordinator_url: str = "tcp://127.0.0.1:6650"
    # Namespace this process operates in.
    namespace: str = "dynamo"
    # System status server (health/metrics) — reference: system_status_server.rs.
    system_enabled: bool = False
    system_port: int = 0  # 0 = ephemeral
    # Logging.
    log_level: str = "info"
    log_jsonl: bool = False
    # Request plane.
    request_timeout_s: float = 600.0
    # Primary lease TTL (liveness). Generous enough that a long GIL-holding
    # build or capture can't starve the keep-alive loop into lease expiry.
    lease_ttl_s: float = 20.0
    # Graceful shutdown drain deadline.
    drain_timeout_s: float = 30.0
    # Scheduling-policy bound on concurrently-executing handler streams
    # (excess CALLs queue; reference: tracker.rs semaphore policies).
    max_handler_streams: int = 1024

    @classmethod
    def from_settings(cls, path: str | os.PathLike | None = None, **overrides: Any) -> "RuntimeConfig":
        """Build config from defaults < file < DYN_* env < explicit overrides.
        The file is JSON, or YAML read by the port's ``utils/yaml_lite``."""
        values: dict[str, Any] = {}
        candidate = path or os.environ.get(ENV_PREFIX + "CONFIG")
        if candidate and Path(candidate).exists():
            text = Path(candidate).read_text()
            try:
                values.update(json.loads(text))
            except json.JSONDecodeError:
                from dynamo_tpu_torch.utils import yaml_lite

                try:
                    values.update(yaml_lite.safe_load(text) or {})
                except Exception as exc:
                    raise ValueError(f"could not parse config file {candidate}") from exc
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for name, f in fields.items():
            env_key = ENV_PREFIX + name.upper()
            if env_key in os.environ:
                values[name] = _coerce(os.environ[env_key], f.type if isinstance(f.type, type) else type(f.default))
        values.update({k: v for k, v in overrides.items() if v is not None})
        values = {k: v for k, v in values.items() if k in fields}
        return cls(**values)


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
    # pp > 1: microbatches a step's pipeline schedule runs through the stages
    # (models/llama.forward_pp). 0 = auto (2*pp); a split axis they do not
    # divide takes the largest divisor below, and fewer than 2 take the
    # sequential schedule.
    pp_microbatches: int = 0
    # Tensor parallelism (tp > 1): one process a rank over torch.distributed
    # with this backend, "nccl" (a card a rank) or "gloo" (required when
    # ranks share a card); rank r runs on cuda:tp_devices[r] (default
    # cuda:r). Ranks that share a card also need an explicit num_blocks:
    # sizing the pool from free memory would race between them.
    dist_backend: str = "nccl"
    tp_devices: tuple[int, ...] = ()
    # Nodes the engine's dp*pp*sp*ep*tp ranks are spread over (node k holds
    # world ranks [k R/N, (k+1) R/N); parallel/multihost.py). tp_devices
    # then names one card for each of this node's ranks.
    num_nodes: int = 1
    # Weight-only quantization: "none" | "int8".
    quantization: str = "none"
    # KV-cache storage: "bfloat16" or "" (model precision: the cache is
    # stored at the model's dtype) | "int8" | "int4" (quantized payload +
    # per-(layer, block, kv head) f32 scales; int4 packs two nibbles a byte).
    kv_dtype: str = "bfloat16"
    enable_prefix_caching: bool = True
    # KVBM tiers: G2 host arena capacity in blocks (0 = disabled), an
    # optional G3 disk tier (path + byte budget) and a G4 remote block
    # store ("host:port" of a RemoteBlockServer), chained in that order.
    # Device-evicted committed blocks write back down the chain, prompts
    # onboard from any of them.
    host_kv_blocks: int = 0
    disk_kv_path: str | None = None
    disk_kv_bytes: int = 1 << 30
    remote_kv_addr: str | None = None
    # Publish committed prefix blocks to the remote store as they form, not
    # only on eviction (needs remote_kv_addr).
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
    # Context-parallel ring prefill (sp > 1, ops/ring_attention.py): the
    # least prompt tokens with which a step of fresh whole prompts prefills
    # as ONE seq-sharded ring chunk instead of the chunked path. 0 = auto
    # (the ring-vs-chunked break-even of obs/costmodel.py on the device's
    # row), N > 0 = that many tokens, -1 = never (the engine then serves as
    # an sp=1 chunked engine on every seq rank).
    ring_prefill_threshold: int = 0
    # Session-sticky KV retention: when a stream carrying a session.id
    # annotation finishes, its committed KV blocks stay pinned on the
    # device for this many seconds of step time, so turn N+1 prefills only
    # the new suffix. 0 = retention off.
    session_ttl: float = 0.0
    # On TTL expiry or pool pressure, stage a retained session's blocks
    # down the KVBM tier ladder before unpinning, so a later turn can
    # re-import them after device eviction. False drops the pins to plain
    # LRU without the write-through.
    session_tiers: bool = True
    # Crash-consistent stream checkpoints: every N committed decode blocks
    # (QoS-degraded: interactive 1x, standard 2x, batch 4x) a stream's
    # blocks and a resumable record go to the remote store. 0 = off; needs
    # remote_kv_addr.
    stream_ckpt_blocks: int = 0

    def mesh_shape(self) -> dict[str, int]:
        return {"data": self.dp, "pipe": self.pp, "model": self.tp,
                "expert": self.ep, "seq": self.sp}
