"""Crash-consistent stream checkpoints (dynamo_stream_ckpt_*) — copy of
``dynamo_tpu/kvbm/stream_ckpt.py``.

Every K committed decode blocks (and once at prefill completion) the
engine enqueues a stream's newly committed blocks plus a small
``StreamCheckpoint`` record through the OffloadManager's budgeted flush
into the shared remote store. A stream resumed from its record (the
annotations below on a request whose prompt is the old prompt plus the
generated tokens) onboards the stored blocks, replays only the suffix
after the checkpoint and continues token for token: greedy streams
exactly, sampled ones through the restored sampler state (the port's
per-slot seed and draw counter; the record's ``key`` is the seed's two
32-bit words, as the JAX engine writes it). The migration operator that
resumes streams on a surviving worker comes with the distributed runtime.

One module holds the three pieces every layer shares:

* the **record** schema (build/parse) — request_id, generated-token
  ledger, committed block-hash chain, sampler state (key data + draw
  counter, so a sampled resume is bit-identical), stop progress;
* the **annotation keys** a resume request carries so the engine can
  restore sampler state and continue the ledger;
* the **metrics family** (the JAX package's names).
"""

from __future__ import annotations

import time
from typing import Any

from dynamo_tpu_torch.utils.metrics import MetricsRegistry

# -- resume-request annotations ----------------------------------------------
# Count of already-generated tokens appended to the resume prompt: the
# engine knows how many trailing prompt tokens are *generated* (penalty
# rebuild + recompute accounting) and counts the request as a resume.
CKPT_GENERATED_KEY = "stream_ckpt.generated"
# Total sampler draws the stream had consumed before the crash (one draw
# per emitted token at decode_window=1) — the fold/step counter the
# engine advances the restored key by.
CKPT_DRAWS_KEY = "stream_ckpt.draws"
# Captured device PRNG key data (list of uint32 words) at checkpoint time
# plus the draw count at capture — the resume path for *unseeded* streams,
# where the key cannot be re-derived from the request.
CKPT_KEY_DATA_KEY = "stream_ckpt.key"
CKPT_KEY_DRAWS_KEY = "stream_ckpt.key_draws"

# Records a crashed worker never deleted expire out of the shared store:
# lazy TTL, enforced client-side on get (kvbm/remote.py get_stream_ckpt).
DEFAULT_CKPT_TTL_S = 600.0

# Device blocks sitting in the checkpoint flush queue are pinned under the
# mem-ledger owner class "stream_ckpt" (obs/mem_ledger.py) — pin at
# OffloadManager.enqueue_stream_ckpt, unpin at flush or staleness drop.
MEM_OWNER_CLASS = "stream_ckpt"


def build_ckpt_record(request_id: str, generated: list[int],
                      seq_hashes: list[int], *,
                      key_data: list[int] | None = None,
                      draws: int = 0, seed: int | None = None,
                      prompt_tokens: int = 0) -> dict[str, Any]:
    """The msgpack-able StreamCheckpoint payload. ``generated`` is the full
    token ledger so far (stop-condition progress is reconstructed from it
    on resume), ``seq_hashes`` the committed chain covering prompt +
    ledger, ``key_data``/``draws`` the sampler PRNG state at capture."""
    return {
        "rid": request_id,
        "generated": [int(t) for t in generated],
        "hashes": [int(h) for h in seq_hashes],
        "key": [int(w) for w in key_data] if key_data is not None else None,
        "draws": int(draws),
        "seed": int(seed) if seed is not None else None,
        "prompt_tokens": int(prompt_tokens),
        "ts": time.time(),
    }


def parse_ckpt_record(rec: Any) -> dict[str, Any] | None:
    """Validate a decoded record; None for anything malformed (a corrupt
    record must degrade to the reprompt path, never raise mid-recovery)."""
    if not isinstance(rec, dict) or "generated" not in rec:
        return None
    try:
        return {
            "rid": str(rec.get("rid", "")),
            "generated": [int(t) for t in rec["generated"]],
            "hashes": [int(h) for h in rec.get("hashes") or []],
            "key": ([int(w) for w in rec["key"]]
                    if rec.get("key") is not None else None),
            "draws": int(rec.get("draws", 0)),
            "seed": (int(rec["seed"]) if rec.get("seed") is not None
                     else None),
            "prompt_tokens": int(rec.get("prompt_tokens", 0)),
            "ts": float(rec.get("ts", 0.0)),
        }
    except (TypeError, ValueError):
        return None


class StreamCkptMetrics:
    """The dynamo_stream_ckpt_* family (the JAX package's names)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.writes = registry.counter(
            "stream_ckpt_writes",
            "StreamCheckpoint records written to the shared remote store")
        self.bytes = registry.counter(
            "stream_ckpt_bytes",
            "Bytes pushed for stream checkpoints (KV blocks + records)")
        self.resumes = registry.counter(
            "stream_ckpt_resumes",
            "Broken streams resumed warm from a stream checkpoint instead "
            "of the cold reprompt path")
        self.resume_recomputed_tokens = registry.counter(
            "stream_ckpt_resume_recomputed_tokens",
            "Tokens recomputed on checkpoint resume (the post-checkpoint "
            "suffix the crash cost — bounded by one checkpoint interval)")
        self.lag_blocks = registry.gauge(
            "stream_ckpt_lag_blocks",
            "Committed blocks of live streams not yet covered by a "
            "checkpoint (crash exposure, in blocks)")
        self.expired = registry.counter(
            "stream_ckpt_expired",
            "Checkpoint lookups that found only a TTL-expired record")


_metrics: StreamCkptMetrics | None = None


def get_stream_ckpt_metrics() -> StreamCkptMetrics:
    global _metrics
    if _metrics is None:
        _metrics = StreamCkptMetrics()
    return _metrics


def install_stream_ckpt_metrics(registry: MetricsRegistry) -> StreamCkptMetrics:
    """Re-home the singleton into ``registry`` (worker or frontend runtime)
    so the family is exposed on /metrics."""
    m = get_stream_ckpt_metrics()
    m.bind(registry)
    return m
