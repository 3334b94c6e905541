"""Request migration: resume a broken stream on another worker.

Fills the role of the reference's Migration operator
(reference: lib/llm/src/migration.rs:26-81 Migration/RetryManager;
docs/architecture/request_migration.md): if a worker dies mid-generation,
re-dispatch the request to a new worker with the already-generated tokens
appended to the prompt (KV rebuilds via prefix cache or recompute), up to
``migration_limit`` times. The client stream never sees the failure.

Recovery discipline on each retry:

- the failing worker (``StreamError.instance_id``) is quarantined via
  ``on_instance_error`` so the re-dispatch can't race the lease-expiry
  watch and re-pick the dead instance;
- the QoS deadline is re-checked — a request that blew its deadline while
  broken is finished with a typed ``cancelled`` delta, not resurrected;
- the retried request keeps the ``obs.traceparent`` annotation (retried
  spans join the original trace) and stamps ``migration.attempt``.

Copy of ``dynamo_tpu/frontend/migration.py``.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Awaitable, Callable

from dynamo_tpu_torch.kvbm.stream_ckpt import (
    CKPT_DRAWS_KEY,
    CKPT_GENERATED_KEY,
    CKPT_KEY_DATA_KEY,
    CKPT_KEY_DRAWS_KEY,
)
from dynamo_tpu_torch.protocols.common import FinishReason, PreprocessedRequest
from dynamo_tpu_torch.qos.deadline import deadline_of, expired
from dynamo_tpu_torch.runtime.client import NoInstancesError, StreamError
from dynamo_tpu_torch.runtime.pipeline import NextFn, Operator
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

log = get_logger("migration")

# A routed generate: request -> stream of LLMEngineOutput dicts.
RoutedGenerate = Callable[[PreprocessedRequest], AsyncIterator[dict]]

# Async checkpoint lookup: request_id -> StreamCheckpoint record (or None).
CkptLookup = Callable[[str], Awaitable[dict | None]]

MIGRATION_ATTEMPT_KEY = "migration.attempt"


class MigrationMetrics:
    """dynamo_migration_attempts_total (cross-checked by
    tools/lint_metrics.py RECOVERY_METRICS)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.attempts = registry.counter(
            "migration_attempts_total",
            "Request re-dispatch attempts after a broken worker stream, "
            "by outcome (resumed|retried|exhausted|deadline) — resumed "
            "means a stream checkpoint was found and the re-dispatch is a "
            "warm, token-exact continuation")


_metrics: MigrationMetrics | None = None


def get_migration_metrics() -> MigrationMetrics:
    global _metrics
    if _metrics is None:
        _metrics = MigrationMetrics()
    return _metrics


def install_migration_metrics(registry: MetricsRegistry) -> MigrationMetrics:
    """Re-home the singleton into the frontend's registry (/metrics)."""
    m = get_migration_metrics()
    m.bind(registry)
    return m


class Migration(Operator):
    """Pipeline operator (runtime/pipeline.py): the retrying backward edge.
    ``inner`` binds a fixed downstream for standalone use; inside a linked
    pipeline the ``next`` callable supersedes it."""

    def __init__(self, inner: RoutedGenerate | None = None,
                 migration_limit: int = 3,
                 wait_ready: Callable[[float], Awaitable[None]] | None = None,
                 on_instance_error: Callable[[int], None] | None = None,
                 lookup_ckpt: CkptLookup | None = None):
        self.inner = inner
        self.migration_limit = migration_limit
        self.wait_ready = wait_ready  # e.g. EndpointClient.wait_for_instances
        # e.g. EndpointClient.quarantine: sideline the failing worker NOW
        # rather than waiting out its lease TTL.
        self.on_instance_error = on_instance_error
        # Stream-checkpoint lookup against the shared G4 store. When it
        # yields a record, the re-dispatch is stamped with stream_ckpt.*
        # annotations: the engine restores the sampler PRNG to the exact
        # post-suffix position and the committed blocks onboard warm, so
        # the resumed stream is token-identical to the unbroken one.
        self.lookup_ckpt = lookup_ckpt

    async def generate(self, req: PreprocessedRequest,
                       next: NextFn | None = None) -> AsyncIterator[dict]:
        inner = next or self.inner
        assert inner is not None, "Migration needs a downstream (inner or next)"
        attempts = 0
        generated: list[int] = []
        current = req
        while True:
            finished = False
            try:
                async for out in inner(current):
                    toks = out.get("token_ids") or []
                    generated.extend(toks)
                    if out.get("finish_reason"):
                        finished = True
                    yield out
                if finished:
                    return
                # stream ended without finish_reason → treat as broken. The
                # truncation itself carries no ERR frame, so attribute it to
                # the worker the router last dispatched to (stamped as
                # ``last_instance_id`` by the routing layer) — otherwise the
                # quarantine below never fires for silent truncations.
                raise StreamError(
                    "stream ended without finish reason",
                    instance_id=getattr(current, "last_instance_id", None))
            except (StreamError, NoInstancesError, ConnectionError, OSError) as exc:
                if finished:
                    # The final chunk (finish_reason set) already reached the
                    # client; the failure was only the stream teardown (e.g.
                    # END frame lost). Re-dispatching would emit duplicate
                    # tokens after the finish chunk.
                    return
                iid = getattr(exc, "instance_id", None)
                if iid is not None and self.on_instance_error is not None:
                    try:
                        self.on_instance_error(iid)
                    except Exception:  # noqa: BLE001 - advisory only
                        log.exception("instance-error callback failed")
                attempts += 1
                if attempts > self.migration_limit:
                    get_migration_metrics().attempts.inc(outcome="exhausted")
                    log.warning("migration limit reached for %s: %s", req.request_id, exc)
                    raise
                # Don't resurrect a request that already blew its QoS
                # deadline: finish the stream with a TYPED cancellation
                # (the worker-side mid-stream enforcement can't fire for a
                # request that is between workers).
                if expired(deadline_of(req.annotations)):
                    get_migration_metrics().attempts.inc(outcome="deadline")
                    log.info("not migrating %s: deadline expired after %s",
                             req.request_id, exc)
                    yield {"token_ids": [],
                           "finish_reason": str(FinishReason.CANCELLED),
                           "error": "deadline exceeded during migration"}
                    return
                # Prefer an exact warm resume: if the dead worker left a
                # stream checkpoint in the shared store, the re-dispatch
                # continues bit-identically (greedy bitwise; sampled via the
                # restored PRNG position) and recomputes at most one
                # checkpoint interval. No record → today's reprompt path.
                record = None
                if self.lookup_ckpt is not None:
                    try:
                        record = await self.lookup_ckpt(req.request_id)
                    except Exception:  # noqa: BLE001 - lookup is best-effort
                        log.exception("stream-checkpoint lookup failed")
                get_migration_metrics().attempts.inc(
                    outcome="resumed" if record is not None else "retried")
                log.info("migrating request %s (attempt %d/%d, %s): %s",
                         req.request_id, attempts, self.migration_limit,
                         "ckpt resume" if record is not None else "reprompt",
                         exc)
                # Back off so retries span the lease-expiry window — dead
                # instances need a few seconds to vanish from discovery and
                # replacements to appear (reference: RetryManager re-resolves
                # instances between attempts).
                await asyncio.sleep(min(1.0 * attempts, 2.5))
                if self.wait_ready is not None:
                    try:
                        await self.wait_ready(8.0)
                    except Exception:
                        pass  # final attempt will surface NoInstancesError
                # resume: prompt + tokens generated so far; budget shrinks
                # (always relative to the ORIGINAL request's budget)
                new_req = PreprocessedRequest.from_dict(req.to_dict())
                new_req.request_id = req.request_id
                new_req.token_ids = list(req.token_ids) + generated
                # Annotations round-trip through to_dict, which keeps the
                # obs.traceparent — retried worker spans join the ORIGINAL
                # trace; the attempt number marks them as a migration leg.
                new_req.annotations = dict(req.annotations or {})
                new_req.annotations[MIGRATION_ATTEMPT_KEY] = attempts
                if record is not None:
                    # Our own accumulated ledger is the COMPLETE suffix (we
                    # saw every streamed token); the record's may lag by up
                    # to one interval. The engine advances the per-stream
                    # PRNG by the draw count and re-pins the checkpointed
                    # blocks through the normal admission-time onboard.
                    new_req.annotations[CKPT_GENERATED_KEY] = len(generated)
                    new_req.annotations[CKPT_DRAWS_KEY] = len(generated)
                    if record.get("key") is not None:
                        new_req.annotations[CKPT_KEY_DATA_KEY] = list(record["key"])
                        new_req.annotations[CKPT_KEY_DRAWS_KEY] = int(
                            record.get("draws") or 0)
                orig_max = req.stop_conditions.max_tokens
                if orig_max is not None:
                    new_req.stop_conditions.max_tokens = max(orig_max - len(generated), 1)
                current = new_req
