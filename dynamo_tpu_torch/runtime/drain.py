"""Drain-aware worker retirement: the protocol between planner and worker.

Fills the role of the reference planner's graceful scale-down (reference:
components/src/dynamo/planner/ KubernetesConnector — a K8s Deployment
patch triggers preStop drain hooks; here the connector and the worker
speak directly). Retirement is a first-class protocol, not a SIGKILL:

1. **Request** — the planner (or an operator) writes a
   :class:`DrainRequest` under ``planner/drain/{namespace}/{instance}``,
   carrying the human-readable reason and a deadline; sending SIGTERM to
   the worker starts the same protocol with default knobs.
2. **Membership out** — the worker flips readiness NotReady, deletes its
   model card + endpoint instance keys, and stops admitting new streams.
   Its lease (and data-plane connections) stay live so in-flight streams
   finish. Because every registration is lease-bound, a drain that dies
   half-way can never leave stale membership: the lease revoke/expiry
   removes whatever the explicit deregistration didn't.
3. **Run down** — in-flight streams run to completion under the bounded
   deadline; past the batch grace, batch-class streams are early-stopped
   (QoS: interactive work gets the whole window, batch work yields it).
4. **Evacuate** — session-retained KV and its resumable session records
   are pushed to the shared remote block store (kvbm/remote.py), so the
   session's next turn lands on a surviving worker as pull-to-warm
   instead of a full recompute.
5. **Exit** — only then are publishers stopped and the lease dropped.

A second SIGTERM/SIGINT aborts the drain (skip waiting + evacuation,
bounded fast teardown) so an operator always has a fast exit.

The ``dynamo_drain_*`` family below is cross-checked by
tools/lint_metrics.py DRAIN_METRICS.

Copy of ``dynamo_tpu/runtime/drain.py``.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

log = get_logger("runtime.drain")

DRAIN_PREFIX = "planner/drain"


def drain_key(namespace: str, instance_id: int) -> str:
    """Coordinator key the planner writes to request a drain."""
    return f"{DRAIN_PREFIX}/{namespace}/{instance_id:016x}"


def drain_status_key(namespace: str, instance_id: int) -> str:
    """Where the draining worker reports progress (not lease-bound, so the
    planner can read the terminal state after the worker exits)."""
    return drain_key(namespace, instance_id) + "/status"


@dataclass
class DrainRequest:
    """The planner→worker handshake payload."""

    reason: str = ""
    deadline_s: float | None = None     # None = the worker's default
    ts: float = 0.0

    def to_bytes(self) -> bytes:
        return json.dumps({"reason": self.reason, "deadline_s": self.deadline_s,
                           "ts": self.ts}).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DrainRequest":
        d = json.loads(raw)
        return cls(reason=str(d.get("reason", "")),
                   deadline_s=d.get("deadline_s"),
                   ts=float(d.get("ts", 0.0)))


class DrainMetrics:
    """The dynamo_drain_* family (names cross-checked by
    tools/lint_metrics.py DRAIN_METRICS)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.duration = registry.histogram(
            "drain_duration_seconds",
            "Wall-clock seconds a worker drain took, request to exit-ready",
            buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0))
        self.streams_completed = registry.counter(
            "drain_streams_completed",
            "In-flight streams that ran to completion during a drain")
        self.streams_aborted = registry.counter(
            "drain_streams_aborted",
            "In-flight streams early-stopped during a drain (batch-class "
            "grace or deadline/abort)")
        self.evacuated_blocks = registry.counter(
            "drain_evacuated_blocks",
            "Session-retained KV blocks pushed to the remote store by drains")
        self.evacuated_bytes = registry.counter(
            "drain_evacuated_bytes",
            "Bytes of session-retained KV pushed to the remote store by drains")
        self.evacuated_sessions = registry.counter(
            "drain_evacuated_sessions",
            "Retained sessions whose resumable record reached the remote store")
        self.active = registry.gauge(
            "drain_active",
            "1 while this worker is draining, else 0")
        self.aborted = registry.counter(
            "drain_aborted",
            "Drains aborted early (operator second signal) before the "
            "run-down and evacuation phases completed")


_metrics: DrainMetrics | None = None


def get_drain_metrics() -> DrainMetrics:
    global _metrics
    if _metrics is None:
        _metrics = DrainMetrics()
    return _metrics


def install_drain_metrics(registry: MetricsRegistry) -> DrainMetrics:
    """Re-home the singleton into a runtime registry (worker /metrics)."""
    m = get_drain_metrics()
    m.bind(registry)
    return m


@dataclass
class DrainReport:
    """What a drain did — logged, published on the status key, and carried
    in the WORKER_DRAINED stdout line the harness asserts on."""

    state: str = "done"                # done | aborted
    reason: str = ""
    duration_s: float = 0.0
    streams_completed: int = 0
    streams_aborted: int = 0
    evacuated_sessions: int = 0
    evacuated_blocks: int = 0
    evacuated_bytes: int = 0

    def to_dict(self) -> dict:
        return {
            "state": self.state, "reason": self.reason,
            "duration_s": round(self.duration_s, 3),
            "streams_completed": self.streams_completed,
            "streams_aborted": self.streams_aborted,
            "evacuated_sessions": self.evacuated_sessions,
            "evacuated_blocks": self.evacuated_blocks,
            "evacuated_bytes": self.evacuated_bytes,
        }


async def _maybe_await(fn: Callable, *args):
    out = fn(*args)
    if inspect.isawaitable(out):
        return await out
    return out


@dataclass
class WorkerDrainer:
    """Orchestrates one drain. Transport-free: every side effect arrives
    as a callback, so the protocol is unit-testable without a fleet.

    ``deregister`` must leave the lease and data plane ALIVE — only
    membership (readiness, model card, instance keys) goes; ``abort_batch``
    early-stops batch-class streams, ``abort_all`` everything still
    running; both return how many streams they stopped. ``evacuate``
    pushes session KV out and returns
    ``{"sessions": n, "blocks": n, "bytes": n}``.
    """

    inflight: Callable[[], int]
    deregister: Callable[[], Awaitable[None] | None]
    evacuate: Callable[[], "Awaitable[dict] | dict | None"] | None = None
    abort_batch: Callable[[], "Awaitable[int] | int"] | None = None
    abort_all: Callable[[], "Awaitable[int] | int"] | None = None
    abort_event: asyncio.Event | None = None
    deadline_s: float = 30.0
    batch_grace_s: float | None = None  # None = half the deadline
    poll_s: float = 0.05
    _state: str = field(default="idle", init=False)

    @property
    def state(self) -> str:
        return self._state

    async def drain(self, reason: str = "",
                    deadline_s: float | None = None) -> DrainReport:
        m = get_drain_metrics()
        m.active.set(1.0)
        self._state = "draining"
        deadline_total = deadline_s if deadline_s else self.deadline_s
        t0 = time.monotonic()
        deadline = t0 + deadline_total
        grace = self.batch_grace_s
        batch_at = t0 + (grace if grace is not None and grace >= 0
                         else deadline_total / 2)
        rep = DrainReport(reason=reason)
        start_inflight = self.inflight()
        log.info("drain start: reason=%r inflight=%d deadline=%.1fs",
                 reason, start_inflight, deadline_total)
        try:
            await _maybe_await(self.deregister)
        except Exception:
            # Unreachable coordinator mid-partition: membership keys are
            # lease-bound, so exit (lease revoke/expiry) still removes them
            # atomically — keep draining locally rather than half-stopping.
            log.warning("drain deregistration failed (coordinator "
                        "unreachable?); lease expiry will clean up", exc_info=True)

        batch_stopped = False
        while self.inflight() > 0:
            now = time.monotonic()
            if self.abort_event is not None and self.abort_event.is_set():
                rep.state = "aborted"
                break
            if now >= deadline:
                break
            if not batch_stopped and now >= batch_at and self.abort_batch:
                batch_stopped = True
                n = int(await _maybe_await(self.abort_batch) or 0)
                if n:
                    rep.streams_aborted += n
                    log.info("drain batch grace expired: early-stopped %d "
                             "batch-class stream(s)", n)
            await asyncio.sleep(self.poll_s)

        if self.inflight() > 0:
            # Deadline overrun (or operator abort): force-stop what's left.
            # The drain still counts as "done" on overrun — it ran the full
            # protocol, bounded; only the second-signal path is "aborted".
            if rep.state != "aborted":
                log.warning("drain deadline (%.1fs) hit with %d stream(s) "
                            "still in flight; force-stopping",
                            deadline_total, self.inflight())
            if self.abort_all is not None:
                rep.streams_aborted += int(
                    await _maybe_await(self.abort_all) or 0)
        rep.streams_completed = max(
            start_inflight - rep.streams_aborted - self.inflight(), 0)

        if rep.state != "aborted" and self.evacuate is not None:
            # Evacuation gets whatever deadline budget is left, floor 2s —
            # a drain that spent its whole window on streams still gets a
            # bounded chance to save the sessions.
            budget = max(deadline - time.monotonic(), 2.0)
            try:
                evac = await asyncio.wait_for(
                    _maybe_await(self.evacuate), timeout=budget)
                if evac:
                    rep.evacuated_sessions = int(evac.get("sessions", 0))
                    rep.evacuated_blocks = int(evac.get("blocks", 0))
                    rep.evacuated_bytes = int(evac.get("bytes", 0))
            except asyncio.TimeoutError:
                log.warning("session evacuation exceeded its %.1fs budget; "
                            "remaining sessions will recompute", budget)
            except Exception:
                log.warning("session evacuation failed; affected sessions "
                            "will recompute", exc_info=True)

        rep.duration_s = time.monotonic() - t0
        m.duration.observe(rep.duration_s)
        m.streams_completed.inc(rep.streams_completed)
        m.streams_aborted.inc(rep.streams_aborted)
        m.evacuated_sessions.inc(rep.evacuated_sessions)
        m.evacuated_blocks.inc(rep.evacuated_blocks)
        m.evacuated_bytes.inc(rep.evacuated_bytes)
        if rep.state == "aborted":
            m.aborted.inc()
        m.active.set(0.0)
        self._state = rep.state
        log.info("drain %s in %.2fs: %d completed, %d aborted, "
                 "%d session(s) / %d block(s) evacuated",
                 rep.state, rep.duration_s, rep.streams_completed,
                 rep.streams_aborted, rep.evacuated_sessions,
                 rep.evacuated_blocks)
        return rep
