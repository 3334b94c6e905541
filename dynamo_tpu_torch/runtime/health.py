"""Health-check canaries: idle-endpoint payload replay flipping Ready/NotReady.

Fills the role of the reference's endpoint health checks
(reference: lib/runtime/src/health_check.rs:20-36 — ``HealthCheckConfig``
with a canary payload plumbed through serve_endpoint; replayed after an
idle period so a wedged worker is discovered BEFORE a real request times
out on it).

Mechanics here: :class:`EndpointHealthMonitor` wraps an endpoint handler.
Real traffic both proves liveness (every completed request marks the
endpoint Ready) and suppresses canaries (no replay while busy). Once the
endpoint has been idle past ``idle_interval_s``, the canary payload is
driven through the SAME handler the router reaches; a hang/timeout or
exception flips the endpoint NotReady. The state is exported through the
worker's load-metrics stats (``ready``), which the KV router consumes —
a NotReady worker stops receiving traffic without being killed, and
recovers the moment a canary succeeds again.

Copy of ``dynamo_tpu/runtime/health.py``.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

log = get_logger("health")


class HealthMetrics:
    """dynamo_health_canary_{total,failures} (cross-checked by
    tools/lint_metrics.py RECOVERY_METRICS). Singleton + install idiom of
    disagg/metrics.py: workers re-home it into their runtime registry."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.canary_total = registry.counter(
            "health_canary_total",
            "Health-check canary payloads replayed through idle endpoints")
        self.canary_failures = registry.counter(
            "health_canary_failures",
            "Canary replays that failed (endpoint flipped NotReady)")


_metrics: HealthMetrics | None = None


def get_health_metrics() -> HealthMetrics:
    global _metrics
    if _metrics is None:
        _metrics = HealthMetrics()
    return _metrics


def install_health_metrics(registry: MetricsRegistry) -> HealthMetrics:
    m = get_health_metrics()
    m.bind(registry)
    return m


@dataclass
class HealthCheckConfig:
    """Canary settings (reference: health_check.rs HealthCheckConfig)."""

    payload: dict = field(default_factory=dict)
    idle_interval_s: float = 5.0    # replay after this much idle time
    timeout_s: float = 10.0         # canary must finish within this
    # With requests IN FLIGHT, no-progress must exceed this (not the idle
    # interval) before a canary fires: a legitimately long first-token wait
    # (cold compile, long-context prefill) is not a wedge, and a canary
    # queued behind it would time out and flip a healthy worker NotReady.
    busy_grace_s: float = 30.0
    request_id_prefix: str = "health-canary"


class _CanaryContext:
    """Minimal RequestContext stand-in for canary calls. Mirrors the QoS
    surface handlers touch (worker handlers stamp ``deadline_ts`` and poll
    ``is_expired``) so a canary replay can't AttributeError a healthy
    worker into NotReady."""

    deadline_ts: float | None = None

    def is_expired(self) -> bool:
        return self.deadline_ts is not None and time.time() >= self.deadline_ts

    def is_cancelled(self) -> bool:
        return self.is_expired()


class EndpointHealthMonitor:
    """Wraps a handler; tracks activity; replays a canary when idle."""

    def __init__(self, handler: Callable[[Any, Any], AsyncIterator],
                 config: HealthCheckConfig):
        self._handler = handler
        self.config = config
        self.ready = True
        self._last_activity = time.monotonic()
        self._inflight = 0
        self._task: asyncio.Task | None = None
        self._seq = 0

    # -- the wrapped handler served on the endpoint ------------------------
    async def handler(self, payload: Any, ctx: Any) -> AsyncIterator:
        self._inflight += 1
        self._last_activity = time.monotonic()
        try:
            async for item in self._handler(payload, ctx):
                self._last_activity = time.monotonic()
                yield item
            # A completed real request is the strongest health signal.
            self.ready = True
        finally:
            self._inflight -= 1
            self._last_activity = time.monotonic()

    # -- canary loop -------------------------------------------------------
    def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(max(self.config.idle_interval_s / 4, 0.05))
            # Idle means "no PROGRESS", not "no requests": a stream yielding
            # tokens keeps _last_activity fresh and suppresses canaries, but
            # in-flight requests that stopped progressing (engine wedged
            # mid-stream — the common production failure) must NOT suppress
            # them, or the wedge goes undetected until a client times out.
            idle = time.monotonic() - self._last_activity
            threshold = (self.config.busy_grace_s if self._inflight > 0
                         else self.config.idle_interval_s)
            if idle < threshold:
                continue
            await self._run_canary()

    async def _run_canary(self) -> None:
        self._seq += 1
        rid = f"{self.config.request_id_prefix}-{self._seq}"
        payload = dict(self.config.payload)
        payload.setdefault("request_id", rid)

        async def drive() -> None:
            async for _ in self._handler(payload, _CanaryContext()):
                pass

        get_health_metrics().canary_total.inc()
        try:
            await asyncio.wait_for(drive(), self.config.timeout_s)
        except Exception as exc:
            get_health_metrics().canary_failures.inc()
            if self.ready:
                log.warning("canary %s failed (%s: %s): endpoint NotReady",
                            rid, type(exc).__name__, exc)
            self.ready = False
            return
        finally:
            # Success or failure, the canary counts as activity: the next
            # replay waits a full idle interval (a fast-FAILING handler must
            # not trigger a canary storm against an unhealthy engine).
            self._last_activity = time.monotonic()
        if not self.ready:
            log.info("canary %s succeeded: endpoint Ready again", rid)
        self.ready = True


def default_canary_payload(max_tokens: int = 1) -> dict:
    """A minimal generate-shaped payload every engine handler accepts
    (reference pattern: the vllm worker's health-check payload,
    components/src/dynamo/vllm/health_check.py)."""
    return {
        "token_ids": [1, 2, 3],
        "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
        "sampling_options": {"temperature": 0.0},
    }
