"""Worker-side publishers: KV cache events + load metrics.

Fills the role of the reference's KvEventPublisher / WorkerMetricsPublisher
(reference: lib/llm/src/kv_router/publisher.rs:92 KvEventPublisher, :686
WorkerMetricsPublisher; subjects kv_router.rs:57-74): the engine's event
sink batches BlockStored/BlockRemoved into coordinator pub/sub messages;
ForwardPassMetrics-equivalent engine stats publish periodically.

Copy of ``dynamo_tpu/router/publisher.py`` over the port's codec.
"""

from __future__ import annotations

import asyncio
import itertools

from dynamo_tpu_torch.utils import msgpack

from dynamo_tpu_torch.router.events import KvCacheEvent, RouterEvent
from dynamo_tpu_torch.transports.client import CoordinatorClient
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("router.publisher")


def kv_events_subject(namespace: str, component: str) -> str:
    return f"kv_events.{namespace}.{component}"


def load_metrics_subject(namespace: str, component: str) -> str:
    return f"load_metrics.{namespace}.{component}"


class KvEventPublisher:
    """Thread-safe sink for engine KV events; batches and publishes.

    The engine core calls ``sink(event)`` from its step thread; a background
    asyncio task drains and publishes batches.
    """

    def __init__(self, client: CoordinatorClient, namespace: str, component: str,
                 worker_id: int, flush_interval_s: float = 0.05):
        self.client = client
        self.subject = kv_events_subject(namespace, component)
        self.worker_id = worker_id
        self.flush_interval_s = flush_interval_s
        self._event_ids = itertools.count(1)
        self._buffer: list[RouterEvent] = []
        self._loop = asyncio.get_event_loop()
        self._task: asyncio.Task | None = None
        self._stopped = False

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._flush_loop())

    def sink(self, event: KvCacheEvent) -> None:
        """Engine-thread-safe event entry point."""
        rev = RouterEvent(worker_id=self.worker_id, event=event,
                          event_id=next(self._event_ids))
        self._loop.call_soon_threadsafe(self._buffer.append, rev)

    async def _flush_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.flush_interval_s)
            await self.flush()

    async def flush(self) -> None:
        if not self._buffer:
            return
        batch, self._buffer = self._buffer, []
        payload = msgpack.packb([e.to_dict() for e in batch])
        try:
            await self.client.publish(self.subject, payload)
        except asyncio.CancelledError:
            # Re-queue the detached batch so stop()'s final flush sends it —
            # cancellation mid-publish must not lose BlockStored/Removed
            # events (routers would keep stale index entries).
            self._buffer = batch + self._buffer
            raise
        except Exception:
            log.exception("kv event publish failed (%d events dropped)", len(batch))

    async def stop(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await self.flush()


class WorkerMetricsPublisher:
    """Periodic engine-stats publisher (ForwardPassMetrics role)."""

    def __init__(self, client: CoordinatorClient, namespace: str, component: str,
                 worker_id: int, stats_fn, interval_s: float = 0.25):
        self.client = client
        self.subject = load_metrics_subject(namespace, component)
        self.worker_id = worker_id
        self.stats_fn = stats_fn
        self.interval_s = interval_s
        self._task: asyncio.Task | None = None
        self._stopped = False

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def _loop(self) -> None:
        while not self._stopped:
            await self.publish_once()
            await asyncio.sleep(self.interval_s)

    async def publish_once(self) -> None:
        """One immediate publish. The drain path calls this after the
        engine empties so the retired worker's LAST snapshot in aggregate
        views (/engine_stats) shows it idle, not frozen mid-load."""
        try:
            stats = dict(self.stats_fn())
            stats["worker_id"] = self.worker_id
            await self.client.publish(
                self.subject, msgpack.packb(stats))
        except Exception:
            log.exception("metrics publish failed")

    async def stop(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
