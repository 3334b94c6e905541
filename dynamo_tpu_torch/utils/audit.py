"""Audit bus: broadcast of full request/response records to pluggable sinks.

Fills the role of the reference's audit subsystem
(reference: lib/llm/src/audit/bus.rs:8-23 — a process-wide broadcast
channel of AuditRecord; handle.rs:13-30 — the per-request handle that
captures the full chat request and final response; sinks subscribe for
logging/compliance).

Here: an asyncio fan-out bus with bounded per-subscriber queues
(slow sinks drop oldest, never block serving), a module-level default bus
mirroring the reference's OnceLock pattern, and a JSONL sink. The HTTP
frontend publishes a record per chat completion when auditing is enabled
(``DYN_AUDIT_JSONL=/path`` or programmatic ``init``).

Copy of ``dynamo_tpu/utils/audit.py``.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any, AsyncIterator

from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("audit")

SCHEMA_VERSION = 1


@dataclass
class AuditRecord:
    """(reference: audit/handle.rs AuditRecord)"""

    request_id: str
    model: str
    requested_streaming: bool = False
    schema_version: int = SCHEMA_VERSION
    timestamp: float = field(default_factory=time.time)
    request: dict[str, Any] | None = None
    response: dict[str, Any] | None = None
    error: str | None = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=str)


class AuditBus:
    """Fan-out of records to bounded subscriber queues (drop-oldest)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._subs: list[asyncio.Queue] = []
        self.published = 0
        self.dropped = 0

    def publish(self, rec: AuditRecord) -> None:
        self.published += 1
        for q in self._subs:
            if q.full():
                # Never block the serving path on a slow sink.
                try:
                    q.get_nowait()
                    self.dropped += 1
                except asyncio.QueueEmpty:
                    pass
            q.put_nowait(rec)

    def subscribe(self) -> "AuditSubscription":
        q: asyncio.Queue = asyncio.Queue(self.capacity)
        self._subs.append(q)
        return AuditSubscription(self, q)

    def _unsubscribe(self, q: asyncio.Queue) -> None:
        if q in self._subs:
            self._subs.remove(q)


class AuditSubscription:
    def __init__(self, bus: AuditBus, q: asyncio.Queue):
        self._bus = bus
        self._q = q

    def __aiter__(self) -> AsyncIterator[AuditRecord]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[AuditRecord]:
        while True:
            yield await self._q.get()

    def cancel(self) -> None:
        self._bus._unsubscribe(self._q)


class JsonlAuditSink:
    """Appends every record as one JSON line (the compliance-log sink)."""

    def __init__(self, bus: AuditBus, path: str):
        self.path = path
        self._sub = bus.subscribe()
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def _loop(self) -> None:
        import asyncio as _asyncio

        loop = _asyncio.get_running_loop()
        try:
            with open(self.path, "a") as f:
                async for rec in self._sub:
                    line = rec.to_json() + "\n"
                    # Disk writes off-loop: a slow/full filesystem must not
                    # stall the serving event loop this sink shares.
                    await loop.run_in_executor(
                        None, lambda: (f.write(line), f.flush()))
        except _asyncio.CancelledError:
            raise
        except Exception:
            # A dead compliance sink must be LOUD — records keep dropping
            # into this subscriber's queue while the operator believes
            # auditing is on.
            log.exception("audit JSONL sink died (%s); records are NOT "
                          "being persisted", self.path)

    async def stop(self) -> None:
        self._sub.cancel()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass


# -- module-level default bus (reference: bus.rs OnceLock BUS) --------------
_BUS: AuditBus | None = None
_SINK: JsonlAuditSink | None = None


def init(capacity: int = 256, jsonl_path: str | None = None) -> AuditBus:
    global _BUS, _SINK
    if _BUS is None:
        _BUS = AuditBus(capacity)
    if jsonl_path and _SINK is None:
        _SINK = JsonlAuditSink(_BUS, jsonl_path)
        _SINK.start()
        log.info("audit JSONL sink: %s", jsonl_path)
    return _BUS


def maybe_init_from_env() -> AuditBus | None:
    """Enable auditing when DYN_AUDIT_JSONL names a sink path."""
    import os

    path = os.environ.get("DYN_AUDIT_JSONL")
    if path:
        return init(jsonl_path=path)
    return _BUS


def bus() -> AuditBus | None:
    return _BUS


def publish(rec: AuditRecord) -> None:
    if _BUS is not None:
        _BUS.publish(rec)
