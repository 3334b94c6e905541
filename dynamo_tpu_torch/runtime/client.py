"""Endpoint client: discovery-watching instance source + push router.

Fills the role of the reference's Client/InstanceSource + PushRouter
(reference: lib/runtime/src/component/client.rs InstanceSource;
pipeline/network/egress/push_router.rs Random/RoundRobin/Direct/KV modes
with busy-threshold): a prefix watch keeps the live instance set current
(lease expiry ⇒ DELETE event ⇒ instance drops out), and ``generate`` opens
a response stream over a pooled duplex connection straight to the chosen
worker.

Copy of ``dynamo_tpu/runtime/client.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, AsyncIterator

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.runtime.protocols import EndpointId, Instance
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
from dynamo_tpu_torch.transports.wire import Frame, MsgpackConnection
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("runtime.client")


class RouterMode(str, Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    KV = "kv"


class NoInstancesError(RuntimeError):
    pass


class StreamError(RuntimeError):
    """A response stream broke (worker ERR frame or lost connection).

    Carries the ``instance_id`` that was serving the stream (when known) so
    recovery layers can act on the FAILING worker — Migration quarantines
    it before re-dispatch instead of racing the lease-expiry watch and
    re-picking the same dead instance."""

    def __init__(self, message: str = "stream error",
                 instance_id: int | None = None):
        super().__init__(message)
        self.instance_id = instance_id


class _WorkerConnection:
    """Multiplexed duplex connection to one worker address."""

    def __init__(self, conn: MsgpackConnection):
        self.conn = conn
        self._ids = itertools.count(1)
        self._streams: dict[int, asyncio.Queue] = {}
        self._reader = asyncio.create_task(self._read_loop())
        self.alive = True
        self._closing = False

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await self.conn.recv()
                if msg is None:
                    break
                q = self._streams.get(msg.get("stream_id"))
                if q is not None:
                    q.put_nowait(msg)
        except Exception as exc:  # corrupt frame, unpack error, socket error
            log.warning("worker connection reader failed: %s", exc)
        finally:
            # Always mark dead + poison in-flight streams so no caller blocks
            # forever and _connect() dials a fresh connection next time.
            self.alive = False
            self.conn.close()
            for q in self._streams.values():
                q.put_nowait({"t": Frame.ERR, "error": "connection lost"})

    async def call(self, endpoint: str, payload: Any, request_id: str,
                   headers: dict | None = None) -> AsyncIterator[Any]:
        await chaos.ainject("runtime.client.call", endpoint=endpoint)
        if self._closing:
            raise StreamError("connection closing")
        sid = next(self._ids)
        q: asyncio.Queue = asyncio.Queue()
        self._streams[sid] = q
        await self.conn.send({
            "t": Frame.CALL, "stream_id": sid, "endpoint": endpoint,
            "request_id": request_id, "payload": payload, "headers": headers or {},
        })
        try:
            while True:
                msg = await q.get()
                t = msg.get("t")
                if t == Frame.DATA:
                    yield msg.get("payload")
                elif t == Frame.END:
                    return
                elif t == Frame.ERR:
                    raise StreamError(msg.get("error", "stream error"))
        finally:
            self._streams.pop(sid, None)
            if self.alive:
                try:
                    await self.conn.send({"t": Frame.CANCEL, "stream_id": sid})
                except Exception:
                    pass
            if self._closing and not self._streams:
                self.close()

    def close(self) -> None:
        self._reader.cancel()
        self.conn.close()

    def close_when_idle(self) -> None:
        """Refuse new streams and close once in-flight ones end. A model
        being unregistered (its last worker deregistered to drain) must not
        cut responses already streaming — the draining worker keeps its
        lease and data plane alive precisely so they can finish."""
        self._closing = True
        if not self._streams:
            self.close()


class EndpointClient:
    """Watches instances of one endpoint and routes requests to them."""

    def __init__(self, runtime: DistributedRuntime, endpoint: EndpointId):
        self.runtime = runtime
        self.endpoint = endpoint
        self.instances: dict[int, Instance] = {}
        self._conns: dict[str, _WorkerConnection] = {}
        self._watch_task: asyncio.Task | None = None
        # instance_id -> monotonic time until which it is skipped (connect
        # failures quarantine an instance until its lease expires or it
        # re-registers — avoids burning retries on a dead address)
        self._quarantine: dict[int, float] = {}

    @classmethod
    async def create(cls, runtime: DistributedRuntime, endpoint: EndpointId) -> "EndpointClient":
        self = cls(runtime, endpoint)
        assert runtime.client is not None
        watch = await runtime.client.watch_prefix(endpoint.instance_prefix)
        self._watch_task = asyncio.create_task(self._watch_loop(watch))
        return self

    async def _watch_loop(self, watch) -> None:
        async for ev in watch:
            if ev.op == "reset":
                # coordinator reconnect: the replay that follows is the
                # complete truth — instances that died during the outage
                # would otherwise linger forever
                if self.instances:
                    log.info("instance set for %s reset on reconnect (%d dropped)",
                             self.endpoint, len(self.instances))
                self.instances.clear()
            elif ev.op == "put" and ev.value:
                inst = Instance.from_bytes(ev.value)
                self.instances[inst.instance_id] = inst
                self._quarantine.pop(inst.instance_id, None)
            elif ev.op == "delete":
                iid = int(ev.key.rsplit("/", 1)[-1], 16)
                inst = self.instances.pop(iid, None)
                if inst is not None:
                    log.info("instance %x of %s vanished", iid, self.endpoint)
        log.warning("instance watch for %s ended (coordinator lost)", self.endpoint)

    async def wait_for_instances(self, timeout: float = 10.0) -> None:
        """Wait until at least one non-quarantined instance is known."""
        deadline = asyncio.get_running_loop().time() + timeout
        while not self.instance_ids():
            if asyncio.get_running_loop().time() >= deadline:
                raise asyncio.TimeoutError(f"no live instances for {self.endpoint}")
            await asyncio.sleep(0.05)

    def instance_ids(self) -> list[int]:
        now = asyncio.get_event_loop().time()
        return sorted(i for i in self.instances if self._quarantine.get(i, 0.0) <= now)

    def known_instance_ids(self) -> list[int]:
        """All registered instances, including quarantined ones. Use for
        liveness decisions (a quarantined instance is still discovered —
        only a lease expiry actually removes it)."""
        return sorted(self.instances)

    def quarantine(self, instance_id: int, duration_s: float = 10.0) -> None:
        """Skip ``instance_id`` in routing for ``duration_s`` (or until it
        re-registers, whichever comes first). Called on connect failures and
        by Migration when a stream dies on a specific worker — routing away
        immediately instead of racing the lease-expiry watch."""
        self._quarantine[instance_id] = (
            asyncio.get_event_loop().time() + duration_s)
        log.info("instance %x quarantined for %.1fs", instance_id, duration_s)

    # ------------------------------------------------------------------
    async def _connect(self, inst: Instance) -> _WorkerConnection:
        await chaos.ainject("runtime.client.connect", address=inst.address)
        wc = self._conns.get(inst.address)
        if wc is not None and wc.alive:
            return wc
        host, _, port = inst.address.rpartition(":")
        wc = _WorkerConnection(await MsgpackConnection.connect(host, int(port)))
        self._conns[inst.address] = wc
        return wc

    async def generate_direct(self, payload: Any, instance_id: int,
                              request_id: str | None = None) -> AsyncIterator[Any]:
        inst = self.instances.get(instance_id)
        if inst is None:
            raise NoInstancesError(f"instance {instance_id:x} not found for {self.endpoint}")
        try:
            wc = await self._connect(inst)
        except OSError:
            self.quarantine(instance_id)
            log.info("instance %x unreachable", instance_id)
            raise
        target = f"{self.endpoint.namespace}.{self.endpoint.component}.{self.endpoint.endpoint}"
        try:
            async for item in wc.call(target, payload, request_id or uuid.uuid4().hex):
                yield item
        except StreamError as exc:
            # Stamp the failing worker so recovery (Migration) can act on
            # it; wire-level ERR frames can't know their own instance.
            if exc.instance_id is None:
                exc.instance_id = instance_id
            raise

    async def close(self, graceful: bool = True) -> None:
        """Stop watching and release connections. Graceful (default) lets
        each connection's in-flight streams run to completion before it
        closes; ``graceful=False`` cuts them immediately (poisoning their
        queues with a connection-lost ERR)."""
        if self._watch_task:
            self._watch_task.cancel()
        for wc in self._conns.values():
            if graceful:
                wc.close_when_idle()
            else:
                wc.close()


@dataclass
class PushRouter:
    """Instance selection policies over an EndpointClient
    (reference: push_router.rs RouterMode + busy-threshold fallback).
    KV mode lives in dynamo_tpu_torch.router.KvPushRouter."""

    client: EndpointClient
    mode: RouterMode = RouterMode.ROUND_ROBIN
    _rr: "itertools.count" = field(default_factory=itertools.count)

    def _pick(self) -> int:
        ids = self.client.instance_ids()
        if not ids:
            raise NoInstancesError(f"no instances for {self.client.endpoint}")
        if self.mode is RouterMode.RANDOM:
            return random.choice(ids)
        return ids[next(self._rr) % len(ids)]

    def pick(self) -> int:
        """Resolve the instance this policy would dispatch to NOW. Callers
        that need the id *before* streaming (so recovery layers can
        attribute a silent truncation to the serving worker) pick here and
        pass it to generate() explicitly."""
        return self._pick()

    async def generate(self, payload: Any, request_id: str | None = None,
                       instance_id: int | None = None) -> AsyncIterator[Any]:
        if instance_id is None:
            if self.mode is RouterMode.DIRECT:
                raise ValueError("RouterMode.DIRECT requires an explicit instance_id")
            instance_id = self._pick()
        async for item in self.client.generate_direct(payload, instance_id, request_id):
            yield item
