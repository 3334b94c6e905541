"""DistributedRuntime: process node handle + component model + endpoint serving.

Fills the role of the reference's runtime core
(reference: lib/runtime/src/lib.rs DistributedRuntime, component.rs
Namespace→Component→Endpoint, component/endpoint.rs serve_endpoint,
ingress/push_endpoint.rs):

- One coordinator connection, one primary lease (liveness: lease drop ⇒
  instances vanish ⇒ clients re-route), one data-plane TCP server per
  process serving all endpoints.
- ``serve_endpoint(handler)`` registers the instance in the coordinator KV
  and dispatches incoming CALL frames to the handler — an async generator
  ``handler(request: dict, ctx) -> yields response dicts`` streamed back as
  DATA/END/ERR frames. Cancellation arrives as a CANCEL frame and cancels
  the handler task (graceful drain on shutdown).

Unlike the reference there is no broker hop: callers dial the instance's
advertised address directly (the reference's NATS-push + TCP-callback pair
collapses into one duplex connection — fewer hops, same semantics).

Copy of ``dynamo_tpu/runtime/runtime.py``.
"""

from __future__ import annotations

import asyncio
import os
import random
import socket
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.transports.client import CoordinatorClient, Lease
from dynamo_tpu_torch.transports.wire import Frame, MsgpackConnection
from dynamo_tpu_torch.runtime.protocols import EndpointId, Instance, MetricsTarget
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

log = get_logger("runtime")

# handler(request, context) -> async iterator of response payloads
Handler = Callable[[dict, "RequestContext"], AsyncIterator[Any]]


@dataclass
class RequestContext:
    """Per-request context (reference: pipeline/context.rs Context)."""

    request_id: str
    endpoint: str
    cancelled: asyncio.Event = field(default_factory=asyncio.Event)
    trace_headers: dict[str, str] = field(default_factory=dict)
    # QoS: absolute wall-clock deadline (epoch seconds). An expired deadline
    # reads as cancellation so every per-output `is_cancelled()` check in
    # worker/router handlers doubles as mid-stream deadline enforcement.
    deadline_ts: float | None = None

    def is_expired(self) -> bool:
        return self.deadline_ts is not None and time.time() >= self.deadline_ts

    def is_cancelled(self) -> bool:
        return self.cancelled.is_set() or self.is_expired()


@dataclass
class _Served:
    endpoint: EndpointId
    handler: Handler
    instance: Instance


class DistributedRuntime:
    """Node handle: coordinator client + lease + data-plane server."""

    def __init__(self, config: RuntimeConfig | None = None):
        self.config = config or RuntimeConfig.from_settings()
        self.client: CoordinatorClient | None = None
        self.primary_lease: Lease | None = None
        self.instance_id: int = (int(time.time() * 1000) << 16) | (os.getpid() & 0xFFFF)
        self.metrics = MetricsRegistry()
        self._served: dict[str, _Served] = {}   # "ns.comp.ep" -> served
        self._server: asyncio.Server | None = None
        self._advertise_host = "127.0.0.1"
        self.data_port: int = 0
        self._inflight = self.metrics.gauge("runtime_inflight_requests", "in-flight handler streams")
        # Structured ownership of every background coroutine this node runs
        # (reference: utils/tasks/tracker.rs): handler streams live in a
        # bounded child; components hang their own children off `tasks`.
        from dynamo_tpu_torch.runtime.tasks import TaskTracker

        self.tasks = TaskTracker(name=f"rt{os.getpid()}")
        self._streams = self.tasks.child(
            "streams", max_concurrency=self.config.max_handler_streams)
        self._draining = False
        self._reconnect_hooks: list = []
        self._metrics_targets: dict[str, MetricsTarget] = {}
        # Per-process system status server (reference:
        # system_status_server.rs), env-gated DYN_SYSTEM_ENABLED/PORT.
        self.status_server = None

    # ------------------------------------------------------------------
    @classmethod
    async def create(cls, config: RuntimeConfig | None = None) -> "DistributedRuntime":
        rt = cls(config)
        rt.client = await CoordinatorClient.connect(
            rt.config.coordinator_url, auto_reconnect=True)
        rt.client.on_reconnected.append(rt._restore_registrations)
        rt.primary_lease = await rt.client.lease_grant(ttl=rt.config.lease_ttl_s)
        # Lease death WITHOUT a connection outage (keepalive starvation /
        # expiry storm) also means every lease-bound key is gone — recover
        # through the same re-declaration path as a reconnect.
        rt.primary_lease.on_lost = rt._restore_registrations
        # Coordinator lease ids are server-unique — mixing one in makes
        # instance ids collision-free even for runtimes created in the same
        # millisecond in the same process.
        rt.instance_id = (int(time.time() * 1000) << 20) | (rt.primary_lease.id & 0xFFFFF)
        rt._server = await asyncio.start_server(rt._on_conn, "0.0.0.0", 0)
        rt.data_port = rt._server.sockets[0].getsockname()[1]
        rt._advertise_host = os.environ.get("DYN_ADVERTISE_HOST", "127.0.0.1")
        if rt.config.system_enabled:
            from dynamo_tpu_torch.runtime.status import SystemStatusServer

            rt.status_server = SystemStatusServer(rt.metrics, rt.config.system_port)
            await rt.status_server.start()
        return rt

    @property
    def inflight_streams(self) -> int:
        """Handler streams currently running (drain run-down watches this)."""
        return self._streams.active

    async def deregister(self, timeout: float = 3.0) -> None:
        """Membership out, lease and data plane STAY ALIVE: readiness goes
        NotReady, new streams are refused (clients re-route via Migration),
        and the endpoint instance + metrics-target keys are deleted so
        routers stop picking this worker — while in-flight streams keep
        their open connections. The drain protocol's step 2
        (runtime/drain.py); ``shutdown()`` later revokes the lease, which
        also sweeps these keys if the coordinator was unreachable here."""
        self._draining = True
        if self.status_server is not None:
            self.status_server.ready = False
        if self.client is None:
            return
        keys = [s.endpoint.instance_key(self.instance_id)
                for s in self._served.values()]
        keys += list(self._metrics_targets)
        for key in keys:
            try:
                # Bounded per-key: a partitioned coordinator must not eat
                # the drain window — lease expiry deletes these anyway.
                await asyncio.wait_for(self.client.delete(key), timeout)
            except Exception:
                log.warning("deregister: could not delete %s "
                            "(lease expiry will)", key)

    async def shutdown(self) -> None:
        """Graceful: deregister instances, drain in-flight, drop lease."""
        self._draining = True
        if self.status_server is not None:
            # NotReady (503) during the drain window — but keep SERVING
            # probes until the drain completes, else a kubelet reads
            # connection-refused as dead and SIGKILLs mid-drain.
            self.status_server.ready = False
        if self.client:
            for served in self._served.values():
                try:
                    await asyncio.wait_for(self.client.delete(
                        served.endpoint.instance_key(self.instance_id)), 3.0)
                except Exception:
                    # Partitioned coordinator: the lease sweep below (or its
                    # TTL expiry server-side) removes the key regardless.
                    log.warning("shutdown: instance deregistration skipped "
                                "(coordinator unreachable)")
        deadline = time.monotonic() + self.config.drain_timeout_s
        while self._streams.active and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        # Bounded teardown: drain_timeout_s caps the WHOLE shutdown — a
        # handler wedged past cancellation is abandoned, not waited on.
        await self.tasks.close(
            timeout=max(deadline - time.monotonic(), 1.0))
        if self.status_server is not None:
            await self.status_server.stop()
        if self.primary_lease and self.client:
            try:
                # Partition-safe: an unreachable coordinator must not wedge
                # process exit — the lease TTL expires server-side instead.
                await asyncio.wait_for(
                    self.primary_lease.revoke(self.client), 3.0)
            except Exception:
                log.warning("lease revoke skipped (coordinator unreachable);"
                            " TTL expiry will reclaim it")
        if self._server:
            self._server.close()
        if self.client:
            await self.client.close()

    async def _restore_registrations(self) -> None:
        """After a coordinator reconnect (possibly a RESTARTED coordinator
        with empty state): leases are gone — grant a fresh primary lease and
        re-put every served instance under it (same instance_id: identity is
        stable across outages), then run component-level hooks (model cards
        etc.). The reference gets this durability from etcd itself; our
        built-in coordinator gets it from clients re-declaring their state."""
        assert self.client is not None
        if self.primary_lease is not None:
            # Client-side-only blip (coordinator survived, lease TTL not yet
            # expired): the lease AND every key bound to it are intact —
            # reuse it (revoking would broadcast deletes and churn every
            # frontend's pipelines for nothing). Just restart the keepalive,
            # whose loop died with the old connection. Gated on epoch
            # continuity: a RESTARTED coordinator re-mints lease ids from 1,
            # so a bare keepalive probe could "renew" a DIFFERENT client's
            # lease and skip re-declaration entirely.
            try:
                alive = (not self.client.epoch_changed
                         and (await self.client._request(
                             {"op": "lease_keepalive",
                              "lease_id": self.primary_lease.id})).get("alive"))
            except Exception:
                alive = False
            if alive:
                if self.primary_lease._task:
                    self.primary_lease._task.cancel()
                self.primary_lease._task = asyncio.create_task(
                    self.client._keepalive_loop(self.primary_lease))
                log.info("coordinator blip: primary lease %d survived; "
                         "registrations intact", self.primary_lease.id)
                return
            # Lease is gone (expired, or the coordinator restarted): stop
            # the orphaned keepalive and re-declare everything fresh. When
            # on_lost delivered us FROM that keepalive task, cancelling it
            # would abort this very restore mid-flight (new lease granted but
            # never re-put, never kept alive) — the loop returns on its own
            # after the callback, so only cancel a foreign task.
            if (self.primary_lease._task is not None
                    and self.primary_lease._task is not asyncio.current_task()):
                self.primary_lease._task.cancel()
        self.primary_lease = await self.client.lease_grant(
            ttl=self.config.lease_ttl_s)
        self.primary_lease.on_lost = self._restore_registrations
        import dataclasses as _dc

        for served in self._served.values():
            served.instance = _dc.replace(
                served.instance, lease_id=self.primary_lease.id)
            await self.client.put(
                served.endpoint.instance_key(self.instance_id),
                served.instance.to_bytes(),
                lease_id=self.primary_lease.id)
        for target in self._metrics_targets.values():
            await self.client.put(target.key, target.to_bytes(),
                                  lease_id=self.primary_lease.id)
        log.info("re-registered %d endpoint(s) after coordinator reconnect",
                 len(self._served))
        for hook in list(self._reconnect_hooks):
            try:
                await hook()
            except Exception:
                log.exception("reconnect hook failed")

    def on_reconnect(self, hook) -> None:
        """Register an async callback run after coordinator reconnection +
        instance re-registration (components re-put model cards here)."""
        self._reconnect_hooks.append(hook)

    async def advertise_metrics(self, role: str, url: str | None = None) -> "MetricsTarget | None":
        """Publish this process's /metrics URL under METRICS_PREFIX, bound
        to the primary lease, so the fleet aggregator discovers it without
        static target lists. ``url=None`` advertises the status server (a
        no-op when DYN_SYSTEM_ENABLED is off — nothing to scrape)."""
        assert self.client and self.primary_lease
        if url is None:
            if self.status_server is None:
                return None
            url = f"http://{self._advertise_host}:{self.status_server.port}"
        target = MetricsTarget(role=role, instance_id=self.instance_id,
                               url=url, namespace=self.config.namespace)
        self._metrics_targets[target.key] = target
        await self.client.put(target.key, target.to_bytes(),
                              lease_id=self.primary_lease.id)
        log.info("advertised %s metrics target %s", role, url)
        return target

    @property
    def advertise_address(self) -> str:
        """The 'host:port' other processes dial to reach this node's data
        plane (what Instance.address is built from)."""
        return f"{self._advertise_host}:{self.data_port}"

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)

    # ------------------------------------------------------------------
    async def _register(self, endpoint: EndpointId, handler: Handler) -> Instance:
        assert self.client and self.primary_lease
        inst = Instance(
            endpoint=endpoint,
            instance_id=self.instance_id,
            address=f"{self._advertise_host}:{self.data_port}",
            lease_id=self.primary_lease.id,
        )
        key = str(endpoint)[len("dyn://"):]
        self._served[key] = _Served(endpoint=endpoint, handler=handler, instance=inst)
        await self.client.put(
            endpoint.instance_key(self.instance_id), inst.to_bytes(),
            lease_id=self.primary_lease.id)
        log.info("serving %s instance=%x at %s", endpoint, self.instance_id, inst.address)
        return inst

    # ------------------------------------------------------------------
    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = MsgpackConnection(reader, writer)
        streams: dict[int, asyncio.Task] = {}
        try:
            while True:
                msg = await conn.recv()
                if msg is None:
                    break
                t = msg.get("t")
                if t == Frame.PING:
                    await conn.send({"t": Frame.PONG})
                elif t == Frame.CALL:
                    sid = msg["stream_id"]
                    try:
                        task = self._streams.spawn(
                            self._run_stream, conn, sid, msg,
                            name=f"stream-{msg.get('endpoint', '?')}-{sid}")
                    except RuntimeError:
                        # Tracker already closed (shutdown race): refuse THIS
                        # stream, keep the multiplexed connection alive for
                        # its in-flight siblings.
                        await conn.send({"t": Frame.ERR, "stream_id": sid,
                                         "error": "shutting down"})
                        continue
                    streams[sid] = task
                    task.add_done_callback(
                        lambda t_, sid=sid: streams.pop(sid, None))
                elif t == Frame.CANCEL:
                    task = streams.get(msg.get("stream_id"))
                    if task:
                        task.cancel()
        finally:
            for task in streams.values():
                task.cancel()
            conn.close()

    async def _run_stream(self, conn: MsgpackConnection, sid: int, msg: dict) -> None:
        target = msg.get("endpoint", "")
        served = self._served.get(target)
        if served is None or self._draining:
            await conn.send({"t": Frame.ERR, "stream_id": sid,
                             "error": f"no such endpoint {target!r}"})
            return
        ctx = RequestContext(
            request_id=msg.get("request_id", ""),
            endpoint=target,
            trace_headers=msg.get("headers") or {},
        )
        try:
            # Deadline propagation for generic endpoints: LLM requests carry
            # it in payload annotations (the worker handler re-stamps ctx),
            # anything else can use this wire header.
            hdr = ctx.trace_headers.get("x-deadline-ts")
            if hdr is not None:
                ctx.deadline_ts = float(hdr)
        except (TypeError, ValueError):
            pass
        self._inflight.inc(endpoint=target)
        try:
            async for item in served.handler(msg.get("payload"), ctx):
                await conn.send({"t": Frame.DATA, "stream_id": sid, "payload": item})
            await conn.send({"t": Frame.END, "stream_id": sid})
        except asyncio.CancelledError:
            ctx.cancelled.set()
            try:
                await conn.send({"t": Frame.END, "stream_id": sid, "cancelled": True})
            except Exception:
                pass
        except Exception as exc:
            log.exception("handler error endpoint=%s", target)
            try:
                await conn.send({"t": Frame.ERR, "stream_id": sid, "error": str(exc)})
            except Exception:
                pass
        finally:
            self._inflight.inc(-1, endpoint=target)


@dataclass
class Namespace:
    runtime: DistributedRuntime
    name: str

    def component(self, name: str) -> "Component":
        return Component(self.runtime, self.name, name)


@dataclass
class Component:
    runtime: DistributedRuntime
    namespace: str
    name: str

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.runtime, EndpointId(self.namespace, self.name, name))


@dataclass
class Endpoint:
    runtime: DistributedRuntime
    id: EndpointId

    async def serve(self, handler: Handler) -> Instance:
        """Register and serve this endpoint (reference: serve_endpoint)."""
        return await self.runtime._register(self.id, handler)

    async def client(self) -> "EndpointClient":
        from dynamo_tpu_torch.runtime.client import EndpointClient

        return await EndpointClient.create(self.runtime, self.id)
