"""The coordination service: KV + leases + prefix watches + pub/sub.

Consolidates the roles the reference splits between etcd (discovery, leases,
model cards, barriers — reference: lib/runtime/src/transports/etcd.rs) and
NATS (KV events stream, router-replica sync, snapshot store — reference:
transports/nats.rs) into ONE built-in service with no external dependency.
The request/response data plane does NOT go through here — workers are
dialed directly (see runtime/).

Semantics:
- ``put(key, value, lease_id=0)``: value bytes; key dies with its lease.
- ``create(key, value, lease)``: succeeds only if absent (kv_create_or_validate
  pattern for barriers/locks).
- ``get_prefix(prefix)`` / ``watch_prefix(prefix)``: watches push PUT/DELETE
  events; a new watch first replays current state marked ``initial=True``.
- ``lease_grant(ttl)`` / ``lease_keepalive(id)``: expiry deletes attached
  keys and emits DELETE events (instance-vanishes-on-death, like etcd).
- ``publish(subject, payload)`` / ``subscribe(subject)``: fan-out pub/sub
  with per-subscriber buffering; subjects support trailing ``*`` wildcard.
- ``queue_push(name, item)`` / ``queue_pop(name)``: shared work queue
  (the NATS work-queue role for the disagg prefill queue).

Copy of ``dynamo_tpu/transports/coordinator.py``.
"""

from __future__ import annotations

import asyncio
import fnmatch
import time
import uuid
from dataclasses import dataclass, field

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.transports.wire import Frame, MsgpackConnection
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("coordinator")


@dataclass
class _KvEntry:
    value: bytes
    lease_id: int = 0
    version: int = 1


@dataclass
class _Lease:
    id: int
    ttl: float
    deadline: float
    keys: set[str] = field(default_factory=set)


class CoordinatorState:
    """Pure in-memory state machine (transport-independent, unit-testable)."""

    def __init__(self) -> None:
        self.kv: dict[str, _KvEntry] = {}
        self.leases: dict[int, _Lease] = {}
        self.queues: dict[str, list[bytes]] = {}
        self._next_lease = 1

    # -- kv ----------------------------------------------------------------
    def put(self, key: str, value: bytes, lease_id: int = 0) -> list[dict]:
        if lease_id and lease_id not in self.leases:
            raise KeyError(f"no such lease {lease_id}")
        prev = self.kv.get(key)
        if prev is not None and prev.lease_id and prev.lease_id != lease_id:
            if prev.lease_id in self.leases:
                self.leases[prev.lease_id].keys.discard(key)
        self.kv[key] = _KvEntry(value=value, lease_id=lease_id,
                                version=(prev.version + 1 if prev else 1))
        if lease_id:
            self.leases[lease_id].keys.add(key)
        return [{"op": "put", "key": key, "value": value}]

    def create(self, key: str, value: bytes, lease_id: int = 0) -> tuple[bool, list[dict]]:
        if key in self.kv:
            return False, []
        return True, self.put(key, value, lease_id)

    def delete(self, key: str) -> list[dict]:
        entry = self.kv.pop(key, None)
        if entry is None:
            return []
        if entry.lease_id in self.leases:
            self.leases[entry.lease_id].keys.discard(key)
        return [{"op": "delete", "key": key}]

    def get(self, key: str) -> bytes | None:
        e = self.kv.get(key)
        return e.value if e else None

    def get_prefix(self, prefix: str) -> dict[str, bytes]:
        return {k: e.value for k, e in self.kv.items() if k.startswith(prefix)}

    # -- leases ------------------------------------------------------------
    def lease_grant(self, ttl: float, now: float) -> int:
        lid = self._next_lease
        self._next_lease += 1
        self.leases[lid] = _Lease(id=lid, ttl=ttl, deadline=now + ttl)
        return lid

    def lease_keepalive(self, lease_id: int, now: float) -> bool:
        lease = self.leases.get(lease_id)
        if lease is None:
            return False
        lease.deadline = now + lease.ttl
        return True

    def lease_revoke(self, lease_id: int) -> list[dict]:
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return []
        events: list[dict] = []
        for key in list(lease.keys):
            events.extend(self.delete(key))
        return events

    def expire_leases(self, now: float) -> list[dict]:
        events: list[dict] = []
        for lid, lease in list(self.leases.items()):
            if lease.deadline <= now:
                log.info("lease %d expired (%d keys)", lid, len(lease.keys))
                events.extend(self.lease_revoke(lid))
        return events

    # -- queues ------------------------------------------------------------
    def queue_push(self, name: str, item: bytes) -> None:
        self.queues.setdefault(name, []).append(item)

    def queue_pop(self, name: str) -> bytes | None:
        q = self.queues.get(name)
        return q.pop(0) if q else None

    def queue_len(self, name: str) -> int:
        return len(self.queues.get(name, []))


@dataclass(eq=False)
class _Session:
    conn: MsgpackConnection
    watches: dict[int, str] = field(default_factory=dict)      # watch_id -> prefix
    subscriptions: dict[int, str] = field(default_factory=dict)  # sub_id -> subject pattern
    # Server→client pushes go through this queue, drained by a per-session
    # sender task, so a stalled client can never block a broadcast for the
    # whole cluster (its queue fills and it gets dropped instead).
    outbox: "asyncio.Queue[dict]" = field(default_factory=lambda: asyncio.Queue(maxsize=8192))
    sender: asyncio.Task | None = None
    _next_id: int = 0

    def next_id(self) -> int:
        # Skip ids already registered: reconnecting clients re-register
        # watches/subs under their ORIGINAL ids (caller-chosen), and a
        # fresh session counter colliding with one would silently cross the
        # streams.
        while True:
            self._next_id += 1
            if (self._next_id not in self.watches
                    and self._next_id not in self.subscriptions):
                return self._next_id

    def enqueue(self, msg: dict) -> bool:
        """Non-blocking push send; False when the client is stalled (full)."""
        try:
            self.outbox.put_nowait(msg)
            return True
        except asyncio.QueueFull:
            return False


class CoordinatorServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self.state = CoordinatorState()
        self._sessions: set[_Session] = set()
        self._server: asyncio.Server | None = None
        self._expiry_task: asyncio.Task | None = None
        self._handler_tasks: set[asyncio.Task] = set()  # strong refs (GC safety)
        # Serializes watch registration+replay against event broadcasts so a
        # watcher can never see a broadcast reordered before its own replay
        # of the same key (e.g. delete-then-stale-initial-put).
        self._watch_lock = asyncio.Lock()
        # Bounded pub/sub replay ring (JetStream role): (seq, subject,
        # payload). 16k messages cover minutes of KV-event traffic — well
        # past any reconnect backoff window.
        from collections import deque as _deque
        from uuid import uuid4 as _uuid4

        self._pub_seq = 0
        self._pub_ring: "_deque[tuple[int, str, bytes]]" = _deque(maxlen=16384)
        # Seq numbers are scoped to THIS server life; resumes from another
        # epoch can never be silently satisfied by our (unrelated) seqs.
        self._epoch = _uuid4().hex

    async def start(self) -> int:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._expiry_task = asyncio.create_task(self._expiry_loop())
        log.info("coordinator listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._expiry_task:
            self._expiry_task.cancel()
        if self._server:
            self._server.close()
        # Close live sessions BEFORE wait_closed(): Python 3.12's
        # wait_closed waits for connection handlers, which run until their
        # client disconnects — a stop with connected clients would deadlock.
        for s in list(self._sessions):
            s.conn.close()
        if self._server:
            await self._server.wait_closed()

    @property
    def url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    # ------------------------------------------------------------------
    async def _expiry_loop(self) -> None:
        while True:
            await asyncio.sleep(0.25)
            events = self.state.expire_leases(time.monotonic())
            if events:
                await self._broadcast_kv_events(events)

    def _drop_session(self, session: _Session, reason: str) -> None:
        log.warning("dropping coordinator session %s: %s", session.conn.peer, reason)
        self._sessions.discard(session)
        if session.sender is not None:
            session.sender.cancel()
        session.conn.close()

    async def _sender_loop(self, session: _Session) -> None:
        """Drain one session's outbox onto its socket."""
        try:
            while True:
                msg = await session.outbox.get()
                await session.conn.send(msg)
        except (asyncio.CancelledError, Exception):
            self._sessions.discard(session)
            session.conn.close()

    async def _broadcast_kv_events(self, events: list[dict]) -> None:
        # Enqueues only (no awaited sends) under the lock: per-session order
        # vs watch replay is preserved via the shared outbox, and a wedged
        # client fills its own queue instead of blocking the cluster.
        async with self._watch_lock:
            for session in list(self._sessions):
                for wid, prefix in list(session.watches.items()):
                    for e in events:
                        if not e["key"].startswith(prefix):
                            continue
                        if not session.enqueue({"t": Frame.WATCH_EVENT, "watch_id": wid, **e}):
                            self._drop_session(session, "watch outbox full")
                            break

    async def _publish(self, subject: str, payload: bytes) -> int:
        # Every message gets a global sequence number and lands in a bounded
        # replay ring — the JetStream-durable-consumer role (reference:
        # transports/nats.rs JetStream streams): a reconnecting subscriber
        # resumes from its last seen seq instead of silently losing the
        # outage window. The ring bounds memory; consumers that fall past
        # its tail get a gap signal and resort to snapshots.
        self._pub_seq += 1
        seq = self._pub_seq
        self._pub_ring.append((seq, subject, payload))
        n = 0
        for session in list(self._sessions):
            for sid, pattern in list(session.subscriptions.items()):
                if fnmatch.fnmatchcase(subject, pattern):
                    if session.enqueue({"t": Frame.PUBSUB_MSG, "sub_id": sid,
                                        "subject": subject, "payload": payload,
                                        "seq": seq}):
                        n += 1
                    else:
                        self._drop_session(session, "pubsub outbox full")
                        break
        return n

    # ------------------------------------------------------------------
    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        session = _Session(conn=MsgpackConnection(reader, writer))
        session.sender = asyncio.create_task(self._sender_loop(session))
        self._sessions.add(session)
        try:
            while True:
                msg = await session.conn.recv()
                if msg is None:
                    break
                if msg.get("t") == Frame.PING:
                    await session.conn.send({"t": Frame.PONG})
                    continue
                # Chaos: a raise here tears down THIS session (finally
                # below) — a one-client partition; clients must reconnect
                # and replay their watches/registrations.
                await chaos.ainject("coordinator.conn", op=msg.get("op"))
                task = asyncio.ensure_future(self._handle(session, msg))
                self._handler_tasks.add(task)
                task.add_done_callback(self._handler_tasks.discard)
        finally:
            self._sessions.discard(session)
            if session.sender is not None:
                session.sender.cancel()
            session.conn.close()

    async def _handle(self, session: _Session, msg: dict) -> None:
        rid = msg.get("id")
        op = msg.get("op", "")
        try:
            result = await self._dispatch(session, op, msg)
            await session.conn.send({"t": Frame.RESPONSE, "id": rid, "ok": True, **result})
        except Exception as exc:
            await session.conn.send(
                {"t": Frame.RESPONSE, "id": rid, "ok": False, "error": str(exc)})

    async def _dispatch(self, session: _Session, op: str, msg: dict) -> dict:
        st = self.state
        now = time.monotonic()
        if op == "put":
            events = st.put(msg["key"], msg["value"], msg.get("lease_id", 0))
            await self._broadcast_kv_events(events)
            return {}
        if op == "create":
            ok, events = st.create(msg["key"], msg["value"], msg.get("lease_id", 0))
            await self._broadcast_kv_events(events)
            return {"created": ok}
        if op == "delete":
            events = st.delete(msg["key"])
            await self._broadcast_kv_events(events)
            return {"deleted": bool(events)}
        if op == "get":
            v = st.get(msg["key"])
            return {"value": v}
        if op == "get_prefix":
            return {"items": st.get_prefix(msg["prefix"])}
        if op == "watch":
            wid = msg.get("watch_id") or session.next_id()
            async with self._watch_lock:  # atomic register+replay vs broadcasts
                session.watches[wid] = msg["prefix"]
                for k, v in st.get_prefix(msg["prefix"]).items():
                    session.enqueue({"t": Frame.WATCH_EVENT, "watch_id": wid,
                                     "op": "put", "key": k, "value": v, "initial": True})
            return {"watch_id": wid}
        if op == "unwatch":
            session.watches.pop(msg.get("watch_id"), None)
            return {}
        if op == "epoch":
            return {"epoch": self._epoch}
        if op == "lease_grant":
            return {"lease_id": st.lease_grant(msg.get("ttl", 10.0), now)}
        if op == "lease_keepalive":
            return {"alive": st.lease_keepalive(msg["lease_id"], now)}
        if op == "lease_revoke":
            events = st.lease_revoke(msg["lease_id"])
            await self._broadcast_kv_events(events)
            return {}
        if op == "subscribe":
            sid = msg.get("sub_id") or session.next_id()
            session.subscriptions[sid] = msg["subject"]
            resp: dict = {"sub_id": sid, "seq": self._pub_seq,
                          "epoch": self._epoch}
            from_seq = msg.get("from_seq")
            if from_seq is not None:
                if msg.get("epoch") != self._epoch:
                    # from_seq belongs to a PREVIOUS server life: our seqs
                    # are unrelated — nothing is replayable regardless of
                    # how the numbers happen to compare. Signal the gap; the
                    # client resets its baseline from resp["seq"].
                    resp["gap"] = True
                else:
                    # durable resume: replay buffered messages after
                    # from_seq; a tail older than the ring's horizon is a
                    # GAP the consumer must recover from out-of-band
                    # (snapshots)
                    ring = list(self._pub_ring)
                    if ring and ring[0][0] > from_seq + 1:
                        resp["gap"] = True
                    elif not ring and self._pub_seq > from_seq:
                        resp["gap"] = True  # evicted entirely
                    for seq, subject, payload in ring:
                        if seq > from_seq and fnmatch.fnmatchcase(
                                subject, msg["subject"]):
                            if not session.enqueue(
                                    {"t": Frame.PUBSUB_MSG, "sub_id": sid,
                                     "subject": subject, "payload": payload,
                                     "seq": seq, "replay": True}):
                                # outbox overflow mid-replay: the tail is
                                # lost — say so, never fake a full recovery
                                resp["gap"] = True
                                break
            return resp
        if op == "unsubscribe":
            session.subscriptions.pop(msg.get("sub_id"), None)
            return {}
        if op == "publish":
            n = await self._publish(msg["subject"], msg["payload"])
            return {"receivers": n}
        if op == "queue_push":
            st.queue_push(msg["name"], msg["item"])
            return {"len": st.queue_len(msg["name"])}
        if op == "queue_pop":
            return {"item": st.queue_pop(msg["name"])}
        if op == "queue_len":
            return {"len": st.queue_len(msg["name"])}
        raise ValueError(f"unknown op: {op!r}")


async def main() -> None:  # pragma: no cover - CLI entry
    import argparse

    p = argparse.ArgumentParser("dynamo-coordinator")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=6650)
    ns = p.parse_args()
    server = CoordinatorServer(ns.host, ns.port)
    port = await server.start()
    print(f"COORDINATOR_READY port={port}", flush=True)
    await asyncio.Event().wait()


if __name__ == "__main__":  # pragma: no cover
    asyncio.run(main())
