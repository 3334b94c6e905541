"""Async client for the coordinator service.

Fills the role of the reference's etcd + NATS client wrappers
(reference: lib/runtime/src/transports/{etcd,nats}.rs): KV with leases and
auto keep-alive, prefix watches with callback or queue delivery, pub/sub,
and shared work queues — over one multiplexed connection.

Copy of ``dynamo_tpu/transports/client.py``.
"""

from __future__ import annotations

import asyncio
import itertools
from dataclasses import dataclass
from typing import Any, AsyncIterator, Awaitable, Callable

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.transports.wire import Frame, MsgpackConnection
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("coordinator.client")


def parse_url(url: str) -> tuple[str, int]:
    url = url.removeprefix("tcp://")
    host, _, port = url.partition(":")
    return host or "127.0.0.1", int(port or 6650)


class CoordinatorError(RuntimeError):
    pass


@dataclass
class WatchEvent:
    # "put" | "delete" | "reset" — reset precedes the post-reconnect replay:
    # consumers must drop accumulated state (deletions during the outage
    # are not replayable; the replay after reset is the complete truth).
    op: str
    key: str
    value: bytes | None = None
    initial: bool = False


class Watch:
    """A prefix watch delivering events through an async queue."""

    def __init__(self, client: "CoordinatorClient", watch_id: int):
        self._client = client
        self.watch_id = watch_id
        self.queue: asyncio.Queue[WatchEvent] = asyncio.Queue()

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[WatchEvent]:
        while True:
            ev = await self.queue.get()
            if ev is None:  # poison: connection lost / watch closed
                return
            yield ev

    async def cancel(self) -> None:
        self._client._watches.pop(self.watch_id, None)
        self._client._watch_prefixes.pop(self.watch_id, None)
        self.queue.put_nowait(None)
        try:
            await self._client._request({"op": "unwatch", "watch_id": self.watch_id})
        except CoordinatorError:
            pass  # disconnected: the server session is gone anyway


class Subscription:
    def __init__(self, client: "CoordinatorClient", sub_id: int):
        self._client = client
        self.sub_id = sub_id
        self.queue: asyncio.Queue[tuple[str, bytes]] = asyncio.Queue()
        # Durable-resume bookkeeping (JetStream role): highest seq seen;
        # reconnects resume from here. ``gap`` flips when the outage outran
        # the server's replay ring — the consumer lost messages and should
        # recover out-of-band (e.g. router radix snapshot reload).
        self.last_seq = 0
        self.gap = False

    def __aiter__(self):
        return self._iter()

    async def _iter(self):
        while True:
            item = await self.queue.get()
            if item is None:  # poison: connection lost / unsubscribed
                return
            yield item

    async def cancel(self) -> None:
        self._client._subs.pop(self.sub_id, None)
        self._client._sub_subjects.pop(self.sub_id, None)
        self.queue.put_nowait(None)
        try:
            await self._client._request({"op": "unsubscribe", "sub_id": self.sub_id})
        except CoordinatorError:
            pass  # disconnected: the server session is gone anyway


@dataclass
class Lease:
    """A lease with background keep-alive (reference: etcd.rs Lease)."""

    id: int
    ttl: float
    _task: asyncio.Task | None = None
    # Fired (once) when the server reports the lease dead while the
    # connection itself is healthy — expiry under keepalive loss, NOT a
    # connection outage (that path runs through on_reconnected). The owner
    # re-grants and re-declares its lease-bound keys here.
    on_lost: Callable[[], Awaitable[None]] | None = None

    async def revoke(self, client: "CoordinatorClient") -> None:
        if self._task:
            self._task.cancel()
        await client._request({"op": "lease_revoke", "lease_id": self.id})


class CoordinatorClient:
    def __init__(self, url: str, auto_reconnect: bool = False):
        self.url = url
        self.auto_reconnect = auto_reconnect
        self._conn: MsgpackConnection | None = None
        self._connected = False
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._watches: dict[int, Watch] = {}
        self._watch_prefixes: dict[int, str] = {}    # for re-registration
        self._subs: dict[int, Subscription] = {}
        self._sub_subjects: dict[int, str] = {}
        self._reader_task: asyncio.Task | None = None
        self._reconnect_task: asyncio.Task | None = None
        self._closed = False
        self._server_epoch: str | None = None  # seqs are per server life
        # True when the LAST reconnect crossed a server restart (epoch
        # change) — lease/key state from before the outage is gone.
        self.epoch_changed = False
        self.reconnects = 0
        # Async callbacks run after every successful reconnect, AFTER
        # watches/subs are re-registered — the place to re-grant leases and
        # re-put lease-bound keys (the coordinator lost them with the
        # session; a RESTARTED coordinator lost everything).
        self.on_reconnected: list[Callable[[], Awaitable[None]]] = []

    # ------------------------------------------------------------------
    @classmethod
    async def connect(cls, url: str, retries: int = 30, delay: float = 0.2,
                      auto_reconnect: bool = False) -> "CoordinatorClient":
        client = cls(url, auto_reconnect=auto_reconnect)
        await client._dial(retries=retries, delay=delay)
        try:
            client._server_epoch = (
                await client._request({"op": "epoch"})).get("epoch")
        except CoordinatorError:
            pass  # old server without the op: epoch tracking degrades
        return client

    async def _dial(self, retries: int = 30, delay: float = 0.2) -> None:
        await chaos.ainject("transports.dial", url=self.url)
        if self._conn is not None:
            self._conn.close()  # never leak a half-dead connection
        host, port = parse_url(self.url)
        last: Exception | None = None
        for _ in range(retries):
            try:
                self._conn = await MsgpackConnection.connect(host, port)
                break
            except OSError as exc:
                last = exc
                await asyncio.sleep(delay)
        else:
            raise CoordinatorError(f"cannot reach coordinator at {self.url}: {last}")
        self._connected = True
        self._reader_task = asyncio.create_task(self._read_loop())

    async def close(self) -> None:
        self._closed = True
        if self._reader_task:
            self._reader_task.cancel()
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if self._conn:
            self._conn.close()
        # Poison every stream: with auto_reconnect the read-loop's finally
        # deliberately skips this, so a close() during an outage must do it
        # or consumers iterate empty queues forever.
        for w in self._watches.values():
            w.queue.put_nowait(None)
        for s in self._subs.values():
            s.queue.put_nowait(None)

    # ------------------------------------------------------------------
    async def _read_loop(self) -> None:
        assert self._conn is not None
        try:
            while True:
                msg = await self._conn.recv()
                if msg is None:
                    return
                self._dispatch_frame(msg)
        except Exception as exc:
            if not self._closed:
                log.warning("coordinator reader failed: %s", exc)
        finally:
            self._connected = False
            if not self._closed:
                log.warning("coordinator connection lost%s",
                            " (reconnecting)" if self.auto_reconnect else "")
            # In-flight requests cannot be retried safely (the op may have
            # applied); fail them either way.
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(CoordinatorError("connection lost"))
            self._pending.clear()
            if self._closed or not self.auto_reconnect:
                # End all watch/subscription streams so no consumer blocks
                # forever on a dead connection.
                for w in self._watches.values():
                    w.queue.put_nowait(None)
                for s in self._subs.values():
                    s.queue.put_nowait(None)
            elif self._reconnect_task is None or self._reconnect_task.done():
                # single owner: a reconnect loop already mid-rebuild keeps
                # going (its redial handles this death); two loops would
                # double-register watches and double-fire on_reconnected
                self._reconnect_task = asyncio.create_task(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        """Re-dial with backoff, then rebuild server-side session state:
        watches re-register under their ORIGINAL ids (the server accepts a
        caller-chosen watch_id) after pushing a synthetic ``reset`` event so
        consumers drop state accumulated before the outage — the replay
        that follows is the complete current truth, and deletions that
        happened while disconnected would otherwise be missed forever.
        Subscriptions re-subscribe (messages during the outage are lost —
        pub/sub is fire-and-forget, consumers tolerate gaps by design)."""
        delay = 0.2
        while not self._closed:
            try:
                await self._dial(retries=1)
            except CoordinatorError:
                delay = min(delay * 1.7, 5.0)
                await asyncio.sleep(delay)
                continue
            prev_epoch = self._server_epoch
            new_epoch = prev_epoch
            try:
                for wid, prefix in list(self._watch_prefixes.items()):
                    w = self._watches.get(wid)
                    if w is not None:
                        w.queue.put_nowait(WatchEvent(op="reset", key=prefix))
                    await self._request(
                        {"op": "watch", "prefix": prefix, "watch_id": wid})
                for sid, subject in list(self._sub_subjects.items()):
                    s = self._subs.get(sid)
                    # every sub presents the PRE-outage epoch — updating it
                    # mid-loop would let later subs resume against the new
                    # epoch with stale seqs (silent loss, no gap)
                    resp = await self._request(
                        {"op": "subscribe", "subject": subject, "sub_id": sid,
                         "from_seq": s.last_seq if s else 0,
                         "epoch": prev_epoch})
                    if s is not None:
                        if resp.get("gap"):
                            s.gap = True
                            # seqs are scoped to a server life: on a gap the
                            # baseline restarts at the NEW server's seq
                            s.last_seq = resp.get("seq", 0)
                            log.warning("subscription %s lost messages "
                                        "across the outage (replay gap)",
                                        subject)
                    new_epoch = resp.get("epoch", new_epoch)
                if not self._sub_subjects:
                    # no subscription to learn the epoch from: ask directly
                    # (lease-reuse decisions key on epoch continuity)
                    new_epoch = (await self._request({"op": "epoch"})).get(
                        "epoch", new_epoch)
            except Exception:
                # ANY rebuild failure (CoordinatorError, socket death mid-
                # send, ...) → redial; never die with consumers un-poisoned
                log.exception("coordinator session rebuild failed; redialing")
                continue
            self._server_epoch = new_epoch
            self.epoch_changed = (prev_epoch is not None
                                  and new_epoch != prev_epoch)
            self.reconnects += 1
            log.info("coordinator reconnected (%d watches, %d subs%s)",
                     len(self._watch_prefixes), len(self._sub_subjects),
                     ", NEW EPOCH" if self.epoch_changed else "")
            for cb in list(self.on_reconnected):
                try:
                    await cb()
                except Exception:
                    log.exception("on_reconnected callback failed")
            if self._connected:
                return
            # the connection died DURING the callbacks and its reader saw
            # this task still alive (no respawn): loop and redial ourselves

    def _dispatch_frame(self, msg: dict) -> None:
        t = msg.get("t")
        if t == Frame.RESPONSE:
            fut = self._pending.pop(msg.get("id"), None)
            if fut and not fut.done():
                fut.set_result(msg)
        elif t == Frame.WATCH_EVENT:
            # initial replay events can arrive before watch_prefix() sees
            # the response — create the Watch on demand
            wid = msg.get("watch_id")
            w = self._watches.get(wid)
            if w is None:
                w = self._watches[wid] = Watch(self, wid)
            w.queue.put_nowait(WatchEvent(
                op=msg["op"], key=msg["key"], value=msg.get("value"),
                initial=bool(msg.get("initial"))))
        elif t == Frame.PUBSUB_MSG:
            sid = msg.get("sub_id")
            s = self._subs.get(sid)
            if s is None:
                s = self._subs[sid] = Subscription(self, sid)
            seq = msg.get("seq", 0)
            if seq and seq <= s.last_seq:
                return  # duplicate (a live event raced the resume replay)
            s.last_seq = max(s.last_seq, seq)
            s.queue.put_nowait((msg["subject"], msg["payload"]))


    async def _request(self, body: dict) -> dict:
        await chaos.ainject("transports.request", op=body.get("op"))
        if self._conn is None or not self._connected:
            # Fail fast during an outage: callers see the same error shape
            # as a mid-flight loss and apply their own retry policy.
            raise CoordinatorError("not connected")
        rid = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        await self._conn.send({"t": Frame.REQUEST, "id": rid, **body})
        resp = await fut
        if not resp.get("ok"):
            raise CoordinatorError(resp.get("error", "unknown error"))
        return resp

    # -- kv ----------------------------------------------------------------
    async def put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        await self._request({"op": "put", "key": key, "value": value, "lease_id": lease_id})

    async def create(self, key: str, value: bytes, lease_id: int = 0) -> bool:
        resp = await self._request(
            {"op": "create", "key": key, "value": value, "lease_id": lease_id})
        return bool(resp.get("created"))

    async def get(self, key: str) -> bytes | None:
        return (await self._request({"op": "get", "key": key})).get("value")

    async def get_prefix(self, prefix: str) -> dict[str, bytes]:
        return (await self._request({"op": "get_prefix", "prefix": prefix})).get("items", {})

    async def delete(self, key: str) -> bool:
        return bool((await self._request({"op": "delete", "key": key})).get("deleted"))

    async def watch_prefix(self, prefix: str) -> Watch:
        resp = await self._request({"op": "watch", "prefix": prefix, "watch_id": 0})
        # events for this watch may already be queued in _read_loop order;
        # register before returning (watch_id assigned server-side)
        wid = resp["watch_id"]
        self._watch_prefixes[wid] = prefix
        w = self._watches.get(wid)
        if w is None:
            w = Watch(self, wid)
            self._watches[wid] = w
        return w

    # -- leases ------------------------------------------------------------
    async def lease_grant(self, ttl: float = 5.0, keepalive: bool = True) -> Lease:
        resp = await self._request({"op": "lease_grant", "ttl": ttl})
        lease = Lease(id=resp["lease_id"], ttl=ttl)
        if keepalive:
            lease._task = asyncio.create_task(self._keepalive_loop(lease))
        return lease

    async def _keepalive_loop(self, lease: Lease) -> None:
        interval = max(lease.ttl / 3.0, 0.1)
        while True:
            await asyncio.sleep(interval)
            try:
                await chaos.ainject("transports.keepalive", lease_id=lease.id)
                ok = (await self._request(
                    {"op": "lease_keepalive", "lease_id": lease.id})).get("alive")
                if not ok:
                    # Expired while the CONNECTION is healthy (keepalive
                    # starvation, e.g. a GIL-holding stall or injected
                    # drops): connection-loss recovery never fires, so tell
                    # the owner directly — it re-grants and re-declares.
                    log.warning("lease %d no longer alive", lease.id)
                    if lease.on_lost is not None:
                        cb, lease.on_lost = lease.on_lost, None
                        try:
                            await cb()
                        except Exception:
                            log.exception("lease on_lost callback failed")
                    return
            except ConnectionError:
                # A dropped keepalive (injected or transient network fault)
                # must not kill the loop — the lease survives until TTL, and
                # the next tick may well get through.
                continue
            except CoordinatorError:
                return

    # -- pubsub ------------------------------------------------------------
    async def subscribe(self, subject: str) -> Subscription:
        resp = await self._request({"op": "subscribe", "subject": subject, "sub_id": 0})
        sid = resp["sub_id"]
        self._sub_subjects[sid] = subject
        s = self._subs.get(sid)
        if s is None:
            s = Subscription(self, sid)
            self._subs[sid] = s
        # baseline: resume-from excludes anything published before this
        # subscription existed
        s.last_seq = max(s.last_seq, resp.get("seq", 0))
        self._server_epoch = resp.get("epoch", self._server_epoch)
        return s

    async def publish(self, subject: str, payload: bytes) -> int:
        resp = await self._request({"op": "publish", "subject": subject, "payload": payload})
        return resp.get("receivers", 0)

    # -- queues ------------------------------------------------------------
    async def queue_push(self, name: str, item: bytes) -> None:
        await self._request({"op": "queue_push", "name": name, "item": item})

    async def queue_pop(self, name: str) -> bytes | None:
        return (await self._request({"op": "queue_pop", "name": name})).get("item")

    async def queue_len(self, name: str) -> int:
        return (await self._request({"op": "queue_len", "name": name})).get("len", 0)
