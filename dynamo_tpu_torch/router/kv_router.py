"""KvRouter + KvPushRouter: KV-cache-aware request routing.

Fills the role of the reference's KvRouter / KvPushRouter
(reference: lib/llm/src/kv_router.rs module; request-time path
indexer.rs:125 compute_block_hash_for_seq → find_matches → KvScheduler →
direct push; background path: kv_events/load_metrics consumers feeding the
radix index and worker loads; ActiveSequences predictions added on dispatch
and freed on stream end; dead workers purged when their instances vanish).

Copy of ``dynamo_tpu/router/kv_router.py``: the router builds the
pure-Python ``RadixIndexer`` directly (the JAX package's C++ twin,
``native/indexer.cc``, is not ported yet); ``KvPushRouter`` also counts
its decisions by worker and their host time (``routing_stats``), and frees
a request's load prediction at its stream's last item, where the JAX
router waits for the stream's generator to be closed.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

from dynamo_tpu_torch.utils import msgpack

from dynamo_tpu_torch.kvbm.metrics import get_prefix_cache_metrics
from dynamo_tpu_torch.obs.costmodel import PrefixCacheCost
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.router.arbiter import RouteDecision, arbitrate
from dynamo_tpu_torch.router.events import RouterEvent
from dynamo_tpu_torch.router.indexer import ApproxKvIndexer, RadixIndexer, WorkerId
from dynamo_tpu_torch.router.publisher import kv_events_subject, load_metrics_subject
from dynamo_tpu_torch.router.scheduler import DefaultWorkerSelector, KvScheduler, WorkerLoad
from dynamo_tpu_torch.router.sequence import ActiveSequences
from dynamo_tpu_torch.runtime.client import EndpointClient, NoInstancesError
from dynamo_tpu_torch.tokens import compute_block_hashes_for_tokens
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("router.kv")


def radix_snapshot_key(namespace: str, component: str) -> str:
    """Coordinator-KV key for the radix warm-start snapshot (the reference
    keeps these in a NATS object-store 'radix-bucket', kv_router.rs:57-74)."""
    return f"radix/{namespace}/{component}/snapshot"


@dataclass
class KvRouterConfig:
    block_size: int = 16
    overlap_weight: float = 1.0
    temperature: float = 0.0
    use_approx_indexer: bool = False   # engines without KV events
    approx_ttl_s: float = 120.0
    sync_replicas: bool = False        # mirror ActiveSequences across routers
    # Radix snapshot warm-start (reference: kv_router.rs:71-74 radix-bucket,
    # indexer.rs:656 dump_tree_as_events): routers periodically dump their
    # index as replayable events to the coordinator KV; a new/restarted
    # replica loads it before consuming live events, so its first routing
    # decision already sees the fleet's caches. 0 disables dumping.
    snapshot_interval_s: float = 5.0
    # Fleet-wide prefix cache arbitration (router/arbiter.py): when set —
    # the workers run with --global-prefix-cache, so published blocks are
    # importable from the shared store — routing prices route-to-warm vs
    # pull-to-cold vs plain recompute against this roofline cost model
    # instead of the heuristic overlap/load scheduler. None = classic
    # scheduling.
    prefix_cost: "PrefixCacheCost | None" = None


class KvRouter:
    """Routing brain: indexer + scheduler + load tracking (transport-free)."""

    def __init__(self, config: KvRouterConfig | None = None):
        self.config = config or KvRouterConfig()
        # The pure-Python indexer. The C++ twin of the JAX package
        # (native/indexer.cc, same semantics) is not ported yet.
        self.indexer = RadixIndexer()
        self.approx = ApproxKvIndexer(self.config.approx_ttl_s)
        self.scheduler = KvScheduler(DefaultWorkerSelector(
            overlap_weight=self.config.overlap_weight,
            temperature=self.config.temperature,
        ))
        self.active = ActiveSequences()
        self.worker_metrics: dict[WorkerId, dict] = {}
        # The prefix-cache arbiter's most recent verdict (observability;
        # only written when config.prefix_cost is set).
        self.last_decision: RouteDecision | None = None
        # Session affinity (engine/session.py retention): session.id →
        # the worker holding that session's retained KV. Bounded LRU;
        # entries for dead workers are purged in remove_worker. A mapped
        # session routes straight to its holder — its retained blocks are
        # pinned there, invisible to the radix index's event-driven view.
        self.session_affinity: "OrderedDict[str, WorkerId]" = OrderedDict()
        self.max_sessions = 4096

    # ------------------------------------------------------------------
    def apply_events(self, events: list[RouterEvent]) -> None:
        for ev in events:
            self.indexer.apply_event(ev)

    def update_metrics(self, metrics: dict) -> None:
        wid = metrics.get("worker_id")
        if wid is not None:
            self.worker_metrics[wid] = metrics

    def remove_worker(self, worker_id: WorkerId) -> None:
        self.indexer.remove_worker(worker_id)
        self.active.remove_worker(worker_id)
        self.worker_metrics.pop(worker_id, None)
        # A dead worker's retained sessions are gone with its HBM; the next
        # turn falls back to arbiter pricing (tier pull vs recompute).
        for sid in [s for s, w in self.session_affinity.items()
                    if w == worker_id]:
            del self.session_affinity[sid]

    # ------------------------------------------------------------------
    def find_best_match(self, request_id: str, token_ids: list[int],
                        worker_ids: list[WorkerId],
                        session_id: str | None = None) -> tuple[WorkerId, int]:
        """Pick a worker; returns (worker_id, overlap_blocks). Registers the
        decision with the ActiveSequences predictor. A ``session_id`` whose
        retention holder is still alive short-circuits scheduling — the
        suffix-only prefill on the holder beats any cold worker; a dead or
        unknown holder falls through to normal arbitration (the arbiter
        prices tier pull vs recompute when prefix_cost is set)."""
        if not worker_ids:
            raise NoInstancesError("no workers")
        # Health gating (reference: health_check.rs consumed by the router):
        # workers whose canaries fail report ready=False and stop receiving
        # traffic. Never filter down to zero — stale metrics must degrade to
        # normal routing, not an outage.
        ready = [w for w in worker_ids
                 if self.worker_metrics.get(w, {}).get("ready", True) is not False]
        if ready:
            worker_ids = ready
        hashes = compute_block_hashes_for_tokens(token_ids, self.config.block_size)
        total_blocks = max(len(hashes), 1)
        overlaps = (self.approx if self.config.use_approx_indexer else self.indexer).find_matches(hashes)
        holder = (self.session_affinity.get(session_id)
                  if session_id is not None else None)
        if holder is not None and holder in worker_ids:
            overlap = overlaps.scores.get(holder, 0)
            get_prefix_cache_metrics().route_decisions.inc(
                action="session_affinity")
            self.session_affinity.move_to_end(session_id)
            self.active.add_request(request_id, holder,
                                    total_blocks - overlap, overlap)
            if self.config.use_approx_indexer:
                self.approx.note_routed(hashes, holder)
            log.debug("session affinity: %s (session %s) -> worker %x",
                      request_id, session_id, holder)
            return holder, overlap
        loads = {}
        for wid in worker_ids:
            m = self.worker_metrics.get(wid, {})
            loads[wid] = WorkerLoad(
                worker_id=wid,
                active_blocks=self.active.active_blocks(wid)
                + int(m.get("num_waiting", 0)) * total_blocks // 4,
                total_blocks=int(m.get("kv_total_blocks", 1) or 1),
                num_waiting=int(m.get("num_waiting", 0)),
            )
        if self.config.prefix_cost is not None:
            dec = arbitrate(total_blocks, overlaps, loads,
                            self.config.prefix_cost)
            get_prefix_cache_metrics().route_decisions.inc(action=dec.action)
            self.last_decision = dec
            wid, overlap = dec.worker_id, dec.overlap_blocks
            log.debug("prefix-cache arbiter: %s -> worker %x (%s, overlap %d,"
                      " pull %d, %.4fs predicted)", request_id, wid,
                      dec.action, overlap, dec.pull_blocks,
                      dec.predicted_seconds)
        else:
            wid = self.scheduler.schedule(total_blocks, overlaps, loads)
            overlap = overlaps.scores.get(wid, 0)
        self.active.add_request(request_id, wid, total_blocks - overlap, overlap)
        if self.config.use_approx_indexer:
            self.approx.note_routed(hashes, wid)
        if session_id is not None:
            # This worker becomes the session's retention holder; the next
            # turn sticks to it.
            self.session_affinity[session_id] = wid
            self.session_affinity.move_to_end(session_id)
            while len(self.session_affinity) > self.max_sessions:
                self.session_affinity.popitem(last=False)
        return wid, overlap

    def complete(self, request_id: str) -> None:
        self.active.free(request_id)


class KvPushRouter:
    """Transport wiring: EndpointClient + coordinator subscriptions + KvRouter
    (the KV mode of PushRouter; reference: push_router.rs KV dispatch)."""

    def __init__(self, client: EndpointClient, config: KvRouterConfig | None = None):
        self.client = client
        self.router = KvRouter(config)
        self._tasks: list[asyncio.Task] = []
        self._known_workers: set[WorkerId] = set()
        self._snapshot_workers: set[WorkerId] = set()
        self._synced: "SyncedActiveSequences | None" = None
        # Decision accounting (the port's addition; the frontend's stats
        # report it): decisions per worker, and the host seconds spent in
        # find_best_match (prompt hashing included).
        self.routed: dict[WorkerId, int] = {}
        self.route_s = 0.0

    @classmethod
    async def create(cls, client: EndpointClient,
                     config: KvRouterConfig | None = None) -> "KvPushRouter":
        self = cls(client, config)
        ep = client.endpoint
        coord = client.runtime.client
        assert coord is not None
        ev_sub = await coord.subscribe(kv_events_subject(ep.namespace, ep.component))
        met_sub = await coord.subscribe(load_metrics_subject(ep.namespace, ep.component))
        # Warm-start AFTER subscribing (no event gap) and BEFORE serving:
        # replaying the snapshot is idempotent against any live events that
        # race in — stored-events only add holders to nodes.
        snap_key = radix_snapshot_key(ep.namespace, ep.component)
        try:
            blob = await coord.get(snap_key)
            if blob:
                events = [RouterEvent.from_dict(d)
                          for d in msgpack.unpackb(blob)]
                self.router.apply_events(events)
                # Workers that exist only in the snapshot (died along with
                # the previous router, before a cleaned dump) must be
                # reconciled against discovery once it syncs — the normal GC
                # only purges workers it saw LIVE first, so without this a
                # phantom worker's entries would persist (and be re-dumped)
                # forever.
                self._snapshot_workers = {e.worker_id for e in events}
                log.info("warm-started radix index from snapshot: %d events, "
                         "%d blocks", len(events), self.router.indexer.block_count())
        except Exception:
            log.exception("radix snapshot load failed; starting cold")
        if self.router.config.sync_replicas:
            from dynamo_tpu_torch.router.sequence import (
                SyncedActiveSequences,
                active_seq_subject,
            )
            synced = SyncedActiveSequences(
                coord, active_seq_subject(ep.namespace, ep.component))
            await synced.start()
            self.router.active = synced
            self._synced = synced
        self._tasks.append(asyncio.create_task(self._event_loop(ev_sub)))
        self._tasks.append(asyncio.create_task(self._metrics_loop(met_sub)))
        self._tasks.append(asyncio.create_task(self._instance_gc_loop()))
        if self.router.config.snapshot_interval_s > 0:
            self._tasks.append(asyncio.create_task(self._snapshot_loop(snap_key)))
        return self

    async def _snapshot_loop(self, key: str) -> None:
        """Periodically dump the radix index as replayable events (last
        writer wins — replicas converge on the same event stream, so any
        replica's dump warm-starts the next)."""
        coord = self.client.runtime.client
        last_version = -1
        while True:
            await asyncio.sleep(self.router.config.snapshot_interval_s)
            version = self.router.indexer.version
            if version == last_version:
                continue
            try:
                events = self.router.indexer.dump_events()
                blob = msgpack.packb([e.to_dict() for e in events])
                await coord.put(key, blob)
                # Only a SUCCESSFUL put retires this version — a transient
                # coordinator error must be retried next cycle even if no
                # new events arrive.
                last_version = version
            except Exception:
                log.exception("radix snapshot dump failed")

    async def _event_loop(self, sub) -> None:
        async for _subject, payload in sub:
            if sub.gap:
                # The reconnect replay ring could not cover the outage: the
                # index may have missed stored/removed events. Fall back to
                # the event-free approximation for affected lookups by
                # degrading gracefully — the ApproxKvIndexer keeps routing
                # sane and live events rebuild the radix from here; stale
                # entries age out via worker removal/GC.
                log.warning("kv event stream had a replay gap; radix index "
                            "may be stale until events repopulate it")
                sub.gap = False
            try:
                events = [RouterEvent.from_dict(d) for d in msgpack.unpackb(payload)]
                self.router.apply_events(events)
            except Exception:
                log.exception("bad kv event batch")

    async def _metrics_loop(self, sub) -> None:
        async for _subject, payload in sub:
            try:
                self.router.update_metrics(msgpack.unpackb(payload))
            except Exception:
                log.exception("bad metrics payload")

    async def _instance_gc_loop(self) -> None:
        """Purge router state for workers whose instances vanished from
        discovery. Uses known_instance_ids (NOT the quarantine-filtered
        list): a transient dial failure must not erase a live worker's
        radix index — only lease expiry removes an instance."""
        while True:
            await asyncio.sleep(0.5)
            live = set(self.client.known_instance_ids())
            if self._snapshot_workers and live:
                # Discovery has synced: snapshot-only workers that are not
                # live died with the previous router — purge them once.
                for wid in self._snapshot_workers - live:
                    log.info("purging snapshot-only worker %x", wid)
                    self.router.remove_worker(wid)
                self._snapshot_workers = set()
            for wid in self._known_workers - live:
                log.info("purging dead worker %x from router state", wid)
                self.router.remove_worker(wid)
            self._known_workers = live

    # ------------------------------------------------------------------
    async def generate(self, request: PreprocessedRequest | dict) -> AsyncIterator[Any]:
        from dynamo_tpu_torch.obs.tracer import get_tracer, trace_context_of

        req = request if isinstance(request, PreprocessedRequest) else PreprocessedRequest.from_dict(request)
        worker_ids = self.client.instance_ids()
        # The routing decision is a hop of its own: a micro span under the
        # request's wire traceparent recording which worker won and why.
        tctx = trace_context_of(req.annotations)
        rspan = (get_tracer().start_span(
            "router.schedule", ctx=tctx, request_id=req.request_id)
            if tctx else None)
        from dynamo_tpu_torch.engine.session import session_id_of

        t0 = time.perf_counter()
        wid, overlap = self.router.find_best_match(
            req.request_id, req.token_ids, worker_ids,
            session_id=session_id_of(req.annotations))
        self.route_s += time.perf_counter() - t0
        self.routed[wid] = self.routed.get(wid, 0) + 1
        req.estimated_prefix_hit_blocks = overlap
        # Recovery hint: remember which worker served this dispatch so a
        # stream that ends without a finish reason (no ERR frame to carry
        # the id) can still be attributed to — and quarantine — the
        # failing instance (frontend/migration.py).
        req.last_instance_id = wid
        if rspan is not None:
            get_tracer().end_span(rspan, worker_id=f"{wid:x}",
                                  overlap_blocks=overlap,
                                  candidates=len(worker_ids))
        log.debug("routed %s -> worker %x (overlap %d blocks)",
                  req.request_id, wid, overlap)
        first = True
        # Track real KV block growth during decode so the load predictor sees
        # long generations (reference: sequence.rs decode-block accounting).
        bs = self.router.config.block_size
        prompt_len = len(req.token_ids)
        gen_tokens = 0
        seen_blocks = -(-prompt_len // bs)
        freed = False
        try:
            async for item in self.client.generate_direct(req.to_dict(), wid, req.request_id):
                if first:
                    self.router.active.mark_prefill_complete(req.request_id)
                    first = False
                if isinstance(item, dict):
                    gen_tokens += len(item.get("token_ids") or [])
                    if item.get("finish_reason") is not None:
                        # The stream's last item: free its load prediction
                        # before handing it on. A caller that stops at the
                        # last item (frontend/migration.py returns) leaves
                        # this generator's close to the garbage collector,
                        # and the client's next request must not find the
                        # finished one counted against its worker.
                        self.router.complete(req.request_id)
                        freed = True
                        yield item
                        continue
                total_blocks_now = -(-(prompt_len + gen_tokens) // bs)
                if total_blocks_now > seen_blocks:
                    self.router.active.note_decode_progress(
                        req.request_id, total_blocks_now - seen_blocks)
                    seen_blocks = total_blocks_now
                yield item
        finally:
            if not freed:
                self.router.complete(req.request_id)

    def routing_stats(self) -> dict:
        """Decisions per worker (hex id), their count, and the host seconds
        they took in all and in the mean (ms)."""
        n = sum(self.routed.values())
        workers = set(self.routed) | set(self.router.worker_metrics)
        return {"routed": {f"{w:x}": c for w, c in self.routed.items()},
                "decisions": n, "route_s": self.route_s,
                "route_ms_mean": 1e3 * self.route_s / n if n else 0.0,
                # what the next decision reads: the blocks indexed from each
                # worker's KV events and the predicted blocks of its
                # requests in flight
                "indexed_blocks": {f"{w:x}": self.router.indexer.worker_block_count(w)
                                   for w in workers},
                "active_blocks": {f"{w:x}": self.router.active.active_blocks(w)
                                  for w in workers}}

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._synced is not None:
            await self._synced.close()
