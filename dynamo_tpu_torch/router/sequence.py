"""Router-local active-sequence load prediction.

Fills the role of the reference's ActiveSequences
(reference: lib/llm/src/kv_router/sequence.rs:53-225 ActiveSequences,
:283 ActiveSequencesMultiWorker): the router predicts each worker's block
usage from its own routing decisions — add on dispatch, shrink when prefill
completes (shared prefix blocks become free), drop on stream end — so
scheduling doesn't wait on the (slower) metrics feedback loop. Multi-router
deployments sync decisions over the coordinator pub/sub via
``SyncedActiveSequences`` (each router broadcasts add/prefill-done/free and
applies its peers' events to the shared prediction).

Copy of ``dynamo_tpu/router/sequence.py`` over the port's codec.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass, field

from dynamo_tpu_torch.utils import msgpack

from dynamo_tpu_torch.router.indexer import WorkerId
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("router.sequence")


@dataclass
class _ActiveReq:
    request_id: str
    worker_id: WorkerId
    prefill_blocks: int      # blocks this request must newly compute
    overlap_blocks: int      # cached blocks it reuses
    decode_blocks: int = 0   # grown during decode
    prefill_done: bool = False
    started: float = field(default_factory=time.monotonic)


class ActiveSequences:
    def __init__(self, ttl_s: float = 1800.0) -> None:
        self._reqs: dict[str, _ActiveReq] = {}
        self._by_worker: dict[WorkerId, set[str]] = {}
        # Safety net against leaked predictions (a crashed peer router, a
        # dropped sync message): entries older than ttl_s are swept lazily
        # so load predictions converge back to reality instead of drifting
        # forever. 30 min comfortably exceeds any real stream lifetime.
        self._ttl_s = ttl_s
        self._last_sweep = time.monotonic()

    def _sweep(self) -> None:
        now = time.monotonic()
        if now - self._last_sweep < self._ttl_s / 10:
            return
        self._last_sweep = now
        for rid in [r.request_id for r in self._reqs.values()
                    if now - r.started > self._ttl_s]:
            ActiveSequences.free(self, rid)

    def add_request(self, request_id: str, worker_id: WorkerId,
                    prefill_blocks: int, overlap_blocks: int) -> None:
        self._reqs[request_id] = _ActiveReq(
            request_id=request_id, worker_id=worker_id,
            prefill_blocks=prefill_blocks, overlap_blocks=overlap_blocks)
        self._by_worker.setdefault(worker_id, set()).add(request_id)

    def mark_prefill_complete(self, request_id: str) -> None:
        req = self._reqs.get(request_id)
        if req:
            req.prefill_done = True

    def note_decode_progress(self, request_id: str, new_blocks: int = 1) -> None:
        req = self._reqs.get(request_id)
        if req:
            req.decode_blocks += new_blocks

    def free(self, request_id: str) -> None:
        req = self._reqs.pop(request_id, None)
        if req:
            peers = self._by_worker.get(req.worker_id)
            if peers:
                peers.discard(request_id)

    # ------------------------------------------------------------------
    def active_blocks(self, worker_id: WorkerId) -> int:
        """Predicted blocks in use on a worker from in-flight requests."""
        self._sweep()
        total = 0
        for rid in self._by_worker.get(worker_id, ()):
            r = self._reqs[rid]
            total += r.prefill_blocks + r.overlap_blocks + r.decode_blocks
        return total

    def request_count(self, worker_id: WorkerId) -> int:
        return len(self._by_worker.get(worker_id, ()))

    def remove_worker(self, worker_id: WorkerId) -> list[str]:
        """Drop all predictions for a dead worker; returns orphaned request ids."""
        rids = list(self._by_worker.pop(worker_id, ()))
        for rid in rids:
            self._reqs.pop(rid, None)
        return rids

    def snapshot(self) -> dict:
        return {
            "requests": {
                rid: {
                    "worker_id": r.worker_id,
                    "prefill_blocks": r.prefill_blocks,
                    "overlap_blocks": r.overlap_blocks,
                    "decode_blocks": r.decode_blocks,
                    "prefill_done": r.prefill_done,
                }
                for rid, r in self._reqs.items()
            }
        }


def active_seq_subject(namespace: str, component: str) -> str:
    return f"active_seq.{namespace}.{component}"


class SyncedActiveSequences(ActiveSequences):
    """ActiveSequences whose mutations are mirrored across router replicas
    (reference: lib/llm/src/kv_router/sequence.rs:283 ActiveSequencesMultiWorker,
    which syncs router decisions over NATS so every replica predicts the
    *global* per-worker load, not just its own dispatches).

    Local mutators apply immediately (the scheduler must see its own decision
    synchronously) and enqueue a broadcast; a background task flushes the
    queue to the coordinator pub/sub and applies peers' events. Request ids
    are globally unique, so replays/echoes are idempotent: our own messages
    are dropped by origin id.
    """

    def __init__(self, coord, subject: str) -> None:
        super().__init__()
        self._coord = coord
        self._subject = subject
        self._origin = uuid.uuid4().hex
        self._outbox: asyncio.Queue[dict] = asyncio.Queue()
        self._tasks: list[asyncio.Task] = []
        self._send_task: asyncio.Task | None = None

    async def start(self) -> None:
        sub = await self._coord.subscribe(self._subject)
        self._tasks.append(asyncio.create_task(self._recv_loop(sub)))
        self._send_task = asyncio.create_task(self._send_loop())
        self._tasks.append(self._send_task)

    async def close(self) -> None:
        # Drain via sentinel instead of cancelling: the send loop publishes
        # everything queued before the sentinel exactly once, then exits —
        # no cancellation race can drop a batch or re-deliver one whose
        # publish already succeeded (peers' 'decode' ops are additive, so a
        # replay would double-count predicted blocks).
        if self._send_task is not None:
            self._emit({"op": "__stop__"})
            try:
                await asyncio.wait_for(asyncio.shield(self._send_task), timeout=5.0)
            except asyncio.TimeoutError:
                log.warning("active-seq sync drain timed out; peers converge via TTL")
            except Exception:
                log.exception("active-seq send loop died; peers converge via TTL")
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)

    # -- local mutators: apply + broadcast ------------------------------
    def add_request(self, request_id: str, worker_id: WorkerId,
                    prefill_blocks: int, overlap_blocks: int) -> None:
        super().add_request(request_id, worker_id, prefill_blocks, overlap_blocks)
        self._emit({"op": "add", "rid": request_id, "wid": worker_id,
                    "pb": prefill_blocks, "ob": overlap_blocks})

    def mark_prefill_complete(self, request_id: str) -> None:
        super().mark_prefill_complete(request_id)
        self._emit({"op": "prefill_done", "rid": request_id})

    def note_decode_progress(self, request_id: str, new_blocks: int = 1) -> None:
        super().note_decode_progress(request_id, new_blocks)
        self._emit({"op": "decode", "rid": request_id, "nb": new_blocks})

    def free(self, request_id: str) -> None:
        super().free(request_id)
        self._emit({"op": "free", "rid": request_id})

    def _emit(self, msg: dict) -> None:
        msg["src"] = self._origin
        self._outbox.put_nowait(msg)

    # -- background plumbing -------------------------------------------
    async def _send_loop(self) -> None:
        while True:
            msg = await self._outbox.get()
            batch = [msg]
            while not self._outbox.empty() and len(batch) < 256:
                batch.append(self._outbox.get_nowait())
            stop = any(m.get("op") == "__stop__" for m in batch)
            batch = [m for m in batch if m.get("op") != "__stop__"]
            if batch:
                await self._publish_with_retry(msgpack.packb(batch))
            if stop:
                return

    async def _publish_with_retry(self, payload: bytes) -> None:
        for attempt in range(3):
            try:
                await self._coord.publish(self._subject, payload)
                return
            except Exception:
                if attempt == 2:
                    # Dropped for good — peers' predictions for these
                    # requests converge via the ActiveSequences TTL sweep.
                    log.exception("active-seq sync publish dropped after retries")
                else:
                    await asyncio.sleep(0.2 * (attempt + 1))

    async def _recv_loop(self, sub) -> None:
        async for _subject, payload in sub:
            try:
                for msg in msgpack.unpackb(payload):
                    if msg.get("src") == self._origin:
                        continue
                    self._apply_peer(msg)
            except Exception:
                log.exception("bad active-seq sync batch")

    def _apply_peer(self, msg: dict) -> None:
        op = msg.get("op")
        if op == "add":
            ActiveSequences.add_request(
                self, msg["rid"], msg["wid"], msg["pb"], msg["ob"])
        elif op == "prefill_done":
            ActiveSequences.mark_prefill_complete(self, msg["rid"])
        elif op == "decode":
            ActiveSequences.note_decode_progress(self, msg["rid"], msg["nb"])
        elif op == "free":
            ActiveSequences.free(self, msg["rid"])
