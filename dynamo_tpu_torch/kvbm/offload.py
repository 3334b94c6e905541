"""Offload manager: device ↔ host ↔ disk ↔ remote block movement policy —
port of ``dynamo_tpu/kvbm/offload.py`` for one device.

- **Offload (write-back)**: when the device PrefixPool evicts a committed
  block under allocation pressure, its contents are pulled off the device
  *before the slot is reused* and stored in the first tier; tiers cascade
  their own LRU victims downward (host → disk → remote).
- **Onboard**: at request admission the engine asks for the prompt's block
  hashes; hashes missing from the device pool but present in a tier are
  injected into freshly allocated device blocks and committed as matchable
  (inactive) cache entries, so the scheduler's normal prefix match reuses
  them.
- **Publish-on-commit** (global prefix cache) and the **stream-checkpoint
  queue** ride the same budgeted flush into the shared remote tier.

Where the JAX package rebinds the cache to the arrays its inject program
returns, the port's inject writes the cache tensors in place: the engine's
captured step graphs read them as static inputs. Under tensor parallelism
the manager runs on the leader over the engine's ``TPTransferEngine``:
the tiers hold whole blocks, as JAX's engine at one process keeps them.
Over several nodes (kvbm/distributed.py) every rank's tiers hold its box:
the manager's puts and lookups are mirrored on each rank (``ranks``), and
with ``vote_plans`` an onboard plan shrinks to the engine-wide minimum.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import numpy as np

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.engine.errors import NoFreeBlocks
from dynamo_tpu_torch.engine.prefix_pool import PrefixPool
from dynamo_tpu_torch.kvbm.metrics import get_prefix_cache_metrics
from dynamo_tpu_torch.kvbm.stream_ckpt import get_stream_ckpt_metrics
from dynamo_tpu_torch.kvbm.transfer import BlockTransferEngine
from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
from dynamo_tpu_torch.utils import msgpack
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("kvbm")

# One onboarding unit: (seq_hash, parent_seq_hash | None, block data).
OnboardPlan = list[tuple[int, "int | None", np.ndarray]]


def plan_onboard(pool: PrefixPool, seq_hashes: list[int],
                 lookup: Callable[[int], "np.ndarray | None"]) -> OnboardPlan:
    """Walk a hash chain: device-resident blocks are touched (MRU-refreshed
    so the upcoming allocation can't evict the chain head), missing blocks
    are resolved through ``lookup``; the walk stops at the first hash found
    nowhere (a later block without its prefix is unmatchable)."""
    plan: OnboardPlan = []
    parent: int | None = None
    for h in seq_hashes:
        if pool.has_hash(h):
            pool.touch(h)
            parent = h
            continue
        block = lookup(h)
        if block is None:
            break
        plan.append((h, parent, block))
        parent = h
    return plan


def inject_and_commit(runner, pool: PrefixPool, transfer: BlockTransferEngine,
                      plan: OnboardPlan, flush: Callable[[], int] | None = None,
                      span_attrs: dict | None = None) -> int:
    """Allocate device blocks, write the plan's data into them in place,
    and commit them as matchable inactive cache entries. Returns blocks
    injected (0 if the pool can't make room). ``runner`` is duck-typed:
    ``cache_k``/``cache_v``.

    ``flush`` (the offload manager's write-back flush) runs between the
    allocation and the inject: the allocate may queue evictions of the very
    blocks being recycled, and their contents must be extracted before the
    inject overwrites them."""
    if not plan:
        return 0
    try:
        block_ids = pool.allocate(len(plan))
    except NoFreeBlocks:
        return 0
    if flush is not None:
        flush()
    transfer.inject(runner.cache_k, runner.cache_v, block_ids,
                    [data for _, _, data in plan], span_attrs=span_attrs)
    for bid, (h, par, _) in zip(block_ids, plan):
        pool.commit(bid, h, par)
    pool.release(block_ids)  # park as matchable inactive blocks
    return len(plan)


@dataclass
class OffloadStats:
    offloaded_blocks: int = 0
    onboarded_blocks: int = 0
    published_blocks: int = 0

    def to_dict(self) -> dict:
        return {"offloaded_blocks": self.offloaded_blocks,
                "onboarded_blocks": self.onboarded_blocks,
                "published_blocks": self.published_blocks}


class OffloadManager:
    """Ties the engine's device cache + PrefixPool to host/disk/remote
    tiers. ``runner`` is duck-typed: ``cache_k``/``cache_v``, written in
    place by inject."""

    #: device-extract budget for publish-on-commit per flush — bounds the
    #: extra gather + remote puts a busy step pays; leftovers carry over.
    PUBLISH_PER_FLUSH = 8
    #: remembered published hashes (dedup window) — bounds memory, and a
    #: redundant re-publish past the window is an idempotent put.
    PUBLISH_MEMORY = 1 << 16
    #: device-extract budget for stream-checkpoint blocks per flush.
    CKPT_PER_FLUSH = 8

    def __init__(self, runner, pool: PrefixPool, tiers: list,
                 publish_tier=None, ckpt_tier=None,
                 transfer: BlockTransferEngine | None = None,
                 vote_plans: bool = False, ranks=None):
        assert tiers, "OffloadManager needs at least one tier"
        self.runner = runner
        self.pool = pool
        self.tiers = tiers
        # the block mover: a tensor-parallel engine's leader passes its own
        # (kvbm/transfer.TPTransferEngine: whole blocks from every rank)
        self.transfer = transfer if transfer is not None else BlockTransferEngine()
        # vote_plans: ranks whose tiers can answer differently (the shared
        # remote store: evictions, connection hiccups) must not inject
        # different plans, so each onboard truncates its plan to the
        # engine-wide minimum length (the walk order is a fixed hash chain,
        # so equal lengths mean identical hash sets).
        self.vote_plans = vote_plans
        # ranks: over several nodes, the mirror that makes every rank's
        # tier cascade take the same puts and lookups on its own box
        # (kvbm/distributed.TierMirror); None on one node.
        self.ranks = ranks
        self._looked: list[int] | None = None
        # publish_tier: the global prefix cache's publish-on-commit target
        # (the shared remote store): committed prefix blocks are pushed
        # there as they form, not only on LRU eviction.
        self.publish_tier = publish_tier
        # ckpt_tier: the shared remote store stream checkpoints park in.
        # Blocks ride the normal tier namespace; a record is written only
        # AFTER every block it covers has flushed, so a stored record always
        # points at reachable KV.
        self.ckpt_tier = ckpt_tier
        self.stats = OffloadStats()
        self._pending: list[tuple[int, int]] = []  # (block_id, seq_hash)
        self._publish_pending: list[tuple[int, int]] = []
        self._published: OrderedDict[int, None] = OrderedDict()
        self._ckpt_pending: list[tuple[int, int]] = []
        # (request_id, record, seq_hashes still awaiting flush)
        self._ckpt_records: list[tuple[str, dict, set[int]]] = []
        self._onboarding = False
        # Memory ledger: queued publish/checkpoint blocks are device
        # references held outside the pool's refcounts, tagged per owner
        # class for the occupancy waterfall and the audit.
        self._mled = get_mem_ledger()
        pool.evict_hook = self._on_evict
        if publish_tier is not None:
            pool.commit_hook = self._on_commit

    # -- offload -----------------------------------------------------------
    def _on_evict(self, block_id: int, seq_hash: int) -> None:
        """Queue the eviction; the device copy happens in one batched
        transfer at flush_pending(). The already-stored dedup check is
        skipped for SHARED tiers (the remote store), whose answers can
        change under our feet; a redundant put is idempotent."""
        top = self.tiers[0]
        # A queued publish of this block is now stale: the slot can be
        # rewritten before the next flush extracts it. The eviction
        # write-back below carries the content to the tier cascade instead.
        if self._publish_pending:
            stale = [h for b, h in self._publish_pending if b == block_id]
            if stale:
                self._publish_pending = [
                    (b, h) for b, h in self._publish_pending if b != block_id]
                if self._mled.enabled:
                    for h in stale:
                        self._mled.unpin("prefix_publish", str(h))
        # Same staleness rule for queued checkpoint blocks: drop the pair
        # AND release any record waiting on its hash — the record still
        # writes (covering what did reach the store); a resume's onboard
        # walk simply stops at the first unreachable hash.
        if self._ckpt_pending:
            dropped = {h for b, h in self._ckpt_pending if b == block_id}
            if dropped:
                self._ckpt_pending = [
                    (b, h) for b, h in self._ckpt_pending if b != block_id]
                for _, _, waiting in self._ckpt_records:
                    waiting -= dropped
                if self._mled.enabled:
                    for h in dropped:
                        self._mled.unpin("stream_ckpt", str(h))
        if not getattr(top, "shared", False) and seq_hash in top:
            return
        self._pending.append((block_id, seq_hash))

    def _on_commit(self, block_id: int, seq_hash: int,
                   parent_hash: "int | None") -> None:
        """PrefixPool commit hook: queue a newly committed block for
        publish-on-commit. Imports are skipped (their content just came FROM
        the tiers), as is anything inside the bounded already-published
        window."""
        if self._onboarding or seq_hash in self._published:
            return
        self._published[seq_hash] = None
        while len(self._published) > self.PUBLISH_MEMORY:
            self._published.popitem(last=False)
        self._publish_pending.append((block_id, seq_hash))
        if self._mled.enabled:
            self._mled.pin("prefix_publish", str(seq_hash), 1)

    def flush_pending(self) -> int:
        """Extract all queued evictions — plus this flush's publish-on-commit
        and checkpoint batches — in one transfer; evictions store to the top
        tier, published blocks push to the publish tier. Must run before the
        evicted slots are rewritten (engine step / onboard inject)."""
        publish = self._publish_pending[: self.PUBLISH_PER_FLUSH]
        self._publish_pending = self._publish_pending[self.PUBLISH_PER_FLUSH:]
        ckpt = self._ckpt_pending[: self.CKPT_PER_FLUSH]
        self._ckpt_pending = self._ckpt_pending[self.CKPT_PER_FLUSH:]
        if self._mled.enabled:
            for _, h in publish:
                self._mled.unpin("prefix_publish", str(h))
            for _, h in ckpt:
                self._mled.unpin("stream_ckpt", str(h))
        if not self._pending and not publish and not ckpt:
            self._flush_ckpt_records(frozenset())
            return 0
        # Chaos: an error here propagates into the engine step — the
        # offload cascade failing is engine-fatal, not silently droppable.
        chaos.inject("kvbm.offload", blocks=len(self._pending))
        pending, self._pending = self._pending, []
        blocks = self.transfer.extract(
            self.runner.cache_k, self.runner.cache_v,
            [b for b, _ in pending] + [b for b, _ in publish] + [b for b, _ in ckpt])
        top = self.tiers[0]
        for (_, seq_hash), block in zip(pending, blocks):
            top.put(seq_hash, block)
        for (_, seq_hash), block in zip(publish, blocks[len(pending):]):
            # a remote put degrades to a drop when the store is unreachable
            self.publish_tier.put(seq_hash, block)
        if ckpt:
            sm = get_stream_ckpt_metrics()
            off = len(pending) + len(publish)
            for (_, seq_hash), block in zip(ckpt, blocks[off:]):
                self.ckpt_tier.put(seq_hash, block)
                sm.bytes.inc(int(block.nbytes))
        if self.ranks is not None:
            self.ranks.store([(top, h) for _, h in pending]
                             + [(self.publish_tier, h) for _, h in publish]
                             + [(self.ckpt_tier, h) for _, h in ckpt])
        self._flush_ckpt_records({h for _, h in ckpt})
        if publish:
            self.stats.published_blocks += len(publish)
            get_prefix_cache_metrics().published_blocks.inc(len(publish))
        self.stats.offloaded_blocks += len(pending)
        return len(pending)

    # -- stream checkpoints -------------------------------------------------
    def enqueue_stream_ckpt(self, request_id: str, record: dict,
                            pairs: "list[tuple[int, int]]") -> None:
        """Queue a stream's newly committed ``(block_id, seq_hash)`` pairs
        plus its StreamCheckpoint record. Blocks flush through the normal
        budgeted path; the record is held back until every hash it waits on
        has flushed, then written via ``ckpt_tier.put_stream_ckpt``."""
        if self.ckpt_tier is None:
            return
        queued = {h for _, h in self._ckpt_pending}
        fresh = [(b, h) for b, h in pairs if h not in queued]
        self._ckpt_pending.extend(fresh)
        if self._mled.enabled:
            for _, h in fresh:
                self._mled.pin("stream_ckpt", str(h), 1)
        self._ckpt_records.append((request_id, record, {h for _, h in pairs}))

    def _flush_ckpt_records(self, flushed: "frozenset[int] | set[int]") -> None:
        """Write every record whose block set is fully flushed (including
        records enqueued with no new blocks). Best-effort: a failed put is
        dropped — resume degrades to the previous checkpoint or reprompt."""
        if not self._ckpt_records:
            return
        sm = get_stream_ckpt_metrics()
        still: list[tuple[str, dict, set[int]]] = []
        for rid, record, waiting in self._ckpt_records:
            waiting -= flushed
            if waiting:
                still.append((rid, record, waiting))
                continue
            if self.ckpt_tier.put_stream_ckpt(rid, record):
                sm.writes.inc(1)
                sm.bytes.inc(len(msgpack.packb(record)))
        self._ckpt_records = still

    def delete_stream_ckpt(self, request_id: str) -> None:
        """Clean-finish reap: drop any queued record and delete the stored
        one — a finished stream must not be resumable."""
        if self.ckpt_tier is None:
            return
        self._ckpt_records = [
            (rid, rec, w) for rid, rec, w in self._ckpt_records if rid != request_id]
        self.ckpt_tier.del_stream_ckpt(request_id)

    def stage_blocks(self, pairs: "list[tuple[int, int]]") -> int:
        """Write-through ``(block_id, seq_hash)`` pairs into the tier cascade
        NOW, while their device slots are still intact — the session
        demotion path: a released pin's blocks go LRU-evictable at once, so
        queueing them like a normal eviction could extract a rewritten slot.
        Returns blocks staged (already-present hashes in a non-shared top
        tier are skipped). On transfer failure the queued pairs are rolled
        back so a later flush can't extract stale slots."""
        top = self.tiers[0]
        shared = getattr(top, "shared", False)
        queued = set(self._pending)
        fresh = [(b, h) for b, h in pairs
                 if (shared or h not in top) and (b, h) not in queued]
        if not fresh:
            return 0
        self._pending.extend(fresh)
        try:
            self.flush_pending()
        except Exception:
            self._pending = [p for p in self._pending if p not in set(fresh)]
            raise
        return len(fresh)

    def drain_publish(self) -> int:
        """Flush the whole publish-on-commit queue (budgeted slices until
        empty), plus any queued stream-checkpoint blocks/records. Called
        when the engine goes idle."""
        total = 0
        while self._publish_pending or self._ckpt_pending or self._ckpt_records:
            before = len(self._publish_pending)
            self.flush_pending()
            total += before - len(self._publish_pending)
        return total

    # -- onboard -----------------------------------------------------------
    def _lookup(self, seq_hash: int) -> np.ndarray | None:
        if self._looked is not None:
            self._looked.append(seq_hash)
        for tier in self.tiers:
            block = tier.get(seq_hash)
            if block is not None:
                return block
        return None

    def onboard(self, seq_hashes: list[int]) -> int:
        """Bring the longest tier-cached prefix of ``seq_hashes`` onto the
        device. Returns the number of blocks injected. The allocation inside
        may evict inactive device blocks → reentrant ``_on_evict`` (the
        evicted blocks are disjoint from the ones being loaded, and tier
        ``get`` returned copies)."""
        t0 = time.perf_counter()
        if self.ranks is not None:
            # every rank looks up what the leader's walk looked up, in order
            self._looked = []
            try:
                plan = plan_onboard(self.pool, seq_hashes, self._lookup)
            finally:
                looked, self._looked = self._looked, None
            plan = plan[: self.ranks.lookup(looked, len(plan), self.vote_plans)]
        else:
            plan = plan_onboard(self.pool, seq_hashes, self._lookup)
        self._onboarding = True  # imported commits must not re-publish
        try:
            n = inject_and_commit(self.runner, self.pool, self.transfer, plan,
                                  flush=self.flush_pending)
        finally:
            self._onboarding = False
        self.stats.onboarded_blocks += n
        if seq_hashes:
            get_prefix_cache_metrics().record_onboard(
                found_blocks=len(plan), imported_blocks=n,
                block_size=self.pool.block_size,
                seconds=time.perf_counter() - t0)
        return n

    def queue_live_ids(self) -> dict[str, set[str]]:
        """Mem-ledger audit live sets: owner ids currently held by the
        publish / stream-checkpoint queues (string-keyed sequence hashes,
        matching the pin tags above)."""
        return {
            "prefix_publish": {str(h) for _, h in self._publish_pending},
            "stream_ckpt": {str(h) for _, h in self._ckpt_pending},
        }

    def snapshot(self) -> dict:
        out = self.stats.to_dict()
        for tier in self.tiers:
            out[tier.name] = {"blocks": len(tier), **tier.stats.to_dict()}
        return out
