"""Global KV-block index: which workers hold which prefix blocks.

Fills the role of the reference's RadixTree indexer
(reference: lib/llm/src/kv_router/indexer.rs:336 RadixTree, :463
find_matches, :472 apply_event, :628 worker removal). Because block
identities are *chained sequence hashes* (a hash fixes its whole prefix),
the radix tree flattens to a hash→node map with parent links — matching a
request is a straight walk down its own hash chain. O(1) per block, no
string-key tree needed.

``ApproxKvIndexer`` (reference: kv_router/approx.rs) needs no worker events:
it assumes the blocks of a routed request live on the chosen worker for a
TTL — used when engines can't publish events.

Copy of ``dynamo_tpu/router/indexer.py``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

from dynamo_tpu_torch.router.events import BlockRemoved, BlockStored, RouterEvent

WorkerId = int


@dataclass
class OverlapScores:
    """Per-worker count of contiguous prefix blocks already resident.
    (reference: indexer.rs OverlapScores)"""

    scores: dict[WorkerId, int] = field(default_factory=dict)
    total_blocks: int = 0  # blocks in the query
    # Contiguous leading chain blocks resident on ANY worker — longer than
    # any single worker's score when the chain is split across the fleet.
    # This is the route-vs-pull arbiter's pull ceiling: with the global
    # prefix cache on, publish-on-commit mirrors every committed block into
    # the shared remote store, so "some worker holds it" ⇒ "a cold worker
    # can import it" (router/arbiter.py).
    chain_depth: int = 0

    def best(self) -> int:
        return max(self.scores.values(), default=0)


@dataclass
class _Node:
    workers: set[WorkerId] = field(default_factory=set)
    parent: int | None = None


class RadixIndexer:
    def __init__(self) -> None:
        self._nodes: dict[int, _Node] = {}
        self._worker_hashes: dict[WorkerId, set[int]] = defaultdict(set)
        self.events_applied = 0
        # Bumped on EVERY mutation (events AND worker purges) — the snapshot
        # dirty-check keys on this, so a dead worker's removal re-dumps too.
        self.version = 0

    # ------------------------------------------------------------------
    def apply_event(self, ev: RouterEvent) -> None:
        self.events_applied += 1
        self.version += 1
        if isinstance(ev.event, BlockStored):
            parent = ev.event.parent_hash
            for h in ev.event.block_hashes:
                node = self._nodes.get(h)
                if node is None:
                    node = self._nodes[h] = _Node(parent=parent)
                node.workers.add(ev.worker_id)
                self._worker_hashes[ev.worker_id].add(h)
                parent = h
        elif isinstance(ev.event, BlockRemoved):
            for h in ev.event.block_hashes:
                node = self._nodes.get(h)
                if node is None:
                    continue
                node.workers.discard(ev.worker_id)
                self._worker_hashes[ev.worker_id].discard(h)
                if not node.workers:
                    del self._nodes[h]

    def remove_worker(self, worker_id: WorkerId) -> None:
        """Purge a dead worker (reference: indexer.rs:628)."""
        self.version += 1
        for h in self._worker_hashes.pop(worker_id, set()):
            node = self._nodes.get(h)
            if node is not None:
                node.workers.discard(worker_id)
                if not node.workers:
                    del self._nodes[h]

    # ------------------------------------------------------------------
    def find_matches(self, seq_hashes: list[int]) -> OverlapScores:
        """Walk the request's own hash chain; a worker's score is the length
        of the contiguous prefix it holds (reference: find_matches)."""
        out = OverlapScores(total_blocks=len(seq_hashes))
        active: set[WorkerId] | None = None
        for depth, h in enumerate(seq_hashes, start=1):
            node = self._nodes.get(h)
            if node is None or not node.workers:
                break
            out.chain_depth = depth  # the chain exists SOMEWHERE up to here
            if active is not None and not active:
                continue  # per-worker contiguity already broken fleet-wide
            holders = node.workers if active is None else (active & node.workers)
            if holders:
                for w in holders:
                    out.scores[w] = depth
            # Workers that dropped out keep their previous depth; the walk
            # continues for chain_depth even when no single worker holds
            # the whole prefix.
            active = holders
        return out

    # ------------------------------------------------------------------
    def dump_events(self) -> list[RouterEvent]:
        """Serialize current state as stored-events so a new router replica
        can warm-start (reference: indexer.rs dump_tree_as_events / the
        radix-bucket snapshot)."""
        events: list[RouterEvent] = []
        for wid, hashes in self._worker_hashes.items():
            for h in hashes:
                node = self._nodes.get(h)
                events.append(RouterEvent(
                    worker_id=wid,
                    event=BlockStored(block_hashes=(h,), parent_hash=node.parent if node else None),
                ))
        return events

    def block_count(self) -> int:
        return len(self._nodes)

    def worker_block_count(self, worker_id: WorkerId) -> int:
        return len(self._worker_hashes.get(worker_id, ()))


class ApproxKvIndexer:
    """Event-free approximation: assumes routed blocks stay resident for a
    TTL on the worker the request went to (reference: approx.rs)."""

    def __init__(self, ttl_s: float = 120.0):
        self.ttl_s = ttl_s
        self._entries: dict[int, dict[WorkerId, float]] = defaultdict(dict)

    def note_routed(self, seq_hashes: list[int], worker_id: WorkerId, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        for h in seq_hashes:
            self._entries[h][worker_id] = now + self.ttl_s

    def find_matches(self, seq_hashes: list[int], now: float | None = None) -> OverlapScores:
        now = time.monotonic() if now is None else now
        out = OverlapScores(total_blocks=len(seq_hashes))
        for depth, h in enumerate(seq_hashes, start=1):
            holders = {w for w, exp in self._entries.get(h, {}).items() if exp > now}
            if not holders:
                break
            out.chain_depth = depth
            for w in holders:
                out.scores[w] = depth
        return out
