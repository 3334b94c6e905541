"""Device block pool with prefix caching, refcounts and LRU eviction —
copy of ``dynamo_tpu/engine/prefix_pool.py``.

- Active blocks are refcounted (shared across requests via prefix matching).
- A block whose refcount drops to zero but which holds *committed* content
  (a full block with a sequence hash) parks in an LRU **inactive** pool —
  still matchable, evicted only on allocation pressure.
- Commit/evict emit BlockStored/BlockRemoved KV events that feed the
  KV-aware router (router/publisher.py).

Device-tier eviction churn feeds the memory ledger (obs/mem_ledger.py) as
in the JAX pool, and the KVBM hooks (``evict_hook``, ``commit_hook``) feed
the offload manager (kvbm/offload.py).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from dynamo_tpu_torch.engine.errors import NoFreeBlocks
from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
from dynamo_tpu_torch.router.events import BlockRemoved, BlockStored, KvCacheEvent


class PrefixPool:
    def __init__(self, num_blocks: int, block_size: int,
                 event_sink: Callable[[KvCacheEvent], None] | None = None,
                 enable_prefix_caching: bool = True):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._event_sink = event_sink
        # Called as evict_hook(block_id, seq_hash) *before* an evicted
        # committed block's id is reused — the KVBM offload manager's
        # write-back point (kvbm/offload.py).
        self.evict_hook: Callable[[int, int], None] | None = None
        # Called as commit_hook(block_id, seq_hash, parent_hash) after a
        # block's content hash registers — the KVBM publish-on-commit point.
        # Fires only for the canonical (first) commit of a hash.
        self.commit_hook: Callable[[int, int, "int | None"], None] | None = None
        # block 0 reserved (trash)
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._refcount: dict[int, int] = {}
        self._hash_of: dict[int, int] = {}          # block_id -> seq_hash (committed)
        self._by_hash: dict[int, int] = {}          # seq_hash -> block_id
        self._inactive: OrderedDict[int, None] = OrderedDict()  # block_id -> LRU order
        # Memory ledger (obs/mem_ledger.py): device-tier eviction churn is
        # recorded where it happens. _churn_cause distinguishes pressure
        # evictions from the deliberate clear() sweep.
        self._mled = get_mem_ledger()
        self._churn_cause = "allocation_pressure"

    # -- introspection -------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._inactive)

    @property
    def num_free_raw(self) -> int:
        """Free-list blocks only (never-written or fully released)."""
        return len(self._free)

    @property
    def num_inactive(self) -> int:
        """Committed-but-unreferenced blocks parked in the LRU."""
        return len(self._inactive)

    @property
    def usage(self) -> float:
        return 1.0 - self.num_free / max(self.num_blocks - 1, 1)

    def cached_block_count(self) -> int:
        return len(self._by_hash)

    def has_hash(self, seq_hash: int) -> bool:
        return seq_hash in self._by_hash

    def block_for_hash(self, seq_hash: int) -> int | None:
        return self._by_hash.get(seq_hash)

    def touch(self, seq_hash: int) -> None:
        """Refresh an inactive cached block to MRU so an imminent allocation
        burst doesn't evict it (KVBM onboarding protects the on-device part
        of a chain it is about to extend)."""
        bid = self._by_hash.get(seq_hash)
        if bid is not None and bid in self._inactive:
            self._inactive.move_to_end(bid)

    # -- events --------------------------------------------------------------
    def _emit(self, ev: KvCacheEvent) -> None:
        if self._event_sink is not None:
            self._event_sink(ev)

    # -- allocation ----------------------------------------------------------
    def allocate(self, n: int) -> list[int]:
        """Allocate n uncommitted blocks (refcount 1), evicting LRU inactive
        committed blocks if the free list runs dry."""
        if n > self.num_free:
            raise NoFreeBlocks(f"need {n} blocks, {self.num_free} free/evictable")
        out = []
        for _ in range(n):
            if self._free:
                bid = self._free.pop()
            else:
                bid = self._evict_one()
            self._refcount[bid] = 1
            out.append(bid)
        return out

    def _evict_one(self) -> int:
        bid, _ = self._inactive.popitem(last=False)  # oldest
        h = self._hash_of.pop(bid, None)
        if h is not None:
            if self.evict_hook is not None:
                self.evict_hook(bid, h)
            del self._by_hash[h]
            if self._mled.enabled:
                self._mled.record_churn("device", self._churn_cause, 1)
            self._emit(BlockRemoved(block_hashes=(h,)))
        return bid

    # -- prefix matching -----------------------------------------------------
    def match_prefix(self, seq_hashes: list[int]) -> list[int]:
        """Return block ids for the longest cached prefix of ``seq_hashes``,
        increffing each matched block (caller owns a reference)."""
        if not self.enable_prefix_caching:
            return []
        out: list[int] = []
        for h in seq_hashes:
            bid = self._by_hash.get(h)
            if bid is None:
                break
            self._ref(bid)
            out.append(bid)
        return out

    def _ref(self, bid: int) -> None:
        rc = self._refcount.get(bid, 0)
        if rc == 0 and bid in self._inactive:
            del self._inactive[bid]
        self._refcount[bid] = rc + 1

    # -- commit / release ----------------------------------------------------
    def commit(self, bid: int, seq_hash: int, parent_hash: int | None = None) -> None:
        """Register a now-full block's content hash (emits BlockStored).
        If the hash is already cached by another block, this block stays
        uncommitted (the canonical copy wins; dedup is at match time)."""
        if not self.enable_prefix_caching:
            return
        if seq_hash in self._by_hash:
            return
        self._by_hash[seq_hash] = bid
        self._hash_of[bid] = seq_hash
        if self.commit_hook is not None:
            self.commit_hook(bid, seq_hash, parent_hash)
        self._emit(BlockStored(block_hashes=(seq_hash,), parent_hash=parent_hash))

    def release(self, block_ids: list[int]) -> None:
        """Drop one reference per block; committed blocks park in the LRU
        inactive pool, uncommitted blocks return to the free list."""
        for bid in block_ids:
            rc = self._refcount.get(bid, 0)
            if rc <= 0:
                raise ValueError(f"double free of block {bid}")
            rc -= 1
            self._refcount[bid] = rc
            if rc == 0:
                del self._refcount[bid]
                if bid in self._hash_of:
                    self._inactive[bid] = None
                    self._inactive.move_to_end(bid)
                else:
                    self._free.append(bid)

    def clear(self) -> None:
        """Drop all cached (inactive) blocks. A deliberate clear drops
        content outright (no write-back offload)."""
        hook, self.evict_hook = self.evict_hook, None
        self._churn_cause = "clear"
        try:
            while self._inactive:
                self._free.append(self._evict_one())
        finally:
            self.evict_hook = hook
            self._churn_cause = "allocation_pressure"
