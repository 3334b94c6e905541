"""Host (G2) and disk (G3) KV block tiers — port of
``dynamo_tpu/kvbm/pools.py``.

Each tier is a plain hash→block store:

- key: the block's *sequence hash* (chained prefix identity from
  dynamo_tpu_torch.tokens) — the same identity the JAX package uses, so a
  block cached by either package is addressable by the other.
- value: one host block in the format of kvbm/transfer.py.

Tiers chain: the host pool spills its LRU victim to an optional overflow
tier (disk, then remote) instead of dropping it. The disk tier's files and
MANIFEST are the JAX package's byte for byte (bf16 blocks as their bits),
so a directory written by one package is served by the other.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from dynamo_tpu_torch.engine.cache import KVCacheSpec
from dynamo_tpu_torch.kvbm.transfer import HOST_FLOAT, ensure_block_format
from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("kvbm")


@dataclass
class TierStats:
    lookups: int = 0
    hits: int = 0
    stores: int = 0
    evictions: int = 0

    def to_dict(self) -> dict:
        return {"lookups": self.lookups, "hits": self.hits,
                "stores": self.stores, "evictions": self.evictions}


def block_shape(spec: KVCacheSpec) -> tuple[int, ...]:
    """Host-side shape of one tiered block: the packed flat layout for
    quantized specs (``bytes_per_block()`` bytes), else
    ``[2, layers, block_size, kv_heads, head_dim]``."""
    if spec.quantized:
        return (spec.bytes_per_block(),)
    return (2, spec.num_layers, spec.block_size, spec.num_kv_heads, spec.head_dim)


def block_dtype(spec: KVCacheSpec) -> np.dtype:
    """Element dtype of the host-side block (uint8 for packed quantized,
    uint16 bits for bf16)."""
    if spec.quantized:
        return np.dtype(np.uint8)
    return np.dtype(HOST_FLOAT[spec.dtype])


class HostBlockPool:
    """Preallocated host-memory arena of KV blocks with LRU eviction: one
    contiguous allocation, blocks are slots in it, never reallocated."""

    name = "host"

    def __init__(self, spec: KVCacheSpec, capacity_blocks: int,
                 overflow=None):
        self.spec = spec
        self.capacity = capacity_blocks
        self.overflow = overflow
        self._arena = np.zeros((capacity_blocks, *block_shape(spec)), block_dtype(spec))
        self._free: list[int] = list(range(capacity_blocks - 1, -1, -1))
        self._lru: OrderedDict[int, int] = OrderedDict()  # seq_hash -> slot, LRU order
        self.stats = TierStats()
        self._mled = get_mem_ledger()

    def __contains__(self, seq_hash: int) -> bool:
        return seq_hash in self._lru

    def __len__(self) -> int:
        return len(self._lru)

    def occupancy(self) -> tuple[int, int]:
        """(resident blocks, resident bytes) — the mem-ledger tier row."""
        n = len(self._lru)
        return n, n * self.spec.bytes_per_block()

    def put(self, seq_hash: int, block: np.ndarray) -> None:
        if seq_hash in self._lru:
            self._lru.move_to_end(seq_hash)
            return
        block = ensure_block_format(block, self.spec)
        if not self._free:
            victim_hash, victim_slot = self._lru.popitem(last=False)
            self.stats.evictions += 1
            if self._mled.enabled:
                self._mled.record_churn("host", "lru", 1)
            if self.overflow is not None:
                self.overflow.put(victim_hash, self._arena[victim_slot])
            self._free.append(victim_slot)
        slot = self._free.pop()
        self._arena[slot] = block
        self._lru[seq_hash] = slot
        self.stats.stores += 1

    def get(self, seq_hash: int) -> np.ndarray | None:
        """Return a *copy* of the block (the arena slot may be recycled by a
        later put while the caller still holds the data)."""
        self.stats.lookups += 1
        slot = self._lru.get(seq_hash)
        if slot is None:
            return None
        self._lru.move_to_end(seq_hash)
        self.stats.hits += 1
        return self._arena[slot].copy()


class DiskBlockPool:
    """Local-disk KV block tier (G3): one file per block, byte-budgeted LRU.

    Files are named ``<seq_hash:016x>.kvb`` and hold the raw block bytes;
    the index is rebuilt from the directory at startup, so cached KV
    survives engine restarts. The MANIFEST records the model identity and
    the storage layout in the JAX package's words (``spec.dtype`` and
    ``spec.kv_dtype`` are the same strings there); any mismatch purges the
    tier."""

    name = "disk"

    def __init__(self, spec: KVCacheSpec, path: str | Path,
                 capacity_bytes: int = 1 << 30, fingerprint: str = "",
                 overflow=None):
        self.spec = spec
        self.overflow = overflow
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.capacity_bytes = capacity_bytes
        self._block_bytes = int(np.prod(block_shape(spec))) * block_dtype(spec).itemsize
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.stats = TierStats()
        self._mled = get_mem_ledger()
        manifest = self.path / "MANIFEST"
        want = f"{fingerprint}|{block_shape(spec)}|{spec.dtype}|{spec.kv_dtype}"
        have = manifest.read_text() if manifest.exists() else None
        if have != want:
            if have is not None:
                log.warning("disk KV tier %s manifest mismatch; purging", self.path)
            for f in self.path.glob("*.kvb"):
                f.unlink(missing_ok=True)
            manifest.write_text(want)
        for f in sorted(self.path.glob("*.kvb"), key=lambda p: p.stat().st_mtime):
            if f.stat().st_size == self._block_bytes:
                self._lru[int(f.stem, 16)] = None
            else:  # truncated write from a crashed process
                f.unlink(missing_ok=True)

    def __contains__(self, seq_hash: int) -> bool:
        return seq_hash in self._lru

    def __len__(self) -> int:
        return len(self._lru)

    def occupancy(self) -> tuple[int, int]:
        """(resident blocks, resident bytes) — the mem-ledger tier row."""
        n = len(self._lru)
        return n, n * self._block_bytes

    def _file(self, seq_hash: int) -> Path:
        return self.path / f"{seq_hash:016x}.kvb"

    def _read(self, seq_hash: int) -> np.ndarray | None:
        try:
            raw = np.fromfile(self._file(seq_hash), dtype=np.uint8)
        except OSError:
            return None
        if raw.size != self._block_bytes:  # truncated/concurrent write
            return None
        return raw.view(block_dtype(self.spec)).reshape(block_shape(self.spec))

    def put(self, seq_hash: int, block: np.ndarray) -> None:
        if seq_hash in self._lru:
            self._lru.move_to_end(seq_hash)
            return
        block = ensure_block_format(block, self.spec)
        while (len(self._lru) + 1) * self._block_bytes > self.capacity_bytes and self._lru:
            victim, _ = self._lru.popitem(last=False)
            if self._mled.enabled:
                self._mled.record_churn("disk", "byte_budget", 1)
            if self.overflow is not None:
                # read directly (not self.get — that would touch the LRU)
                raw = self._read(victim)
                if raw is not None:
                    self.overflow.put(victim, raw)
            self._file(victim).unlink(missing_ok=True)
            self.stats.evictions += 1
        np.ascontiguousarray(block).view(np.uint8).tofile(self._file(seq_hash))
        self._lru[seq_hash] = None
        self.stats.stores += 1

    def get(self, seq_hash: int) -> np.ndarray | None:
        self.stats.lookups += 1
        if seq_hash not in self._lru:
            return None
        block = self._read(seq_hash)
        if block is None:
            self._lru.pop(seq_hash, None)
            self._file(seq_hash).unlink(missing_ok=True)
            return None
        self._lru.move_to_end(seq_hash)
        self.stats.hits += 1
        return block
