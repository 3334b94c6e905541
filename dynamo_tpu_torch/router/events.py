"""KV cache events: workers → router.

Reference: lib/llm/src/kv_router/protocols.rs — workers publish
block-stored / block-removed events keyed by chained sequence hashes; routers
fold them into a global radix index. Events serialize as plain dicts
(msgpack/json) on the message plane.

Copy of ``dynamo_tpu/router/events.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union


@dataclass(frozen=True)
class BlockStored:
    """Blocks newly resident on a worker. ``block_hashes`` are *sequence*
    hashes (prefix-chained); ``parent_hash`` is the seq hash of the block
    preceding block_hashes[0] (None at sequence start)."""

    block_hashes: tuple[int, ...]
    parent_hash: int | None = None
    token_ids: tuple[int, ...] = ()   # optional: tokens covered (debug/recorder)

    def to_dict(self) -> dict:
        return {
            "type": "stored",
            "block_hashes": list(self.block_hashes),
            "parent_hash": self.parent_hash,
        }


@dataclass(frozen=True)
class BlockRemoved:
    block_hashes: tuple[int, ...]

    def to_dict(self) -> dict:
        return {"type": "removed", "block_hashes": list(self.block_hashes)}


KvCacheEvent = Union[BlockStored, BlockRemoved]


@dataclass(frozen=True)
class RouterEvent:
    """An event attributed to a worker (what the router consumes).
    Reference: kv_router/indexer.rs RouterEvent."""

    worker_id: int
    event: KvCacheEvent
    event_id: int = 0

    def to_dict(self) -> dict:
        return {"worker_id": self.worker_id, "event_id": self.event_id, "event": self.event.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "RouterEvent":
        ev = d["event"]
        if ev["type"] == "stored":
            event: KvCacheEvent = BlockStored(
                block_hashes=tuple(ev["block_hashes"]), parent_hash=ev.get("parent_hash")
            )
        else:
            event = BlockRemoved(block_hashes=tuple(ev["block_hashes"]))
        return cls(worker_id=d["worker_id"], event=event, event_id=d.get("event_id", 0))
