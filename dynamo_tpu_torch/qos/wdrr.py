"""Weighted deficit-round-robin queue, deque-compatible — copy of
``dynamo_tpu/qos/wdrr.py``.

Drop-in replacement for the scheduler's `waiting: deque[Seq]`: supports
the exact surface the scheduler uses — `append`, `appendleft` (preempt
resume), `q[0]` peek, `popleft`, `remove`, `in`, `len`, truthiness,
iteration — while serving classes by weighted DRR underneath.

Peek semantics: `q[0]` commits the DRR decision and caches the item so
the scheduler's peek-then-popleft admission pattern stays consistent
(the same item is peeked and popped even if enqueues happen between).
Preempted items pushed back via `appendleft` bypass DRR entirely: they
already held resources and must re-admit first to avoid losing work.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterator

from dynamo_tpu_torch.qos.config import DEFAULT_WEIGHTS, PRIORITY_CLASSES


class WdrrQueue:
    def __init__(self, key_fn: Callable[[Any], str] | None = None,
                 weights: dict[str, int] | None = None):
        self._key = key_fn or (lambda item: getattr(item, "qos_priority", "standard"))
        self._weights = {c: max(1, int(w)) for c, w in (weights or DEFAULT_WEIGHTS).items()}
        self._lanes: dict[str, deque] = {}
        self._order: list[str] = [c for c in PRIORITY_CLASSES if c in self._weights]
        for c in self._weights:
            if c not in self._order:
                self._order.append(c)
        for c in self._order:
            self._lanes[c] = deque()
        self._deficit: dict[str, float] = {c: 0.0 for c in self._order}
        self._idx = 0
        self._fresh = True  # rotation pointer just arrived at _order[_idx]
        self._resume: deque = deque()  # preempted items, served before all lanes
        self._peeked: Any = None
        self._has_peeked = False

    # -- enqueue ----------------------------------------------------------

    def _lane(self, cls: str) -> deque:
        lane = self._lanes.get(cls)
        if lane is None:
            lane = self._lanes[cls] = deque()
            self._order.append(cls)
            self._weights.setdefault(cls, 1)
            self._deficit[cls] = 0.0
        return lane

    def append(self, item: Any) -> None:
        self._lane(str(self._key(item))).append(item)

    def appendleft(self, item: Any) -> None:
        # Preserve deque semantics: item goes ahead of whatever q[0]
        # currently is, including an already-committed peek.
        if self._has_peeked:
            self._resume.appendleft(self._peeked)
            self._peeked, self._has_peeked = None, False
        self._resume.appendleft(item)

    # -- serve ------------------------------------------------------------

    def _advance(self) -> None:
        self._idx = (self._idx + 1) % len(self._order)
        self._fresh = True

    def _next(self) -> Any:
        """Commit the next item to serve (removes it from its lane)."""
        if self._has_peeked:
            return self._peeked
        if self._resume:
            self._peeked, self._has_peeked = self._resume.popleft(), True
            return self._peeked
        # Weight >= 1 guarantees a fresh visit to a non-empty lane serves,
        # so 2 passes over the rotation always suffice.
        for _ in range(2 * len(self._order)):
            cls = self._order[self._idx]
            lane = self._lanes[cls]
            if not lane:
                self._deficit[cls] = 0.0
                self._advance()
                continue
            if self._fresh:
                self._deficit[cls] += self._weights.get(cls, 1)
                self._fresh = False
            if self._deficit[cls] >= 1.0:
                self._deficit[cls] -= 1.0
                item = lane.popleft()
                if not lane:
                    self._deficit[cls] = 0.0
                    self._advance()
                self._peeked, self._has_peeked = item, True
                return item
            self._advance()
        raise IndexError("pop from empty WdrrQueue")

    def __getitem__(self, i: int) -> Any:
        if i != 0:
            raise IndexError("WdrrQueue only supports peeking index 0")
        if not self:
            raise IndexError("peek from empty WdrrQueue")
        return self._next()

    def popleft(self) -> Any:
        if not self:
            raise IndexError("pop from empty WdrrQueue")
        item = self._next()
        self._peeked, self._has_peeked = None, False
        return item

    # -- bookkeeping ------------------------------------------------------

    def remove(self, item: Any) -> None:
        if self._has_peeked and self._peeked is item:
            self._peeked, self._has_peeked = None, False
            return
        try:
            self._resume.remove(item)
            return
        except ValueError:
            pass
        for lane in self._lanes.values():
            try:
                lane.remove(item)
                return
            except ValueError:
                continue
        raise ValueError("WdrrQueue.remove(x): x not in queue")

    def __contains__(self, item: Any) -> bool:
        if self._has_peeked and self._peeked is item:
            return True
        if item in self._resume:
            return True
        return any(item in lane for lane in self._lanes.values())

    def __len__(self) -> int:
        n = (1 if self._has_peeked else 0) + len(self._resume)
        return n + sum(len(lane) for lane in self._lanes.values())

    def __bool__(self) -> bool:
        return self._has_peeked or bool(self._resume) or any(self._lanes.values())

    def __iter__(self) -> Iterator[Any]:
        if self._has_peeked:
            yield self._peeked
        yield from self._resume
        for cls in self._order:
            yield from self._lanes[cls]

    def depths(self) -> dict[str, int]:
        """Per-class queue depth (peeked/resume items counted in their class)."""
        out = {c: len(lane) for c, lane in self._lanes.items()}
        for item in list(self._resume) + ([self._peeked] if self._has_peeked else []):
            cls = str(self._key(item))
            out[cls] = out.get(cls, 0) + 1
        return out
