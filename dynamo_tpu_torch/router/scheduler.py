"""KV-aware worker selection: cost + temperature softmax.

Fills the role of the reference's KvScheduler
(reference: lib/llm/src/kv_router/scheduler.rs:87 KvScheduler, :519 cost
formula ``overlap_weight * potential_prefill_blocks + decode_blocks``, :389
softmax_sample, :462 DefaultWorkerSelector, pluggable WorkerSelector trait
kv_router.rs:78).

Copy of ``dynamo_tpu/router/scheduler.py``.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Protocol

from dynamo_tpu_torch.router.indexer import OverlapScores, WorkerId


@dataclass
class WorkerLoad:
    """What the scheduler knows about one worker (from published
    ForwardPassMetrics + the local ActiveSequences predictor)."""

    worker_id: WorkerId
    active_blocks: int = 0        # predicted/reported blocks in use
    total_blocks: int = 1         # capacity
    num_waiting: int = 0

    @property
    def usage(self) -> float:
        return self.active_blocks / max(self.total_blocks, 1)


@dataclass
class SchedulingRequest:
    total_blocks: int                       # blocks in the incoming request
    overlaps: OverlapScores
    loads: dict[WorkerId, WorkerLoad]


class WorkerSelector(Protocol):
    def select(self, req: SchedulingRequest) -> WorkerId: ...


def softmax_sample(costs: dict[WorkerId, float], temperature: float,
                   rng: random.Random) -> WorkerId:
    """Sample a worker ∝ softmax(-cost / temperature); temperature→0 is
    argmin (reference: scheduler.rs:389)."""
    ids = list(costs)
    if temperature <= 1e-6:
        return min(ids, key=lambda w: (costs[w], w))
    lo = min(costs.values())
    weights = [math.exp(-(costs[w] - lo) / temperature) for w in ids]
    total = sum(weights)
    r = rng.random() * total
    acc = 0.0
    for w, wt in zip(ids, weights):
        acc += wt
        if r <= acc:
            return w
    return ids[-1]


@dataclass
class DefaultWorkerSelector:
    """cost = overlap_weight * potential_prefill_blocks + decode_blocks
    (reference: scheduler.rs:519)."""

    overlap_weight: float = 1.0
    temperature: float = 0.0
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    def select(self, req: SchedulingRequest) -> WorkerId:
        if not req.loads:
            raise ValueError("no workers to select from")
        costs: dict[WorkerId, float] = {}
        for wid, load in req.loads.items():
            overlap = req.overlaps.scores.get(wid, 0)
            potential_prefill = max(req.total_blocks - overlap, 0)
            costs[wid] = self.overlap_weight * potential_prefill + load.active_blocks
        return softmax_sample(costs, self.temperature, self.rng)


@dataclass
class KvScheduler:
    selector: WorkerSelector = field(default_factory=DefaultWorkerSelector)

    def schedule(self, total_blocks: int, overlaps: OverlapScores,
                 loads: dict[WorkerId, WorkerLoad]) -> WorkerId:
        return self.selector.select(SchedulingRequest(
            total_blocks=total_blocks, overlaps=overlaps, loads=loads))
