"""Route-vs-pull-vs-recompute arbitration for the fleet-wide prefix cache.

When workers publish committed prefix blocks to the shared G4 remote store
(``global_prefix_cache``), the router has a third option beyond "route to
the warmest worker": send the request to a *cold* worker and let its
admission-time onboard pull the published blocks over the DCN. Which plan
wins is a pure roofline question — recompute burns prefill FLOPs at the
device's MFU, a pull burns wire bytes at DCN bandwidth plus a fixed setup
cost — so the arbiter prices all three against the same
``PrefixCacheCost`` (obs/costmodel.py) plus a crude per-worker queue
estimate, and picks the cheapest.

The function is deliberately pure (no router state, no clocks) so unit
tests can hand-compute break-evens (tests/test_prefix_cache.py).

Copy of ``dynamo_tpu/router/arbiter.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from dynamo_tpu_torch.obs.costmodel import PrefixCacheCost
from dynamo_tpu_torch.router.indexer import OverlapScores, WorkerId
from dynamo_tpu_torch.router.scheduler import WorkerLoad

ACTIONS = ("route", "pull", "recompute")

# Tie-break precedence: at equal predicted seconds, prefer the plan that
# moves the least data — recompute beats route beats pull. A plan only
# wins by being strictly cheaper, so "do something fancy" always has to
# pay for itself.
_PRECEDENCE = {"recompute": 0, "route": 1, "pull": 2}


@dataclass(frozen=True)
class RouteDecision:
    """The arbiter's verdict for one request."""

    worker_id: WorkerId
    overlap_blocks: int       # prefix blocks already resident on worker_id
    action: str               # "route" | "pull" | "recompute"
    pull_blocks: int          # blocks worker_id is expected to import (pull)
    predicted_seconds: float  # queue + import + recompute estimate of the plan


def arbitrate(
    total_blocks: int,
    overlaps: OverlapScores,
    loads: dict[WorkerId, WorkerLoad],
    cost: PrefixCacheCost,
) -> RouteDecision:
    """Price three plans and return the cheapest:

    * **route**: send to the worker holding the longest resident prefix;
      recompute only its miss tail.
    * **pull**: send to the least-queued worker; its onboard imports the
      globally-available chain (``overlaps.chain_depth`` blocks — resident
      *somewhere* in the fleet, hence published to the shared store) and
      recomputes past it.
    * **recompute**: send to the least-queued worker and just prefill.

    Queue time is modelled as the worker's active blocks re-expressed as
    prefill-seconds (``active_blocks * block_size * seconds_per_token``) —
    a deliberately crude backlog proxy, but it is measured in the same
    unit as the transfer/recompute terms so the comparison stays honest.
    """
    if not loads:
        raise ValueError("no workers to arbitrate over")
    bs = cost.block_size
    spt = cost.seconds_per_token

    def queue_s(w: WorkerId) -> float:
        return loads[w].active_blocks * bs * spt

    def overlap(w: WorkerId) -> int:
        return min(overlaps.scores.get(w, 0), total_blocks)

    # Warmest worker (ties: shorter queue, then id — deterministic).
    holder = min(loads, key=lambda w: (-overlap(w), loads[w].active_blocks, w))
    # Least-queued worker (ties: more overlap, then id).
    cold = min(loads, key=lambda w: (queue_s(w), -overlap(w), w))
    # Blocks available *somewhere* — the pull ceiling. chain_depth counts
    # contiguous chain blocks held by any worker, which publish-on-commit
    # mirrors into the shared store.
    avail = min(overlaps.chain_depth, total_blocks)

    plans: list[tuple[float, str, WorkerId, int, int]] = [
        (queue_s(holder)
         + cost.recompute_seconds((total_blocks - overlap(holder)) * bs),
         "route", holder, overlap(holder), 0),
        (queue_s(cold)
         + cost.recompute_seconds((total_blocks - overlap(cold)) * bs),
         "recompute", cold, overlap(cold), 0),
    ]
    if avail > overlap(cold):
        pull_blocks = avail - overlap(cold)
        plans.append(
            (queue_s(cold) + cost.pull_seconds(pull_blocks)
             + cost.recompute_seconds((total_blocks - avail) * bs),
             "pull", cold, overlap(cold), pull_blocks))

    secs, action, wid, ov, pulled = min(
        plans, key=lambda p: (p[0], _PRECEDENCE[p[1]]))
    return RouteDecision(worker_id=wid, overlap_blocks=ov, action=action,
                         pull_blocks=pulled, predicted_seconds=secs)
