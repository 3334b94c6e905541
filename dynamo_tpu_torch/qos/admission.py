"""Capacity-aware admission: turn live engine stats into admit/shed decisions.

Stats arrive in two shapes depending on deployment: a flat engine dict
(`{"num_waiting": ..., "kv_usage": ...}`) when the frontend wraps an
engine directly, or the watcher shape (`{"workers": {wid: stats}}`)
when fed by the KV-metrics watcher. `aggregate_stats` normalizes both.

Copy of ``dynamo_tpu/qos/admission.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

from dynamo_tpu_torch.qos.config import QosConfig, class_rank

# Pressure levels, low to high.
OK, DEGRADE, SHED, OVERLOAD, FULL = 0, 1, 2, 3, 4

_LEVEL_NAMES = {OK: "ok", DEGRADE: "degrade", SHED: "shed",
                OVERLOAD: "overload", FULL: "full"}


@dataclass
class EngineLoad:
    queue_depth: float = 0.0      # per-worker average waiting requests
    running: float = 0.0
    kv_usage: float = 0.0         # max across workers, 0..1
    kv_total_blocks: float = 0.0
    workers: int = 0
    known: bool = False           # False → no signal yet, fail open


@dataclass
class Decision:
    admitted: bool
    status: int = 200
    reason: str = ""              # "" | "rate_limit" | "shed" | "overload" | "deadline"
    retry_after_s: float = 0.0
    degrade: bool = False         # clamp max_tokens / disable spec
    pressure: int = OK

    @property
    def pressure_name(self) -> str:
        return _LEVEL_NAMES.get(self.pressure, "ok")


def _flat_load(stats: Mapping[str, Any]) -> EngineLoad:
    return EngineLoad(
        queue_depth=float(stats.get("num_waiting", 0) or 0),
        running=float(stats.get("num_running", 0) or 0),
        kv_usage=float(stats.get("kv_usage", 0.0) or 0.0),
        kv_total_blocks=float(stats.get("kv_total_blocks", 0) or 0),
        workers=1,
        known=True,
    )


def aggregate_stats(stats: Mapping[str, Any] | None) -> EngineLoad:
    """Normalize either stats shape into a single EngineLoad."""
    if not stats:
        return EngineLoad()
    workers = stats.get("workers")
    if isinstance(workers, Mapping) and workers:
        loads = [_flat_load(w) for w in workers.values() if isinstance(w, Mapping)]
        if not loads:
            return EngineLoad()
        n = len(loads)
        return EngineLoad(
            queue_depth=sum(l.queue_depth for l in loads) / n,
            running=sum(l.running for l in loads),
            kv_usage=max(l.kv_usage for l in loads),
            kv_total_blocks=sum(l.kv_total_blocks for l in loads),
            workers=n,
            known=True,
        )
    if "num_waiting" in stats or "kv_usage" in stats or "num_running" in stats:
        return _flat_load(stats)
    return EngineLoad()


class AdmissionController:
    """Maps (priority class, engine load) to an admit/degrade/shed decision."""

    def __init__(self, cfg: QosConfig):
        self.cfg = cfg

    def pressure(self, load: EngineLoad) -> int:
        if not load.known:
            return OK
        c = self.cfg
        headroom = 1.0 - load.kv_usage
        if load.queue_depth >= c.full_queue_depth:
            return FULL
        if load.queue_depth >= c.max_queue_depth or headroom < c.min_kv_headroom:
            return OVERLOAD
        if load.queue_depth >= c.shed_queue_depth or load.kv_usage >= c.shed_kv_usage:
            return SHED
        if load.queue_depth >= c.degrade_queue_depth or load.kv_usage >= c.degrade_kv_usage:
            return DEGRADE
        return OK

    def _retry_after(self, load: EngineLoad) -> float:
        # Crude drain estimate: half the queue at ~1 req/s/worker, floored
        # at the configured hint. Good enough to spread retries out.
        base = self.cfg.retry_after_s
        if load.workers > 0 and load.queue_depth > 0:
            return max(base, round(load.queue_depth / (2.0 * load.workers), 1))
        return base

    def evaluate(self, priority: str, load: EngineLoad) -> Decision:
        level = self.pressure(load)
        rank = class_rank(priority)
        if level >= FULL:
            return Decision(False, 503, "overload", self._retry_after(load), pressure=level)
        if level >= OVERLOAD and rank > class_rank("interactive"):
            return Decision(False, 429, "overload", self._retry_after(load), pressure=level)
        if level >= SHED and rank >= class_rank("batch"):
            return Decision(False, 429, "shed", self._retry_after(load), pressure=level)
        return Decision(True, 200, "", 0.0, degrade=level >= DEGRADE, pressure=level)
