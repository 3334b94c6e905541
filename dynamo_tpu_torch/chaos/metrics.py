"""Prometheus counter for injected faults (dynamo_chaos_injected_total).

Same install idiom as disagg/metrics.py: a module singleton backed by a
private registry until a process re-homes it into its runtime registry
(workers/frontends call ``install_chaos_metrics`` when chaos is enabled),
so injected faults show up on /metrics next to the symptoms they cause.
Name is cross-checked by tools/lint_metrics.py RECOVERY_METRICS.

Copy of ``dynamo_tpu/chaos/metrics.py``.
"""

from __future__ import annotations

from dynamo_tpu_torch.utils.metrics import MetricsRegistry


class ChaosMetrics:
    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.injected = registry.counter(
            "chaos_injected_total",
            "Faults injected by the chaos engine, by fault point and kind")

    def record(self, point: str, kind: str) -> None:
        self.injected.inc(1, point=point, kind=kind)


_metrics: ChaosMetrics | None = None


def get_chaos_metrics() -> ChaosMetrics:
    global _metrics
    if _metrics is None:
        _metrics = ChaosMetrics()
    return _metrics


def install_chaos_metrics(registry: MetricsRegistry) -> ChaosMetrics:
    m = get_chaos_metrics()
    m.bind(registry)
    return m
