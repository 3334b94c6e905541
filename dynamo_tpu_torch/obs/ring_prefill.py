"""Prometheus family for the context-parallel ring prefill
(dynamo_ring_prefill_*) — copy of ``dynamo_tpu/obs/ring_prefill.py``.

An engine at sp > 1 arbitrates each step of fresh whole prompts: past the
ring-vs-chunked threshold (``EngineConfig.ring_prefill_threshold``, or
the break-even of obs/costmodel.py ``ring_prefill_break_even_tokens`` at
0) the step prefills as ONE seq-sharded ring chunk (ops/ring_attention.py);
shorter prompts, and steps whose rows do not all start at 0, take the
chunked path on every seq rank. This family makes the arbitration visible
on /metrics: how often each side won and how many prompt tokens the ring
carried.

Registrations are idempotent (MetricsRegistry keys by name), so the
module-level singleton can be re-bound into a runtime's registry
(``install_ring_prefill_metrics``: the worker and the launcher do at
sp > 1); library use falls back to a private registry. The names are the
JAX family's, cross-checked by tools/lint_metrics.py
``RING_PREFILL_METRICS``.
"""

from __future__ import annotations

from dynamo_tpu_torch.utils.metrics import MetricsRegistry


class RingPrefillMetrics:
    """The dynamo_ring_prefill_* family (the JAX package's names)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.invocations = registry.counter(
            "ring_prefill_invocations",
            "Prefill dispatches that ran the seq-sharded ring path")
        self.tokens = registry.counter(
            "ring_prefill_tokens",
            "Prompt tokens prefilled through ring attention")
        self.bypassed = registry.counter(
            "ring_prefill_bypassed",
            "Prefill dispatches on an sp>1 mesh that stayed on the "
            "chunked sequential path (below threshold or shape guard)")
        self.threshold_tokens = registry.gauge(
            "ring_prefill_threshold_tokens",
            "Engaged ring-vs-chunked token threshold (explicit knob or "
            "cost-model break-even)")


_metrics: RingPrefillMetrics | None = None


def get_ring_prefill_metrics() -> RingPrefillMetrics:
    global _metrics
    if _metrics is None:
        _metrics = RingPrefillMetrics()
    return _metrics


def install_ring_prefill_metrics(registry: MetricsRegistry) -> RingPrefillMetrics:
    """Re-home the singleton into a runtime registry (worker /metrics)."""
    m = get_ring_prefill_metrics()
    m.bind(registry)
    return m
