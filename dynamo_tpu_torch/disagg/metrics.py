"""Prometheus family for the streamed KV handoff (dynamo_kv_transfer_*) —
copy of ``dynamo_tpu/disagg/metrics.py``.

The consumer-side overlap ratio is the fraction of a streamed transfer's
pull window that ran while the remote prefill was still computing (1.0 =
the transfer fully hid behind prefill, 0.0 = a serialized handoff).
Stage/pull/import byte counters and the per-wave size histogram say how
the bytes moved, phase by phase.

Registrations are idempotent (MetricsRegistry keys by name), so the
module-level singleton can be re-bound into a runtime's registry via
``install_kv_metrics``: workers call it so the family shows up on
/metrics; tests and library use fall back to a private registry. The
names are the JAX family's.
"""

from __future__ import annotations

from dynamo_tpu_torch.utils.metrics import MetricsRegistry

# Wave payloads are block-granular host copies: 64 KiB – 256 MiB spans the
# tiny-test to full-width range.
_WAVE_BYTES_BUCKETS = (
    65536.0, 262144.0, 1048576.0, 4194304.0, 16777216.0,
    67108864.0, 268435456.0, float("inf"),
)


class KvTransferMetrics:
    """The dynamo_kv_transfer_* family."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.overlap_ratio = registry.gauge(
            "kv_transfer_overlap_ratio",
            "Fraction of the last streamed KV pull that overlapped the "
            "remote prefill (1.0 = transfer fully hidden behind compute)")
        self.waves = registry.counter(
            "kv_transfer_waves_total",
            "Streamed KV handoff waves processed, by phase "
            "(stage|pull|import)")
        self.bytes = registry.counter(
            "kv_transfer_bytes_total",
            "Bytes moved by the streamed KV handoff, by phase "
            "(stage|pull|import)")
        self.wave_bytes = registry.histogram(
            "kv_transfer_wave_bytes",
            "Per-wave payload size of the streamed KV handoff (this rank's "
            "shard slice)", buckets=_WAVE_BYTES_BUCKETS)

    def record_wave(self, phase: str, nbytes: int) -> None:
        self.waves.inc(1, phase=phase)
        self.bytes.inc(nbytes, phase=phase)
        self.wave_bytes.observe(nbytes)


_metrics: KvTransferMetrics | None = None


def get_kv_metrics() -> KvTransferMetrics:
    global _metrics
    if _metrics is None:
        _metrics = KvTransferMetrics()
    return _metrics


def install_kv_metrics(registry: MetricsRegistry) -> KvTransferMetrics:
    """Re-home the singleton's metrics into ``registry`` (the worker's
    runtime registry) so the family is exposed on /metrics."""
    m = get_kv_metrics()
    m.bind(registry)
    return m
