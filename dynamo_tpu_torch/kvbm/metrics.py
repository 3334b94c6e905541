"""Prometheus family for the fleet-wide prefix cache (dynamo_prefix_cache_*) —
copy of ``dynamo_tpu/kvbm/metrics.py``.

One module covers both halves of the loop:

* **outcome** (engine side): every admission-time onboard against the
  kvbm tiers is a *lookup*; finding at least one block anywhere below the
  device is a *hit*; blocks actually scattered into the device pool count as
  *imported* and convert to *recompute-avoided tokens* at the engine's block
  size. ``import_seconds`` measures the whole onboard (tier fetch + device
  inject), beside the cost model's ``pull_seconds``.
* **decision** (router side): the route-vs-pull arbiter's verdict per
  scheduled request, labelled by action (``route`` | ``pull`` |
  ``recompute``).

Registrations are idempotent (MetricsRegistry keys by name), so the
module-level singleton can be re-bound into a runtime's registry via
``install_prefix_cache_metrics`` — workers and routers call it so the
family shows up on /metrics; tests and library use fall back to a private
registry. The names are the JAX family's.
"""

from __future__ import annotations

from dynamo_tpu_torch.utils.metrics import MetricsRegistry

# Imports span one-RTT tiny-test fetches to multi-hundred-block system
# prompts pulled over the DCN.
_IMPORT_SECONDS_BUCKETS = (
    0.0005, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    float("inf"),
)


class PrefixCacheMetrics:
    """The dynamo_prefix_cache_* family (the JAX package's names)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.lookups = registry.counter(
            "prefix_cache_lookups",
            "Admission-time prefix onboard attempts against the kvbm tiers")
        self.hits = registry.counter(
            "prefix_cache_hits",
            "Onboard attempts that found at least one prefix block in a "
            "tier below the device pool")
        self.imported_blocks = registry.counter(
            "prefix_cache_imported_blocks",
            "Prefix KV blocks scattered into the device pool instead of "
            "being recomputed")
        self.recompute_avoided_tokens = registry.counter(
            "prefix_cache_recompute_avoided_tokens",
            "Prompt tokens whose prefill was skipped because their KV "
            "blocks were imported from a cache tier")
        self.import_seconds = registry.histogram(
            "prefix_cache_import_seconds",
            "Wall seconds of one prefix onboard (tier fetch + device "
            "inject)", buckets=_IMPORT_SECONDS_BUCKETS)
        self.published_blocks = registry.counter(
            "prefix_cache_published_blocks",
            "Committed prefix blocks pushed to the shared remote tier by "
            "the publish-on-commit path")
        self.route_decisions = registry.counter(
            "prefix_cache_route_decisions",
            "Route-vs-pull arbiter verdicts, by action "
            "(route|pull|recompute)")

    def record_onboard(self, *, found_blocks: int, imported_blocks: int,
                       block_size: int, seconds: float) -> None:
        """One admission-time onboard outcome."""
        self.lookups.inc(1)
        if found_blocks > 0:
            self.hits.inc(1)
        if imported_blocks > 0:
            self.imported_blocks.inc(imported_blocks)
            self.recompute_avoided_tokens.inc(imported_blocks * block_size)
        self.import_seconds.observe(seconds)


_metrics: PrefixCacheMetrics | None = None


def get_prefix_cache_metrics() -> PrefixCacheMetrics:
    global _metrics
    if _metrics is None:
        _metrics = PrefixCacheMetrics()
    return _metrics


def install_prefix_cache_metrics(registry: MetricsRegistry) -> PrefixCacheMetrics:
    """Re-home the singleton's metrics into ``registry`` (the worker's or
    router's runtime registry) so the family is exposed on /metrics."""
    m = get_prefix_cache_metrics()
    m.bind(registry)
    return m
