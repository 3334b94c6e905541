"""QoS configuration: priority classes, pressure thresholds, degradation knobs.

Copy of ``dynamo_tpu/qos/config.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Highest first. Unknown classes are treated as "standard" for shedding
# decisions but still get their own WDRR lane (weight 1).
PRIORITY_CLASSES: tuple[str, ...] = ("interactive", "standard", "batch")

DEFAULT_WEIGHTS: dict[str, int] = {"interactive": 8, "standard": 4, "batch": 1}


def class_rank(priority: str) -> int:
    """0 = most important. Unknown classes rank with 'standard'."""
    try:
        return PRIORITY_CLASSES.index(priority)
    except ValueError:
        return PRIORITY_CLASSES.index("standard")


@dataclass
class QosConfig:
    enabled: bool = True
    default_priority: str = "standard"
    weights: dict[str, int] = field(default_factory=lambda: dict(DEFAULT_WEIGHTS))

    # Per-client token bucket; rate 0 disables rate limiting.
    rate_limit_rps: float = 0.0
    rate_burst: float = 10.0
    max_tracked_clients: int = 10_000

    # Pressure thresholds, evaluated against aggregated engine stats.
    # Queue depths are per-worker averages so the knobs don't need
    # retuning when the fleet scales.
    degrade_queue_depth: int = 16   # soft: clamp max_tokens, disable spec
    degrade_kv_usage: float = 0.85
    shed_queue_depth: int = 32      # shed "batch" class with 429
    shed_kv_usage: float = 0.95
    max_queue_depth: int = 64       # only "interactive" admitted (429 others)
    min_kv_headroom: float = 0.02
    full_queue_depth: int = 128     # 503 everything

    # Graceful degradation.
    clamp_max_tokens: int = 256

    # Deadlines.
    default_deadline_ms: float | None = None

    # Hint returned in Retry-After when we cannot estimate drain time.
    retry_after_s: float = 1.0
