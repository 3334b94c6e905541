"""Request-level quality-of-service: admission control, priority-weighted
fair queueing, deadline propagation, and load shedding.

The gateway sits in the frontend's request path; the WDRR queue slots in
front of the engine scheduler; deadline annotations ride the existing
PreprocessedRequest wire format so every hop (frontend → router → worker
→ engine) can cancel expired work.

Copy of ``dynamo_tpu/qos/__init__.py``.
"""

from dynamo_tpu_torch.qos.admission import AdmissionController, Decision, EngineLoad, aggregate_stats
from dynamo_tpu_torch.qos.config import DEFAULT_WEIGHTS, PRIORITY_CLASSES, QosConfig, class_rank
from dynamo_tpu_torch.qos.deadline import (
    DEADLINE_KEY,
    NO_SPEC_KEY,
    PRIORITY_KEY,
    deadline_of,
    expired,
    priority_of,
    remaining_s,
)
from dynamo_tpu_torch.qos.gateway import QosGateway
from dynamo_tpu_torch.qos.token_bucket import ClientRateLimiter, TokenBucket
from dynamo_tpu_torch.qos.wdrr import WdrrQueue

__all__ = [
    "AdmissionController",
    "ClientRateLimiter",
    "DEADLINE_KEY",
    "DEFAULT_WEIGHTS",
    "Decision",
    "EngineLoad",
    "NO_SPEC_KEY",
    "PRIORITY_CLASSES",
    "PRIORITY_KEY",
    "QosConfig",
    "QosGateway",
    "TokenBucket",
    "WdrrQueue",
    "aggregate_stats",
    "class_rank",
    "deadline_of",
    "expired",
    "priority_of",
    "remaining_s",
]
