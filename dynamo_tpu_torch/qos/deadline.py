"""Deadline and priority annotations on the request wire format — copy of
``dynamo_tpu/qos/deadline.py``.

Deadlines are absolute wall-clock epoch seconds carried in
`PreprocessedRequest.annotations`, so they survive to_dict/from_dict
across frontend → router → worker → engine hops without re-deriving.
Clients express deadlines as a relative budget (`x-deadline-ms` header
or `deadline_ms` body field); the frontend converts on arrival.
"""

from __future__ import annotations

import time
from typing import Any, Mapping

PRIORITY_KEY = "qos.priority"
DEADLINE_KEY = "qos.deadline_ts"
NO_SPEC_KEY = "qos.no_spec"

PRIORITY_HEADER = "x-priority"
DEADLINE_HEADER = "x-deadline-ms"
CLIENT_HEADER = "x-client-id"


def priority_from(headers: Mapping[str, str] | None = None,
                  body: Mapping[str, Any] | None = None,
                  default: str = "standard") -> str:
    p = None
    if headers is not None:
        p = headers.get(PRIORITY_HEADER)
    if p is None and body is not None:
        p = body.get("priority")
    if p is None:
        return default
    p = str(p).strip().lower()
    return p if p else default


def deadline_from(headers: Mapping[str, str] | None = None,
                  body: Mapping[str, Any] | None = None,
                  default_ms: float | None = None,
                  now: float | None = None) -> float | None:
    """Resolve a relative ms budget into an absolute epoch-seconds deadline."""
    ms: Any = None
    if headers is not None:
        ms = headers.get(DEADLINE_HEADER)
    if ms is None and body is not None:
        ms = body.get("deadline_ms")
    if ms is None:
        ms = default_ms
    if ms is None:
        return None
    try:
        ms = float(ms)
    except (TypeError, ValueError):
        return None
    return (time.time() if now is None else now) + ms / 1000.0


def deadline_of(annotations: Mapping[str, Any] | None) -> float | None:
    if not annotations:
        return None
    ts = annotations.get(DEADLINE_KEY)
    if ts is None:
        return None
    try:
        return float(ts)
    except (TypeError, ValueError):
        return None


def priority_of(annotations: Mapping[str, Any] | None,
                default: str = "standard") -> str:
    if not annotations:
        return default
    p = annotations.get(PRIORITY_KEY)
    return str(p) if p else default


def remaining_s(deadline_ts: float | None, now: float | None = None) -> float | None:
    if deadline_ts is None:
        return None
    return deadline_ts - (time.time() if now is None else now)


def expired(deadline_ts: float | None, now: float | None = None) -> bool:
    if deadline_ts is None:
        return False
    return (time.time() if now is None else now) >= deadline_ts
