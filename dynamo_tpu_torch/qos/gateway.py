"""The QoS gateway: one object the frontend consults per request.

Combines per-client rate limiting, capacity-predicate admission,
deadline bookkeeping, and graceful degradation, and exports every
decision through the metrics registry so shedding is observable.

Copy of ``dynamo_tpu/qos/gateway.py``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Mapping

from dynamo_tpu_torch.qos.admission import AdmissionController, Decision, aggregate_stats
from dynamo_tpu_torch.qos.config import QosConfig
from dynamo_tpu_torch.qos.deadline import DEADLINE_KEY, NO_SPEC_KEY, PRIORITY_KEY, expired
from dynamo_tpu_torch.qos.token_bucket import ClientRateLimiter
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)


class QosGateway:
    def __init__(self, cfg: QosConfig | None = None,
                 registry: MetricsRegistry | None = None,
                 now_fn: Callable[[], float] = time.time,
                 mono_fn: Callable[[], float] = time.monotonic):
        self.cfg = cfg or QosConfig()
        self._now = now_fn
        self.limiter = ClientRateLimiter(
            self.cfg.rate_limit_rps, self.cfg.rate_burst,
            self.cfg.max_tracked_clients, mono_fn)
        self.admission = AdmissionController(self.cfg)
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self.m_admitted = reg.counter("qos_admitted_total", "Requests admitted by the QoS gateway")
        self.m_rejected = reg.counter("qos_rejected_total", "Requests rejected by the QoS gateway")
        self.m_degraded = reg.counter("qos_degraded_total", "Degradation actions applied under pressure")
        self.m_deadline_cancelled = reg.counter(
            "qos_deadline_cancelled_total", "Requests cancelled because their deadline expired")
        self.g_pressure = reg.gauge("qos_pressure_level", "Current pressure level (0=ok..4=full)")
        self.g_queue_depth = reg.gauge("qos_queue_depth", "Per-worker average waiting queue depth")
        self.g_kv_usage = reg.gauge("qos_kv_usage", "Max KV-cache block usage across workers")
        reg.func_gauge("qos_tracked_clients", lambda: float(len(self.limiter)),
                       "Clients with live rate-limit buckets")

    def admit(self, client_id: str, priority: str,
              stats: Mapping[str, Any] | None,
              deadline_ts: float | None = None) -> Decision:
        """Full admission pipeline: deadline → rate limit → capacity."""
        if not self.cfg.enabled:
            return Decision(True)
        now = self._now()
        if expired(deadline_ts, now):
            self.m_deadline_cancelled.inc(stage="admission")
            self.m_rejected.inc(priority=priority, reason="deadline")
            return Decision(False, 504, "deadline")
        allowed, retry_after = self.limiter.check(client_id)
        if not allowed:
            self.m_rejected.inc(priority=priority, reason="rate_limit")
            return Decision(False, 429, "rate_limit", max(retry_after, 0.1))
        load = aggregate_stats(stats)
        decision = self.admission.evaluate(priority, load)
        self.g_pressure.set(float(decision.pressure))
        self.g_queue_depth.set(load.queue_depth)
        self.g_kv_usage.set(load.kv_usage)
        if decision.admitted:
            self.m_admitted.inc(priority=priority)
        else:
            self.m_rejected.inc(priority=priority, reason=decision.reason)
            log.debug("qos: shed %s request (reason=%s pressure=%s)",
                      priority, decision.reason, decision.pressure_name)
        return decision

    def annotate(self, pre: Any, priority: str,
                 deadline_ts: float | None, decision: Decision) -> None:
        """Stamp QoS annotations onto a PreprocessedRequest and apply
        degradation actions when the admission decision asked for them."""
        ann = getattr(pre, "annotations", None)
        if ann is None:
            ann = {}
            try:
                pre.annotations = ann
            except AttributeError:
                return
        ann[PRIORITY_KEY] = priority
        if deadline_ts is not None:
            ann[DEADLINE_KEY] = deadline_ts
        if decision.degrade:
            stop = getattr(pre, "stop_conditions", None)
            max_tok = getattr(stop, "max_tokens", None) if stop is not None else None
            if max_tok is None or max_tok > self.cfg.clamp_max_tokens:
                if stop is not None:
                    stop.max_tokens = self.cfg.clamp_max_tokens
                    self.m_degraded.inc(action="clamp_max_tokens")
            if not ann.get(NO_SPEC_KEY):
                ann[NO_SPEC_KEY] = True
                self.m_degraded.inc(action="disable_spec")

    def note_deadline_cancel(self, stage: str) -> None:
        self.m_deadline_cancelled.inc(stage=stage)
