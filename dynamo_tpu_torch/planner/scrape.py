"""Prometheus scraping for the planner.

Reference: components/src/dynamo/planner/utils/prometheus.py — the planner
observes the frontend's Prometheus metrics. Here we scrape a ``/metrics``
endpoint directly (no Prometheus server in the loop) and diff counters
across intervals to recover per-interval rates.

Two sources:

* ``FrontendScraper`` — one frontend's own exposition.
* ``AggregatorScraper`` — the fleet aggregator's re-exposition
  (``dynamo_tpu_torch/obs/fleet.py``): the same families, but rolled up across
  every discovered frontend under ``instance="_fleet"`` labels, plus the
  aggregator's SLO gauges, so ``Planner.plan()`` sees fleet-wide rates and
  its decisions can carry the SLO snapshot that justified them.

Copy of ``dynamo_tpu/planner/scrape.py``: ``fetch`` is the port's
asyncio-streams ``utils.metrics.fetch_metrics`` instead of aiohttp.
"""

from __future__ import annotations

from dynamo_tpu_torch.planner.planner_core import Metrics
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.metrics import (  # shared parser — inverts expose()
    Sample,
    fetch_metrics,
    metrics_url,
    parse_prometheus,
)

__all__ = ["Sample", "parse_prometheus", "FrontendScraper",
           "AggregatorScraper", "FLEET_INSTANCE"]

log = get_logger("planner")

# Label value the aggregator uses for fleet rollup series (obs/fleet.py):
# per-target series carry instance="host:port"; the cross-instance sums
# carry instance=FLEET_INSTANCE so the two never double-count.
FLEET_INSTANCE = "_fleet"


def _sum_for(sample: Sample, name: str, model: str | None = None,
             **where: str) -> float:
    want = set(where.items())
    total = 0.0
    for (n, labels), v in sample.items():
        if n != name:
            continue
        if model is not None and ("model", model) not in labels:
            continue
        if not want <= set(labels):
            continue
        total += v
    return total


class FrontendScraper:
    """Diffs the frontend's counters into per-interval Metrics."""

    # Extra label constraints applied to every sum (subclasses narrow this).
    _where: dict[str, str] = {}

    def __init__(self, metrics_url_: str, model: str | None = None):
        self.url = metrics_url_
        self.model = model
        self._prev: Sample | None = None
        self.last_sample: Sample | None = None  # most recent full scrape

    async def fetch(self) -> Sample:
        return await fetch_metrics(self.url, timeout_s=10.0)

    def _delta(self, cur: Sample, name: str) -> float:
        now = _sum_for(cur, name, self.model, **self._where)
        before = (_sum_for(self._prev, name, self.model, **self._where)
                  if self._prev else 0.0)
        return max(now - before, 0.0)  # counter reset → treat as fresh

    async def observe_interval(self) -> Metrics:
        cur = await self.fetch()
        self.last_sample = cur
        if self._prev is None:
            # First scrape: only establish the baseline. Diffing against zero
            # would report all-time cumulative totals as one interval's load
            # (an attach to a long-running frontend could spuriously scale to
            # max_replicas and pollute the predictor window).
            self._prev = cur
            return Metrics()  # all-default: num_req=0 → planner skips it
        n_req = self._delta(cur, "dynamo_frontend_model_requests_total")
        in_tok = self._delta(cur, "dynamo_frontend_input_tokens_total")
        out_tok = self._delta(cur, "dynamo_frontend_output_tokens_total")
        ttft_sum = self._delta(cur, "dynamo_frontend_time_to_first_token_seconds_sum")
        ttft_cnt = self._delta(cur, "dynamo_frontend_time_to_first_token_seconds_count")
        itl_sum = self._delta(cur, "dynamo_frontend_inter_token_latency_seconds_sum")
        itl_cnt = self._delta(cur, "dynamo_frontend_inter_token_latency_seconds_count")
        self._prev = cur
        return Metrics(
            num_req=n_req,
            isl=in_tok / n_req if n_req else 0.0,
            osl=out_tok / n_req if n_req else 0.0,
            ttft_s=ttft_sum / ttft_cnt if ttft_cnt else None,
            itl_s=itl_sum / itl_cnt if itl_cnt else None,
        )


class AggregatorScraper(FrontendScraper):
    """Fleet-wide rates from the aggregator's rollup series.

    The aggregator re-serves every discovered target's families with
    ``instance`` labels and adds cross-instance rollups under
    ``instance="_fleet"``; restricting sums to the rollup keeps the math
    identical to FrontendScraper while covering every frontend at once."""

    _where = {"instance": FLEET_INSTANCE}

    def __init__(self, fleet_url: str, model: str | None = None):
        super().__init__(metrics_url(fleet_url), model)

    def slo_snapshot(self) -> dict[str, dict[str, float]]:
        """SLO state from the last scrape's gauges, keyed by SLO name:
        ``{"ttft_p95": {"budget_remaining": 0.82, "burn_rate_5m": 0.4,
        "burn_rate_1h": 0.2, ...}}``. Empty until observe_interval ran."""
        snap: dict[str, dict[str, float]] = {}
        for (name, labels), v in (self.last_sample or {}).items():
            d = dict(labels)
            slo = d.get("slo")
            if not slo:
                continue
            if name == "dynamo_slo_error_budget_remaining":
                snap.setdefault(slo, {})["budget_remaining"] = v
            elif name == "dynamo_slo_burn_rate" and "window" in d:
                snap.setdefault(slo, {})[f"burn_rate_{d['window']}"] = v
        return snap

    def slo_reason(self) -> str:
        """Compact one-line SLO snapshot for Decision.reason / connector
        apply(reason=...): ``slo[ttft_p95 budget=0.82 burn5m=0.40; ...]``."""
        snap = self.slo_snapshot()
        parts = []
        for slo in sorted(snap):
            d = snap[slo]
            frag = f"{slo} budget={d.get('budget_remaining', 1.0):.2f}"
            for w in ("5m", "1h", "6h"):
                if f"burn_rate_{w}" in d:
                    frag += f" burn{w}={d[f'burn_rate_{w}']:.2f}"
            parts.append(frag)
        return f"slo[{'; '.join(parts)}]" if parts else ""

    def mem_reason(self) -> str:
        """Compact capacity-forecast stamp for Decision.reason:
        ``mem[ttx=42s posture=tight]``. Reads the mem-ledger gauges
        (obs/mem_ledger.py) from the last scrape — the worst (minimum)
        TTX and worst (maximum) posture across per-instance series. The
        ``_fleet`` rollup rows are skipped: summing gauges across workers
        would fabricate a TTX no worker reports. Empty when no worker
        exposes the family (ledger disabled fleet-wide)."""
        from dynamo_tpu_torch.obs.mem_ledger import POSTURES, TTX_CAP_S

        min_ttx: float | None = None
        max_posture = 0
        for (name, labels), v in (self.last_sample or {}).items():
            if dict(labels).get("instance") == FLEET_INSTANCE:
                continue
            if name == "dynamo_mem_ttx_seconds":
                min_ttx = v if min_ttx is None else min(min_ttx, v)
            elif name == "dynamo_mem_capacity_posture":
                max_posture = max(max_posture, int(v))
        if min_ttx is None:
            return ""
        posture = POSTURES[min(max_posture, len(POSTURES) - 1)]
        ttx = ("inf" if min_ttx >= TTX_CAP_S
               else f"{min_ttx:.0f}s")
        return f"mem[ttx={ttx} posture={posture}]"
