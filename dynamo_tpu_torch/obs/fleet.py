"""Fleet observability plane: discovery-driven aggregation + SLO engine.

Fills the role of the reference's metrics-aggregation service plus the
Prometheus service discovery feeding its SLA planner (reference:
deploy/metrics + the planner's Prometheus queries): every process that
serves a ``/metrics`` endpoint registers a lease-bound
:class:`~dynamo_tpu_torch.runtime.protocols.MetricsTarget` under
``dyn/metrics/{namespace}/...``; the :class:`FleetAggregator` polls that
prefix (no static target lists), scrapes every live target concurrently
with bounded timeouts, and re-serves the union at one ``/metrics``
endpoint:

* per-target series keep their family names and gain ``instance``/
  ``role`` labels (stale targets additionally carry ``stale="1"`` —
  last-known-good data degrades, it never silently disappears);
* cross-instance rollups (sum counters/gauges, merge histogram buckets)
  are emitted under ``instance="_fleet"`` so one label filter yields the
  fleet-wide view without double counting.

On top of the rollup sits the :class:`SloEngine`: declarative
:class:`SloSpec`\\ s (TTFT p95 ≤ X, ITL p95 ≤ Y, availability from
``qos_admitted`` vs terminal-status counters) evaluated as multi-window
multi-burn-rate alerts (Google SRE style: the 5m/1h pair pages, the
1h/6h pair warns) with ``dynamo_slo_*`` gauges, and an EWMA anomaly
detector over perf gauges feeding the ``/debug/fleet`` dashboard.

Copy of ``dynamo_tpu/obs/fleet.py``: the scrapes go through the port's
asyncio-streams ``fetch_metrics`` (``utils/metrics.py``), and the compile
storms read the port's compile ledger (``obs/compile_ledger.py``), whose
events are step programs made on the card under the JAX family's name.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.runtime.protocols import METRICS_PREFIX, MetricsTarget
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.metrics import (
    MetricsRegistry,
    Sample,
    _fmt_labels,
    fetch_metrics,
    metric_sum,
)

log = get_logger("fleet")

# Label value for cross-instance rollup series (planner/scrape.py filters
# on it; must never collide with a real host:port instance label).
FLEET_INSTANCE = "_fleet"

# Statuses mirrored from chaos/invariants.py (kept literal here so the
# availability SLI contract is visible next to the spec that uses it).
_TERMINAL_STATUSES = ("200", "499", "500")
_GENERATE_ROUTES = ("chat", "completions")

# Perf-gauge families watched by the EWMA anomaly detector.
ANOMALY_PREFIXES = ("dynamo_engine_perf_",)

# Compile-storm detection (obs/compile_ledger.py feeds the series): this
# many SERVE-path XLA compiles from one instance inside the trailing
# window means its bucket lattice is churning — every one of them stalled
# a real request's dispatch. Warmup-source compiles are excluded: a fresh
# worker precompiling its lattice is healthy, not a storm.
COMPILE_STORM_WINDOW_S = 60.0
COMPILE_STORM_THRESHOLD = 8


# ---------------------------------------------------------------------------
# SLO specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SloSpec:
    """One declarative SLO.

    ``kind="latency"``: the SLI is the fraction of observations of
    ``histogram`` at or under ``threshold_s`` (so target=0.95 with
    threshold X reads "p95 ≤ X"). ``kind="availability"``: good/total
    come from terminal-status counters (200 vs 499/500) on the generate
    routes, cross-checked against ``dynamo_qos_admitted_total``.
    ``kind="counter_ratio"``: good/total come from one labelled counter
    family — good is the series where ``good_label == good_value``, total
    is every series of ``counter`` (the shape behind kv_headroom: each
    engine-step free-pool observation lands in
    dynamo_mem_headroom_observations_total{state="ok"|"short"})."""

    name: str
    kind: str                  # "latency" | "availability" | "counter_ratio"
    target: float              # e.g. 0.95 → error budget 0.05
    histogram: str = ""        # latency only: histogram family name
    threshold_s: float = 0.0   # latency only: SLO bound in seconds
    counter: str = ""          # counter_ratio only: counter family name
    good_label: str = ""       # counter_ratio only: label that marks good
    good_value: str = ""       # counter_ratio only: value of the good label

    @property
    def budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


DEFAULT_SLO_SPECS = (
    SloSpec(name="ttft_p95", kind="latency", target=0.95,
            histogram="dynamo_frontend_time_to_first_token_seconds",
            threshold_s=2.0),
    SloSpec(name="itl_p95", kind="latency", target=0.95,
            histogram="dynamo_frontend_inter_token_latency_seconds",
            threshold_s=0.2),
    SloSpec(name="availability", kind="availability", target=0.999),
    # Scheduler interference (obs/sched_ledger.py): the fraction of HOL
    # stalls — decode-ready streams waiting out a co-scheduled prefill —
    # that stay under half a second. Burns when long prompts starve
    # decode streams fleet-wide (the signal ROADMAP item 2's chunked
    # prefill is meant to flatten).
    SloSpec(name="decode_stall", kind="latency", target=0.99,
            histogram="dynamo_sched_hol_stall_seconds",
            threshold_s=0.5),
    # KV capacity headroom (obs/mem_ledger.py): each engine step scores
    # its free-pool forecast ok/short (short = TTX posture tight or
    # critical). Sustained short TTX burns this budget and pages through
    # the same multi-window machinery as the latency SLOs — the "we will
    # hit no_free_blocks in under two minutes" signal, fleet-wide.
    SloSpec(name="kv_headroom", kind="counter_ratio", target=0.95,
            counter="dynamo_mem_headroom_observations_total",
            good_label="state", good_value="ok"),
)


def parse_slo_specs(text: str) -> tuple[SloSpec, ...]:
    """Parse the ``--slo-spec`` JSON document: ``{"slos": [{...}, ...]}``
    (see docs/OBSERVABILITY.md "Fleet aggregation & SLOs" for the field
    reference). Raises ValueError on malformed specs."""
    doc = json.loads(text)
    specs = []
    for raw in doc.get("slos", []):
        spec = SloSpec(
            name=raw["name"], kind=raw["kind"],
            target=float(raw["target"]),
            histogram=raw.get("histogram", ""),
            threshold_s=float(raw.get("threshold_s", 0.0)),
            counter=raw.get("counter", ""),
            good_label=raw.get("good_label", ""),
            good_value=str(raw.get("good_value", "")))
        if spec.kind not in ("latency", "availability", "counter_ratio"):
            raise ValueError(f"slo {spec.name!r}: unknown kind {spec.kind!r}")
        if spec.kind == "latency" and not spec.histogram:
            raise ValueError(f"slo {spec.name!r}: latency needs a histogram")
        if spec.kind == "counter_ratio" and not (
                spec.counter and spec.good_label and spec.good_value):
            raise ValueError(
                f"slo {spec.name!r}: counter_ratio needs counter, "
                f"good_label, and good_value")
        if not 0.0 < spec.target < 1.0:
            raise ValueError(f"slo {spec.name!r}: target must be in (0, 1)")
        specs.append(spec)
    if not specs:
        raise ValueError("slo spec document declares no slos")
    return tuple(specs)


# ---------------------------------------------------------------------------
# SLO burn-rate engine
# ---------------------------------------------------------------------------

# Window name -> seconds. The (fast_short, fast_long) pair pages, the
# (slow_short, slow_long) pair warns; a pair fires only when BOTH windows
# burn above its threshold (the long window proves it's sustained, the
# short window proves it's still happening).
DEFAULT_WINDOWS = {"5m": 300.0, "1h": 3600.0, "6h": 21600.0}
FAST_PAIR = ("5m", "1h")     # page
SLOW_PAIR = ("1h", "6h")     # warn
DEFAULT_PAGE_BURN = 14.4     # SRE workbook: 2% of 30d budget in 1h
DEFAULT_WARN_BURN = 6.0      # 10% of 30d budget in 6h


@dataclass
class _SloState:
    # ring of (t, good, total) cumulative snapshots, oldest first
    series: list[tuple[float, float, float]] = field(default_factory=list)
    paging: bool = False
    warning: bool = False


class SloEngine:
    """Multi-window multi-burn-rate evaluation over cumulative counters.

    Feed it cumulative ``(good, total)`` event counts per SLO (from the
    fleet rollup) via :meth:`observe`; :meth:`evaluate` computes windowed
    error rates, burn rates (error rate ÷ budget), page/warn states, and
    error budget remaining over the retained history, and mirrors them
    into the ``dynamo_slo_*`` gauges. A window with less history than its
    span falls back to the oldest retained snapshot (a partial window —
    better than pretending zero burn while the series warms up)."""

    def __init__(self, specs: Iterable[SloSpec] = DEFAULT_SLO_SPECS,
                 registry: MetricsRegistry | None = None,
                 windows: dict[str, float] | None = None,
                 page_burn: float = DEFAULT_PAGE_BURN,
                 warn_burn: float = DEFAULT_WARN_BURN,
                 clock: Callable[[], float] = time.monotonic):
        self.specs = {s.name: s for s in specs}
        self.windows = dict(windows or DEFAULT_WINDOWS)
        self.page_burn = page_burn
        self.warn_burn = warn_burn
        self.clock = clock
        self._state = {name: _SloState() for name in self.specs}
        reg = registry if registry is not None else MetricsRegistry()
        self.g_budget = reg.gauge(
            "slo_error_budget_remaining",
            "fraction of the SLO error budget left over the retained "
            "history (0 = exhausted)")
        self.g_burn = reg.gauge(
            "slo_burn_rate",
            "windowed error rate divided by the SLO error budget")
        self.c_violations = reg.counter(
            "slo_violations_total",
            "rising edges of the multi-window burn-rate alerts")

    # -- data feed ---------------------------------------------------------
    def observe(self, name: str, good: float, total: float,
                t: float | None = None) -> None:
        """Record a cumulative (good, total) snapshot for SLO ``name``."""
        st = self._state[name]
        t = self.clock() if t is None else t
        st.series.append((t, float(good), float(total)))
        horizon = t - max(self.windows.values()) - 1.0
        while len(st.series) > 2 and st.series[1][0] <= horizon:
            st.series.pop(0)

    # -- math --------------------------------------------------------------
    def _window_rates(self, name: str, window_s: float) -> tuple[float, float]:
        """(error_rate, total_delta) over the trailing ``window_s``."""
        series = self._state[name].series
        if len(series) < 2:
            return 0.0, 0.0
        t_now, good_now, total_now = series[-1]
        base = series[0]
        for snap in series:
            if snap[0] <= t_now - window_s:
                base = snap  # newest snapshot at/older than the window start
            else:
                break
        d_total = max(total_now - base[2], 0.0)
        d_good = max(good_now - base[1], 0.0)
        if d_total <= 0.0:
            return 0.0, 0.0
        d_bad = max(d_total - d_good, 0.0)
        return d_bad / d_total, d_total

    def burn_rate(self, name: str, window: str) -> float:
        error_rate, _ = self._window_rates(name, self.windows[window])
        return error_rate / self.specs[name].budget

    def budget_remaining(self, name: str) -> float:
        """1 - (observed error rate ÷ budget) over the retained history,
        floored at 0 (exhausted)."""
        error_rate, d_total = self._window_rates(
            name, max(self.windows.values()))
        if d_total <= 0.0:
            return 1.0
        return max(0.0, 1.0 - error_rate / self.specs[name].budget)

    # -- evaluation --------------------------------------------------------
    def evaluate(self) -> dict[str, dict]:
        """Evaluate every SLO, update gauges/counters, return the snapshot
        (the /debug/fleet ``slos`` block)."""
        out: dict[str, dict] = {}
        for name, spec in self.specs.items():
            st = self._state[name]
            burns = {w: self.burn_rate(name, w) for w in self.windows}
            paging = all(burns[w] >= self.page_burn for w in FAST_PAIR
                         if w in burns)
            warning = all(burns[w] >= self.warn_burn for w in SLOW_PAIR
                          if w in burns)
            if paging and not st.paging:
                self.c_violations.inc(slo=name, severity="page")
            if warning and not st.warning:
                self.c_violations.inc(slo=name, severity="warn")
            st.paging, st.warning = paging, warning
            remaining = self.budget_remaining(name)
            self.g_budget.set(remaining, slo=name)
            for w, b in burns.items():
                self.g_burn.set(b, slo=name, window=w)
            last = st.series[-1] if st.series else (0.0, 0.0, 0.0)
            out[name] = {
                "kind": spec.kind,
                "target": spec.target,
                "threshold_s": spec.threshold_s or None,
                "burn_rates": {w: round(b, 4) for w, b in burns.items()},
                "budget_remaining": round(remaining, 4),
                "page": paging,
                "warn": warning,
                "good": last[1],
                "total": last[2],
            }
        return out


# ---------------------------------------------------------------------------
# EWMA anomaly detection
# ---------------------------------------------------------------------------

class EwmaAnomaly:
    """Per-series EWMA mean/variance; a sample further than ``k`` EW
    standard deviations from the mean (after ``min_samples`` warmup) is
    flagged. Cheap enough to run over every perf gauge each scrape."""

    def __init__(self, alpha: float = 0.3, k: float = 3.0,
                 min_samples: int = 5):
        self.alpha, self.k, self.min_samples = alpha, k, min_samples
        self._state: dict[tuple, tuple[float, float, int]] = {}

    def observe(self, key: tuple, value: float) -> dict | None:
        """Returns an anomaly record if ``value`` is an outlier, else None."""
        mean, var, n = self._state.get(key, (value, 0.0, 0))
        flagged = None
        std = var ** 0.5
        if n >= self.min_samples and std > 1e-12 and \
                abs(value - mean) > self.k * std:
            flagged = {"value": round(value, 6), "mean": round(mean, 6),
                       "std": round(std, 6)}
        d = value - mean
        mean += self.alpha * d
        var = (1 - self.alpha) * (var + self.alpha * d * d)
        self._state[key] = (mean, var, n + 1)
        return flagged


# ---------------------------------------------------------------------------
# Fleet aggregation
# ---------------------------------------------------------------------------

@dataclass
class TargetState:
    target: MetricsTarget
    sample: Sample | None = None
    last_ok_t: float = 0.0      # clock() of last successful scrape
    last_seen_t: float = 0.0    # clock() of last discovery sighting
    last_error: str = ""
    consecutive_failures: int = 0
    registered: bool = True     # key still present under the prefix


class FleetAggregator:
    """Discovers, scrapes, folds, and re-serves the fleet's metrics.

    Drive it with :meth:`run` (a loop of :meth:`scrape_once` every
    ``scrape_interval_s``) or call :meth:`scrape_once` directly from
    tests. All exposition goes through :meth:`expose`; the JSON dashboard
    through :meth:`debug_info`."""

    def __init__(self, client, namespace: str = "dynamo",
                 scrape_interval_s: float = 2.0,
                 scrape_timeout_s: float = 2.0,
                 staleness_ttl_s: float = 10.0,
                 specs: Iterable[SloSpec] = DEFAULT_SLO_SPECS,
                 registry: MetricsRegistry | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 compile_storm_threshold: int = COMPILE_STORM_THRESHOLD,
                 compile_storm_window_s: float = COMPILE_STORM_WINDOW_S):
        self.client = client
        self.namespace = namespace
        self.scrape_interval_s = scrape_interval_s
        self.scrape_timeout_s = scrape_timeout_s
        self.staleness_ttl_s = staleness_ttl_s
        self.clock = clock
        self.registry = registry if registry is not None else MetricsRegistry()
        self.targets: dict[str, TargetState] = {}
        self.engine = SloEngine(specs, registry=self.registry, clock=clock)
        self.anomaly = EwmaAnomaly()
        self._anomalies: list[dict] = []
        self.compile_storm_threshold = compile_storm_threshold
        self.compile_storm_window_s = compile_storm_window_s
        # per-instance ring of (t, cumulative serve-compile count)
        self._compile_series: dict[str, list[tuple[float, float]]] = {}
        self._storming: set[str] = set()
        self._compile_storms: list[dict] = []
        self.c_scrapes = self.registry.counter(
            "fleet_scrapes_total", "scrape attempts against fleet targets")
        self.c_scrape_errors = self.registry.counter(
            "fleet_scrape_errors_total",
            "failed scrapes (timeout, refused, HTTP error, chaos)")
        self.g_targets = self.registry.gauge(
            "fleet_targets", "discovered targets by freshness state")
        self.h_scrape_seconds = self.registry.histogram(
            "fleet_scrape_seconds", "wall time of one full scrape sweep")
        self.g_compile_storm = self.registry.gauge(
            "fleet_compile_storm",
            "serve-path XLA compiles per instance over the trailing "
            "compile-storm window (>= threshold flags a storm)")

    # -- discovery ---------------------------------------------------------
    @property
    def _prefix(self) -> str:
        return f"{METRICS_PREFIX}/{self.namespace}/"

    async def discover(self) -> None:
        """Refresh the target set from the coordinator's metrics prefix.
        A key that disappeared (lease death) keeps its last sample until
        staleness expiry so its data degrades instead of vanishing."""
        now = self.clock()
        kvs = await self.client.get_prefix(self._prefix)
        seen: set[str] = set()
        for key, raw in kvs.items():
            try:
                target = MetricsTarget.from_bytes(raw)
            except (ValueError, KeyError, TypeError) as exc:
                log.warning("bad metrics target at %s: %s", key, exc)
                continue
            seen.add(key)
            st = self.targets.get(key)
            if st is None:
                self.targets[key] = st = TargetState(target=target)
                log.info("discovered %s target %s", target.role, target.url)
            st.target = target
            st.registered = True
            st.last_seen_t = now
        for key, st in list(self.targets.items()):
            if key in seen:
                continue
            st.registered = False
            # drop only after the stale grace expires with no re-sighting
            if now - max(st.last_ok_t, st.last_seen_t) > self.staleness_ttl_s:
                log.info("dropping dead target %s", st.target.url)
                del self.targets[key]

    # -- scraping ----------------------------------------------------------
    def is_fresh(self, st: TargetState) -> bool:
        return (self.clock() - st.last_ok_t) <= self.staleness_ttl_s \
            and st.sample is not None

    async def _scrape_target(self, st: TargetState) -> None:
        self.c_scrapes.inc(instance=st.target.instance)
        try:
            await chaos.ainject("obs.fleet.scrape",
                                instance=st.target.instance,
                                role=st.target.role)
            st.sample = await asyncio.wait_for(
                fetch_metrics(st.target.url, timeout_s=self.scrape_timeout_s),
                timeout=self.scrape_timeout_s + 1.0)
            st.last_ok_t = self.clock()
            st.last_error = ""
            st.consecutive_failures = 0
        except Exception as exc:  # noqa: BLE001 — any failure is a data point
            st.last_error = f"{type(exc).__name__}: {exc}"[:200]
            st.consecutive_failures += 1
            self.c_scrape_errors.inc(instance=st.target.instance)

    async def scrape_once(self) -> None:
        """One sweep: discover, scrape all targets concurrently, fold the
        rollup into the SLO engine and anomaly detector. Never raises on
        target failure — a dead target is a data point, not a crash."""
        t0 = self.clock()
        await self.discover()
        if self.targets:
            await asyncio.gather(
                *(self._scrape_target(st) for st in self.targets.values()))
        fresh = sum(1 for st in self.targets.values() if self.is_fresh(st))
        self.g_targets.set(float(fresh), state="fresh")
        self.g_targets.set(float(len(self.targets) - fresh), state="stale")
        rollup = self.fleet_sample()
        for spec in self.engine.specs.values():
            good, total = self._slo_counts(spec, rollup)
            self.engine.observe(spec.name, good, total)
        self.engine.evaluate()
        self._detect_anomalies()
        self._detect_compile_storms()
        self.h_scrape_seconds.observe(max(self.clock() - t0, 0.0))

    async def run(self) -> None:
        while True:
            try:
                await self.scrape_once()
            except Exception:  # noqa: BLE001 — the loop must survive anything
                log.exception("fleet scrape sweep failed")
            await asyncio.sleep(self.scrape_interval_s)

    # -- folding -----------------------------------------------------------
    def fleet_sample(self) -> Sample:
        """Cross-instance rollup: sum every sample name+label set across
        targets (stale targets contribute their last-known-good sample —
        counters must not step backwards just because a scrape failed)."""
        rollup: Sample = {}
        for st in self.targets.values():
            if st.sample is None:
                continue
            for key, v in st.sample.items():
                rollup[key] = rollup.get(key, 0.0) + v
        return rollup

    def _slo_counts(self, spec: SloSpec, rollup: Sample) -> tuple[float, float]:
        """(good, total) cumulative event counts for one SLO."""
        if spec.kind == "availability":
            good = total = 0.0
            for (name, labels), v in rollup.items():
                if name != "dynamo_frontend_requests_total":
                    continue
                d = dict(labels)
                if d.get("route") not in _GENERATE_ROUTES:
                    continue
                if d.get("status") not in _TERMINAL_STATUSES:
                    continue
                total += v
                if d.get("status") == "200":
                    good += v
            return good, total
        if spec.kind == "counter_ratio":
            good = total = 0.0
            for (name, labels), v in rollup.items():
                if name != spec.counter:
                    continue
                total += v
                if dict(labels).get(spec.good_label) == spec.good_value:
                    good += v
            return good, total
        # latency: cumulative bucket counts. good = observations at or
        # under the smallest bucket bound >= threshold; total = _count.
        by_le: dict[float, float] = {}
        for (name, labels), v in rollup.items():
            if name != f"{spec.histogram}_bucket":
                continue
            le = dict(labels).get("le")
            if le is None:
                continue
            try:
                ub = float("inf") if le == "+Inf" else float(le)
            except ValueError:
                continue
            by_le[ub] = by_le.get(ub, 0.0) + v
        total = metric_sum(rollup, f"{spec.histogram}_count")
        eligible = [ub for ub in by_le if ub >= spec.threshold_s - 1e-12]
        good = by_le[min(eligible)] if eligible else 0.0
        return good, total

    def _detect_anomalies(self) -> None:
        flags: list[dict] = []
        for st in self.targets.values():
            if st.sample is None or not self.is_fresh(st):
                continue
            for (name, labels), v in st.sample.items():
                if not name.startswith(ANOMALY_PREFIXES):
                    continue
                rec = self.anomaly.observe(
                    (st.target.instance, name, labels), v)
                if rec is not None:
                    flags.append({"metric": name,
                                  "instance": st.target.instance,
                                  **rec})
        self._anomalies = flags[:32]

    def _detect_compile_storms(self) -> None:
        """Per-instance serve-compile rate over the trailing window. A
        storm (>= threshold compiles in the window) flags the instance in
        ``/debug/fleet`` and pages through the SloEngine violations
        counter — the same rising-edge machinery burn-rate alerts use."""
        now = self.clock()
        horizon = now - self.compile_storm_window_s
        storms: list[dict] = []
        for st in self.targets.values():
            if st.sample is None or not self.is_fresh(st):
                continue
            inst = st.target.instance
            cum = sum(v for (name, labels), v in st.sample.items()
                      if name == "dynamo_xla_compile_events_total"
                      and dict(labels).get("source") == "serve")
            series = self._compile_series.setdefault(inst, [])
            series.append((now, cum))
            while len(series) > 2 and series[1][0] <= horizon:
                series.pop(0)
            base = series[0]
            for snap in series:
                if snap[0] <= horizon:
                    base = snap  # newest snapshot at/older than window start
                else:
                    break
            delta = max(cum - base[1], 0.0)
            self.g_compile_storm.set(delta, instance=inst)
            if delta >= self.compile_storm_threshold:
                storms.append({"instance": inst, "role": st.target.role,
                               "compiles": delta,
                               "window_s": self.compile_storm_window_s})
                if inst not in self._storming:
                    self.engine.c_violations.inc(
                        slo="compile_storm", severity="page")
                self._storming.add(inst)
            else:
                self._storming.discard(inst)
        gone = set(self._compile_series) - {
            st.target.instance for st in self.targets.values()}
        for inst in gone:
            del self._compile_series[inst]
            self._storming.discard(inst)
        self._compile_storms = storms

    # -- serving -----------------------------------------------------------
    def expose(self) -> str:
        """The fleet /metrics exposition: the aggregator's own registry
        (dynamo_fleet_* / dynamo_slo_*), then per-target series with
        instance/role (and stale) labels, then instance="_fleet" rollups."""
        lines = [self.registry.expose().rstrip("\n")]
        lines.append("# fleet re-exposition: per-target series")
        for st in sorted(self.targets.values(),
                         key=lambda s: s.target.instance):
            if st.sample is None:
                continue
            extra = {"instance": st.target.instance, "role": st.target.role}
            if not self.is_fresh(st):
                extra["stale"] = "1"
            for (name, labels), v in sorted(st.sample.items(),
                                            key=lambda kv: kv[0][0]):
                merged = {**dict(labels), **extra}
                lines.append(f"{name}{_fmt_labels(merged)} {v}")
        lines.append('# fleet rollups (instance="_fleet")')
        rollup = self.fleet_sample()
        for (name, labels) in sorted(rollup,
                                     key=lambda k: (k[0], sorted(k[1]))):
            merged = {**dict(labels), "instance": FLEET_INSTANCE}
            lines.append(f"{name}{_fmt_labels(merged)} {rollup[(name, labels)]}")
        return "\n".join(lines) + "\n"

    def _top_contributors(self, spec: SloSpec, n: int = 3) -> list[dict]:
        """Per-target cumulative error rates for one SLO, worst first —
        the dashboard's "who is burning the budget" view."""
        rows = []
        for st in self.targets.values():
            if st.sample is None:
                continue
            good, total = self._slo_counts(spec, st.sample)
            if total <= 0:
                continue
            rows.append({"instance": st.target.instance,
                         "role": st.target.role,
                         "error_rate": round(1.0 - good / total, 4),
                         "total": total})
        rows.sort(key=lambda r: r["error_rate"], reverse=True)
        return rows[:n]

    def debug_info(self) -> dict:
        """The /debug/fleet JSON document (schema in docs/OBSERVABILITY.md)."""
        now = self.clock()
        slos = self.engine.evaluate()
        for name, spec in self.engine.specs.items():
            slos[name]["top_contributors"] = self._top_contributors(spec)
        return {
            "namespace": self.namespace,
            "scrape_interval_s": self.scrape_interval_s,
            "staleness_ttl_s": self.staleness_ttl_s,
            "targets": [
                {
                    "instance": st.target.instance,
                    "role": st.target.role,
                    "url": st.target.url,
                    "fresh": self.is_fresh(st),
                    "registered": st.registered,
                    "age_s": round(now - st.last_ok_t, 3)
                    if st.last_ok_t else None,
                    "consecutive_failures": st.consecutive_failures,
                    "last_error": st.last_error or None,
                    "series": len(st.sample) if st.sample else 0,
                }
                for st in sorted(self.targets.values(),
                                 key=lambda s: s.target.instance)
            ],
            "slos": slos,
            "anomalies": self._anomalies,
            "compile_storms": self._compile_storms,
        }
