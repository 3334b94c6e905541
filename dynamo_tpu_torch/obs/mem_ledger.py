"""KV memory & capacity ledger: pin-owner taxonomy, leak audit, TTX forecast —
copy of ``dynamo_tpu/obs/mem_ledger.py``.

The scheduling ledger prices *compute* decisions; this module does the
same for the resource those decisions actually contend over — KV blocks.
Three planes, all riding one process-global :class:`MemLedger`:

* **Pin-owner taxonomy** — every device-block pin/unpin is tagged with an
  owner class (``OWNER_CLASSES``: ``stream`` — an admitted request's
  block table, ``session`` — session-sticky retention pins,
  ``prefix_publish`` — commit-queue references awaiting a publish flush,
  ``stream_ckpt`` — checkpoint-queue references awaiting a ckpt flush,
  ``staging`` — disagg export/wave pins held for an in-flight transfer)
  plus the owner id (request/session/xfer id, block hash). The per-class
  totals feed the ``dynamo_mem_device_blocks{owner}`` occupancy waterfall;
  tier occupancy (host/disk/remote blocks+bytes) comes from registered
  pull callbacks, and every eviction/demotion increments
  ``dynamo_mem_churn_blocks_total{tier,cause}``.
* **Leak audit** — :meth:`MemLedger.audit` reconciles tagged pins against
  the live-id sets each engine registers (:meth:`register_live_source`):
  a pin whose owner id no longer exists anywhere is an *orphan*, exported
  as ``dynamo_mem_orphan_pins{owner}`` with the offending ids served at
  ``/debug/mem``.
* **TTX forecasting** — per-QoS EWMA block consumption rates (admission
  allocations minus releases) divide into the current free-block count:
  ``dynamo_mem_ttx_seconds`` plus a capacity posture (``ok|tight|
  critical``). Every observation also increments
  ``dynamo_mem_headroom_observations_total{state}``, the counter pair
  behind the JAX package's fleet ``kv_headroom`` SLI.

The port's engine pins ``stream`` blocks (the scheduler's block tables),
``session`` blocks (session retention) and the ``prefix_publish`` and
``stream_ckpt`` queue blocks of the KVBM tiers, and its live-id source
reports each from the store or queue that holds it; ``staging`` pins come
with the disagg handoff, and the source reports that class empty. Every
KVBM tier registers a tier row beside the device's.

Disabled mode (``DYN_MEM_LEDGER=0``) flips ``MemLedger.enabled``; every
call site gates on that flag BEFORE building any record, so a disabled
ledger adds zero per-step work — the same contract as
``DYN_SCHED_LEDGER``.

The ``dynamo_mem_*`` family (the JAX family's names) installs on a
service's registry via ``install_mem_metrics``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Iterable, Mapping

from dynamo_tpu_torch.utils.metrics import MetricsRegistry

MEM_ENV = "DYN_MEM_LEDGER"

#: Every pin the ledger accepts carries one of these owner classes.
OWNER_CLASSES = ("stream", "session", "prefix_publish", "stream_ckpt",
                 "staging")

#: Capacity postures, in order of severity (the gauge exports the index).
POSTURES = ("ok", "tight", "critical")

#: TTX below these bounds moves the posture to tight / critical. Tight is
#: also the headroom SLI boundary: an observation with ttx < tight counts
#: as a "short" event against the kv_headroom error budget.
TTX_TIGHT_S = 120.0
TTX_CRITICAL_S = 30.0

#: Forecast ceiling when the net consumption rate is <= 0 (the pool is
#: draining or idle): "never exhausts" clamps here so the gauge stays a
#: finite, plottable number (~11.5 days).
TTX_CAP_S = 1e6


def mem_enabled(default: bool = True) -> bool:
    """The module-level gate: DYN_MEM_LEDGER=0 disables all memory-ledger
    accounting (record paths return before any work)."""
    val = os.environ.get(MEM_ENV, "")
    if val == "":
        return default
    return val not in ("0", "false", "no", "off")


# ---------------------------------------------------------------------------
# Prometheus family
# ---------------------------------------------------------------------------

class MemMetrics:
    """The dynamo_mem_* family (the JAX family's names, labels and help
    texts)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.device_blocks = registry.gauge(
            "mem_device_blocks",
            "Device KV occupancy waterfall: blocks pinned per owner class "
            "(stream|session|prefix_publish|stream_ckpt|staging) plus the "
            "free and cached (inactive, evictable) rows, owner label")
        self.tier_blocks = registry.gauge(
            "mem_tier_blocks",
            "KV blocks resident per offload tier (host|disk|remote), "
            "tier label")
        self.tier_bytes = registry.gauge(
            "mem_tier_bytes",
            "KV bytes resident per offload tier (host|disk|remote), "
            "tier label")
        self.churn = registry.counter(
            "mem_churn_blocks_total",
            "Blocks evicted/demoted per tier, by cause "
            "(allocation_pressure|session_demote|clear|lru|byte_budget)")
        self.orphans = registry.gauge(
            "mem_orphan_pins",
            "Pins whose owner id no longer exists in any live source at "
            "the last audit, by owner class (nonzero = leak)")
        self.audits = registry.counter(
            "mem_audits_total",
            "Pin-leak audits run, by result (clean|orphans)")
        self.ttx = registry.gauge(
            "mem_ttx_seconds",
            "Forecast seconds until the device block pool exhausts at the "
            "current EWMA net consumption rate (capped when draining)")
        self.posture = registry.gauge(
            "mem_capacity_posture",
            "Capacity posture index from the TTX forecast "
            "(0=ok, 1=tight, 2=critical)")
        self.alloc = registry.counter(
            "mem_alloc_blocks_total",
            "Device blocks allocated for admissions and decode growth, "
            "by qos_class")
        self.release = registry.counter(
            "mem_release_blocks_total",
            "Device blocks released by stream finish/preemption, "
            "by qos_class")
        self.headroom = registry.counter(
            "mem_headroom_observations_total",
            "TTX observations by headroom state (ok|short): the counter "
            "pair behind the fleet kv_headroom SLI")


_metrics: MemMetrics | None = None


def get_mem_metrics() -> MemMetrics:
    global _metrics
    if _metrics is None:
        _metrics = MemMetrics()
    return _metrics


def install_mem_metrics(registry: MetricsRegistry) -> MemMetrics:
    """Re-home the singleton's metrics into ``registry`` (the worker's
    runtime registry) so the family is exposed on /metrics. Gauges are
    republished from the live ledger so an install that lands AFTER the
    engine started still exposes current occupancy; counters stay
    monotonic and are not replayed."""
    m = get_mem_metrics()
    m.bind(registry)
    get_mem_ledger().republish()
    return m


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------

class MemLedger:
    """Process-global KV memory accounting.

    Thread-safe: the engine-core thread pins/unpins while the asyncio side
    reads snapshots for stats/debug endpoints and the audit may run from
    either. Multiple engines in one process (mocker fleets) share the
    ledger; audits union every registered live source, so cross-engine
    aggregation never manufactures orphans."""

    _CHURN_RING = 256   # recent churn events kept for the /debug trend

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = mem_enabled()
        self.audit_interval_s = 30.0
        self.ewma_alpha = 0.3
        self.ttx_tight_s = TTX_TIGHT_S
        self.ttx_critical_s = TTX_CRITICAL_S
        # (owner_class, owner_id) -> pinned block count
        self._pins: dict[tuple[str, str], int] = {}
        # device waterfall extras (engine publishes at its record point)
        self._device_free = 0
        self._device_cached = 0
        self._device_total = 0
        # tier occupancy pull callbacks: name -> fn() -> (blocks, bytes)
        self._tiers: dict[str, Callable[[], tuple[int, int]]] = {}
        # audit live-id sources: key -> fn() -> {owner_class: iterable ids}
        self._live_sources: dict[str, Callable[[], Mapping]] = {}
        # churn accounting
        self.churn_totals: dict[tuple[str, str], int] = {}
        self._churn_ring: deque[tuple[float, str, str, int]] = deque(
            maxlen=self._CHURN_RING)
        # TTX state
        self._alloc_acc: dict[str, int] = {}     # qos -> blocks since obs
        self._release_acc: dict[str, int] = {}
        self._alloc_rate: dict[str, float] = {}  # qos -> EWMA blocks/s
        self._release_rate: dict[str, float] = {}
        self.alloc_totals: dict[str, int] = {}
        self.release_totals: dict[str, int] = {}
        self._last_obs_t: float | None = None
        self.ttx_s = TTX_CAP_S
        self.posture = "ok"
        # audit state
        self._last_audit_t: float | None = None
        self.last_audit: dict | None = None

    # -- configuration --------------------------------------------------
    def configure(self, enabled: bool | None = None, *,
                  audit_interval_s: float | None = None,
                  ttx_tight_s: float | None = None,
                  ttx_critical_s: float | None = None) -> None:
        """Engine-startup hook: re-read the env gate (or force a value)
        and optionally override the audit cadence / posture thresholds."""
        with self._lock:
            self.enabled = mem_enabled() if enabled is None else enabled
            if audit_interval_s is not None:
                self.audit_interval_s = audit_interval_s
            if ttx_tight_s is not None:
                self.ttx_tight_s = ttx_tight_s
            if ttx_critical_s is not None:
                self.ttx_critical_s = ttx_critical_s

    def reset(self) -> None:
        """Test hook: drop all pins/rates/sources (metrics counters are
        monotonic and keep their values; gauges are re-zeroed)."""
        with self._lock:
            self._pins.clear()
            self._tiers.clear()
            self._live_sources.clear()
            self.churn_totals.clear()
            self._churn_ring.clear()
            self._alloc_acc.clear()
            self._release_acc.clear()
            self._alloc_rate.clear()
            self._release_rate.clear()
            self.alloc_totals.clear()
            self.release_totals.clear()
            self._last_obs_t = None
            self.ttx_s = TTX_CAP_S
            self.posture = "ok"
            self._last_audit_t = None
            self.last_audit = None
            self._device_free = self._device_cached = self._device_total = 0
        m = get_mem_metrics()
        for owner in OWNER_CLASSES:
            m.device_blocks.set(0.0, owner=owner)
            m.orphans.set(0.0, owner=owner)
        m.device_blocks.set(0.0, owner="free")
        m.device_blocks.set(0.0, owner="cached")
        m.ttx.set(TTX_CAP_S)
        m.posture.set(0.0)

    # -- pin taxonomy ----------------------------------------------------
    def pin(self, owner: str, owner_id: str, blocks: int) -> None:
        """Tag ``blocks`` device blocks as pinned by (owner, owner_id)."""
        if not self.enabled or blocks <= 0:
            return
        key = (owner, str(owner_id))
        with self._lock:
            self._pins[key] = self._pins.get(key, 0) + int(blocks)
            total = self._owner_total(owner)
        get_mem_metrics().device_blocks.set(float(total), owner=owner)

    def unpin(self, owner: str, owner_id: str,
              blocks: int | None = None) -> None:
        """Release ``blocks`` pins of (owner, owner_id); None = all of
        them. Over-release clamps at zero (the pool's own double-free
        check is the hard error path, not the ledger's)."""
        if not self.enabled:
            return
        key = (owner, str(owner_id))
        with self._lock:
            held = self._pins.get(key, 0)
            if held <= 0:
                return
            drop = held if blocks is None else min(int(blocks), held)
            left = held - drop
            if left > 0:
                self._pins[key] = left
            else:
                del self._pins[key]
            total = self._owner_total(owner)
        get_mem_metrics().device_blocks.set(float(total), owner=owner)

    def _owner_total(self, owner: str) -> int:
        # caller holds the lock
        return sum(n for (cls, _), n in self._pins.items() if cls == owner)

    def owner_blocks(self) -> dict[str, int]:
        """Pinned device blocks per owner class (zero rows included)."""
        with self._lock:
            out = {cls: 0 for cls in OWNER_CLASSES}
            for (cls, _), n in self._pins.items():
                out[cls] = out.get(cls, 0) + n
        return out

    def top_owners(self, top: int = 10) -> list[dict]:
        """Largest individual pin holders: [{owner, id, blocks}]."""
        with self._lock:
            items = sorted(self._pins.items(), key=lambda kv: kv[1],
                           reverse=True)[:top]
        return [{"owner": cls, "id": oid, "blocks": n}
                for (cls, oid), n in items]

    # -- occupancy -------------------------------------------------------
    def observe_device(self, free: int, cached: int,
                       total: int | None = None) -> None:
        """Publish the pool-side waterfall rows: ``free`` (free-list) and
        ``cached`` (committed-inactive, evictable) block counts."""
        if not self.enabled:
            return
        with self._lock:
            self._device_free = int(free)
            self._device_cached = int(cached)
            if total is not None:
                self._device_total = int(total)
        m = get_mem_metrics()
        m.device_blocks.set(float(free), owner="free")
        m.device_blocks.set(float(cached), owner="cached")

    def register_tier(self, name: str,
                      fn: Callable[[], tuple[int, int]]) -> None:
        """Register a tier occupancy callback ``fn() -> (blocks, bytes)``.
        Pulled only at snapshot/debug/audit time — a tier whose len() is a
        network call (the remote store) never lands on the step path."""
        with self._lock:
            self._tiers[name] = fn

    def tier_occupancy(self) -> dict[str, dict]:
        """Pull every registered tier; a failing callback reports an
        error row instead of raising (a dead remote store must not take
        /debug/mem down with it)."""
        with self._lock:
            tiers = dict(self._tiers)
        out: dict[str, dict] = {}
        m = get_mem_metrics()
        for name, fn in tiers.items():
            try:
                blocks, nbytes = fn()
            except Exception as exc:  # noqa: BLE001 — degrade, don't raise
                out[name] = {"error": f"{type(exc).__name__}: {exc}"[:120]}
                continue
            out[name] = {"blocks": int(blocks), "bytes": int(nbytes)}
            m.tier_blocks.set(float(blocks), tier=name)
            m.tier_bytes.set(float(nbytes), tier=name)
        return out

    # -- churn -----------------------------------------------------------
    def record_churn(self, tier: str, cause: str, blocks: int = 1,
                     ts: float | None = None) -> None:
        """One eviction/demotion event: ``blocks`` left ``tier`` because
        of ``cause`` (allocation_pressure, session_demote, clear, lru,
        byte_budget)."""
        if not self.enabled or blocks <= 0:
            return
        key = (tier, cause)
        with self._lock:
            self.churn_totals[key] = self.churn_totals.get(key, 0) + blocks
            self._churn_ring.append(
                (ts if ts is not None else time.time(), tier, cause, blocks))
        get_mem_metrics().churn.inc(blocks, tier=tier, cause=cause)

    def churn_trend(self, limit: int = 64) -> list[dict]:
        with self._lock:
            recent = list(self._churn_ring)[-limit:]
        return [{"ts": round(t, 3), "tier": tier, "cause": cause,
                 "blocks": n} for t, tier, cause, n in recent]

    # -- TTX forecasting -------------------------------------------------
    def record_alloc(self, qos: str, blocks: int) -> None:
        """Blocks consumed from the pool (admission or decode growth)."""
        if not self.enabled or blocks <= 0:
            return
        with self._lock:
            self._alloc_acc[qos] = self._alloc_acc.get(qos, 0) + blocks
            self.alloc_totals[qos] = self.alloc_totals.get(qos, 0) + blocks
        get_mem_metrics().alloc.inc(blocks, qos_class=qos)

    def record_release(self, qos: str, blocks: int) -> None:
        """Blocks returned to the pool (finish/preempt release)."""
        if not self.enabled or blocks <= 0:
            return
        with self._lock:
            self._release_acc[qos] = self._release_acc.get(qos, 0) + blocks
            self.release_totals[qos] = (
                self.release_totals.get(qos, 0) + blocks)
        get_mem_metrics().release.inc(blocks, qos_class=qos)

    def observe_free(self, free_blocks: int,
                     now: float | None = None) -> tuple[float, str]:
        """Fold the accumulated alloc/release deltas into the per-QoS EWMA
        rates and refresh the forecast: ``ttx = free / net_rate`` where
        ``net_rate = Σ_qos (alloc_ewma - release_ewma)``, capped at
        TTX_CAP_S when the pool is not consuming. Returns (ttx, posture)
        and counts one kv_headroom observation."""
        if not self.enabled:
            return TTX_CAP_S, "ok"
        t = now if now is not None else time.time()
        with self._lock:
            if self._last_obs_t is None or t <= self._last_obs_t:
                # first observation (or non-advancing clock): baseline only
                self._last_obs_t = t
                self._alloc_acc.clear()
                self._release_acc.clear()
                ttx, posture = self.ttx_s, self.posture
            else:
                dt = t - self._last_obs_t
                self._last_obs_t = t
                a = self.ewma_alpha
                for qos in set(self._alloc_rate) | set(self._alloc_acc):
                    inst = self._alloc_acc.get(qos, 0) / dt
                    prev = self._alloc_rate.get(qos, inst)
                    self._alloc_rate[qos] = a * inst + (1 - a) * prev
                for qos in set(self._release_rate) | set(self._release_acc):
                    inst = self._release_acc.get(qos, 0) / dt
                    prev = self._release_rate.get(qos, inst)
                    self._release_rate[qos] = a * inst + (1 - a) * prev
                self._alloc_acc.clear()
                self._release_acc.clear()
                net = (sum(self._alloc_rate.values())
                       - sum(self._release_rate.values()))
                if net > 1e-9:
                    ttx = min(max(free_blocks, 0) / net, TTX_CAP_S)
                else:
                    ttx = TTX_CAP_S
                if ttx < self.ttx_critical_s:
                    posture = "critical"
                elif ttx < self.ttx_tight_s:
                    posture = "tight"
                else:
                    posture = "ok"
                self.ttx_s, self.posture = ttx, posture
        m = get_mem_metrics()
        m.ttx.set(ttx)
        m.posture.set(float(POSTURES.index(posture)))
        m.headroom.inc(state=("ok" if posture == "ok" else "short"))
        return ttx, posture

    def consumption_rates(self) -> dict[str, dict[str, float]]:
        """Per-QoS EWMA rates: {qos: {alloc_bps, release_bps, net_bps}}."""
        with self._lock:
            out = {}
            for qos in sorted(set(self._alloc_rate) | set(self._release_rate)):
                al = self._alloc_rate.get(qos, 0.0)
                rl = self._release_rate.get(qos, 0.0)
                out[qos] = {"alloc_bps": round(al, 4),
                            "release_bps": round(rl, 4),
                            "net_bps": round(al - rl, 4)}
        return out

    # -- leak audit ------------------------------------------------------
    def register_live_source(self, key: str,
                             fn: Callable[[], Mapping]) -> None:
        """Register an audit source: ``fn() -> {owner_class: iterable of
        live owner ids}``. One source per engine (keyed by engine id) so
        in-process fleets union their live sets instead of clobbering."""
        with self._lock:
            self._live_sources[str(key)] = fn

    def unregister_live_source(self, key: str) -> None:
        with self._lock:
            self._live_sources.pop(str(key), None)

    def audit(self, now: float | None = None) -> dict:
        """Reconcile every tagged pin against the union of live ids: a
        pin whose owner id no live source knows is an orphan. Exports
        ``dynamo_mem_orphan_pins{owner}`` and retains the report for
        /debug/mem. Owner classes with NO registered live source are
        skipped (unauditable is not orphaned)."""
        t = now if now is not None else time.time()
        with self._lock:
            sources = list(self._live_sources.values())
            pins = dict(self._pins)
        live: dict[str, set[str]] = {}
        covered: set[str] = set()
        for fn in sources:
            try:
                got = fn()
            except Exception:  # noqa: BLE001 — a dead source audits empty
                continue
            for cls, ids in got.items():
                covered.add(cls)
                live.setdefault(cls, set()).update(str(i) for i in ids)
        orphans: dict[str, list[dict]] = {}
        counts = {cls: 0 for cls in OWNER_CLASSES}
        for (cls, oid), n in pins.items():
            if cls not in covered:
                continue
            if oid in live.get(cls, ()):
                continue
            orphans.setdefault(cls, []).append({"id": oid, "blocks": n})
            counts[cls] = counts.get(cls, 0) + 1
        for rows in orphans.values():
            rows.sort(key=lambda r: r["blocks"], reverse=True)
        total = sum(counts.values())
        report = {
            "ts": t,
            "orphan_pins": total,
            "orphans": orphans,
            "by_owner": counts,
            "pins_checked": len(pins),
            "classes_covered": sorted(covered),
        }
        with self._lock:
            self._last_audit_t = t
            self.last_audit = report
        m = get_mem_metrics()
        for cls in OWNER_CLASSES:
            m.orphans.set(float(counts.get(cls, 0)), owner=cls)
        m.audits.inc(result=("orphans" if total else "clean"))
        return report

    def maybe_audit(self, now: float | None = None) -> dict | None:
        """Periodic-audit valve: runs :meth:`audit` when the configured
        interval elapsed since the last one. Returns the report or None."""
        if not self.enabled:
            return None
        t = now if now is not None else time.time()
        with self._lock:
            last = self._last_audit_t
            due = last is None or t - last >= self.audit_interval_s
        return self.audit(t) if due else None

    # -- publishing ------------------------------------------------------
    def republish(self) -> None:
        """Push current gauge state into the (possibly re-bound) metrics
        family — install_mem_metrics and test hooks."""
        m = get_mem_metrics()
        owners = self.owner_blocks()
        with self._lock:
            free, cached = self._device_free, self._device_cached
            ttx, posture = self.ttx_s, self.posture
            audit = self.last_audit
        for cls, n in owners.items():
            m.device_blocks.set(float(n), owner=cls)
        m.device_blocks.set(float(free), owner="free")
        m.device_blocks.set(float(cached), owner="cached")
        m.ttx.set(ttx)
        m.posture.set(float(POSTURES.index(posture)))
        if audit:
            for cls in OWNER_CLASSES:
                m.orphans.set(
                    float(audit["by_owner"].get(cls, 0)), owner=cls)
        self.tier_occupancy()

    def snapshot(self) -> dict:
        """Compact dict for stats publishing / bench artifacts."""
        owners = self.owner_blocks()
        with self._lock:
            out = {
                "enabled": self.enabled,
                "device_blocks": {
                    **owners,
                    "free": self._device_free,
                    "cached": self._device_cached,
                },
                "device_total_blocks": self._device_total,
                "churn": {f"{t}/{c}": n
                          for (t, c), n in sorted(self.churn_totals.items())},
                "alloc_blocks": dict(self.alloc_totals),
                "release_blocks": dict(self.release_totals),
                "ttx_seconds": round(self.ttx_s, 3),
                "posture": self.posture,
                "orphan_pins": (self.last_audit or {}).get("orphan_pins", 0),
                "last_audit_ts": (self.last_audit or {}).get("ts"),
            }
        out["tiers"] = self.tier_occupancy()
        return out

    def debug_info(self, limit: int = 64) -> dict:
        """The /debug/mem document: tier waterfall, top pin owners, churn
        trend, consumption rates, and the last audit report."""
        return {
            "enabled": self.enabled,
            "env": MEM_ENV,
            "totals": self.snapshot(),
            "top_owners": self.top_owners(),
            "churn_trend": self.churn_trend(limit),
            "rates": self.consumption_rates(),
            "ttx": {
                "seconds": round(self.ttx_s, 3),
                "posture": self.posture,
                "tight_s": self.ttx_tight_s,
                "critical_s": self.ttx_critical_s,
            },
            "last_audit": self.last_audit,
        }


_ledger: MemLedger | None = None
_ledger_lock = threading.Lock()


def get_mem_ledger() -> MemLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = MemLedger()
        return _ledger


def live_ids_of(*, streams: Iterable[str] = (), sessions: Iterable[str] = (),
                prefix_publish: Iterable[str] = (),
                stream_ckpt: Iterable[str] = (),
                staging: Iterable[str] = ()) -> dict[str, list[str]]:
    """Build one live-source payload with every owner class present —
    engines should report ALL classes they own pins for, even when empty
    (an omitted class is 'unauditable', not 'nothing live')."""
    return {
        "stream": [str(i) for i in streams],
        "session": [str(i) for i in sessions],
        "prefix_publish": [str(i) for i in prefix_publish],
        "stream_ckpt": [str(i) for i in stream_ckpt],
        "staging": [str(i) for i in staging],
    }
