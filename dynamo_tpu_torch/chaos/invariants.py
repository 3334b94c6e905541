"""Post-scenario invariant checking: did the system degrade *correctly*?

A chaos scenario doesn't assert that nothing failed — failure is the
input. It asserts the system-wide postconditions that must hold no matter
what was injected:

* **No lost streams** — every client request either finished (a terminal
  ``finish_reason``) or surfaced a *typed* error (an HTTP error status or
  an error payload). A stream that just stops is an outage.
* **No leaked KV blocks** — after the fleet drains, every engine reports
  zero running/waiting requests and zero pinned device blocks
  (``kv_usage`` counts only refcounted/active blocks; parked prefix-cache
  blocks are evictable and don't count).
* **Rank-identical SPMD op streams** — multi-host engines must have
  applied the exact same op sequence on every rank; divergence means a
  future collective hangs.
* **Metrics balance** — ``qos_admitted_total`` must equal the terminal
  request count after admission (completed + failed), i.e.
  admitted + shed == every request accounted for. Requests rejected
  before admission (400/404 client errors) sit outside both sides.

The report is plain data (``to_dict``) so the deterministic-replay test
can assert two runs of the same seed produce *identical* reports.

Copy of ``dynamo_tpu/chaos/invariants.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

from dynamo_tpu_torch.utils.metrics import metric_sum, parse_prometheus

__all__ = ["parse_prometheus", "metric_sum", "StreamOutcome",
           "InvariantReport", "InvariantChecker",
           "ADMITTED_TERMINAL_STATUSES", "SHED_STATUSES",
           "CLIENT_ERROR_STATUSES", "GENERATE_ROUTES"]

# frontend_requests_total statuses on the chat/completions routes, split by
# where in the request lifecycle they are emitted (frontend/service.py):
# post-admission terminals count against qos_admitted_total; shed statuses
# mirror qos_rejected_total; client errors precede the QoS gate entirely.
ADMITTED_TERMINAL_STATUSES = {"200", "499", "500"}
SHED_STATUSES = {"429", "503", "504"}
CLIENT_ERROR_STATUSES = {"400", "404", "501", "502"}
GENERATE_ROUTES = {"chat", "completions"}


@dataclass
class StreamOutcome:
    """What one client request ended as, from the client's point of view."""

    request_id: str
    status: str            # "finished" | "error" | "lost"
    detail: str = ""

    def to_dict(self) -> dict:
        return {"request_id": self.request_id, "status": self.status,
                "detail": self.detail}


@dataclass
class InvariantReport:
    failures: list[str] = field(default_factory=list)
    checks: list[str] = field(default_factory=list)
    details: dict[str, Any] = field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return not self.failures

    def ok(self, name: str) -> None:
        self.checks.append(name)

    def fail(self, msg: str) -> None:
        self.failures.append(msg)

    def to_dict(self) -> dict:
        return {"passed": self.passed, "checks": list(self.checks),
                "failures": list(self.failures), "details": dict(self.details)}


class InvariantChecker:
    """Accumulates scenario evidence, then renders one report."""

    def __init__(self) -> None:
        self.report = InvariantReport()

    # -- streams -----------------------------------------------------------
    def check_streams(self, outcomes: Iterable[StreamOutcome]) -> None:
        outcomes = list(outcomes)
        lost = [o for o in outcomes if o.status == "lost"]
        counts = {
            "finished": sum(o.status == "finished" for o in outcomes),
            "error": sum(o.status == "error" for o in outcomes),
            "lost": len(lost),
        }
        self.report.details["streams"] = counts
        if lost:
            for o in lost[:5]:
                self.report.fail(
                    f"stream lost: request {o.request_id} ended without a "
                    f"finish reason or typed error ({o.detail})")
        else:
            self.report.ok("no_lost_streams")

    # -- kv leaks ----------------------------------------------------------
    def check_block_leaks(self, engine_stats: Mapping[str, Any]) -> None:
        """``engine_stats`` is the frontend /engine_stats JSON: per model,
        ``workers`` maps worker id -> published engine stats. Single-worker
        fleets (no kv router) may publish no per-worker map; that is a skip,
        not a pass.

        Workers running the memory ledger (obs/mem_ledger.py) publish a
        ``mem`` block whose pin-owner audit replaces the old kv_usage
        heuristic: ``orphan_pins`` must be zero AND no owner class may
        still hold pinned blocks after drain. Workers without the block
        (DYN_MEM_LEDGER=0) fall back to the kv_usage walk."""
        leaks: list[str] = []
        seen = audited = 0
        for model, stats in engine_stats.items():
            for wid, m in (stats.get("workers") or {}).items():
                if not isinstance(m, Mapping):
                    continue
                seen += 1
                running = m.get("num_running", 0) or 0
                waiting = m.get("num_waiting", 0) or 0
                usage = m.get("kv_usage", 0.0) or 0.0
                if running or waiting:
                    leaks.append(
                        f"{model}/{wid}: {running} running + {waiting} "
                        "waiting after drain")
                    continue
                mem = m.get("mem")
                if isinstance(mem, Mapping) and mem.get("enabled"):
                    audited += 1
                    orphans = int(mem.get("orphan_pins", 0) or 0)
                    if orphans:
                        leaks.append(
                            f"{model}/{wid}: {orphans} orphan pin(s) at "
                            "last mem-ledger audit (leaked references)")
                    held = {
                        cls: n for cls, n in
                        (mem.get("device_blocks") or {}).items()
                        if cls not in ("free", "cached") and n}
                    # session pins legitimately survive a drain (retained
                    # turns are the feature, not a leak)
                    held.pop("session", None)
                    if held:
                        leaks.append(
                            f"{model}/{wid}: pinned blocks after drain "
                            f"by owner {held}")
                elif usage > 1e-9:
                    leaks.append(
                        f"{model}/{wid}: kv_usage={usage:.4f} with no "
                        "running requests (leaked pinned blocks)")
        self.report.details["block_leak_workers_checked"] = seen
        self.report.details["block_leak_workers_audited"] = audited
        for leak in leaks:
            self.report.fail(f"kv leak: {leak}")
        if not leaks and seen:
            self.report.ok("no_leaked_blocks")

    # -- SPMD op streams ---------------------------------------------------
    def check_op_streams(self, streams: Mapping[int, Iterable[Any]]) -> None:
        """``streams`` maps rank -> its applied op sequence. All ranks must
        have applied identical sequences (broadcast-then-apply contract of
        engine._emit_op); the first divergence is reported by index."""
        per_rank = {r: list(ops) for r, ops in streams.items()}
        self.report.details["op_stream_ranks"] = sorted(per_rank)
        if len(per_rank) < 2:
            return
        ranks = sorted(per_rank)
        ref_rank, ref = ranks[0], per_rank[ranks[0]]
        diverged = False
        for r in ranks[1:]:
            ops = per_rank[r]
            if ops == ref:
                continue
            diverged = True
            idx = next((i for i, (a, b) in enumerate(zip(ref, ops))
                        if a != b), min(len(ref), len(ops)))
            self.report.fail(
                f"SPMD op streams diverge: rank {r} differs from rank "
                f"{ref_rank} at op index {idx} "
                f"(lengths {len(ops)} vs {len(ref)})")
        if not diverged:
            self.report.ok("spmd_op_streams_identical")

    # -- warm resume -------------------------------------------------------
    def check_warm_resume(self, engine_stats: Mapping[str, Any],
                          minimum: int = 1) -> None:
        """After a drained worker evacuated its retained sessions
        (runtime/drain.py), surviving workers must have resumed at least
        ``minimum`` session turns from the remote records — retirement
        converts would-be full recomputes into pull-to-warm imports.
        ``engine_stats`` is the frontend /engine_stats JSON."""
        resumes = hits = 0
        for stats in engine_stats.values():
            for m in (stats.get("workers") or {}).values():
                if isinstance(m, Mapping):
                    resumes += int(m.get("session_remote_resumes", 0) or 0)
                    hits += int(m.get("session_hits", 0) or 0)
        self.report.details["warm_resume"] = {
            "session_remote_resumes": resumes, "session_hits": hits}
        if resumes < minimum:
            self.report.fail(
                f"no warm resume: {resumes} session turn(s) resumed from "
                f"evacuated records (needed >= {minimum})")
        else:
            self.report.ok("sessions_resumed_warm")

    # -- checkpoint resume -------------------------------------------------
    def check_ckpt_resume(self, engine_stats: Mapping[str, Any],
                          minimum: int = 1) -> None:
        """After an unplanned worker kill, surviving workers must have
        warm-resumed at least ``minimum`` checkpointed streams
        (kvbm/stream_ckpt.py): resumes >= kills for checkpointed streams —
        the crash cost recompute, never the stream. ``engine_stats`` is the
        frontend /engine_stats JSON."""
        resumes = writes = 0
        for stats in engine_stats.values():
            for m in (stats.get("workers") or {}).values():
                if isinstance(m, Mapping):
                    resumes += int(m.get("stream_ckpt_resumes", 0) or 0)
                    writes += int(m.get("stream_ckpt_writes", 0) or 0)
        self.report.details["ckpt_resume"] = {
            "stream_ckpt_resumes": resumes, "stream_ckpt_writes": writes}
        if resumes < minimum:
            self.report.fail(
                f"no checkpoint resume: {resumes} stream(s) warm-resumed "
                f"from checkpoints (needed >= {minimum})")
        else:
            self.report.ok("streams_resumed_from_ckpt")

    # -- metrics balance ---------------------------------------------------
    def check_metrics_balance(self, metrics_text: str) -> None:
        """shed + completed + failed == admitted + shed, from the frontend's
        /metrics exposition (chat/completions routes only)."""
        samples = parse_prometheus(metrics_text)
        admitted = metric_sum(samples, "dynamo_qos_admitted_total")
        shed = metric_sum(samples, "dynamo_qos_rejected_total")
        completed = failed = shed_http = 0.0
        for (name, labels), v in samples.items():
            if name != "dynamo_frontend_requests_total":
                continue
            d = dict(labels)
            if d.get("route") not in GENERATE_ROUTES:
                continue
            status = d.get("status", "")
            if status == "200":
                completed += v
            elif status in ADMITTED_TERMINAL_STATUSES:
                failed += v
            elif status in SHED_STATUSES:
                shed_http += v
        self.report.details["metrics_balance"] = {
            "admitted": admitted, "completed": completed, "failed": failed,
            "shed": shed, "shed_http": shed_http,
        }
        if admitted != completed + failed:
            self.report.fail(
                f"metrics imbalance: qos_admitted_total={admitted:g} but "
                f"completed({completed:g}) + failed({failed:g}) = "
                f"{completed + failed:g}")
        else:
            self.report.ok("metrics_admitted_balance")
        if shed_http > shed:
            # every shed HTTP response must have a matching QoS rejection
            # (the reverse can differ: non-generate routes also reject)
            self.report.fail(
                f"metrics imbalance: {shed_http:g} shed HTTP responses but "
                f"only {shed:g} qos_rejected_total")
        else:
            self.report.ok("metrics_shed_balance")

    # -- fleet rollup ------------------------------------------------------
    def check_fleet_rollup(self, aggregator_text: str) -> None:
        """Same admitted-vs-terminal balance, but read from the fleet
        aggregator's rollup series (``instance="_fleet"``): after targets
        died and recovered mid-scenario the aggregator's fleet view must
        still account for every admitted request."""
        samples = parse_prometheus(aggregator_text)
        fleet = {"instance": "_fleet"}
        admitted = metric_sum(samples, "dynamo_qos_admitted_total", **fleet)
        completed = failed = 0.0
        for (name, labels), v in samples.items():
            if name != "dynamo_frontend_requests_total":
                continue
            d = dict(labels)
            if d.get("instance") != "_fleet":
                continue
            if d.get("route") not in GENERATE_ROUTES:
                continue
            status = d.get("status", "")
            if status == "200":
                completed += v
            elif status in ADMITTED_TERMINAL_STATUSES:
                failed += v
        scrape_errors = metric_sum(samples, "dynamo_fleet_scrape_errors_total")
        self.report.details["fleet_rollup"] = {
            "admitted": admitted, "completed": completed, "failed": failed,
            "scrape_errors": scrape_errors,
        }
        if admitted != completed + failed:
            self.report.fail(
                f"fleet rollup imbalance: qos_admitted_total={admitted:g} "
                f"but completed({completed:g}) + failed({failed:g}) = "
                f"{completed + failed:g}")
        else:
            self.report.ok("fleet_rollup_admitted_balance")

    def finish(self) -> InvariantReport:
        return self.report
