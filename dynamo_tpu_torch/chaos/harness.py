"""Chaos harness: drive a mocker fleet through scripted failure scenarios.

Spawns a real coordinator + mocker workers + frontend as subprocesses
(the zero-accelerator e2e shape of tests/test_e2e_mockers.py), injects
faults — either by manipulating processes directly (SIGKILL, restart) or
by shipping a ChaosPlan to the children via ``DYN_CHAOS_PLAN`` /
``DYN_CHAOS_SEED`` — then drives client load and hands the evidence to
the :class:`~dynamo_tpu_torch.chaos.invariants.InvariantChecker`.

Scenarios return a :class:`ScenarioResult` whose ``report`` is plain data,
so a caller can print it and the deterministic-replay test can compare
two runs byte-for-byte.

Copy of ``dynamo_tpu/chaos/harness.py``: the fleet is the port's processes
(``dynamo_tpu_torch.transports.coordinator``, ``.components.worker
--engine mocker``, ``.components.kv_store``, ``.components.frontend`` and
``.components.aggregator``), and their environment sets no JAX or TPU
variable. ``tests/test_torch_chaos.py`` runs the scenarios, chip_smoke (m1)
too::

    python -c "from dynamo_tpu_torch.chaos.harness import run_scenario; \
        print(run_scenario('smoke').to_dict())"
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from dynamo_tpu_torch.chaos.invariants import (
    InvariantChecker,
    InvariantReport,
    StreamOutcome,
)
from dynamo_tpu_torch.chaos.plan import ChaosPlan
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("chaos.harness")

REPO = Path(__file__).resolve().parent.parent.parent

_BASE_ENV = {
    "PYTHONPATH": str(REPO),
    "PYTHONUNBUFFERED": "1",
    "DYN_LOG": "info",
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Proc:
    """Subprocess with readiness-line gating + captured logs (the
    ManagedProcess shape of tests/utils_process.py, importable from the
    package so the harness works outside pytest)."""

    def __init__(self, args: list[str], name: str, env: dict | None = None):
        self.name = name
        self.args = [sys.executable, "-u", *args]
        self.env = {**os.environ, **_BASE_ENV, **(env or {})}
        self.proc: subprocess.Popen | None = None
        self._lines: list[str] = []

    def start(self) -> "Proc":
        self.proc = subprocess.Popen(
            self.args, env=self.env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._drain, daemon=True).start()
        return self

    def _drain(self) -> None:
        assert self.proc and self.proc.stdout
        for line in self.proc.stdout:
            self._lines.append(line)

    def wait_for_line(self, needle: str, timeout: float = 30.0) -> str:
        deadline = time.time() + timeout
        scanned = 0
        while time.time() < deadline:
            lines = self._lines
            while scanned < len(lines):
                if needle in lines[scanned]:
                    return lines[scanned]
                scanned += 1
            if self.proc.poll() is not None and scanned >= len(self._lines):
                raise RuntimeError(
                    f"{self.name} exited rc={self.proc.returncode}:\n"
                    + "".join(self._lines[-50:]))
            time.sleep(0.02)
        raise TimeoutError(f"{self.name}: no {needle!r} within {timeout}s:\n"
                           + "".join(self._lines[-50:]))

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill_hard(self) -> None:
        if self.alive():
            self.proc.kill()

    def stop(self, grace: float = 5.0) -> None:
        if self.proc is None or self.proc.poll() is not None:
            return
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(grace)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(5)

    def logs(self) -> str:
        return "".join(self._lines)


def http_json(url: str, payload: dict | None = None, timeout: float = 30.0,
              headers: dict | None = None):
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode() if payload is not None else None,
        headers={"content-type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


@dataclass
class FleetConfig:
    workers: int = 2
    router_mode: str = "kv"
    speedup_ratio: float = 50.0
    block_size: int = 4
    num_blocks: int = 128
    max_model_len: int = 512
    migration_limit: int = 3
    lease_ttl_s: float | None = None          # None = runtime default
    chaos_plan: "ChaosPlan | None" = None     # shipped to WORKERS via env
    chaos_seed: int | None = None
    worker_env: dict[str, str] = field(default_factory=dict)
    frontend_env: dict[str, str] = field(default_factory=dict)
    worker_args: list[str] = field(default_factory=list)
    kv_store: bool = False                    # spawn a G4 remote block store
    aggregator: bool = False                  # spawn a fleet aggregator
    aggregator_env: dict[str, str] = field(default_factory=dict)
    scrape_interval_s: float = 0.5            # aggregator sweep cadence
    staleness_ttl_s: float = 2.0              # aggregator staleness window


class MockerFleet:
    """coordinator + N mocker workers + frontend, as real processes."""

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg
        self.coord_port = free_port()
        self.http_port = free_port()
        self.coord_url = f"tcp://127.0.0.1:{self.coord_port}"
        self.base = f"http://127.0.0.1:{self.http_port}"
        self.coordinator: Proc | None = None
        self.workers: list[Proc] = []
        self.frontend: Proc | None = None
        self.kv_store: Proc | None = None
        self.kv_port = free_port() if cfg.kv_store else 0
        self.aggregator: Proc | None = None
        self.agg_port = free_port() if cfg.aggregator else 0
        self.agg_base = f"http://127.0.0.1:{self.agg_port}"

    # -- lifecycle ---------------------------------------------------------
    def _common_env(self) -> dict[str, str]:
        env: dict[str, str] = {}
        if self.cfg.lease_ttl_s is not None:
            env["DYN_LEASE_TTL_S"] = str(self.cfg.lease_ttl_s)
        return env

    def _worker_env(self) -> dict[str, str]:
        env = {**self._common_env(), **self.cfg.worker_env}
        if self.cfg.aggregator:
            # scrape targets need the per-process status server up so
            # advertise_metrics() has a /metrics URL to publish
            env.setdefault("DYN_SYSTEM_ENABLED", "1")
        if self.cfg.chaos_plan is not None:
            env["DYN_CHAOS_PLAN"] = json.dumps(self.cfg.chaos_plan.to_dict())
        if self.cfg.chaos_seed is not None:
            env["DYN_CHAOS_SEED"] = str(self.cfg.chaos_seed)
        return env

    def start_worker(self, i: int) -> Proc:
        extra = (["--remote-kv-addr", f"127.0.0.1:{self.kv_port}"]
                 if self.cfg.kv_store else [])
        w = Proc(
            ["-m", "dynamo_tpu_torch.components.worker", "--engine", "mocker",
             "--coordinator", self.coord_url,
             "--block-size", str(self.cfg.block_size),
             "--speedup-ratio", str(self.cfg.speedup_ratio),
             "--max-model-len", str(self.cfg.max_model_len),
             "--num-blocks", str(self.cfg.num_blocks),
             *extra, *self.cfg.worker_args],
            name=f"worker{i}", env=self._worker_env()).start()
        return w

    def start(self) -> "MockerFleet":
        self.coordinator = Proc(
            ["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
             "--port", str(self.coord_port)], name="coordinator").start()
        self.coordinator.wait_for_line("COORDINATOR_READY", 20)
        if self.cfg.kv_store:
            self.kv_store = Proc(
                ["-m", "dynamo_tpu_torch.components.kv_store", "--host", "127.0.0.1",
                 "--port", str(self.kv_port),
                 # register lease-bound so the frontend's stream-checkpoint
                 # lookup can discover the store (workers get the address
                 # explicitly via --remote-kv-addr)
                 "--coordinator", self.coord_url],
                name="kv_store", env=self._common_env()).start()
            self.kv_store.wait_for_line("KV_STORE_READY", 20)
        self.workers = [self.start_worker(i) for i in range(self.cfg.workers)]
        for w in self.workers:
            w.wait_for_line("WORKER_READY", 30)
        self.frontend = Proc(
            ["-m", "dynamo_tpu_torch.components.frontend",
             "--coordinator", self.coord_url, "--host", "127.0.0.1",
             "--port", str(self.http_port),
             "--router-mode", self.cfg.router_mode,
             "--migration-limit", str(self.cfg.migration_limit)],
            name="frontend", env={**self._common_env(),
                                  **self.cfg.frontend_env}).start()
        self.frontend.wait_for_line("FRONTEND_READY", 30)
        if self.cfg.aggregator:
            self.aggregator = Proc(
                ["-m", "dynamo_tpu_torch.components.aggregator",
                 "--coordinator", self.coord_url, "--host", "127.0.0.1",
                 "--port", str(self.agg_port),
                 "--scrape-interval", str(self.cfg.scrape_interval_s),
                 "--scrape-timeout", "2.0",
                 "--staleness-ttl", str(self.cfg.staleness_ttl_s)],
                name="aggregator",
                env={**self._common_env(),
                     **self.cfg.aggregator_env}).start()
            self.aggregator.wait_for_line("AGGREGATOR_READY", 30)
        deadline = time.time() + 15
        while time.time() < deadline:
            try:
                if http_json(self.base + "/v1/models")["data"]:
                    return self
            except Exception:
                pass
            time.sleep(0.1)
        raise TimeoutError("model never discovered:\n" + self.frontend.logs())

    def stop(self) -> None:
        if self.aggregator:
            self.aggregator.stop()
        if self.frontend:
            self.frontend.stop()
        for w in self.workers:
            w.stop()
        if self.kv_store:
            self.kv_store.stop()
        if self.coordinator:
            self.coordinator.stop()

    def __enter__(self) -> "MockerFleet":
        try:
            return self.start()
        except BaseException:
            # a fleet that fails to start stops what it started (the JAX
            # copy leaves those processes running)
            self.stop()
            raise

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- observation -------------------------------------------------------
    def metrics_text(self) -> str:
        with urllib.request.urlopen(self.base + "/metrics", timeout=10) as r:
            return r.read().decode()

    def engine_stats(self) -> dict:
        return http_json(self.base + "/engine_stats")

    def aggregator_metrics_text(self) -> str:
        with urllib.request.urlopen(self.agg_base + "/metrics",
                                    timeout=10) as r:
            return r.read().decode()

    def fleet_debug(self) -> dict:
        return http_json(self.agg_base + "/debug/fleet", timeout=10)

    def wait_fleet_fresh(self, n: int, timeout: float = 30.0) -> dict:
        """Wait until the aggregator reports >= n fresh scrape targets;
        returns the final /debug/fleet document."""
        deadline = time.time() + timeout
        info: dict = {}
        while time.time() < deadline:
            try:
                info = self.fleet_debug()
                fresh = sum(1 for t in info.get("targets", [])
                            if t.get("fresh"))
                if fresh >= n:
                    return info
            except Exception:
                pass
            time.sleep(0.2)
        raise TimeoutError(
            f"aggregator never reached {n} fresh targets: {info}")

    def wait_drained(self, timeout: float = 20.0) -> dict:
        """Wait until every published worker snapshot shows an idle engine;
        returns the final /engine_stats. Published metrics lag ~1s."""
        deadline = time.time() + timeout
        stats: dict = {}
        while time.time() < deadline:
            stats = self.engine_stats()
            busy = False
            for model in stats.values():
                for m in (model.get("workers") or {}).values():
                    if (m.get("num_running", 0) or m.get("num_waiting", 0)
                            or (m.get("kv_usage", 0.0) or 0.0) > 1e-9):
                        busy = True
            if not busy:
                return stats
            time.sleep(0.3)
        return stats

    # -- load --------------------------------------------------------------
    def drive_load(self, n: int = 12, max_tokens: int = 8,
                   concurrency: int = 4, timeout: float = 30.0,
                   interval_s: float = 0.0) -> list[StreamOutcome]:
        """Fire ``n`` completions; classify every outcome for the stream-
        accounting invariant. An HTTP error status is a TYPED error (the
        client was told); a transport-level failure or a response without a
        finish_reason is a LOST stream."""

        def one(i: int) -> StreamOutcome:
            rid = f"chaos-{i}"
            if interval_s:
                time.sleep(interval_s * i)
            try:
                r = http_json(self.base + "/v1/completions", {
                    "model": "tiny-llama",
                    "prompt": f"chaos prompt {i} " * 4,
                    "max_tokens": max_tokens, "ignore_eos": True,
                }, timeout=timeout, headers={"x-request-id": rid})
                fr = r["choices"][0].get("finish_reason")
                if fr:
                    return StreamOutcome(rid, "finished", fr)
                return StreamOutcome(rid, "lost", "no finish_reason")
            except urllib.error.HTTPError as exc:
                return StreamOutcome(rid, "error", f"http {exc.code}")
            except Exception as exc:  # noqa: BLE001 - transport-level loss
                return StreamOutcome(rid, "lost", f"{type(exc).__name__}: {exc}")

        with concurrent.futures.ThreadPoolExecutor(concurrency) as ex:
            return list(ex.map(one, range(n)))

    def complete(self, prompt: str, rid: str, session: str | None = None,
                 max_tokens: int = 8, timeout: float = 30.0,
                 ) -> tuple[StreamOutcome, str]:
        """One completion with optional session affinity; returns the
        classified outcome plus the generated text (so a follow-up turn
        can extend the conversation — the ByteTokenizer is prefix-stable,
        so ``prompt + text`` re-hashes to the same block chain)."""
        headers = {"x-request-id": rid}
        if session is not None:
            headers["x-session-id"] = session
        try:
            r = http_json(self.base + "/v1/completions", {
                "model": "tiny-llama", "prompt": prompt,
                "max_tokens": max_tokens, "ignore_eos": True,
            }, timeout=timeout, headers=headers)
            choice = r["choices"][0]
            fr = choice.get("finish_reason")
            if fr:
                return StreamOutcome(rid, "finished", fr), choice.get("text") or ""
            return StreamOutcome(rid, "lost", "no finish_reason"), ""
        except urllib.error.HTTPError as exc:
            return StreamOutcome(rid, "error", f"http {exc.code}"), ""
        except Exception as exc:  # noqa: BLE001 - transport-level loss
            return StreamOutcome(rid, "lost", f"{type(exc).__name__}: {exc}"), ""


@dataclass
class ScenarioResult:
    name: str
    report: InvariantReport
    outcomes: list[StreamOutcome]
    seed: int | None = None

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "report": self.report.to_dict(),
                "outcomes": [o.to_dict() for o in self.outcomes]}


def _finish(name: str, fleet: MockerFleet,
            outcomes: list[StreamOutcome],
            seed: int | None = None,
            require_shed_zero: bool = False,
            aggregator_text: str | None = None) -> ScenarioResult:
    """Shared epilogue: drain, then run every fleet-level invariant."""
    checker = InvariantChecker()
    checker.check_streams(outcomes)
    stats = fleet.wait_drained()
    checker.check_block_leaks(stats)
    checker.check_metrics_balance(fleet.metrics_text())
    if aggregator_text is not None:
        checker.check_fleet_rollup(aggregator_text)
    if require_shed_zero:
        from dynamo_tpu_torch.chaos.invariants import metric_sum, parse_prometheus

        shed = metric_sum(parse_prometheus(fleet.metrics_text()),
                          "dynamo_qos_rejected_total")
        if shed:
            checker.report.fail(f"unexpected shedding: {shed:g} rejected")
    return ScenarioResult(name, checker.finish(), outcomes, seed=seed)


# ---------------------------------------------------------------------------
# Scenarios. Each takes a seed so the chaos-plan-driven ones replay exactly.
# ---------------------------------------------------------------------------

def scenario_smoke(seed: int = 1234) -> ScenarioResult:
    """Tier-1 smoke (<30s): inject transient dispatch errors + delays into
    every worker via a seeded plan; Migration must absorb them all."""
    plan = ChaosPlan.from_dict({"seed": seed, "rules": [
        # A burst of retryable dispatch failures...
        {"point": "worker.dispatch", "kind": "error", "rate": 0.3, "count": 4},
        # ...plus jitter on the mocker step loop (never fatal).
        {"point": "mocker.step", "kind": "delay", "rate": 0.05,
         "delay_s": 0.01},
    ]})
    cfg = FleetConfig(workers=2, chaos_plan=plan, chaos_seed=seed)
    with MockerFleet(cfg) as fleet:
        outcomes = fleet.drive_load(n=10, concurrency=4)
        return _finish("smoke", fleet, outcomes, seed=seed)


def scenario_worker_kill(seed: int = 1234) -> ScenarioResult:
    """Kill one worker mid-decode (chaos kind=kill after a few dispatches);
    migration re-dispatches onto the survivor, no stream is lost."""
    plan = ChaosPlan.from_dict({"seed": seed, "rules": [
        # the 3rd dispatch on whichever worker gets there first dies hard
        {"point": "worker.dispatch", "kind": "kill", "rate": 1.0,
         "count": 1, "after": 2},
    ]})
    cfg = FleetConfig(workers=2, chaos_plan=plan, chaos_seed=seed,
                      lease_ttl_s=3.0, speedup_ratio=10.0)
    with MockerFleet(cfg) as fleet:
        outcomes = fleet.drive_load(n=10, max_tokens=24, concurrency=3,
                                    timeout=60.0, interval_s=0.3)
        return _finish("worker_kill", fleet, outcomes, seed=seed)


def scenario_coordinator_partition(seed: int = 1234) -> ScenarioResult:
    """Kill + restart the coordinator mid-serving: workers re-register,
    frontend watches reset+replay, requests succeed throughout recovery."""
    cfg = FleetConfig(workers=2, lease_ttl_s=3.0)
    with MockerFleet(cfg) as fleet:
        pre = fleet.drive_load(n=4, concurrency=2)
        fleet.coordinator.stop()
        time.sleep(1.0)
        fleet.coordinator = Proc(
            ["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
             "--port", str(fleet.coord_port)], name="coordinator2").start()
        fleet.coordinator.wait_for_line("COORDINATOR_READY", 20)
        # data-plane connections survive the partition; serving continues
        # while control-plane state is re-declared
        mid = fleet.drive_load(n=4, concurrency=2, timeout=60.0)
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                if http_json(fleet.base + "/v1/models")["data"]:
                    break
            except Exception:
                pass
            time.sleep(0.5)
        post = fleet.drive_load(n=4, concurrency=2, timeout=60.0)
        return _finish("coordinator_partition", fleet, pre + mid + post,
                       seed=seed)


def scenario_lease_expiry_storm(seed: int = 1234) -> ScenarioResult:
    """Drop every worker's lease keepalives (chaos on transports.keepalive)
    with a short TTL: leases expire in waves, instances vanish via
    prefix-watch DELETEs, then re-register on the runtime's reconnect
    path. Requests riding through the storm must all terminate."""
    plan = ChaosPlan.from_dict({"seed": seed, "rules": [
        # every keepalive for ~2 TTLs fails, then the storm passes
        {"point": "transports.keepalive", "kind": "error", "rate": 1.0,
         "count": 4},
    ]})
    cfg = FleetConfig(workers=2, chaos_plan=plan, chaos_seed=seed,
                      lease_ttl_s=2.0)
    with MockerFleet(cfg) as fleet:
        outcomes = fleet.drive_load(n=12, concurrency=3, timeout=60.0,
                                    interval_s=0.5)
        # give re-registration time to settle before the drain check
        time.sleep(3.0)
        return _finish("lease_expiry_storm", fleet, outcomes, seed=seed)


def scenario_slow_rank_stall(seed: int = 1234) -> ScenarioResult:
    """One fleet under heavy per-step delay injection (the slow-rank/
    straggler shape): throughput drops but nothing times out, sheds, or
    leaks — slowness must degrade latency only."""
    plan = ChaosPlan.from_dict({"seed": seed, "rules": [
        {"point": "mocker.step", "kind": "delay", "rate": 0.5,
         "delay_s": 0.05},
    ]})
    cfg = FleetConfig(workers=2, chaos_plan=plan, chaos_seed=seed)
    with MockerFleet(cfg) as fleet:
        outcomes = fleet.drive_load(n=8, max_tokens=16, concurrency=4,
                                    timeout=60.0)
        return _finish("slow_rank_stall", fleet, outcomes, seed=seed,
                       require_shed_zero=True)


def scenario_aggregator_partition(seed: int = 1234) -> ScenarioResult:
    """Scrape targets dying/partitioned mid-interval: the aggregator must
    degrade the dead target to stale-labeled data with zero crashes while
    the rest of the fleet stays fresh, count every failed scrape in
    ``dynamo_fleet_scrape_errors_total``, and — after the worker comes
    back — its fleet qos_admitted rollup must re-balance against the
    terminal statuses."""
    agg_plan = ChaosPlan.from_dict({"seed": seed, "rules": [
        # a burst of injected scrape faults on top of the real partition
        {"point": "obs.fleet.scrape", "kind": "error", "rate": 0.2,
         "count": 6},
    ]})
    cfg = FleetConfig(
        workers=2, aggregator=True, speedup_ratio=10.0,
        scrape_interval_s=0.3, staleness_ttl_s=1.5,
        aggregator_env={"DYN_CHAOS_PLAN": json.dumps(agg_plan.to_dict()),
                        "DYN_CHAOS_SEED": str(seed)})
    with MockerFleet(cfg) as fleet:
        # discovery without static target lists: frontend + both workers
        fleet.wait_fleet_fresh(3)
        pre = fleet.drive_load(n=6, concurrency=3)

        victim = fleet.workers[1]
        victim.kill_hard()
        # the dead target must flip to stale without dropping the others
        deadline = time.time() + 20
        degraded: dict = {}
        while time.time() < deadline:
            degraded = fleet.fleet_debug()
            fresh = [t for t in degraded.get("targets", []) if t["fresh"]]
            stale = [t for t in degraded.get("targets", []) if not t["fresh"]]
            if stale and len(fresh) >= 2:
                break
            time.sleep(0.2)
        mid = fleet.drive_load(n=4, concurrency=2, timeout=60.0)

        fleet.workers[1] = fleet.start_worker(1)
        fleet.workers[1].wait_for_line("WORKER_READY", 30)
        fleet.wait_fleet_fresh(3)
        post = fleet.drive_load(n=4, concurrency=2, timeout=60.0)

        # the rollup is a scrape-time snapshot: wait for the sweep after
        # the last terminal status lands before judging the balance
        fleet.wait_drained()
        agg_text = ""
        deadline = time.time() + 15
        while time.time() < deadline:
            agg_text = fleet.aggregator_metrics_text()
            probe = InvariantChecker()
            probe.check_fleet_rollup(agg_text)
            if probe.report.passed:
                break
            time.sleep(max(cfg.scrape_interval_s, 0.2))

        res = _finish("aggregator_partition", fleet, pre + mid + post,
                      seed=seed, aggregator_text=agg_text)
        stale_seen = [t for t in degraded.get("targets", [])
                      if not t.get("fresh")]
        if not stale_seen:
            res.report.fail("dead worker never degraded to stale")
        else:
            res.report.ok("partition_degraded_to_stale")
        from dynamo_tpu_torch.chaos.invariants import metric_sum, parse_prometheus

        errs = metric_sum(parse_prometheus(agg_text),
                          "dynamo_fleet_scrape_errors_total")
        if errs <= 0:
            res.report.fail("dynamo_fleet_scrape_errors_total never moved")
        else:
            res.report.ok("scrape_errors_counted")
        if not fleet.aggregator.alive():
            res.report.fail("aggregator crashed during the partition:\n"
                            + fleet.aggregator.logs()[-2000:])
        else:
            res.report.ok("aggregator_survived")
        return res


def _check_orphan_pins(res: ScenarioResult, stats: dict) -> None:
    """Mem-ledger leak audit (obs/mem_ledger.py): every worker publishing
    a ``mem`` stats block must report zero orphan pins at its last audit —
    a pin whose owner id no longer exists anywhere is a leaked device
    reference no drain can reclaim."""
    orphans: dict[str, int] = {}
    checked = 0
    for model, s in stats.items():
        for wid, m in (s.get("workers") or {}).items():
            if not isinstance(m, dict):
                continue
            mem = m.get("mem") or {}
            if not mem.get("enabled"):
                continue
            checked += 1
            n = int(mem.get("orphan_pins", 0) or 0)
            if n:
                orphans[f"{model}/{wid}"] = n
    res.report.details["orphan_pins_workers_checked"] = checked
    if orphans:
        res.report.fail(f"mem-ledger audit found orphan pins: {orphans}")
    elif checked:
        res.report.ok("orphan_pins_zero")


def scenario_retire_under_load(seed: int = 1234,
                               quick: bool = False) -> ScenarioResult:
    """Drain-aware retirement end to end (runtime/drain.py): a worker
    holding retained sessions AND live streams is retired while a fresh
    replica serves on. The drain must lose zero streams, evacuate every
    session to the G4 store, and turn N+1 of each session must land on
    the survivor as a warm resume (remote record hit), not a recompute.
    ``quick=True`` is the sub-30s tier-1 smoke shape."""
    n_sessions = 2 if quick else 4
    n_bg = 3 if quick else 8
    cfg = FleetConfig(
        workers=1, kv_store=True, speedup_ratio=50.0, lease_ttl_s=3.0,
        # TTL far beyond the scenario: retention must survive until the
        # drain evacuates it (pop_oldest ignores TTL); both workers drain
        # at the end, so no sweep is needed for the leak check either.
        worker_args=["--session-ttl", "120",
                     "--drain-deadline", "6" if quick else "12"])
    with MockerFleet(cfg) as fleet:
        outcomes: list[StreamOutcome] = []
        turn1: dict[str, str] = {}
        # Turn 1: every session lands on worker0 (the only worker).
        for s in range(n_sessions):
            sid = f"sess-{s}"
            prompt = f"retire scenario session {s} context " * 3
            o, text = fleet.complete(prompt, f"turn1-{s}", session=sid)
            outcomes.append(o)
            turn1[sid] = prompt + text

        # Scale up, then retire worker0 mid-traffic.
        fleet.workers.append(fleet.start_worker(1))
        fleet.workers[1].wait_for_line("WORKER_READY", 30)
        victim = fleet.workers[0]
        bg_out: list[StreamOutcome] = []
        bg = threading.Thread(target=lambda: bg_out.extend(
            fleet.drive_load(n=n_bg, max_tokens=16, concurrency=2,
                             timeout=60.0)))
        bg.start()
        time.sleep(0.2)  # let some streams land on the victim first
        victim.proc.send_signal(signal.SIGTERM)
        drained_line = victim.wait_for_line("WORKER_DRAINED", 40)
        bg.join(90)
        outcomes.extend(bg_out)
        victim.proc.wait(10)

        # Turn 2: the retired worker is gone — each session's next turn
        # must resume warm on the survivor from the evacuated record.
        for s in range(n_sessions):
            sid = f"sess-{s}"
            o, _ = fleet.complete(turn1[sid] + " and then", f"turn2-{s}",
                                  session=sid, timeout=60.0)
            outcomes.append(o)
        # the survivor's resume counters reach /engine_stats on its next
        # publish tick — poll briefly instead of racing one snapshot
        stats: dict = {}
        deadline = time.time() + 10
        while time.time() < deadline:
            stats = fleet.engine_stats()
            probe = InvariantChecker()
            probe.check_warm_resume(stats, minimum=n_sessions)
            if probe.report.passed:
                break
            time.sleep(0.25)

        # Retire the survivor too: its retained turn-2 pins evacuate and
        # release, so the leak check sees a fully quiesced fleet.
        survivor = fleet.workers[1]
        survivor.proc.send_signal(signal.SIGTERM)
        survivor_line = survivor.wait_for_line("WORKER_DRAINED", 40)
        survivor.proc.wait(10)

        res = _finish("retire_under_load", fleet, outcomes, seed=seed)
        warm = InvariantChecker()
        warm.report = res.report
        warm.check_warm_resume(stats, minimum=n_sessions)
        _check_orphan_pins(res, stats)

        def parse_drained(line: str) -> dict:
            try:
                return json.loads(line.split("WORKER_DRAINED", 1)[1].strip())
            except Exception:
                return {}

        report = parse_drained(drained_line)
        res.report.details["drain_report"] = report
        # Routers forget retired workers, so exit-time occupancy from the
        # terminal reports is the leak check for the two drained processes.
        leaked = [r for r in (report, parse_drained(survivor_line))
                  if r.get("final_kv_usage", 0) > 1e-9
                  or r.get("final_num_running", 0)]
        if leaked:
            res.report.fail(f"retired worker exited with pinned KV: {leaked}")
        else:
            res.report.ok("retired_workers_quiesced")
        if report.get("state") != "done":
            res.report.fail(f"drain did not complete: {report}")
        else:
            res.report.ok("drain_completed")
        if report.get("evacuated_sessions", 0) < n_sessions:
            res.report.fail(
                f"evacuated {report.get('evacuated_sessions', 0)} of "
                f"{n_sessions} retained sessions")
        else:
            res.report.ok("all_sessions_evacuated")
        if victim.proc.returncode != 0:
            res.report.fail(
                f"retired worker exited rc={victim.proc.returncode} "
                "(SIGKILL escalation?)")
        else:
            res.report.ok("retired_worker_clean_exit")
        return res


def scenario_worker_kill_mid_decode(seed: int = 1234,
                                    quick: bool = False) -> ScenarioResult:
    """Crash-consistent stream checkpoints end to end (kvbm/stream_ckpt.py):
    a worker is SIGKILLed at a seeded decode step while a stream is
    mid-generation. The stream must NOT be lost: Migration finds the
    checkpoint record in the G4 store and resumes on a fresh replica,
    token-identical to an unkilled run (the mocker's md5 token stream
    depends only on (request_id, index), so re-running the same request id
    unkilled is an exact control), recomputing at most one checkpoint
    interval. ``quick=True`` is the sub-30s tier-1 smoke shape."""
    kill_after = 8 if quick else 12
    ckpt_blocks = 1           # --stream-ckpt-blocks (base cadence)
    interval_blocks = ckpt_blocks * 2   # standard-priority QoS degradation
    plan = ChaosPlan.from_dict({"seed": seed, "rules": [
        # SIGKILL the victim at a seeded decode step: hit 1 is the
        # admission+prefill iteration, every later hit decodes one token.
        {"point": "mocker.step", "kind": "kill", "rate": 1.0,
         "count": 1, "after": kill_after},
    ]})
    cfg = FleetConfig(workers=1, kv_store=True, lease_ttl_s=3.0,
                      speedup_ratio=50.0, chaos_plan=plan, chaos_seed=seed,
                      worker_args=["--stream-ckpt-blocks", str(ckpt_blocks),
                                   # keep token ids byte-decodable so the
                                   # resumed-vs-control text check is non-vacuous
                                   "--vocab-size", "260"])
    with MockerFleet(cfg) as fleet:
        victim = fleet.workers[0]
        prompt = "ckpt victim stream context " * 3
        max_tokens = 24
        got: list[tuple[StreamOutcome, str]] = []
        t = threading.Thread(target=lambda: got.append(
            fleet.complete(prompt, "ckpt-victim", max_tokens=max_tokens,
                           timeout=90.0)))
        t.start()
        victim.proc.wait(30)  # the seeded SIGKILL mid-decode

        # Fresh replica WITHOUT the kill plan: the resume target.
        fleet.cfg.chaos_plan = None
        fleet.workers.append(fleet.start_worker(1))
        fleet.workers[1].wait_for_line("WORKER_READY", 30)
        bg: list[StreamOutcome] = []
        if not quick:
            bg = fleet.drive_load(n=6, max_tokens=8, concurrency=2,
                                  timeout=60.0)
        t.join(90)
        outcomes = ([got[0][0]] if got
                    else [StreamOutcome("ckpt-victim", "lost", "no response")])
        resumed_text = got[0][1] if got else ""
        # Control: the SAME request id, unkilled. Identical output proves
        # the resumed stream was token-exact, not merely completed.
        ctrl_o, ctrl_text = fleet.complete(prompt, "ckpt-victim",
                                           max_tokens=max_tokens,
                                           timeout=60.0)
        outcomes.append(ctrl_o)
        outcomes.extend(bg)

        # The survivor's resume counters reach /engine_stats on its next
        # publish tick — poll briefly instead of racing one snapshot.
        stats: dict = {}
        deadline = time.time() + 10
        while time.time() < deadline:
            stats = fleet.engine_stats()
            probe = InvariantChecker()
            probe.check_ckpt_resume(stats, minimum=1)
            if probe.report.passed:
                break
            time.sleep(0.25)
        frontend_logs = fleet.frontend.logs()

        res = _finish("worker_kill_mid_decode", fleet, outcomes, seed=seed)
        ck = InvariantChecker()
        ck.report = res.report
        ck.check_ckpt_resume(stats, minimum=1)
        _check_orphan_pins(res, stats)
        res.report.details["ckpt"] = {
            "resumed_text": resumed_text, "control_text": ctrl_text,
            "kill_after": kill_after, "interval_blocks": interval_blocks}
        if not resumed_text or resumed_text != ctrl_text:
            res.report.fail(
                "resumed stream output differs from the unkilled control "
                f"run: {resumed_text!r} vs {ctrl_text!r}")
        else:
            res.report.ok("resumed_output_identical")
        recomputed = sum(
            int(m.get("stream_ckpt_resume_recomputed", 0) or 0)
            for s in stats.values()
            for m in (s.get("workers") or {}).values()
            if isinstance(m, dict))
        # One interval of recompute, plus the partial trailing block that
        # by construction can never be checkpointed (only FULL committed
        # blocks flush).
        bound = (interval_blocks + 1) * cfg.block_size
        res.report.details["ckpt"]["recomputed_tokens"] = recomputed
        # bg streams run unkilled (resume count 1), so the whole recompute
        # budget belongs to the victim stream.
        if recomputed > bound:
            res.report.fail(
                f"checkpoint resume recomputed {recomputed} tokens, more "
                f"than one interval (bound {bound})")
        else:
            res.report.ok("recompute_bounded_by_interval")
        if "quarantined" in frontend_logs:
            res.report.ok("killed_instance_quarantined")
        else:
            res.report.fail(
                "frontend never quarantined the killed instance")
        return res


def scenario_scale_during_partition(seed: int = 1234) -> ScenarioResult:
    """Scale-down while the coordinator is PARTITIONED away: the retiring
    worker cannot delete its membership keys or write its status — the
    drain must still complete locally within its bounded windows and exit
    rc 0 (no SIGKILL), and because every registration is lease-bound the
    dead worker's keys vanish on lease expiry: never a half-deregistered
    ghost. Traffic mid-partition migrates off the refusing worker."""
    cfg = FleetConfig(workers=2, lease_ttl_s=3.0, speedup_ratio=50.0,
                      worker_args=["--drain-deadline", "6"])
    with MockerFleet(cfg) as fleet:
        pre = fleet.drive_load(n=4, concurrency=2)
        # Published snapshots must show idle BEFORE the partition: during
        # it no publishes flow, so the frontend's last view of the retiring
        # worker has to be a quiesced one.
        fleet.wait_drained()

        fleet.coordinator.kill_hard()
        victim = fleet.workers[1]
        victim.proc.send_signal(signal.SIGTERM)
        # Streams the stale frontend still routes at the draining worker
        # are refused (typed ERR) and migrate to the survivor.
        mid = fleet.drive_load(n=4, concurrency=2, timeout=60.0)
        drained_line = victim.wait_for_line("WORKER_DRAINED", 45)
        victim.proc.wait(15)

        fleet.coordinator = Proc(
            ["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
             "--port", str(fleet.coord_port)], name="coordinator2").start()
        fleet.coordinator.wait_for_line("COORDINATOR_READY", 20)
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                if http_json(fleet.base + "/v1/models")["data"]:
                    break
            except Exception:
                pass
            time.sleep(0.5)
        post = fleet.drive_load(n=4, concurrency=2, timeout=60.0)

        res = _finish("scale_during_partition", fleet, pre + mid + post,
                      seed=seed)
        try:
            report = json.loads(
                drained_line.split("WORKER_DRAINED", 1)[1].strip())
        except Exception:
            report = {}
        res.report.details["drain_report"] = report
        if report.get("state") not in ("done", "aborted"):
            res.report.fail(f"drain neither completed nor cleanly "
                            f"aborted: {report}")
        else:
            res.report.ok("drain_bounded_under_partition")
        if victim.proc.returncode != 0:
            res.report.fail(
                f"partitioned drain exited rc={victim.proc.returncode} "
                "(escalation instead of a bounded local drain)")
        else:
            res.report.ok("clean_exit_under_partition")
        return res


SCENARIOS: dict[str, Callable[[int], ScenarioResult]] = {
    "smoke": scenario_smoke,
    "worker_kill": scenario_worker_kill,
    "coordinator_partition": scenario_coordinator_partition,
    "lease_expiry_storm": scenario_lease_expiry_storm,
    "slow_rank_stall": scenario_slow_rank_stall,
    "aggregator_partition": scenario_aggregator_partition,
    "retire_under_load": scenario_retire_under_load,
    "retire_under_load_smoke": lambda seed=1234: scenario_retire_under_load(
        seed, quick=True),
    "worker_kill_mid_decode": scenario_worker_kill_mid_decode,
    "worker_kill_mid_decode_smoke": lambda seed=1234:
        scenario_worker_kill_mid_decode(seed, quick=True),
    "scale_during_partition": scenario_scale_during_partition,
}


def run_scenario(name: str, seed: int = 1234) -> ScenarioResult:
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r} (one of {sorted(SCENARIOS)})")
    log.info("chaos scenario %s (seed=%d)", name, seed)
    return fn(seed)
