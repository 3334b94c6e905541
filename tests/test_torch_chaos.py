"""The port's chaos package against the JAX package's: the invariant
checker, the fault points the torch engine and the KVBM carry, seeded
replay, and the harness's scenarios over the port's mocker fleet.

- Invariants: the unit cases of ``tests/test_chaos.py`` re-run with the
  port's classes swapped in, and the same evidence given to both packages'
  ``InvariantChecker`` gives equal ``to_dict()`` reports
  (``parse_prometheus`` / ``metric_sum`` equal results).
- Fault points on a CPU ``tiny-llama`` engine, at JAX's places:
  ``engine.step`` (an error takes the engine-fatal ``fail_all`` path),
  ``kvbm.offload`` (engine-fatal, never dropped), ``kvbm.remote`` and
  ``kvbm.remote.connect`` (the store client's breaker: the streams are those
  of an unfaulted engine).
- The scenarios carry ``slow`` exactly where ``tests/test_chaos.py`` has
  it (the two whose fleets run a KV store, retirement and the mid-decode
  kill, are in ``tests/test_torch_chaos_recovery.py``); a fleet with the
  port's aggregator (``FleetConfig(aggregator=True)``) finds every target
  and rolls up what its frontend admitted; a fleet that fails to start
  stops its processes.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import threading
import types

import pytest

import tests.test_chaos as jax_chaos_tests
from dynamo_tpu import chaos as jchaos
from dynamo_tpu.chaos import invariants as jinv
from dynamo_tpu_torch import chaos as tchaos
from dynamo_tpu_torch.chaos import invariants as tinv
from dynamo_tpu_torch.chaos.harness import FleetConfig, run_scenario
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.kvbm import remote as tremote
from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig

pytestmark = pytest.mark.chaos


@pytest.fixture
def seed():
    """The chaos tests' seed (``DYN_CHAOS_SEED`` overrides it); both
    packages' in-process chaos engines are reset afterwards."""
    yield int(os.environ.get(tchaos.SEED_ENV, "42"))
    tchaos.reset()
    jchaos.reset()


def rebind(fn, **names):
    """``fn`` with ``names`` swapped into its module globals."""
    g = dict(fn.__globals__)
    g.update(names)
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------

INVARIANT_CASES = ["test_invariant_streams", "test_invariant_block_leaks",
                   "test_invariant_warm_resume", "test_invariant_op_streams",
                   "test_invariant_metrics_balance", "test_parse_prometheus_and_metric_sum",
                   "test_identical_evidence_gives_identical_report"]


@pytest.mark.parametrize("case", INVARIANT_CASES)
def test_invariant_case_on_the_port(case):
    """One invariant case of tests/test_chaos.py with the port's checker."""
    rebind(getattr(jax_chaos_tests, case), InvariantChecker=tinv.InvariantChecker,
           StreamOutcome=tinv.StreamOutcome, metric_sum=tinv.metric_sum,
           parse_prometheus=tinv.parse_prometheus)()


METRICS = jax_chaos_tests._metrics_text(1)
HOLE = jax_chaos_tests._metrics_text(0)
FLEET = (METRICS.replace('{priority="standard"}', '{instance="_fleet",priority="standard"}')
         .replace('{route="', '{instance="_fleet",route="')
         + "dynamo_fleet_scrape_errors_total 3\n")
WORKERS = {"m": {"workers": {
    "a": {"num_running": 0, "num_waiting": 0, "kv_usage": 0.0,
          "mem": {"enabled": True, "orphan_pins": 0,
                  "device_blocks": {"free": 10, "cached": 2, "session": 4}},
          "session_remote_resumes": 2, "session_hits": 3,
          "stream_ckpt_resumes": 1, "stream_ckpt_writes": 7},
    "b": {"num_running": 1, "num_waiting": 0, "kv_usage": 0.1},
    "c": {"num_running": 0, "num_waiting": 0, "kv_usage": 0.3},
    "d": {"num_running": 0, "num_waiting": 0,
          "mem": {"enabled": True, "orphan_pins": 2,
                  "device_blocks": {"stream": 3, "free": 1}}},
    "e": "not a mapping"}}}
EVIDENCE = {
    "streams": [("check_streams", [("a", "finished", "stop"), ("b", "error", "http 500"),
                                   ("c", "lost", "timeout")])],
    "block_leaks": [("check_block_leaks", WORKERS)],
    "no_workers": [("check_block_leaks", {"m": {"workers": {}}})],
    "op_streams": [("check_op_streams", {0: ["add", "step", "step"], 1: ["add", "reap"],
                                         2: ["add", "step", "step"]})],
    "warm_resume": [("check_warm_resume", WORKERS), ("check_warm_resume", WORKERS, 3)],
    "ckpt_resume": [("check_ckpt_resume", WORKERS), ("check_ckpt_resume", {"m": {}})],
    "metrics_balance": [("check_metrics_balance", METRICS), ("check_metrics_balance", HOLE)],
    "fleet_rollup": [("check_fleet_rollup", FLEET), ("check_fleet_rollup", METRICS)],
}


def report(inv, steps) -> dict:
    c = inv.InvariantChecker()
    for name, *args in steps:
        if name == "check_streams":
            args = [[inv.StreamOutcome(*o) for o in args[0]]]
        getattr(c, name)(*args)
    return c.finish().to_dict()


@pytest.mark.parametrize("case", sorted(EVIDENCE))
def test_same_evidence_same_report(case):
    want = report(jinv, EVIDENCE[case])
    assert report(tinv, EVIDENCE[case]) == want
    assert want["checks"] or want["failures"] or case == "no_workers"


@pytest.mark.parametrize("text", [METRICS, HOLE, FLEET])
def test_parse_prometheus_and_metric_sum_equal_jax(text):
    j, t = jinv.parse_prometheus(text), tinv.parse_prometheus(text)
    assert t == j
    for name, labels in (("dynamo_frontend_requests_total", {"route": "chat"}),
                         ("dynamo_qos_admitted_total", {}),
                         ("dynamo_qos_admitted_total", {"instance": "_fleet"}),
                         ("dynamo_fleet_scrape_errors_total", {})):
        assert tinv.metric_sum(t, name, **labels) == jinv.metric_sum(j, name, **labels)


# ---------------------------------------------------------------------------
# Seeded replay
# ---------------------------------------------------------------------------

PLAN = {"rules": [{"point": "engine.step", "kind": "error", "rate": 0.3},
                  {"point": "kvbm.*", "kind": "disconnect", "rate": 0.2, "count": 5},
                  {"point": "kvbm.offload", "kind": "error", "rate": 0.5, "after": 3}]}


def fault_log(pkg, seed) -> list:
    pkg.configure({**PLAN, "seed": seed})
    for i in range(60):
        for point in ("engine.step", "kvbm.offload", "kvbm.remote", "kvbm.remote.connect"):
            with contextlib.suppress(ConnectionError):
                pkg.inject(point, blocks=i)
    return pkg.injection_log()


def test_seeded_replay_gives_the_same_fault_sequence(seed):
    """A plan over the new points replays identically in the port, and
    fires where the JAX injector fires with the same seed."""
    first = fault_log(tchaos, seed)
    assert first and fault_log(tchaos, seed) == first
    assert fault_log(jchaos, seed) == first
    assert fault_log(tchaos, seed + 1) != first
    assert {k[1] for k in first} == {"engine.step", "kvbm.offload", "kvbm.remote",
                                     "kvbm.remote.connect"}


# ---------------------------------------------------------------------------
# The fault points on a CPU engine
# ---------------------------------------------------------------------------

def core_cfg(**kw) -> EngineConfig:
    d = dict(model="tiny-llama", block_size=4, num_blocks=64, max_batch_size=4,
             max_model_len=128, prefill_chunk=32, decode_bucket=(4,), warmup_mode="off")
    d.update(kw)
    return EngineConfig(**d)


def req(rid, prompt, max_tokens=8):
    return tproto.PreprocessedRequest(
        token_ids=list(prompt), request_id=rid,
        stop_conditions=tproto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=tproto.SamplingOptions(temperature=0.0))


def prompts(base: int, n: int = 2, length: int = 20) -> list:
    return [(f"r{base}-{i}", range(base + 37 * i, base + 37 * i + length)) for i in range(n)]


async def serve(eng, batch) -> dict:
    async def one(rid, prompt):
        toks, reasons = [], []
        async for out in eng.generate(req(rid, prompt)):
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                reasons.append(str(out.finish_reason))
        return toks, reasons
    outs = await asyncio.gather(*(one(rid, p) for rid, p in batch))
    return {rid: o for (rid, _), o in zip(batch, outs)}


def blocks_back(core) -> bool:
    return core.pool.num_free == core.pool.num_blocks - 1


async def run_engine(cfg, batches, plan=None, seed=0) -> tuple[list, teng.EngineCore]:
    """Serve ``batches`` one after another on an AsyncTorchEngine, with
    ``plan`` configured in this process first."""
    core = teng.EngineCore(cfg, device="cpu")
    eng = teng.AsyncTorchEngine(core)
    if plan is not None:
        tchaos.configure({**plan, "seed": seed})
    try:
        results = []
        for batch in batches:
            results.append(await serve(eng, batch))
            results[-1]["_blocks_back"] = blocks_back(core)
        return results, core
    finally:
        tchaos.reset()
        await eng.shutdown()


async def test_engine_step_error_takes_the_fail_all_path(seed):
    """``engine.step`` sits inside the step loop's try: an error fails every
    in-flight stream with finish reason error and frees its blocks; the
    rules' ``after`` counts only iterations with work; the next batch is
    served as by an engine that never faulted."""
    cfg = core_cfg()
    plan = {"rules": [{"point": "engine.step", "kind": "error", "rate": 1.0,
                       "count": 1, "after": 4}]}
    b1, b2 = prompts(1), prompts(300)
    want, _ = await run_engine(cfg, [b1, b2])
    got, _ = await run_engine(cfg, [b1, b2], plan, seed)
    for rid, _ in b1:
        toks, reasons = got[0][rid]
        assert reasons == ["error"], got[0]
        # four steps with work ran before the fault: the prefill and three
        # decodes (pipelined: the tokens of the first three are out)
        assert toks == want[0][rid][0][:len(toks)] and len(toks) >= 2
    assert got[0]["_blocks_back"]
    assert got[1] == want[1]


async def test_engine_step_counts_no_idle_iteration(seed):
    """Neither the full warmup's steps (``build_engine`` runs them before
    the step loop starts) nor the loop's idle turns reach the fault point;
    the first step with work does."""
    tchaos.configure({"seed": seed, "rules": [
        {"point": "engine.step", "kind": "delay", "delay_s": 0.0, "rate": 1.0}]})
    eng = teng.build_engine(core_cfg(warmup_mode="full"), device="cpu")
    try:
        assert eng.core.warmup_summary["captured"] > 0
        eng.start()
        await asyncio.sleep(0.3)          # idle: the loop waits on its wake event
        assert tchaos.injection_log() == []
        await serve(eng, prompts(1, n=1))
        assert tchaos.injection_log()
    finally:
        tchaos.reset()
        await eng.shutdown()


class Store:
    """The port's RemoteBlockServer on a loop thread of its own."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.server = tremote.RemoteBlockServer(capacity_bytes=1 << 24)
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        port = asyncio.run_coroutine_threadsafe(
            self.server.start("127.0.0.1", 0), self.loop).result(10)
        self.addr = f"127.0.0.1:{port}"

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


@pytest.fixture
def store():
    s = Store()
    yield s
    s.close()


def run_core(core, batch) -> dict:
    for rid, p in batch:
        assert core.add_request(req(rid, p)) is None
    got = {rid: [] for rid, _ in batch}
    while core.has_work():
        for rid, out in core.step().items():
            got[rid].extend(out.token_ids)
    return got


@pytest.mark.parametrize("point", ["kvbm.remote", "kvbm.remote.connect"])
def test_remote_store_faults_open_the_breaker(point, store, seed):
    """An injected ConnectionError at ``kvbm.remote`` (inside ``_call``'s
    retry loop) or ``kvbm.remote.connect`` takes the dead-store path: one
    reconnect, then the breaker opens. The publishing engine's greedy
    streams are the unfaulted run's, and no pin is orphaned."""
    batch = prompts(5)
    cfg = core_cfg(remote_kv_addr=store.addr, global_prefix_cache=True)
    want = run_core(teng.EngineCore(cfg, device="cpu"), batch)
    get_mem_ledger().reset()
    tchaos.configure({"seed": seed, "rules": [
        {"point": point, "kind": "error", "rate": 1.0, "count": 2}]})
    core = teng.EngineCore(cfg, device="cpu")
    try:
        assert run_core(core, batch) == want
        remote = core.kvbm.publish_tier
        assert remote._broken_until > 0, "the breaker never opened"
        assert [k[1] for k in tchaos.injection_log()] == [point, point]
        assert blocks_back(core)
        assert get_mem_ledger().audit()["orphan_pins"] == 0
    finally:
        tchaos.reset()
        core.close()


async def test_offload_error_is_engine_fatal(seed):
    """``kvbm.offload`` fires in ``flush_pending`` when there is work to
    flush: its error reaches the step loop and fails the in-flight streams
    through ``fail_all`` (not a dropped offload); every block comes back and
    the next batch's streams equal an unfaulted engine's."""
    # 16 device blocks: the second batch evicts the first's cached blocks
    # into the host tier, so its first step has an offload to flush
    cfg = core_cfg(num_blocks=16, host_kv_blocks=64, max_model_len=64)
    plan = {"rules": [{"point": "kvbm.offload", "kind": "error", "rate": 1.0, "count": 1}]}
    b1, b2, b3 = prompts(1), prompts(200), prompts(400)
    want, _ = await run_engine(cfg, [b1, b2, b3])
    got, core = await run_engine(cfg, [b1, b2, b3], plan, seed)
    assert got[0] == want[0]
    assert [got[1][rid][1] for rid, _ in b2] == [["error"]] * len(b2), got[1]
    assert got[1]["_blocks_back"]
    assert got[2] == want[2]
    assert core.kvbm.stats.offloaded_blocks > 0


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

def test_unknown_scenario_is_refused():
    with pytest.raises(ValueError, match="unknown scenario"):
        run_scenario("no_such_scenario")


def test_fleet_with_the_aggregator_finds_every_target():
    """``FleetConfig(aggregator=True)`` starts the port's aggregator, which
    discovers the frontend and both workers through the coordinator and
    rolls up every request the frontend admitted."""
    from dynamo_tpu_torch.chaos.harness import MockerFleet

    with MockerFleet(FleetConfig(workers=2, aggregator=True, scrape_interval_s=0.3)) as fleet:
        info = fleet.wait_fleet_fresh(3)
        assert sorted(t["role"] for t in info["targets"]) == ["frontend", "worker", "worker"]
        assert all(t["registered"] and t["consecutive_failures"] == 0
                   for t in info["targets"])
        outcomes = fleet.drive_load(n=6, concurrency=3)
        assert all(o.status == "finished" for o in outcomes), outcomes
        fleet.wait_drained()
        for _ in range(50):
            checker = tinv.InvariantChecker()
            checker.check_fleet_rollup(fleet.aggregator_metrics_text())
            rollup = checker.report.details["fleet_rollup"]
            if checker.report.passed and rollup["completed"] == 6:
                break
            threading.Event().wait(0.2)
        assert checker.report.passed and rollup["completed"] == 6, rollup
        assert fleet.aggregator.alive()


def test_a_fleet_that_fails_to_start_stops_its_processes():
    """A worker that refuses its flags fails the fleet's start; the
    coordinator it already started is stopped with it."""
    from dynamo_tpu_torch.chaos.harness import MockerFleet

    fleet = MockerFleet(FleetConfig(workers=1, worker_args=["--num-nodes", "2"]))
    with pytest.raises(RuntimeError, match="worker0 exited"):
        with fleet:
            pass
    assert fleet.coordinator is not None and not fleet.coordinator.alive()
    assert not any(w.alive() for w in fleet.workers)


def test_scenario_smoke(seed):
    """Tier-1: a seeded error + delay plan on both mocker workers;
    Migration absorbs every injected dispatch failure."""
    res = run_scenario("smoke", seed=seed)
    assert res.report.passed, res.report.failures
    assert res.report.details["streams"]["lost"] == 0


@pytest.mark.slow
def test_scenario_worker_kill(seed):
    res = run_scenario("worker_kill", seed=seed)
    assert res.report.passed, res.report.failures


@pytest.mark.slow
def test_scenario_coordinator_partition(seed):
    res = run_scenario("coordinator_partition", seed=seed)
    assert res.report.passed, res.report.failures


@pytest.mark.slow
def test_scenario_lease_expiry_storm(seed):
    res = run_scenario("lease_expiry_storm", seed=seed)
    assert res.report.passed, res.report.failures


@pytest.mark.slow
def test_scenario_slow_rank_stall(seed):
    res = run_scenario("slow_rank_stall", seed=seed)
    assert res.report.passed, res.report.failures


@pytest.mark.slow
def test_scenario_aggregator_partition(seed):
    res = run_scenario("aggregator_partition", seed=seed)
    assert res.report.passed, res.report.failures


@pytest.mark.slow
def test_scenario_scale_during_partition(seed):
    res = run_scenario("scale_during_partition", seed=seed)
    assert res.report.passed, res.report.failures
