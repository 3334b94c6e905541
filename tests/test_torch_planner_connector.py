"""The port's ``ProcessConnector`` and planner component over the port's
mocker workers, as processes.

- The three ``ProcessConnector`` tests of ``tests/test_drain.py`` (spawn to
  ready; a scale-down drains through the drain-key handshake to exit 0
  with a ``done`` report and no SIGKILL; a crashed replica is reaped and
  respawned) re-run on the port: their deferred imports read the port's
  connector and coordinator client, and the connector spawns
  ``dynamo_tpu_torch.components.worker --engine mocker``.
- ``python -m dynamo_tpu_torch.components.planner --mode process`` over a
  coordinator, a frontend and the aggregator (``--fleet-url``) goes from 1
  to 2 to 1 mocker workers: one worker at no load, two under a load its
  profile sizes at two, one again when the load falls to a trickle; the
  retired worker drains to exit 0 and every request finishes.

An interval without a completed request is no data point to the planner
(JAX's ``Planner.observe`` skips ``num_req == 0``): an idle fleet keeps its
last prediction, so the scale-down is driven by a trickle of requests and
the ``constant`` predictor reads the last interval alone.
"""

from __future__ import annotations

import json
import re
import sys
import threading
import time

import pytest

import tests.test_drain as jdrain
from dynamo_tpu_torch.chaos.harness import Proc, free_port, http_json
from dynamo_tpu_torch.planner import connector as tconnector
from dynamo_tpu_torch.planner import interpolator as tinterp
from dynamo_tpu_torch.runtime.drain import drain_status_key
from dynamo_tpu_torch.transports import client as tclient


@pytest.fixture(scope="module")
def coord():
    port = free_port()
    p = Proc(["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
              "--port", str(port)], name="drain-coord").start()
    p.wait_for_line("COORDINATOR_READY", 20)
    yield f"tcp://127.0.0.1:{port}"
    p.stop()


@pytest.mark.parametrize("case", ["test_connector_spawn_to_ready",
                                  "test_connector_scale_down_drains_before_exit",
                                  "test_connector_crash_reap_then_respawn_to_target"])
def test_connector_case_on_the_port(case, coord, monkeypatch):
    import asyncio
    import types

    monkeypatch.setitem(sys.modules, "dynamo_tpu.planner.connector", tconnector)
    monkeypatch.setitem(sys.modules, "dynamo_tpu.transports.client", tclient)
    fn = getattr(jdrain, case)
    g = {**fn.__globals__, "drain_status_key": drain_status_key}
    asyncio.run(types.FunctionType(fn.__code__, g, fn.__name__)(coord))


#: the planner's cadence and its sizing: under ``ITL_SLA`` the synthetic
#: profile admits only its concurrency-1 point (itl 0.0102 s at these
#: contexts, 0.0108 s at concurrency 4), ~98 tok/s a replica; a heavy
#: interval needs ceil(n x 16 / 2 s / 98) >= 2 replicas from n >= 13
#: requests, a trickle of one request an interval needs 1
INTERVAL_S, ITL_SLA, OSL = 2.0, 0.0105, 16


def test_planner_process_mode_scales_mockers_1_2_1():
    coord_port, http_port, agg_port = free_port(), free_port(), free_port()
    url = f"tcp://127.0.0.1:{coord_port}"
    base, agg = f"http://127.0.0.1:{http_port}", f"http://127.0.0.1:{agg_port}"
    procs: list[Proc] = []

    def start(args, name, env=None, ready=None):
        p = Proc(args, name, env).start()
        procs.append(p)
        if ready:
            p.wait_for_line(ready, 30)
        return p

    data = tinterp.synthetic_profile()
    di = tinterp.DecodeInterpolator.from_data(data)
    thpt, conc = di.find_best_throughput_per_chip(ITL_SLA, 70 + OSL / 2)
    assert conc == 1.0 and 90 < thpt < 100
    stop = threading.Event()
    outcomes: list[dict] = []

    def load(concurrency: int, pause: float) -> None:
        def one(i):
            while not stop.is_set():
                r = http_json(base + "/v1/completions", {
                    "model": "tiny-llama", "prompt": f"planner prompt {i} " * 4,
                    "max_tokens": OSL, "ignore_eos": True}, timeout=60)
                outcomes.append(r)
                time.sleep(pause)

        ts = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(concurrency)]
        for t in ts:
            t.start()
        return ts

    def decisions(planner: Proc) -> list[int]:
        return [int(m.group(1)) for m in re.finditer(r"decision prefill=\d+ decode=(\d+)",
                                                     planner.logs())]

    def wait(pred, timeout: float, what: str, planner: Proc) -> None:
        deadline = time.time() + timeout
        while not pred():
            if time.time() > deadline:
                pytest.fail(f"{what}:\n{planner.logs()[-4000:]}")
            time.sleep(0.1)

    try:
        start(["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
               "--port", str(coord_port)], "coordinator", ready="COORDINATOR_READY")
        start(["-m", "dynamo_tpu_torch.components.frontend", "--coordinator", url,
               "--host", "127.0.0.1", "--port", str(http_port), "--router-mode", "kv"],
              "frontend", ready="FRONTEND_READY")
        start(["-m", "dynamo_tpu_torch.components.aggregator", "--coordinator", url,
               "--host", "127.0.0.1", "--port", str(agg_port), "--scrape-interval", "0.5",
               "--staleness-ttl", "3"], "aggregator", ready="AGGREGATOR_READY")
        worker_args = f"--engine mocker --coordinator {url} --speedup-ratio 50 --drain-deadline 10"
        planner = start(["-m", "dynamo_tpu_torch.components.planner", "--mode", "process",
                         "--coordinator", url, "--fleet-url", agg,
                         "--adjustment-interval", str(INTERVAL_S), "--min-replicas", "1",
                         "--max-replicas", "2", "--load-predictor", "constant",
                         "--itl-sla", str(ITL_SLA), "--decode-worker-args", worker_args],
                        "planner", env={"DYN_SYSTEM_ENABLED": "1"}, ready="PLANNER_READY")
        # 1: the first decision (no load) spawns one worker
        wait(lambda: planner.logs().count("WORKER_READY") == 1, 30, "no first worker", planner)
        wait(lambda: http_json(base + "/v1/models")["data"], 15, "model not served", planner)
        assert decisions(planner)[0] == 1
        # 2: under load the planner decides 2 and a second worker serves
        heavy = load(8, 0.0)
        wait(lambda: 2 in decisions(planner), 30, "never scaled to 2", planner)
        wait(lambda: planner.logs().count("WORKER_READY") == 2, 30, "no second worker", planner)
        ids = re.findall(r"WORKER_READY instance=([0-9a-f]{16})", planner.logs())

        def routed_to_second() -> bool:
            st = http_json(base + "/engine_stats").get("tiny-llama", {})
            return st.get("router", {}).get("routed", {}).get(ids[1].lstrip("0"), 0) > 0

        wait(routed_to_second, 30, "the second worker got no request", planner)
        wait(lambda: sorted(t["role"] for t in http_json(agg + "/debug/fleet")["targets"]
                            if t["fresh"]) == ["frontend", "worker", "worker"],
             10, "the aggregator did not find both workers", planner)
        stop.set()
        for t in heavy:
            t.join(60)
        # 1 again: a trickle of one request an interval
        stop.clear()
        n_up = len(decisions(planner))
        trickle = load(1, INTERVAL_S)
        wait(lambda: 1 in decisions(planner)[n_up:] and "WORKER_DRAINED" in planner.logs(),
             40, "never scaled back to 1", planner)
        stop.set()
        for t in trickle:
            t.join(60)
        logs = planner.logs()
        drained = json.loads(logs.split("WORKER_DRAINED ", 1)[1].splitlines()[0])
        assert drained["state"] == "done", drained
        assert re.search(r"instance=%s exited rc=0" % ids[1], logs), logs[-3000:]
        assert "SIGKILL" not in logs and "ignored the drain window" not in logs
        seq = decisions(planner)
        assert seq[0] == 1 and 2 in seq and seq[-1] == 1, seq
        assert all("slo[" in ln and "budget=" in ln for ln in logs.splitlines()
                   if "decision prefill=" in ln)
        assert outcomes and all(r["choices"][0]["finish_reason"] == "length"
                                and r["usage"]["completion_tokens"] == OSL for r in outcomes)
    finally:
        stop.set()
        for p in reversed(procs):
            # the planner retires its last worker through the drain first
            p.stop(30.0 if p.name == "planner" else 5.0)
