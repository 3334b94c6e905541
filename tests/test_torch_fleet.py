"""The port's fleet observability plane against the JAX package's.

- Every test of ``tests/test_fleet.py`` re-runs with the port's classes
  swapped in (``rebind``; a deferred ``from dynamo_tpu... import`` reads a
  ``sys.modules`` alias of the port's module), and so do
  ``tests/test_mem_obs.py::test_fleet_kv_headroom_sli`` and
  ``::test_planner_mem_reason`` and
  ``tests/test_sched_obs.py::test_fleet_decode_stall_sli``.
- The same seeded scrapes, target churn and injected clock, given to both
  packages' ``FleetAggregator`` (each package's ``fetch_metrics``
  monkeypatched as the JAX tests' ``FakeClient`` tests do), give equal
  ``expose()`` text, ``debug_info()``, burn rates, budgets, anomaly and
  storm flags after every sweep; both ``SloEngine``\\ s and ``EwmaAnomaly``\\ s
  agree on seeded series.
- The fleet end to end (``test_fleet_e2e_discovery_rollup_staleness_and_
  planner``) on the port's processes: coordinator, mocker workers,
  frontend, aggregator and planner.
- The aggregator's four routes over the port's ``HttpServer`` (HEAD
  included) answer what JAX's aiohttp app answers for the same state.
- ``fetch_metrics``: the asyncio-streams client reads a plain, a chunked
  and a close-delimited body, and raises on a non-200 answer and on its
  timeout.
"""

from __future__ import annotations

import asyncio
import json
import sys
import types

import numpy as np
import pytest

import tests.test_fleet as jt
import tests.test_mem_obs as jmem_tests
import tests.test_sched_obs as jsched_tests
from dynamo_tpu.obs import fleet as jfleet
from dynamo_tpu.runtime import protocols as jprot
from dynamo_tpu.utils import metrics as jmet
from dynamo_tpu_torch.chaos import harness as tharness
from dynamo_tpu_torch.frontend import http as thttp
from dynamo_tpu_torch.obs import fleet as tfleet
from dynamo_tpu_torch.planner import scrape as tscrape
from dynamo_tpu_torch.runtime import protocols as tprot
from dynamo_tpu_torch.transports import client as tclient
from dynamo_tpu_torch.utils import metrics as tmet


def rebind(fn, **names):
    """``fn`` with ``names`` swapped into its module globals."""
    g = dict(fn.__globals__)
    g.update(names)
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def port_names() -> dict:
    names = {
        "DEFAULT_SLO_SPECS": tfleet.DEFAULT_SLO_SPECS, "EwmaAnomaly": tfleet.EwmaAnomaly,
        "FleetAggregator": tfleet.FleetAggregator, "SloEngine": tfleet.SloEngine,
        "SloSpec": tfleet.SloSpec, "parse_slo_specs": tfleet.parse_slo_specs,
        "METRICS_PREFIX": tprot.METRICS_PREFIX, "MetricsTarget": tprot.MetricsTarget,
        "MetricsRegistry": tmet.MetricsRegistry, "metric_sum": tmet.metric_sum,
        "metrics_url": tmet.metrics_url, "parse_prometheus": tmet.parse_prometheus,
        "SPEC": tfleet.SloSpec(name="ttft_p95", kind="latency", target=0.95,
                               histogram="h", threshold_s=2.0),
    }
    names["make_engine"] = rebind(jt.make_engine, **names)
    names["_put_target"] = rebind(jt._put_target, **names)
    names["make_agg"] = rebind(jt.make_agg, **names)
    names["_fleet_rollup_consistent"] = rebind(jt._fleet_rollup_consistent, **names)
    return names


class PortPatch:
    """A monkeypatch whose dotted-string targets in the JAX package name
    the port's module instead."""

    def __init__(self, mp):
        self.mp = mp

    def setattr(self, target, *args, **kw):
        if isinstance(target, str) and target.startswith("dynamo_tpu."):
            target = "dynamo_tpu_torch." + target.removeprefix("dynamo_tpu.")
        return self.mp.setattr(target, *args, **kw)


def run(fn, *args):
    out = fn(*args)
    if asyncio.iscoroutine(out):
        asyncio.run(out)


# ---------------------------------------------------------------------------
# tests/test_fleet.py on the port
# ---------------------------------------------------------------------------

SYNC_CASES = ["test_parse_round_trips_hostile_label_values",
              "test_parse_round_trips_gauge_histogram_and_empty_labels",
              "test_metric_sum_and_metrics_url", "test_parse_slo_specs_valid",
              "test_burn_rate_hand_computed_windows",
              "test_fast_window_page_fires_on_rising_edge_only",
              "test_slow_window_warn_without_page", "test_budget_remaining_and_exhaustion",
              "test_engine_prunes_history_but_keeps_window_base",
              "test_ewma_flags_spike_after_warmup"]
PATCH_CASES = ["test_aggregator_discovers_rolls_up_and_degrades",
               "test_aggregator_survives_fetch_chaos",
               "test_compile_storm_flags_and_pages_on_rising_edge"]
REJECTED_DOCS = [{"slos": []},
                 {"slos": [{"name": "x", "kind": "nope", "target": 0.9}]},
                 {"slos": [{"name": "x", "kind": "latency", "target": 0.9}]},
                 {"slos": [{"name": "x", "kind": "availability", "target": 1.5}]},
                 {"slos": [{"name": "x", "kind": "counter_ratio", "target": 0.9}]}]


@pytest.mark.parametrize("case", SYNC_CASES)
def test_fleet_case_on_the_port(case):
    run(rebind(getattr(jt, case), **port_names()))


@pytest.mark.parametrize("doc", REJECTED_DOCS)
def test_parse_slo_specs_rejects_on_the_port(doc):
    run(rebind(jt.test_parse_slo_specs_rejects, **port_names()), doc)
    with pytest.raises(ValueError) as tex:
        tfleet.parse_slo_specs(json.dumps(doc))
    with pytest.raises(ValueError) as jex:
        jfleet.parse_slo_specs(json.dumps(doc))
    assert str(tex.value) == str(jex.value)


@pytest.mark.parametrize("case", PATCH_CASES)
def test_aggregator_case_on_the_port(case, monkeypatch):
    run(rebind(getattr(jt, case), **port_names()), PortPatch(monkeypatch))


def test_aggregator_scraper_case_on_the_port(monkeypatch):
    monkeypatch.setitem(sys.modules, "dynamo_tpu.planner.scrape", tscrape)
    run(rebind(jt.test_aggregator_scraper_rates_and_slo_reason, **port_names()), monkeypatch)


@pytest.mark.parametrize("case", [(jmem_tests, "test_fleet_kv_headroom_sli"),
                                  (jmem_tests, "test_planner_mem_reason"),
                                  (jsched_tests, "test_fleet_decode_stall_sli")],
                         ids=lambda c: c[1])
def test_sli_case_on_the_port(case, monkeypatch):
    """The JAX test, its deferred imports reading the port's modules."""
    from dynamo_tpu_torch.obs import mem_ledger as tmem

    module, name = case
    monkeypatch.setitem(sys.modules, "dynamo_tpu.obs.fleet", tfleet)
    monkeypatch.setitem(sys.modules, "dynamo_tpu.planner.scrape", tscrape)
    run(rebind(getattr(module, name), parse_prometheus=tmet.parse_prometheus,
               MetricsRegistry=tmet.MetricsRegistry, TTX_CAP_S=tmem.TTX_CAP_S))


def test_sli_counts_and_mem_reason_equal_jax():
    """The three SLI shapes and the memory stamp, package against package."""
    from dynamo_tpu.planner.scrape import AggregatorScraper as JScraper

    text = "\n".join([
        'dynamo_mem_headroom_observations_total{state="ok"} 95',
        'dynamo_mem_headroom_observations_total{state="short"} 5',
        'dynamo_sched_hol_stall_seconds_bucket{qos_class="standard",le="0.02"} 3',
        'dynamo_sched_hol_stall_seconds_bucket{qos_class="standard",le="0.5"} 8',
        'dynamo_sched_hol_stall_seconds_bucket{qos_class="standard",le="+Inf"} 10',
        'dynamo_sched_hol_stall_seconds_count{qos_class="standard"} 10',
        'dynamo_frontend_requests_total{route="chat",status="200"} 8',
        'dynamo_frontend_requests_total{route="completions",status="499"} 1',
        'dynamo_frontend_requests_total{route="chat",status="500"} 2',
        'dynamo_mem_ttx_seconds{instance="a:1"} 42.4',
        'dynamo_mem_ttx_seconds{instance="_fleet"} 1.0',
        'dynamo_mem_capacity_posture{instance="a:1"} 2',
    ]) + "\n"
    jagg = jfleet.FleetAggregator(None, registry=jmet.MetricsRegistry())
    tagg = tfleet.FleetAggregator(None, registry=tmet.MetricsRegistry())
    for js, ts in zip(jfleet.DEFAULT_SLO_SPECS, tfleet.DEFAULT_SLO_SPECS):
        assert js == jfleet.SloSpec(**vars(ts))
        assert jagg._slo_counts(js, jmet.parse_prometheus(text)) == \
            tagg._slo_counts(ts, tmet.parse_prometheus(text))
    j, t = JScraper("http://agg:1"), tscrape.AggregatorScraper("http://agg:1")
    j.last_sample, t.last_sample = jmet.parse_prometheus(text), tmet.parse_prometheus(text)
    assert t.mem_reason() == j.mem_reason() == "mem[ttx=42s posture=critical]"


# ---------------------------------------------------------------------------
# Seeded twins: the same scrapes and clock through both packages
# ---------------------------------------------------------------------------

URLS = {"frontend": ["http://10.0.0.1:8080"],
        "worker": ["http://10.0.0.2:9001", "http://10.0.0.3:9002", "http://10.0.0.4:9003"]}


def script(seed: int, sweeps: int = 24) -> list[dict]:
    """Each sweep: the clock's step, the registered targets, the text each
    live URL serves (or ``None``: the scrape fails). Counters grow; perf
    gauges wander and sometimes spike; serve compiles come in bursts."""
    rng = np.random.default_rng(seed)
    urls = [u for us in URLS.values() for u in us]
    cum: dict[str, dict] = {u: {"ok": 0, "err": 0, "bkt": [0, 0, 0], "itl": [0, 0], "comp": 0,
                                "warm": 0, "head_ok": 0, "head_short": 0, "stall": [0, 0, 0],
                                "mfu": 0.3, "adm": 0} for u in urls}
    out = []
    for _ in range(sweeps):
        texts = {}
        for u in urls:
            c = cum[u]
            if rng.random() < 0.12:
                texts[u] = None
                continue
            n = int(rng.integers(0, 40))
            bad = int(rng.binomial(n, 0.05 if rng.random() < 0.7 else 0.6))
            c["ok"] += n - bad
            c["err"] += bad
            c["adm"] += n
            fast = int(rng.binomial(n, 0.8))
            mid = int(rng.binomial(n - fast, 0.5))
            c["bkt"] = [c["bkt"][0] + fast, c["bkt"][1] + fast + mid, c["bkt"][2] + n]
            c["itl"] = [c["itl"][0] + int(rng.binomial(5 * n, 0.97)), c["itl"][1] + 5 * n]
            if rng.random() < 0.25:
                c["comp"] += int(rng.integers(0, 12))
            c["warm"] += int(rng.integers(0, 3))
            short = int(rng.binomial(n, 0.1 if rng.random() < 0.8 else 0.9))
            c["head_ok"] += n - short
            c["head_short"] += short
            s1 = int(rng.integers(0, 4))
            c["stall"] = [c["stall"][0] + s1, c["stall"][1] + s1 + int(rng.integers(0, 2)),
                          c["stall"][2] + s1 + int(rng.integers(0, 3))]
            c["mfu"] = float(np.round(0.3 + 0.01 * rng.standard_normal()
                                      + (1.0 if rng.random() < 0.08 else 0.0), 6))
            if u in URLS["frontend"]:
                texts[u] = "\n".join([
                    f'dynamo_frontend_requests_total{{route="chat",status="200"}} {c["ok"]}',
                    f'dynamo_frontend_requests_total{{route="completions",status="500"}} {c["err"]}',
                    f'dynamo_frontend_requests_total{{route="health",status="200"}} {c["ok"] * 3}',
                    f'dynamo_qos_admitted_total{{model="m"}} {c["adm"]}',
                    f'dynamo_frontend_model_requests_total{{model="m"}} {c["ok"] + c["err"]}',
                    *[f'dynamo_frontend_time_to_first_token_seconds_bucket{{le="{le}"}} {v}'
                      for le, v in zip(("1.0", "2.5", "+Inf"), c["bkt"])],
                    f'dynamo_frontend_time_to_first_token_seconds_count {c["bkt"][2]}',
                    f'dynamo_frontend_time_to_first_token_seconds_sum {0.7 * c["bkt"][2]}',
                    f'dynamo_frontend_inter_token_latency_seconds_bucket{{le="0.25"}} {c["itl"][0]}',
                    f'dynamo_frontend_inter_token_latency_seconds_bucket{{le="+Inf"}} {c["itl"][1]}',
                    f'dynamo_frontend_inter_token_latency_seconds_count {c["itl"][1]}',
                ]) + "\n"
            else:
                texts[u] = "\n".join([
                    f'dynamo_engine_perf_mfu {c["mfu"]}',
                    f'dynamo_engine_perf_step_seconds_count {c["adm"] * 4}',
                    f'dynamo_xla_compile_events_total{{kind="decode",source="serve"}} {c["comp"]}',
                    f'dynamo_xla_compile_events_total{{kind="decode",source="warmup"}} {c["warm"]}',
                    f'dynamo_mem_headroom_observations_total{{state="ok"}} {c["head_ok"]}',
                    f'dynamo_mem_headroom_observations_total{{state="short"}} {c["head_short"]}',
                    *[f'dynamo_sched_hol_stall_seconds_bucket{{qos_class="standard",le="{le}"}} {v}'
                      for le, v in zip(("0.02", "0.5", "+Inf"), c["stall"])],
                    f'dynamo_sched_hol_stall_seconds_count{{qos_class="standard"}} {c["stall"][2]}',
                ]) + "\n"
        registered = [u for u in urls if not (u == urls[-1] and 8 <= len(out) < 14)
                      and not (u == urls[-2] and len(out) >= 18)]
        out.append({"dt": float(rng.choice([0.5, 2.0, 7.0, 45.0, 400.0])),
                    "registered": registered, "texts": texts})
    return out


class FakeClient:
    def __init__(self):
        self.kv: dict[str, bytes] = {}

    async def get_prefix(self, prefix: str) -> dict[str, bytes]:
        return {k: v for k, v in self.kv.items() if k.startswith(prefix)}


def drive(pkg: str, steps: list[dict], monkeypatch) -> list[dict]:
    """Run ``steps`` through one package's aggregator; a record a sweep."""
    fleet, prot, met = (tfleet, tprot, tmet) if pkg == "torch" else (jfleet, jprot, jmet)
    clock = [1000.0]
    client = FakeClient()
    agg = fleet.FleetAggregator(client, namespace="dynamo", staleness_ttl_s=5.0,
                                clock=lambda: clock[0])
    texts: dict = {}

    async def fake_fetch(url, timeout_s=10.0):
        t = texts.get(url)
        if t is None:
            raise ConnectionError("connection refused")
        return met.parse_prometheus(t)

    monkeypatch.setattr(fleet, "fetch_metrics", fake_fetch)
    targets = {u: prot.MetricsTarget(role=role, instance_id=i + 1, url=u, namespace="dynamo")
               for i, (role, u) in enumerate((r, u) for r, us in URLS.items() for u in us)}
    records = []

    async def go():
        for st in steps:
            clock[0] += st["dt"]
            texts.clear()
            texts.update(st["texts"])
            client.kv = {targets[u].key: targets[u].to_bytes() for u in st["registered"]}
            await agg.scrape_once()
            records.append({
                "expose": agg.expose(), "debug": agg.debug_info(),
                "burn": {(s, w): agg.engine.burn_rate(s, w) for s in agg.engine.specs
                         for w in agg.engine.windows},
                "budget": {s: agg.engine.budget_remaining(s) for s in agg.engine.specs},
                "anomalies": agg._anomalies, "storms": agg._compile_storms,
                "pages": {(s, sev): agg.engine.c_violations.get(slo=s, severity=sev)
                          for s in [*agg.engine.specs, "compile_storm"]
                          for sev in ("page", "warn")}})

    asyncio.run(go())
    return records


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_aggregator_twin_on_seeded_scrapes(seed, monkeypatch):
    steps = script(seed)
    want = drive("jax", steps, monkeypatch)
    got = drive("torch", steps, monkeypatch)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"sweep {i} differs"
    # the script exercises what it claims to: staleness, drops, pages,
    # anomalies and storms
    assert any('stale="1"' in r["expose"] for r in want)
    assert any(len(r["debug"]["targets"]) < 4 for r in want)
    assert any(r["storms"] for r in want) and any(r["anomalies"] for r in want)
    assert any(v for r in want for v in r["pages"].values())


@pytest.mark.parametrize("seed", range(6))
def test_slo_engine_and_ewma_twin(seed):
    rng = np.random.default_rng(100 + seed)
    spec = dict(name="s", kind="latency", target=float(rng.choice([0.9, 0.95, 0.999])),
                histogram="h", threshold_s=1.0)
    engines = [fleet.SloEngine([fleet.SloSpec(**spec)], registry=met.MetricsRegistry())
               for fleet, met in ((jfleet, jmet), (tfleet, tmet))]
    anomalies = [jfleet.EwmaAnomaly(), tfleet.EwmaAnomaly()]
    t = good = total = 0.0
    for _ in range(200):
        t += float(rng.choice([1.0, 30.0, 300.0, 1800.0]))
        n = float(rng.integers(0, 100))
        total += n
        good += float(rng.binomial(int(n), float(rng.choice([0.99, 0.5]))))
        outs = []
        for e in engines:
            e.observe("s", good, total, t=t)
            outs.append((e.evaluate(), {w: e.burn_rate("s", w) for w in e.windows},
                         e.budget_remaining("s"),
                         [e.c_violations.get(slo="s", severity=v) for v in ("page", "warn")]))
        assert outs[0] == outs[1]
        v = float(rng.normal(1.0, 0.05) + (3.0 if rng.random() < 0.05 else 0.0))
        assert anomalies[0].observe(("k",), v) == anomalies[1].observe(("k",), v)


# ---------------------------------------------------------------------------
# The aggregator's routes, fetch_metrics
# ---------------------------------------------------------------------------

async def raw(port: int, method: str, path: str) -> tuple[int, dict, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, v in
               (ln.split(":", 1) for ln in lines[1:] if ":" in ln)}
    return int(lines[0].split()[1]), headers, body


def test_aggregator_routes_equal_jax_app(monkeypatch):
    """Both packages' apps over one scripted state: every route's status
    and body agree; HEAD answers GET's status and length with no body."""
    from aiohttp import web as aioweb

    from dynamo_tpu.components import aggregator as jagg_main
    from dynamo_tpu_torch.components import aggregator as tagg_main

    steps = script(7, sweeps=6)
    clock = [1000.0]

    def agg_of(fleet, prot, met):
        client = FakeClient()
        a = fleet.FleetAggregator(client, staleness_ttl_s=5.0, clock=lambda: clock[0])
        texts = steps[-1]["texts"]

        async def fake_fetch(url, timeout_s=10.0):
            if texts.get(url) is None:
                raise ConnectionError("refused")
            return met.parse_prometheus(texts[url])

        monkeypatch.setattr(fleet, "fetch_metrics", fake_fetch)
        for i, u in enumerate(steps[-1]["registered"]):
            tg = prot.MetricsTarget(role="worker" if i else "frontend", instance_id=i + 1,
                                    url=u, namespace="dynamo")
            client.kv[tg.key] = tg.to_bytes()
        return a

    async def go():
        jagg = agg_of(jfleet, jprot, jmet)
        tagg = agg_of(tfleet, tprot, tmet)
        await jagg.scrape_once()
        await tagg.scrape_once()
        runner = aioweb.AppRunner(jagg_main.make_app(jagg))
        await runner.setup()
        site = aioweb.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        jport = site._server.sockets[0].getsockname()[1]
        tapp = tagg_main.make_app(tagg)
        tport = await tapp.start("127.0.0.1", 0)
        try:
            for path in ("/metrics", "/debug/fleet", "/health", "/live"):
                js, _, jb = await raw(jport, "GET", path)
                ts, th, tb = await raw(tport, "GET", path)
                assert (ts, js) == (200, 200), path
                if path == "/metrics":
                    assert tb.decode() == jb.decode()
                    assert th["content-type"].startswith("text/plain")
                else:
                    assert json.loads(tb) == json.loads(jb), path
                    assert th["content-type"].startswith("application/json")
                hs, hh, hb = await raw(tport, "HEAD", path)
                assert (hs, hb) == (200, b""), path
                assert int(hh["content-length"]) == len(tb), path
            assert (await raw(tport, "GET", "/nope"))[0] == 404
        finally:
            await tapp.stop()
            await runner.cleanup()

    asyncio.run(go())


@pytest.mark.parametrize("mode", ["length", "chunked", "close"])
def test_fetch_metrics_reads_every_body_framing(mode):
    text = 'dynamo_x_total{a="1"} 3\ndynamo_y 2.5\n'

    async def serve(reader, writer):
        await reader.readuntil(b"\r\n\r\n")
        body = text.encode()
        if mode == "length":
            writer.write(b"HTTP/1.1 200 OK\r\ncontent-length: %d\r\n\r\n" % len(body) + body)
        elif mode == "chunked":
            writer.write(b"HTTP/1.1 200 OK\r\ntransfer-encoding: chunked\r\n\r\n"
                         + b"".join(b"%x\r\n%s\r\n" % (len(body[i:i + 7]), body[i:i + 7])
                                    for i in range(0, len(body), 7)) + b"0\r\n\r\n")
        else:
            writer.write(b"HTTP/1.1 200 OK\r\n\r\n" + body)
        await writer.drain()
        writer.close()

    async def go():
        srv = await asyncio.start_server(serve, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        try:
            return await tmet.fetch_metrics(f"http://127.0.0.1:{port}")
        finally:
            srv.close()

    assert asyncio.run(go()) == jmet.parse_prometheus(text)


def test_fetch_metrics_raises_on_status_and_timeout():
    async def go():
        async def not_found(_req):
            return thttp.Response(status=404, text="no")

        srv = thttp.HttpServer()
        srv.add_get("/metrics", not_found)
        port = await srv.start("127.0.0.1", 0)

        async def silent(reader, writer):
            await asyncio.sleep(5)

        hang = await asyncio.start_server(silent, "127.0.0.1", 0)
        hport = hang.sockets[0].getsockname()[1]
        try:
            with pytest.raises(tmet.HttpStatusError) as ex:
                await tmet.fetch_metrics(f"http://127.0.0.1:{port}/")
            assert ex.value.status == 404
            with pytest.raises(asyncio.TimeoutError):
                await tmet.fetch_metrics(f"http://127.0.0.1:{hport}", timeout_s=0.2)
        finally:
            await srv.stop()
            hang.close()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# The fleet end to end on the port's processes
# ---------------------------------------------------------------------------

def test_fleet_e2e_on_the_port(monkeypatch):
    """``tests/test_fleet.py::test_fleet_e2e_discovery_rollup_staleness_and_
    planner`` with the port's harness, coordinator client and planner (its
    ``-m dynamo_tpu.components.planner`` names the port's module)."""

    def port_proc(args, name, env=None):
        args = ["dynamo_tpu_torch." + a.removeprefix("dynamo_tpu.")
                if a.startswith("dynamo_tpu.") else a for a in args]
        return tharness.Proc(args, name, env)

    shim = types.ModuleType("dynamo_tpu.chaos.harness")
    shim.__dict__.update({k: getattr(tharness, k) for k in
                          ("FleetConfig", "MockerFleet", "free_port", "http_json")})
    shim.Proc = port_proc
    monkeypatch.setitem(sys.modules, "dynamo_tpu.chaos.harness", shim)
    monkeypatch.setitem(sys.modules, "dynamo_tpu.transports.client", tclient)
    rebind(jt.test_fleet_e2e_discovery_rollup_staleness_and_planner, **port_names())()
