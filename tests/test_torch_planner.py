"""The port's SLA planner against the JAX package's.

- Every test of ``tests/test_planner.py`` but the connector and profiler
  ones re-runs with the port's classes swapped in (``rebind``).
- Predictors, interpolators, ``find_best_throughput_per_chip`` and
  ``Planner.observe`` / ``compute_replicas`` / ``plan`` over a seeded grid
  of loads, profiles and configs (chip budgets and correction factors
  included) give results equal to JAX's, reasons included.
- ``VirtualConnector`` of each package through the port's coordinator:
  the same key, the same JSON (its wall-clock ``ts`` aside), the same
  revisions, a restarted connector resuming the stored revision.
- The profiler on a CPU ``tiny-llama`` (``device="cpu"``) against JAX's:
  equal ``engine_config_for_sweep`` fields, ``_request`` token ids, decode
  tokens counted in each timed window, npz keys and shapes; wall-clock
  values are not compared. ``test_profiler_itl_scales_sanely`` reads
  wall-clock ratios (load-sensitive under ``-n 6``): its twin holds what
  the ratio stands on — every timed window counts ``concurrency × steps``
  decode tokens of a batch that decodes together, and each throughput is
  the effective concurrency over its ITL.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import types

import numpy as np
import pytest

import tests.test_planner as jt
from dynamo_tpu.planner import interpolator as jinterp
from dynamo_tpu.planner import load_predictor as jpred
from dynamo_tpu.planner import planner_core as jcore
from dynamo_tpu.planner import profiler as jprof
from dynamo_tpu_torch.planner import interpolator as tinterp
from dynamo_tpu_torch.planner import load_predictor as tpred
from dynamo_tpu_torch.planner import planner_core as tcore
from dynamo_tpu_torch.planner import profiler as tprof
from dynamo_tpu_torch.utils import metrics as tmet


def rebind(fn, **names):
    """``fn`` with ``names`` swapped into its module globals."""
    g = dict(fn.__globals__)
    g.update(names)
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def port_names() -> dict:
    names = {"DecodeInterpolator": tinterp.DecodeInterpolator,
             "PrefillInterpolator": tinterp.PrefillInterpolator,
             "synthetic_profile": tinterp.synthetic_profile,
             "make_predictor": tpred.make_predictor, "Metrics": tcore.Metrics,
             "Planner": tcore.Planner, "PlannerConfig": tcore.PlannerConfig,
             "parse_prometheus": tmet.parse_prometheus}
    names["make_planner"] = rebind(jt.make_planner, **names)
    return names


PLAIN_CASES = ["test_constant_predictor", "test_moving_average_predictor",
               "test_linear_trend_predictor_tracks_ramp", "test_linear_trend_clamps_at_zero",
               "test_unknown_predictor_rejected", "test_predictor_ignores_nan",
               "test_replicas_scale_with_load", "test_replicas_exact_prefill_math",
               "test_no_load_gives_min_replicas", "test_max_replicas_bound",
               "test_chip_budget_trims_prefill_first", "test_ttft_correction_scales_prefill_up",
               "test_observe_predict_plan_cycle", "test_parse_prometheus_text"]
PROFILE_CASES = ["test_prefill_interpolation_matches_analytic",
                 "test_decode_interpolation_monotone", "test_find_best_throughput_respects_sla"]


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_planner_case_on_the_port(case):
    rebind(getattr(jt, case), **port_names())()


@pytest.mark.parametrize("case", PROFILE_CASES)
def test_interpolator_case_on_the_port(case):
    profile = tinterp.synthetic_profile(base_ttft_s=0.1, prefill_rate_tokps=8000.0,
                                        base_itl_s=0.01)
    rebind(getattr(jt, case), **port_names())(profile)


# ---------------------------------------------------------------------------
# Seeded twins
# ---------------------------------------------------------------------------

def random_profile(rng) -> dict:
    """A synthetic profile with random parameters, or random sweep arrays
    (unsorted ISL, a non-monotone grid) that exercise the interpolators'
    ordering and fallbacks."""
    if rng.random() < 0.5:
        return jinterp.synthetic_profile(
            base_ttft_s=float(rng.uniform(0.01, 0.5)),
            prefill_rate_tokps=float(rng.uniform(500, 20000)),
            base_itl_s=float(rng.uniform(0.002, 0.05)),
            chips_per_replica=int(rng.integers(1, 4)))
    n_isl, n_c, n_x = (int(x) for x in rng.integers(1, 5, 3))
    isl = rng.permutation(rng.choice(np.arange(16, 8192), n_isl, replace=False)).astype(float)
    conc = np.sort(rng.choice(np.arange(1, 129), n_c, replace=False)).astype(float)
    ctx = np.sort(rng.choice(np.arange(16, 16384), n_x, replace=False)).astype(float)
    itl = rng.uniform(0.002, 0.2, (n_c, n_x))
    return {"prefill_isl": isl, "prefill_ttft_s": rng.uniform(0.01, 2.0, n_isl),
            "prefill_thpt_per_chip": rng.uniform(100, 20000, n_isl),
            "decode_concurrency": conc, "decode_context": ctx, "decode_itl_s": itl,
            "decode_thpt_per_chip": conc[:, None] / itl}


def random_config(rng) -> dict:
    lo = int(rng.integers(0, 3))
    return dict(ttft_sla_s=float(rng.uniform(0.05, 2.0)), itl_sla_s=float(rng.uniform(0.002, 0.2)),
                adjustment_interval_s=float(rng.choice([1.0, 5.0, 30.0])),
                chips_per_prefill_replica=int(rng.integers(1, 4)),
                chips_per_decode_replica=int(rng.integers(1, 4)),
                min_replicas=lo, max_replicas=lo + int(rng.integers(0, 16)),
                load_predictor=str(rng.choice(["constant", "moving_average", "linear"])),
                prediction_window=int(rng.integers(1, 30)),
                chip_budget=int(rng.choice([0, 0, 2, 5, 12])))


def planners(cfg: dict, data: dict):
    return [core.Planner(core.PlannerConfig(**cfg), interp.PrefillInterpolator.from_data(data),
                         interp.DecodeInterpolator.from_data(data))
            for core, interp in ((jcore, jinterp), (tcore, tinterp))]


@pytest.mark.parametrize("seed", range(12))
def test_planner_twin_on_a_seeded_grid(seed):
    """observe → predict → plan, interval by interval, and compute_replicas
    at seeded loads: every decision and reason equal JAX's."""
    rng = np.random.default_rng(seed)
    data = random_profile(rng)
    cfg = random_config(rng)
    jp, tp = planners(cfg, data)
    for _ in range(40):
        kind = rng.random()
        m = dict(num_req=float(rng.integers(0, 2000)) if kind > 0.15 else 0.0,
                 isl=float(rng.uniform(0, 8192)), osl=float(rng.uniform(0, 2048)),
                 ttft_s=float(rng.uniform(0.01, 5.0)) if rng.random() < 0.7 else None,
                 itl_s=float(rng.uniform(0.001, 0.5)) if rng.random() < 0.7 else None)
        if rng.random() < 0.1:
            m["isl"] = float("nan")
        jp.observe(jcore.Metrics(**m))
        tp.observe(tcore.Metrics(**m))
        assert (tp.p_correction, tp.d_correction) == (jp.p_correction, jp.d_correction)
        assert tp.predict_load() == jp.predict_load()
        assert dataclasses.asdict(tp.plan()) == dataclasses.asdict(jp.plan())
        load = (float(rng.uniform(0, 5000)), float(rng.uniform(0, 16384)),
                float(rng.uniform(0, 4096)))
        assert dataclasses.asdict(tp.compute_replicas(*load)) == \
            dataclasses.asdict(jp.compute_replicas(*load))


@pytest.mark.parametrize("seed", range(8))
def test_interpolators_and_predictors_twin(seed):
    rng = np.random.default_rng(1000 + seed)
    data = random_profile(rng)
    pj, pt = jinterp.PrefillInterpolator.from_data(data), tinterp.PrefillInterpolator.from_data(data)
    dj, dt = jinterp.DecodeInterpolator.from_data(data), tinterp.DecodeInterpolator.from_data(data)
    for _ in range(50):
        isl, conc, ctx = rng.uniform(0, 10000), rng.uniform(0, 160), rng.uniform(0, 20000)
        sla = float(rng.choice([1e-6, rng.uniform(0.001, 0.3), 10.0]))
        assert pt.interpolate_ttft(isl) == pj.interpolate_ttft(isl)
        assert pt.interpolate_thpt_per_chip(isl) == pj.interpolate_thpt_per_chip(isl)
        assert dt.interpolate_itl(conc, ctx) == dj.interpolate_itl(conc, ctx)
        assert dt.interpolate_thpt_per_chip(conc, ctx) == dj.interpolate_thpt_per_chip(conc, ctx)
        assert dt.find_best_throughput_per_chip(sla, ctx) == \
            dj.find_best_throughput_per_chip(sla, ctx)
    for kind in jpred.LOAD_PREDICTORS:
        w = int(rng.integers(1, 20))
        a, b = jpred.make_predictor(kind, w), tpred.make_predictor(kind, w)
        for _ in range(60):
            v = float(rng.choice([rng.uniform(0, 1000), float("nan")]))
            a.add_data_point(v)
            b.add_data_point(v)
            assert b.predict_next() == a.predict_next()
    assert [np.asarray(v).tolist() for v in tinterp.synthetic_profile().values()] == \
        [np.asarray(v).tolist() for v in jinterp.synthetic_profile().values()]


# ---------------------------------------------------------------------------
# VirtualConnector through the port's coordinator
# ---------------------------------------------------------------------------

def test_virtual_connector_writes_what_jax_writes():
    from dynamo_tpu.planner.connector import VirtualConnector as JVC
    from dynamo_tpu.transports.client import CoordinatorClient as JClient
    from dynamo_tpu_torch.planner.connector import VirtualConnector as TVC
    from dynamo_tpu_torch.transports.client import CoordinatorClient as TClient
    from dynamo_tpu_torch.transports.coordinator import CoordinatorServer

    async def go():
        server = CoordinatorServer()
        port = await server.start()
        url = f"tcp://127.0.0.1:{port}"
        try:
            got = {}
            for tag, VC, Client in (("jax", JVC, JClient), ("torch", TVC, TClient)):
                client = await Client.connect(url)
                vc = VC(client, f"ns-{tag}")
                await vc.apply(2, 3, "scale up")
                await vc.apply(1, 1)
                again = VC(client, f"ns-{tag}")  # a restarted planner resumes
                await again.apply(4, 2, "slo[x budget=0.50]")
                raw = await client.get(again.key)
                got[tag] = (again.key, json.loads(raw), again.revision)
                await client.close()
            (jk, jdoc, jrev), (tk, tdoc, trev) = got["jax"], got["torch"]
            assert tk == jk.replace("ns-jax", "ns-torch") == "planner/decisions/ns-torch"
            assert trev == jrev == 3
            jdoc.pop("ts"), tdoc.pop("ts")
            assert tdoc == jdoc == {"revision": 3, "prefill_replicas": 4,
                                    "decode_replicas": 2, "reason": "slo[x budget=0.50]"}
        finally:
            await server.stop()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# The profiler on the CPU
# ---------------------------------------------------------------------------

GRIDS = ([16, 32], [1, 2], [16, 48])
STEPS, BLOCK = 4, 4


def sweep_fields(cfg) -> dict:
    return {f: getattr(cfg, f) for f in (
        "allow_random_weights", "model", "block_size", "num_blocks", "max_batch_size",
        "max_model_len", "decode_bucket", "enable_prefix_caching", "tp")}


class Windows:
    """A ``time`` stand-in for a profiler module: each pair of
    ``perf_counter`` calls is one timed window; it records the engine's
    decode tokens (and kv positions' growth) across each."""

    def __init__(self):
        self.core = None
        self.open: int | None = None
        self.decode_tokens: list[int] = []

    def perf_counter(self) -> float:
        import time

        n = self.core.metrics.num_decode_tokens if self.core is not None else 0
        if self.open is None:
            self.open = n
        else:
            self.decode_tokens.append(n - self.open)
            self.open = None
        return time.perf_counter()


def profile_with(mod, windows: Windows, monkeypatch, **kw) -> tuple:
    monkeypatch.setattr(mod, "time", windows)
    cfg = mod.engine_config_for_sweep("tiny-llama", *GRIDS, decode_steps=STEPS,
                                      block_size=BLOCK)
    prof = mod.SlaProfiler(cfg, chips=1, **kw)
    windows.core = prof.core
    return cfg, prof, prof.run(*GRIDS, decode_steps=STEPS)


def test_profiler_on_cpu_tiny_llama_against_jax(tmp_path, monkeypatch):
    jw, tw = Windows(), Windows()
    jcfg, _, jdata = profile_with(jprof, jw, monkeypatch)
    tcfg, tp, tdata = profile_with(tprof, tw, monkeypatch, device="cpu")
    assert sweep_fields(tcfg) == sweep_fields(jcfg)
    for ctx, mt, rid, seed in ((16, 3, "a", 0), (300, 1, "b", 7), (4096, 9, "c", 31)):
        j, t = jprof._request(ctx, mt, rid, seed), tprof._request(ctx, mt, rid, seed)
        assert t.token_ids == j.token_ids and t.request_id == j.request_id
        assert t.stop_conditions.max_tokens == j.stop_conditions.max_tokens == mt
        assert t.stop_conditions.ignore_eos and t.sampling_options.temperature == 0.0
    # one window per measurement (warmups included): prefill's hold no
    # decode token; the timed decode windows count concurrency x steps
    assert len(tw.decode_tokens) == len(jw.decode_tokens) == 2 * (
        len(GRIDS[0]) + len(GRIDS[1]) * len(GRIDS[2]))
    assert tw.decode_tokens == jw.decode_tokens
    assert tw.decode_tokens[2 * len(GRIDS[0]) + 1::2] == [
        c * STEPS for c in GRIDS[1] for _ in GRIDS[2]]
    tprof.save_profile(tmp_path / "t.npz", tdata)
    jprof.save_profile(tmp_path / "j.npz", jdata)
    tl, jl = tprof.load_profile(tmp_path / "t.npz"), jprof.load_profile(tmp_path / "j.npz")
    assert {k: v.shape for k, v in tl.items()} == {k: v.shape for k, v in jl.items()}
    assert sorted(tl) == sorted(tinterp.synthetic_profile())
    for k in ("prefill_isl", "decode_concurrency", "decode_context"):
        assert tl[k].tolist() == jl[k].tolist()
    assert all(np.isfinite(v).all() and (v > 0).all() for v in tl.values())
    # the npz drives the port's planner, as JAX's round trip does
    planner = tcore.Planner(tcore.PlannerConfig(ttft_sla_s=10.0, itl_sla_s=10.0, max_replicas=8),
                            tinterp.PrefillInterpolator.from_data(tl),
                            tinterp.DecodeInterpolator.from_data(tl))
    d = planner.compute_replicas(num_req=5.0, isl=24.0, osl=8.0)
    assert 1 <= d.prefill_replicas <= 8 and 1 <= d.decode_replicas <= 8
    assert tp.core.device_name == "cpu"


def test_profiler_decode_windows_and_throughput_arithmetic(monkeypatch):
    """What ``test_profiler_itl_scales_sanely``'s ratio stands on, without
    reading wall-clock ratios: at each concurrency the timed window counts
    ``concurrency × steps`` decode tokens, and each throughput per card is
    the effective concurrency over the ITL."""
    w = Windows()
    monkeypatch.setattr(tprof, "time", w)
    cfg = tprof.engine_config_for_sweep("tiny-llama", [16], [1, 4], [32], decode_steps=4,
                                        block_size=4)
    prof = tprof.SlaProfiler(cfg, chips=1, device="cpu")
    w.core = prof.core
    itl, thpt = prof.profile_decode([1, 4, 9], [32], steps=4)
    assert w.decode_tokens[1::2] == [4, 16, 16]  # 9 is capped at max_batch_size 4
    assert (itl > 0).all()
    np.testing.assert_allclose(thpt[:, 0] * itl[:, 0], [1, 4, 4], rtol=1e-12)


def test_profiler_runs_on_cuda_unless_asked(monkeypatch):
    """No device given: the engine resolves ``cuda``, which this host lacks."""
    cfg = tprof.engine_config_for_sweep("tiny-llama", [16], [1], [16], decode_steps=2,
                                        block_size=4)
    with pytest.raises(Exception, match="(?i)cuda"):
        tprof.SlaProfiler(cfg)
