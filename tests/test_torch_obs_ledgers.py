"""The port's step profiler, scheduling and memory ledgers, step ring and
their hooks (prefix pool churn, the scheduler's block / preempt / pin
accounting, the device tier row) against the JAX package's.

Each case drives the JAX object and the port's with the same calls, the
clock passed in where the API takes one (``ts``, ``now``), and compares
what each returns and what its Prometheus family exposes. Numbers must be
equal (both copies do the same float operations in the same order); the
step profiler's are held to 1e-12 relative.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import cache as jcache
from dynamo_tpu.engine import prefix_pool as jpool_mod
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.models.config import MODEL_PRESETS as JP
from dynamo_tpu.obs import mem_ledger as jmem
from dynamo_tpu.obs import profiler as jprof
from dynamo_tpu.obs import recorder as jrec
from dynamo_tpu.obs import sched_ledger as jsl
from dynamo_tpu.obs import tracer as jtracer
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu.utils.logging import TraceContext as JTraceContext
from dynamo_tpu.utils.metrics import MetricsRegistry as JRegistry
from dynamo_tpu_torch.engine import cache as tcache
from dynamo_tpu_torch.engine import prefix_pool as tpool_mod
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.engine import StepOutputs
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TP
from dynamo_tpu_torch.obs import mem_ledger as tmem
from dynamo_tpu_torch.obs import profiler as tprof
from dynamo_tpu_torch.obs import recorder as trec
from dynamo_tpu_torch.obs import sched_ledger as tsl
from dynamo_tpu_torch.obs import tracer as ttracer
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.utils.logging import TraceContext as TTraceContext
from dynamo_tpu_torch.utils.metrics import MetricsRegistry as TRegistry

TRACE = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


@pytest.fixture(autouse=True)
def fresh_ledgers():
    """Each case starts from empty ledgers in both packages, with the gates
    the environment sets (on, unless a case says otherwise)."""
    for mod in (jsl, tsl):
        mod.get_sched_ledger().reset()
        mod.get_sched_ledger().configure()
    for mod in (jmem, tmem):
        mod.get_mem_ledger().reset()
        mod.get_mem_ledger().configure()
    yield


def close(a, b, rel=1e-12) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            close(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y, rel)
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rel) or a == b, (a, b)
    else:
        assert a == b, (a, b)


@dataclasses.dataclass
class _Seq:
    """What the profiler and step_geometry read of a row's seq."""
    guided: object = None


def _batches(spec):
    """The same batches in each package's PendingStep.batches form: JAX
    (kind, rows, sample_rows, toks, lps) with numpy tokens, the port's
    (kind, rows, sample_rows, StepOutputs)."""
    jb, tb = [], []
    for kind, rows, width in spec:
        seq = _Seq()
        rs = [(seq, start, length) for start, length in rows]
        shape = (len(rows), width) if width > 1 else (len(rows),)
        toks = np.zeros(shape, np.int32)
        jb.append((kind, rs, [True] * len(rs), toks, toks.astype(np.float32)))
        tb.append((kind, rs, [True] * len(rs),
                   StepOutputs(torch.from_numpy(toks), torch.zeros(shape))))
    return jb, tb


#: step shapes of every batch kind: decode (one step and a fused window of
#: 4), legacy prefill, unified mixed (decode rows then chunks), a verify
#: step of 5-token chunks, and a degenerate mixed batch of 1-token rows
STEPS = [
    [("decode", [(17, 1), (40, 1), (3, 1)], 1)],
    [("decode", [(17, 1), (40, 1)], 4)],
    [("prefill", [(0, 32), (16, 7)], 1)],
    [("mixed", [(20, 1), (33, 1), (0, 32), (32, 11)], 1)],
    [("verify", [(50, 5), (9, 3)], 5)],
    [("mixed", [(20, 1), (33, 1), (5, 1)], 1)],
    [("decode", [(60, 1)] * 9, 1), ("prefill", [(0, 30)], 1)],
]


def _configs(**kw):
    d = dict(model="tiny-llama", block_size=4, num_blocks=64, max_batch_size=16,
             max_model_len=128, prefill_chunk=32, decode_bucket=(4, 8, 16), spec_k=4)
    d.update(kw)
    return JEngineConfig(**d), TEngineConfig(**d)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_step_profiler_measure_matches_jax(kv_dtype):
    jec, tec = _configs(kv_dtype=kv_dtype)
    jreg, treg = JRegistry(), TRegistry()
    jprof.install_perf_metrics(jreg)
    tprof.install_perf_metrics(treg)
    jp = jprof.StepPerfProfiler(JP["tiny-llama"], jec, device_kind="cpu", enabled=True)
    tp = tprof.StepPerfProfiler(TP["tiny-llama"], tec, "cpu", enabled=True)
    for i, spec in enumerate(STEPS):
        jb, tb = _batches(spec)
        wall = 0.001 * (i + 1)
        close(jp.measure(jb, wall), tp.measure(tb, wall))
    assert treg.expose() == jreg.expose()
    assert tp.measure([], 0.1) == jp.measure([], 0.1) == {}


def test_step_profiler_gate_and_unknown_card(monkeypatch):
    jec, tec = _configs()
    monkeypatch.setenv(tprof.PERF_ENV, "0")
    assert not tprof.StepPerfProfiler(TP["tiny-llama"], tec, "cpu").enabled
    monkeypatch.delenv(tprof.PERF_ENV)
    p = tprof.StepPerfProfiler(TP["tiny-llama"], tec, "NVIDIA H100 80GB HBM3")
    assert p.enabled and p.hw.name == "h100-sxm"
    p = tprof.StepPerfProfiler(TP["tiny-llama"], tec, "NVIDIA H100 PCIe")
    assert not p.enabled and p.hw is None
    assert p.measure(_batches(STEPS[0])[1], 0.01) == {}


@pytest.mark.parametrize("kw", [{}, dict(unified_step=False), dict(kv_dtype="int8"),
                                dict(decode_window=4)])
def test_step_geometry_matches_jax(kw):
    jec, tec = _configs(**kw)
    for spec in STEPS:
        jb, tb = _batches(spec)
        dec = sum(1 for _, rows, _ in spec for _s, length in rows if length == 1)
        close(jsl.step_geometry(JP["tiny-llama"], jec, jb, mixed_dec_rows=dec),
              tsl.step_geometry(TP["tiny-llama"], tec, tb, mixed_dec_rows=dec))


def _sched_calls(mod, ctx_cls, tracer_mod):
    """One sequence of scheduling-ledger calls; returns the ledger's
    documents and the hol spans it opened."""
    led = mod.get_sched_ledger()
    reg = (JRegistry if mod is jsl else TRegistry)()
    mod.install_sched_metrics(reg)
    tr = tracer_mod.get_tracer()
    n0 = len(list(tr.recorder.iter_spans()))
    led.set_prefill_chunks({"interactive": 16, "standard": 32, "batch": 64})
    ctx = ctx_cls.parse(TRACE)
    for i in range(6):
        led.record_block("no_free_blocks" if i % 2 else "batch_full")
        if i == 3:
            led.record_block("wdrr_gate")
            led.record_preempt(37, "qos")
        led.record_preempt(5 * i)
        hol = None
        if i % 2:
            hol = mod.HolStall(culprit=f"r{i % 4}", culprit_tokens=32 * i,
                               victims=[(ctx if v == 0 else None, f"v{v}", "interactive")
                                        for v in range(i)],
                               stall_share=None if i == 5 else 0.25 * i / 5)
        led.record_step(wall_s=0.01 * (i + 1), kinds=("mixed",) if i % 2 else ("decode",),
                        prefill_rows=i % 2, decode_rows=i, decode_window=1,
                        live_tokens=10 * i + 1, sched_tokens=16 * (i + 1),
                        live_flops=1e9 * i, sched_flops=2e9 * (i + 1) if i != 2 else 0.0,
                        live_bytes=3e6 * i, sched_bytes=4e6 * (i + 1), budget_util=0.1 * i,
                        queue_depths={"interactive": i, "batch": 1}, hol=hol,
                        ts=1000.0 + i)
    spans = [(s.name, s.attrs, round(s.end - s.start, 9), s.trace_id)
             for s in list(tr.recorder.iter_spans())[n0:] if s.name == "engine.hol_stall"]
    return (led.snapshot(steps=True), led.debug_info(), led.debug_info(recorder=tr.recorder),
            spans, reg.expose())


def test_sched_ledger_matches_jax():
    jout = _sched_calls(jsl, JTraceContext, jtracer)
    tout = _sched_calls(tsl, TTraceContext, ttracer)
    jsnap, jdbg, jdbg_rec, jspans, jexp = jout
    tsnap, tdbg, tdbg_rec, tspans, texp = tout
    assert tsnap == jsnap
    assert tdbg == jdbg
    # the recorder-side culprits aggregate over all hol spans each
    # recorder holds; the ledger's own part must agree
    assert set(tdbg_rec) == set(jdbg_rec)
    assert tspans == jspans and tspans
    assert texp == jexp


def test_sched_ledger_disabled(monkeypatch):
    monkeypatch.setenv(tsl.SCHED_ENV, "0")
    led = tsl.get_sched_ledger()
    led.configure()
    led.record_block("batch_full")
    assert led.record_step(wall_s=0.1, kinds=("decode",)) is None
    assert led.snapshot()["steps_total"] == 0 and not led.blocked_totals


def _mem_calls(mod):
    led = mod.get_mem_ledger()
    reg = (JRegistry if mod is jmem else TRegistry)()
    mod.install_mem_metrics(reg)
    live = {"stream": ["a", "b"]}
    led.register_live_source("e1", lambda: mod.live_ids_of(streams=live["stream"]))
    led.register_tier("device", lambda: (12, 12 * 4096))

    def broken():
        raise RuntimeError("store down")

    led.register_tier("remote", broken)
    out = []
    for i, (oid, n) in enumerate([("a", 4), ("b", 2), ("c", 3), ("a", 1)]):
        led.pin("stream", oid, n)
        led.record_alloc("standard" if i % 2 else "interactive", n)
        led.observe_device(free=50 - 3 * i, cached=i, total=63)
        out.append(led.observe_free(50 - 3 * i, now=100.0 + i))
    led.record_churn("device", "allocation_pressure", 2, ts=104.5)
    led.record_churn("device", "clear", 1, ts=105.0)
    led.unpin("stream", "b")
    led.record_release("standard", 2)
    led.unpin("stream", "a", 2)
    led.unpin("stream", "zzz")
    out.append(led.observe_free(45, now=106.0))
    out.append(led.audit(now=107.0))
    out.append(led.maybe_audit(now=108.0))
    led.configure(audit_interval_s=0.5)
    out.append(led.maybe_audit(now=108.0))
    live["stream"].append("c")
    out.append(led.audit(now=109.0))
    out += [led.owner_blocks(), led.top_owners(), led.consumption_rates(), led.snapshot(),
            led.debug_info(), led.churn_trend()]
    led.republish()
    out.append(reg.expose())
    return out


def test_mem_ledger_matches_jax():
    jout, tout = _mem_calls(jmem), _mem_calls(tmem)
    close(jout, tout)
    orphaned = tout[5]
    assert orphaned["orphan_pins"] == 1 and orphaned["orphans"]["stream"][0]["id"] == "c"
    assert tout[-8]["orphan_pins"] == 0  # c went live
    assert tmem.live_ids_of(streams=[1], staging=["x"]) == jmem.live_ids_of(
        streams=[1], staging=["x"])


def test_mem_ledger_disabled(monkeypatch):
    monkeypatch.setenv(tmem.MEM_ENV, "0")
    led = tmem.get_mem_ledger()
    led.configure()
    led.pin("stream", "a", 3)
    assert led.owner_blocks()["stream"] == 0
    assert led.observe_free(3, now=1.0) == (tmem.TTX_CAP_S, "ok")
    assert led.maybe_audit(now=2.0) is None


def _pool_ops(pool_mod, mem_mod):
    pool = pool_mod.PrefixPool(9, 4)
    a = pool.allocate(4)
    for i, bid in enumerate(a):
        pool.commit(bid, 1000 + i, 999 + i if i else None)
    pool.release(a)                      # 4 committed blocks park in the LRU
    b = pool.allocate(6)                 # 4 free + 2 evicted (pressure)
    pool.release(b)
    c = pool.allocate(2)
    for i, bid in enumerate(c):
        pool.commit(bid, 2000 + i)
    pool.release(c)
    pool.clear()
    return mem_mod.get_mem_ledger().snapshot()["churn"], pool.num_free, pool.num_inactive


def test_prefix_pool_churn_matches_jax():
    got = _pool_ops(jpool_mod, jmem), _pool_ops(tpool_mod, tmem)
    assert got[0] == got[1]
    assert got[1][0] == {"device/allocation_pressure": 2, "device/clear": 4}


def test_device_tier_row_matches_jax():
    from dynamo_tpu.models.config import MODEL_PRESETS

    for kv in ("bfloat16", "int8", "int4"):
        rows = []
        for pool_mod, cache_mod, mem_mod, cfg in (
                (jpool_mod, jcache, jmem, MODEL_PRESETS["tiny-llama"]),
                (tpool_mod, tcache, tmem, TP["tiny-llama"])):
            pool = pool_mod.PrefixPool(16, 4)
            cache_mod.register_device_tier(pool, cache_mod.KVCacheSpec.for_model(
                cfg, 16, 4, kv_dtype=kv))
            pool.allocate(5)
            rows.append(mem_mod.get_mem_ledger().tier_occupancy())
        assert rows[0] == rows[1] and rows[1]["device"]["blocks"] == 5


def _sched_run(sched_mod, proto, sled_mod, mem_mod, pool_mod):
    """Admissions past the batch cap and the pool, per-QoS chunk caps and
    a preemption under block pressure through one scheduler."""
    pool = pool_mod.PrefixPool(16, 4)
    s = sched_mod.Scheduler(pool=pool, max_batch_size=4, prefill_chunk=16, max_model_len=64,
                            max_tokens_per_step=40,
                            chunk_by_qos={"interactive": 4, "standard": 8, "batch": 16})
    seqs = []
    for i, qos in enumerate(["batch", "interactive", "standard", "batch", "interactive"]):
        req = proto.PreprocessedRequest(
            token_ids=list(range(1 + i, 11 + 3 * i)), request_id=f"r{i}",
            stop_conditions=proto.StopConditions(max_tokens=20),
            annotations={"qos.priority": qos})
        seq = sched_mod.Seq(req=req, block_size=4)
        s.add(seq)
        seqs.append(seq)
    plans = []
    for step in range(40):
        plan = s.plan()
        plans.append(([(w.seq.request_id, w.start, w.length) for w in plan.prefill],
                      [q.request_id for q in plan.decode]))
        for w in plan.prefill:
            w.seq.num_computed = w.start + w.length
            if w.seq.num_computed >= w.seq.prefill_target():
                w.seq.tokens.append(7)
        for q in plan.decode:
            q.num_computed += 1
            q.tokens.append(7)
        for q in list(s.running):
            if q.num_output_tokens >= 12:
                s.finish(q, proto.FinishReason.STOP)
    sled = sled_mod.get_sched_ledger()
    mled = mem_mod.get_mem_ledger()
    return (plans, s.preemption_count, dict(sled.blocked_totals), dict(sled.preempt_totals),
            mled.owner_blocks(), mled.top_owners(), dict(mled.alloc_totals),
            dict(mled.release_totals))


def test_scheduler_hooks_and_chunk_caps_match_jax():
    jgot = _sched_run(jsched, jproto, jsl, jmem, jpool_mod)
    tgot = _sched_run(tsched, tproto, tsl, tmem, tpool_mod)
    assert tgot == jgot
    plans, preemptions, blocked, preempt, *_ = tgot
    # the per-QoS caps shaped the first chunks, and pressure was exercised
    first = {rid: length for step in plans for rid, start, length in step[0] if start == 0}
    assert first == {"r0": 10, "r1": 4, "r2": 8, "r3": 16, "r4": 4}
    assert blocked and preemptions and preempt


def test_step_ring_and_chrome_rows_match_jax():
    jr, tr = jrec.FlightRecorder(), trec.FlightRecorder()
    for i in range(3):
        kw = dict(num_prefill=i, num_decode=2 * i, num_waiting=1, num_preempted=0,
                  occupancy=0.25 * i, decode_tokens=i, prefill_tokens=3, flops=1e9 * i,
                  hbm_bytes=2e6, tok_s=100.0 * i, mfu=0.001 * i, bw_util=0.5,
                  roofline_frac=0.25)
        jr.steps.record(1000.0 + i, 0.01, **kw)
        tr.steps.record(1000.0 + i, 0.01, **kw)
    assert [r.to_dict() for r in tr.steps.snapshot()] == [
        r.to_dict() for r in jr.steps.snapshot()]
    assert tr.dump_chrome() == jr.dump_chrome()


def test_metric_families_match_jax():
    """Every family's names, kinds and help texts, with nothing recorded."""
    for jmod, tmod, cls in ((jprof, tprof, "PerfMetrics"), (jsl, tsl, "SchedMetrics"),
                            (jmem, tmem, "MemMetrics")):
        jreg, treg = JRegistry(), TRegistry()
        getattr(jmod, cls)(jreg)
        getattr(tmod, cls)(treg)
        assert treg.expose() == jreg.expose()


def test_phases_label_the_port_forward():
    """capture_phases on the CPU collects the port's phase hooks: the KV
    scatter and attention of every layer, the logits projection and the
    sampling of a runner step; outside a capture a phase is a
    record_function label."""
    from dynamo_tpu_torch.engine.engine import ModelRunner

    assert isinstance(tprof.phase("x"), torch.profiler.record_function)
    tec = TEngineConfig(model="tiny-llama", block_size=4, num_blocks=16, max_batch_size=2,
                        max_model_len=32, prefill_chunk=16)
    runner = ModelRunner(TP["tiny-llama"], tec, device="cpu")
    req = tproto.PreprocessedRequest(token_ids=[5, 6, 7], request_id="p",
                                     sampling_options=tproto.SamplingOptions(temperature=0.0))
    seq = tsched.Seq(req=req, block_size=4)
    seq.slot, seq.block_ids = 0, [1]
    with tprof.capture_phases() as sink:
        runner.run([(seq, 0, 3)], [True])
    assert set(sink) == {"scatter", "attention", "logits", "sampling"}
    assert all(v >= 0.0 for v in sink.values())
