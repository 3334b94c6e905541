"""The port's engine with its cost model, ledgers, step profiler and spans
against the JAX engine's, on the same requests and weights (CPU).

tiny-llama in f32 (the JAX init's weights carried over by the weight
bridge) with ``prefill_chunk=0`` and an ITL budget small enough that the
three QoS classes resolve different chunks; interactive, standard and
batch prompts (one of them traced) arrive while three streams decode.
Each engine steps synchronously; the twins must agree on:

- ``chunk_by_qos`` and the resolved chunk cap;
- the greedy streams (token for token: f32);
- every step's plan (prefill rows with start and length, decode rows,
  window);
- every scheduling-ledger step record and the ledger's snapshot, with
  its wall-clock fields left out (goodput, live and scheduled tokens,
  FLOPs and bytes, budget use, queue depths, block and preempt causes,
  HOL culprit and victims, and each step's HOL ``stall_share``);
- the memory ledger's snapshot without its clock-driven fields (the
  occupancy waterfall, pin totals, alloc / release and churn counts,
  tiers) and the leak audit's verdict;
- the step profiler's fields of every step without its wall-clock ones
  (FLOPs, bytes, token counts), and the step ring's batch composition;
- the span names and attributes of the traced request (the hol spans'
  wall-clock ``seconds`` left out).

The same scenario at the default ``prefill_chunk=512`` and, in the port
only, with ``DYN_SCHED_LEDGER=0 DYN_MEM_LEDGER=0 DYN_PERF_PROFILE=0``
must give the same streams. Equality is exact throughout: the twins
compute the same f32 tokens and the same float bookkeeping.
"""

from __future__ import annotations

import dataclasses
import time
import uuid

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import MODEL_PRESETS as JP
from dynamo_tpu.obs import mem_ledger as jmem
from dynamo_tpu.obs import sched_ledger as jsl
from dynamo_tpu.obs import tracer as jtracer
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TP
from dynamo_tpu_torch.models.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.obs import mem_ledger as tmem
from dynamo_tpu_torch.obs import sched_ledger as tsl
from dynamo_tpu_torch.obs import tracer as ttracer
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig

MODEL = "tiny-llama-f32-obs"
#: wall-clock fields of the sched snapshot and step record
SCHED_WALL = {"hol_stall_seconds_total", "interference_row_seconds_total", "top_culprits"}
STEP_WALL = {"ts", "wall_s", "hol_stall_s", "interference_row_s"}
#: the step profiler's fields that divide by the step's wall
PERF_WALL = {"ts", "wall_s", "tok_s", "mfu", "bw_util", "roofline_frac"}
GATES = ("DYN_SCHED_LEDGER", "DYN_MEM_LEDGER", "DYN_PERF_PROFILE")


@pytest.fixture(scope="module")
def params():
    jcfg = dataclasses.replace(JP["tiny-llama"], dtype="float32", name=MODEL)
    JP[MODEL] = jcfg
    TP[MODEL] = TModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(TModelConfig)})
    jp = jllama.init_params(jcfg, jax.random.key(3))
    yield jp, tloader.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del JP[MODEL], TP[MODEL]


def _cfg(**kw) -> dict:
    d = dict(model=MODEL, block_size=4, num_blocks=64, max_batch_size=8, max_model_len=128,
             prefill_chunk=0, itl_slo_ms=0.05, decode_bucket=(4, 8))
    d.update(kw)
    return d


def _req(proto, rid, prompt, max_tokens, qos=None, trace_id=None):
    ann = {}
    if qos:
        ann["qos.priority"] = qos
    if trace_id:
        # a trace of its own for each run: a recorder keeps 512 spans a trace
        ann["obs.traceparent"] = f"00-{trace_id}-b7ad6b7169203331-01"
    return proto.PreprocessedRequest(
        token_ids=list(prompt), request_id=rid, model=MODEL, annotations=ann,
        stop_conditions=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=proto.SamplingOptions(temperature=0.0))


#: (request id, prompt, max tokens, qos class, traced); the first three are
#: sent at once, the rest after the third step (mid-decode)
EARLY = [(f"d{i}", [(5 * i + 3 * j) % 400 + 1 for j in range(9 + i)], 14, None, False)
         for i in range(3)]
LATE = [("int", [(7 * j) % 300 + 2 for j in range(50)], 6, "interactive", True),
        ("std", [(11 * j) % 300 + 3 for j in range(70)], 5, "standard", False),
        ("bat", [(13 * j) % 300 + 4 for j in range(100)], 4, "batch", False)]


def _run(core, proto, trace_id=None):
    """Sync steps over the scenario, the late interactive request traced
    under ``trace_id``; returns the streams, each step's plan and each
    step's plan-time HOL stall share."""
    plans, shares = [], []
    plan_fn, begin_fn = core.sched.plan, core.step_begin

    def plan():
        p = plan_fn()
        plans.append(([(w.seq.request_id, w.start, w.length) for w in p.prefill],
                      [s.request_id for s in p.decode], p.decode_window))
        return p

    def step_begin():
        pending = begin_fn()
        if pending is not None:
            hol = (pending.sched or {}).get("hol")
            shares.append(None if hol is None else (hol.culprit, hol.culprit_tokens,
                                                    [v[1:] for v in hol.victims],
                                                    hol.stall_share))
        return pending

    core.sched.plan, core.step_begin = plan, step_begin
    got = {}
    for rid, *_ in EARLY + LATE:
        got[rid] = []
    for rid, prompt, n, qos, traced in EARLY:
        assert core.add_request(_req(proto, rid, prompt, n, qos, traced and trace_id)) is None
    for i in range(400):
        if i == 3:
            for rid, prompt, n, qos, traced in LATE:
                assert core.add_request(
                    _req(proto, rid, prompt, n, qos, traced and trace_id)) is None
        if not core.has_work() and i > 3:
            break
        for rid, out in core.step().items():
            got[rid] += out.token_ids
    return got, plans, shares


def _reset():
    for mod in (jsl, tsl):
        mod.get_sched_ledger().reset()
    for mod in (jmem, tmem):
        mod.get_mem_ledger().reset()


def _ledgers(core, ledger_mods, tracer_mod, epoch0, trace_id):
    sled = ledger_mods[0].get_sched_ledger()
    mled = ledger_mods[1].get_mem_ledger()
    snap = {k: v for k, v in sled.snapshot().items() if k not in SCHED_WALL}
    culprits = sorted((c["request_id"], c["victims"]) for c in sled.top_culprits())
    steps = [{k: v for k, v in dataclasses.asdict(r).items() if k not in STEP_WALL}
             for r in sled.steps]
    audit = {k: v for k, v in mled.audit(now=1e9).items() if k != "ts"}
    msnap = {k: v for k, v in mled.snapshot().items()
             if k not in ("ttx_seconds", "posture", "last_audit_ts")}
    ring = [{k: v for k, v in r.to_dict().items() if k not in PERF_WALL}
            for r in tracer_mod.get_tracer().recorder.steps.snapshot() if r.ts >= epoch0]
    spans = sorted(
        ((s.start, s.name, {k: v for k, v in s.attrs.items() if k != "seconds"})
         for s in tracer_mod.get_tracer().recorder.iter_spans()
         if s.trace_id == trace_id and s.name.startswith("engine.") and s.start >= epoch0),
        key=lambda x: x[0])
    return {"sched": snap, "culprits": culprits, "steps": steps, "audit": audit,
            "mem": msnap, "ring": ring, "spans": [s[1:] for s in spans]}


def _pair(params, **kw):
    jp, tp = params
    _reset()
    epoch0 = time.time()
    trace_id = uuid.uuid4().hex
    jcore = jeng.EngineCore(JEngineConfig(**_cfg(**kw)), params=jp)
    jgot = _run(jcore, jproto, trace_id)
    jdocs = _ledgers(jcore, (jsl, jmem), jtracer, epoch0, trace_id)
    tcore = teng.EngineCore(TEngineConfig(**_cfg(**kw)), params=tp, device="cpu")
    tgot = _run(tcore, tproto, trace_id)
    tdocs = _ledgers(tcore, (tsl, tmem), ttracer, epoch0, trace_id)
    return (jcore, jgot, jdocs), (tcore, tgot, tdocs)


@pytest.mark.parametrize("prefill_chunk", [0, 512])
def test_engine_observability_matches_jax(params, prefill_chunk):
    (jcore, jgot, jdocs), (tcore, tgot, tdocs) = _pair(params, prefill_chunk=prefill_chunk)
    assert tcore.chunk_by_qos == jcore.chunk_by_qos
    assert tcore.engine_cfg.prefill_chunk == jcore.engine_cfg.prefill_chunk
    if prefill_chunk == 0:
        assert len(set(tcore.chunk_by_qos.values())) == 3, tcore.chunk_by_qos
    else:
        assert set(tcore.chunk_by_qos.values()) == {512}
    streams, plans, shares = tgot
    assert streams == jgot[0]
    assert [len(streams[r]) for r, *_ in EARLY + LATE] == [n for _, _, n, _, _ in EARLY + LATE]
    assert plans == jgot[1]
    assert shares == jgot[2]
    assert any(s is not None and s[3] is not None for s in shares), "no HOL stall priced"
    for key in ("sched", "culprits", "steps", "audit", "mem", "ring", "spans"):
        assert tdocs[key] == jdocs[key], key
    assert tdocs["audit"]["orphan_pins"] == 0
    assert tdocs["mem"]["device_blocks"]["stream"] == 0
    phases = [n for n, _ in tdocs["spans"] if n != "engine.compile"]
    assert phases[:3] == ["engine.queue", "engine.prefill", "engine.decode"], phases
    assert tdocs["steps"] and tdocs["ring"]


def test_ledgers_off_leave_the_streams(params, monkeypatch):
    """The three gates off: the port's streams are the ledgers-on streams,
    and nothing is recorded."""
    (_, jgot, _), (tcore, tgot, _) = _pair(params)
    for gate in GATES:
        monkeypatch.setenv(gate, "0")
    _reset()
    off = teng.EngineCore(TEngineConfig(**_cfg()), params=params[1], device="cpu")
    got, plans, shares = _run(off, tproto)
    assert got == tgot[0] == jgot[0]
    assert plans == tgot[1]
    assert not off.perf.enabled and shares == [None] * len(plans)
    assert tsl.get_sched_ledger().snapshot()["steps_total"] == 0
    assert tmem.get_mem_ledger().owner_blocks()["stream"] == 0


def test_pipelined_loop_keeps_the_books(params):
    """The pipelined loop (step N+1 dispatched before step N's finalize)
    gives the sync streams, one step record a finalize, no orphan pins and
    every block back."""
    (_, _, _), (_, tgot, _) = _pair(params)
    _reset()
    core = teng.EngineCore(TEngineConfig(**_cfg()), params=params[1], device="cpu")
    for rid, prompt, n, qos, _traced in EARLY + LATE:
        assert core.add_request(_req(tproto, rid, prompt, n, qos)) is None
    got = {rid: [] for rid, *_ in EARLY + LATE}
    pending, finalized = None, 0
    while core.has_work() or pending is not None:
        nxt = core.step_begin() if core.has_work() else None
        if pending is not None:
            for rid, out in core.step_finalize(pending).items():
                got[rid] += out.token_ids
            finalized += 1
        pending = nxt
    assert tsl.get_sched_ledger().snapshot()["steps_total"] == finalized
    assert core.mem_led.audit()["orphan_pins"] == 0
    assert core.pool.num_free == core.pool.num_blocks - 1
    ref = {rid: [] for rid in got}
    _reset()
    sync = teng.EngineCore(TEngineConfig(**_cfg()), params=params[1], device="cpu")
    for rid, prompt, n, qos, _traced in EARLY + LATE:
        sync.add_request(_req(tproto, rid, prompt, n, qos))
    while sync.has_work():
        for rid, out in sync.step().items():
            ref[rid] += out.token_ids
    assert got == ref


def test_stats_carry_the_ledgers(params):
    import asyncio

    core = teng.EngineCore(TEngineConfig(**_cfg()), params=params[1], device="cpu")
    engine = teng.AsyncTorchEngine(core)

    async def go():
        async for _ in engine.generate(_req(tproto, "s", [3, 4, 5, 6], 3)):
            pass
        stats = engine.stats()
        await engine.shutdown()
        return stats

    stats = asyncio.run(go())
    assert {"compile", "sched", "mem"} <= set(stats)
    assert stats["sched"]["prefill_chunk_tokens"] == core.chunk_by_qos
    # shutdown drops the engine's live-id source
    assert core._mem_source_key not in tmem.get_mem_ledger()._live_sources


@pytest.mark.parametrize("device_s", [None, 0.25])
def test_step_profiler_clock(params, monkeypatch, device_s):
    """The step profiler divides by the device time of the step's programs
    where their outputs carry it (CUDA events on the card: the sum over a
    step's batches), and by the finalize's host wall where they do not
    (the CPU, as the JAX engine)."""
    monkeypatch.setattr(teng.StepOutputs, "device_seconds", lambda self: device_s)
    _reset()
    core = teng.EngineCore(TEngineConfig(**_cfg()), params=params[1], device="cpu")
    seen = []
    measure = core.perf.measure

    def spy(batches, wall_s):
        seen.append((len(batches), wall_s))
        return measure(batches, wall_s)

    core.perf.measure = spy
    t0 = time.perf_counter()
    got, _, _ = _run(core, tproto)
    elapsed = time.perf_counter() - t0
    assert seen and sum(map(len, got.values())) == sum(n for *_, n, _q, _t in EARLY + LATE)
    if device_s is None:
        assert 0 < sum(w for _, w in seen) <= elapsed
    else:
        assert [w for _, w in seen] == [device_s * n for n, _ in seen]
