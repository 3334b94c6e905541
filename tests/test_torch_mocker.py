"""The port's mocker (``dynamo_tpu_torch/mocker/engine.py``) held to the
JAX package's, in process.

Each case is the request script of one in-process mocker test of the JAX
suite (``tests/test_compile_obs.py``, ``test_sched_obs.py``,
``test_mem_obs.py``, ``test_qos.py``, ``test_drain.py``,
``test_session.py``, ``test_prefix_cache.py``), run once on each
package's ``MockEngine``. What each run gives must be equal, exactly: the
token streams and finish reasons, the KV events in order, ``stats()``, the
compile, scheduling and memory ledgers' records, the spans, the stream
checkpoint records and session records written to the store, and what
``warmup``, ``abort_class`` and ``evacuate_sessions`` return. Only
wall-clock stamps and the random trace ids are dropped.

The mocker's times are ``asyncio.sleep`` calls, so each script runs on an
event loop with a virtual clock (:class:`VirtualClockLoop`): a timer fires
when nothing else is ready, at once, and the interleaving of the clients
and the step loop is the same in both runs. Each package's ledgers,
metrics and tracer are reset before its run.
"""

from __future__ import annotations

import asyncio
import importlib
import selectors
import threading

import pytest

PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
#: wall-clock stamps and random trace ids, dropped before the comparison
VOLATILE = {"ts", "last_audit_ts", "trace_id"}


class _VirtualSelector(selectors.DefaultSelector):
    loop: "VirtualClockLoop"

    def select(self, timeout=None):
        events = super().select(0 if timeout is not None else None)
        if not events and timeout:
            self.loop.virtual_time += timeout   # jump to the next timer
        return events


class VirtualClockLoop(asyncio.SelectorEventLoop):
    """An event loop whose clock moves only when the loop would wait."""

    def __init__(self):
        sel = _VirtualSelector()
        super().__init__(sel)
        sel.loop = self
        self.virtual_time = 0.0

    def time(self) -> float:
        return self.virtual_time


class VirtualTime:
    """The ``time`` module as the mocker sees it during a run: ``time()``,
    ``monotonic()`` and ``perf_counter()`` read the loop's virtual clock
    (from a fixed epoch), so the memory ledger's rates and forecast are the
    same in both runs."""

    EPOCH = 1.7e9

    def __init__(self, loop: VirtualClockLoop):
        self.loop = loop

    def time(self) -> float:
        return self.EPOCH + self.loop.virtual_time

    monotonic = perf_counter = time


class Pkg:
    """One package's names, as the twinned JAX tests import them."""

    def __init__(self, root: str):
        self.root = root
        imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
        self.mock = imp("mocker.engine")
        self.common = imp("protocols.common")
        self.compile = imp("obs.compile_ledger")
        self.sched = imp("obs.sched_ledger")
        self.mem = imp("obs.mem_ledger")
        self.tracer = imp("obs.tracer")
        self.recorder = imp("obs.recorder")
        self.session = imp("engine.session")
        self.deadline = imp("qos.deadline")
        self.ckpt = imp("kvbm.stream_ckpt")
        self.pcm = imp("kvbm.metrics")
        self.remote = imp("kvbm.remote")
        self.metrics = imp("utils.metrics")

    def reset(self) -> None:
        reg = self.metrics.MetricsRegistry
        led = self.compile.get_compile_ledger()
        led.reset()
        led.configure("lazy")
        self.compile.install_compile_metrics(reg())
        for mod, get, install in ((self.sched, "get_sched_ledger", "install_sched_metrics"),
                                  (self.mem, "get_mem_ledger", "install_mem_metrics")):
            led = getattr(mod, get)()
            led.reset()
            led.configure(True)
            getattr(mod, install)(reg())
        self.session.install_session_metrics(reg())
        self.ckpt.install_stream_ckpt_metrics(reg())
        self.pcm.install_prefix_cache_metrics(reg())
        self.tracer.get_tracer().recorder = self.recorder.FlightRecorder(capacity=256)

    def req(self, tokens, rid, max_tokens=4, **annotations):
        c = self.common
        return c.PreprocessedRequest(
            token_ids=list(tokens), request_id=rid,
            stop_conditions=c.StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=c.SamplingOptions(temperature=0.0),
            annotations=annotations or None)


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, (list, tuple)):
        return [strip(v) for v in x]
    return x


class Run:
    """One package's mocker under a script: every observable it leaves."""

    def __init__(self, P: Pkg, store_addr: str | None = None):
        self.P = P
        self.store_addr = store_addr
        self.log: list = []          # what the script observed, in order
        self.events: list = []       # KV events, in order
        self.records: list = []      # store writes: checkpoints, sessions
        self.engines: list = []

    def engine(self, **kw):
        args = dict(kw)
        if args.pop("remote", False):
            args["remote_kv_addr"] = self.store_addr
        eng = self.P.mock.MockEngine(self.P.mock.MockEngineArgs(**args),
                                     event_sink=lambda e: self.events.append(e.to_dict()))
        if eng.remote is not None:
            for op in ("put_stream_ckpt", "del_stream_ckpt", "put_session"):
                orig = getattr(eng.remote, op)

                def wrapped(*a, _op=op, _orig=orig):
                    self.records.append([_op, *a])
                    return _orig(*a)
                setattr(eng.remote, op, wrapped)
        self.engines.append(eng)
        return eng

    async def gen(self, eng, tokens, rid, max_tokens=4, **ann):
        toks, reasons = [], []
        async for out in eng.generate(self.P.req(tokens, rid, max_tokens, **ann)):
            toks.extend(out.token_ids)
            reasons.append(str(out.finish_reason) if out.finish_reason is not None else None)
        self.log.append(["stream", rid, toks, reasons])
        return toks

    def note(self, name, value):
        self.log.append([name, strip(value)])

    def evidence(self) -> dict:
        P = self.P
        return strip({
            "log": self.log,
            "events": self.events,
            "records": self.records,
            "stats": [e.stats() for e in self.engines],
            "compile": [e.to_dict() for e in P.compile.get_compile_ledger().events],
            "sched": P.sched.get_sched_ledger().debug_info(),
            "mem": P.mem.get_mem_ledger().debug_info(),
            "spans": sorted(([s.name, s.status, s.attrs]
                             for s in P.tracer.get_tracer().recorder.iter_spans()),
                            key=repr),
        })


class Store:
    """A RemoteBlockServer of the package on a loop thread of its own (the
    mocker's store client is synchronous)."""

    def __init__(self, P: Pkg):
        self.loop = asyncio.new_event_loop()
        self.server = P.remote.RemoteBlockServer(capacity_bytes=1 << 22)
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        port = asyncio.run_coroutine_threadsafe(
            self.server.start("127.0.0.1", 0), self.loop).result(10)
        self.addr = f"127.0.0.1:{port}"

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


# ---------------------------------------------------------------------------
# The scripts: one for each in-process mocker test of the JAX suite
# ---------------------------------------------------------------------------

OBS = dict(block_size=4, speedup_ratio=1000.0, max_model_len=256, num_blocks=128)


async def compile_lazy_records_serve_compiles(r: Run):
    """test_compile_obs.py::test_mocker_lazy_records_serve_compiles"""
    eng = r.engine(**OBS, compile_s=0.5, warmup_mode="lazy")
    await r.gen(eng, range(5, 29), "a")
    await r.gen(eng, range(500, 524), "b")
    await eng.stop()


async def compile_full_warmup_prevents_serve_compiles(r: Run):
    """test_compile_obs.py::test_mocker_full_warmup_prevents_serve_compiles"""
    eng = r.engine(**OBS, compile_s=0.5, warmup_mode="full")
    r.note("warmup", eng.warmup())
    await r.gen(eng, range(5, 29), "a")
    await eng.stop()


async def compile_off_mode_is_silent(r: Run):
    """test_compile_obs.py::test_mocker_off_mode_is_silent"""
    eng = r.engine(**OBS, compile_s=0.5, warmup_mode="off")
    r.note("warmup", eng.warmup())
    await r.gen(eng, range(5, 29), "a")
    await eng.stop()


async def compile_sig_mirror(r: Run):
    """test_compile_obs.py::test_mocker_sig_mirror_matches_ledger_module"""
    eng = r.engine(**OBS, compile_s=0.5, warmup_mode="lazy")
    await r.gen(eng, range(5, 29), "a", max_tokens=2)
    await eng.stop()


async def compile_legacy_prefill_sigs(r: Run):
    """test_compile_obs.py::test_mocker_legacy_flag_keeps_prefill_sigs"""
    eng = r.engine(**OBS, compile_s=0.5, warmup_mode="lazy", unified_step=False)
    await r.gen(eng, range(5, 29), "a", max_tokens=2)
    await eng.stop()


async def sched_parity(r: Run):
    """test_sched_obs.py::test_mocker_sched_parity (and test_mem_obs.py::
    test_mocker_mem_parity: the same script, both ledgers compared)"""
    eng = r.engine(**OBS, compile_s=0.0)
    await r.gen(eng, range(5, 29), "a")
    r.note("audit", r.P.mem.get_mem_ledger().audit())
    await eng.stop()


async def hol_attribution(r: Run, unified: bool = True, rid: str = "victim-a",
                          max_tokens: int = 100):
    """test_sched_obs.py::test_mocker_concurrent_hol_attribution: a traced
    decode stream stalled by a second request's prefill"""
    tr = r.P.tracer
    eng = r.engine(**{**OBS, "speedup_ratio": 100.0}, compile_s=0.0, unified_step=unified)
    ctx = tr.TraceContext.new()
    first = asyncio.Event()

    async def victim():
        toks = []
        async for out in eng.generate(r.P.req(range(5, 29), rid, max_tokens,
                                              **{tr.TRACE_KEY: ctx.header()})):
            toks.extend(out.token_ids)
            first.set()
        r.log.append(["stream", rid, toks])

    vt = asyncio.create_task(victim())
    await asyncio.wait_for(first.wait(), 10)
    await r.gen(eng, range(200, 232), "culprit-b", max_tokens=2)
    await asyncio.wait_for(vt, 30)
    r.note("top_culprits", r.P.sched.get_sched_ledger().top_culprits())
    await eng.stop()


async def hol_unified_vs_legacy(r: Run):
    """test_sched_obs.py::test_mocker_unified_lowers_hol_stall"""
    for unified in (True, False):
        r.P.sched.get_sched_ledger().reset()
        await hol_attribution(r, unified=unified, rid="victim", max_tokens=60)
        r.note("hol", r.P.sched.get_sched_ledger().snapshot())


async def qos_cancels_expired_before_prefill(r: Run):
    """test_qos.py::test_mocker_cancels_expired_before_prefill"""
    d = r.P.deadline
    eng = r.engine(vocab_size=128, speedup_ratio=1000.0)
    await r.gen(eng, [1, 2, 3], "late", **{d.PRIORITY_KEY: "batch", d.DEADLINE_KEY: 1.0})
    await eng.stop()


async def qos_priority_admission_order(r: Run):
    """test_qos.py::test_mocker_priority_admission_order"""
    d = r.P.deadline
    eng = r.engine(vocab_size=128, max_batch_size=1, speedup_ratio=1000.0)
    done = []

    async def one(priority, tag):
        await r.gen(eng, [1, 2, 3], tag, max_tokens=2, **{d.PRIORITY_KEY: priority})
        done.append(tag)

    tasks = [asyncio.create_task(one("batch", f"b{i}")) for i in range(3)]
    await asyncio.sleep(0)
    tasks.append(asyncio.create_task(one("interactive", "hot")))
    await asyncio.gather(*tasks)
    r.note("done_order", done)
    await eng.stop()


async def drain_evacuate_then_remote_resume(r: Run):
    """test_drain.py::test_mocker_evacuate_then_remote_resume"""
    sk = r.P.session.SESSION_KEY
    args = dict(num_blocks=64, block_size=16, enable_prefix_caching=True,
                session_ttl=60.0, speedup_ratio=1000.0, remote=True)
    a = r.engine(**args)
    prompt = list(range(1, 65))
    out1 = await r.gen(a, prompt, "t1", **{sk: "s1"})
    r.note("evacuate", a.evacuate_sessions())
    await a.stop()
    b = r.engine(**args)
    await r.gen(b, prompt + out1 + list(range(100, 132)), "t2", **{sk: "s1"})
    await b.stop()


async def drain_abort_class_is_qos_scoped(r: Run):
    """test_drain.py::test_mocker_abort_class_is_qos_scoped (0.6 s where the
    JAX test waits 0.3 s: on the virtual clock the first step's 0.5 s
    cold-bucket stall would leave both streams without a token)"""
    d = r.P.deadline
    eng = r.engine(num_blocks=128, block_size=16, speedup_ratio=1.0)
    tb = asyncio.create_task(r.gen(eng, range(1, 33), "b1", max_tokens=500,
                                   **{d.PRIORITY_KEY: "batch"}))
    ti = asyncio.create_task(r.gen(eng, range(1, 33), "i1", max_tokens=500,
                                   **{d.PRIORITY_KEY: "interactive"}))
    await asyncio.sleep(0.6)
    r.note("abort_batch", eng.abort_class("batch"))
    await tb
    r.note("interactive_running", not ti.done())
    r.note("abort_all", eng.abort_class())
    await ti
    await eng.stop()


async def session_retention(r: Run):
    """test_session.py::test_mock_engine_session_retention"""
    sk = r.P.session.SESSION_KEY
    eng = r.engine(num_blocks=64, block_size=16, enable_prefix_caching=True,
                   session_ttl=30.0, speedup_ratio=1000.0)
    p1 = list(range(1, 65))
    out1 = await r.gen(eng, p1, "t1", **{sk: "m1"})
    r.note("session", eng.stats()["session"])
    await r.gen(eng, p1 + out1 + list(range(100, 132)), "t2", **{sk: "m1"})
    sm = r.P.session.get_session_metrics()
    r.note("session_metrics", [sm.hits.get(), sm.avoided_tokens.get()])
    await eng.stop()


async def prefix_cache_fleet_cold_import(r: Run):
    """test_prefix_cache.py::test_mocker_fleet_cold_import"""
    args = dict(num_blocks=64, block_size=4, vocab_size=128, speedup_ratio=1000.0,
                remote=True, global_prefix_cache=True)
    a, b = r.engine(**args), r.engine(**args)
    await r.gen(a, range(1, 25), "a")
    await r.gen(b, range(1, 25), "b")
    m = r.P.pcm.get_prefix_cache_metrics()
    r.note("avoided", m.recompute_avoided_tokens.get())
    await a.stop()
    await b.stop()


async def stream_ckpt_records(r: Run):
    """The mocker's stream checkpoints (kvbm/stream_ckpt.py mirror): a
    stream checkpointed every interval, one cut by ``abort_class``, and a
    resume request continuing the first one's md5 sequence."""
    d, ck = r.P.deadline, r.P.ckpt
    eng = r.engine(num_blocks=64, block_size=4, vocab_size=260, speedup_ratio=1000.0,
                   remote=True, stream_ckpt_blocks=1)
    out = await r.gen(eng, range(1, 13), "ck1", max_tokens=20,
                      **{d.PRIORITY_KEY: "interactive"})
    cut = asyncio.create_task(r.gen(eng, range(40, 52), "ck2", max_tokens=400))
    await asyncio.sleep(0.02)
    r.note("abort", eng.abort_class(None))
    await cut
    await r.gen(eng, list(range(1, 13)) + out[:9], "ck1", max_tokens=11,
                **{ck.CKPT_GENERATED_KEY: 9})
    await eng.stop()


CASES = {f.__name__: f for f in (
    compile_lazy_records_serve_compiles, compile_full_warmup_prevents_serve_compiles,
    compile_off_mode_is_silent, compile_sig_mirror, compile_legacy_prefill_sigs,
    sched_parity, hol_attribution, hol_unified_vs_legacy,
    qos_cancels_expired_before_prefill, qos_priority_admission_order,
    drain_evacuate_then_remote_resume, drain_abort_class_is_qos_scoped,
    session_retention, prefix_cache_fleet_cold_import, stream_ckpt_records)}


def run_case(root: str, case: str, monkeypatch=None) -> dict:
    P = Pkg(root)
    P.reset()
    store = Store(P)
    loop = VirtualClockLoop()
    real_time, P.mock.time = P.mock.time, VirtualTime(loop)
    try:
        r = Run(P, store.addr)
        asyncio.run(CASES[case](r), loop_factory=lambda: loop)
        return r.evidence()
    finally:
        P.mock.time = real_time
        store.close()
        P.reset()


def _notes(ev: dict) -> dict:
    return {e[0]: e[1] for e in ev["log"] if e[0] != "stream"}


def _streams(ev: dict) -> dict:
    return {e[1]: e[2] for e in ev["log"] if e[0] == "stream"}


#: what the twinned JAX test asserts, on the port's evidence (so that no
#: case passes by both packages doing nothing)
EXPECT = {
    "compile_lazy_records_serve_compiles": lambda ev: (
        {e["kind"] for e in ev["compile"]} == {"mixed", "decode"}
        and all(e["source"] == "serve" for e in ev["compile"])),
    "compile_full_warmup_prevents_serve_compiles": lambda ev: (
        _notes(ev)["warmup"]["coverage"] == 1.0
        and all(e["source"] == "warmup" for e in ev["compile"])),
    "compile_off_mode_is_silent": lambda ev: (
        ev["compile"] == [] and "compile" not in ev["stats"][0]),
    "compile_sig_mirror": lambda ev: [e["kind"] for e in ev["compile"]] == ["mixed", "decode"],
    "compile_legacy_prefill_sigs": lambda ev: [e["kind"] for e in ev["compile"]] == [
        "prefill", "decode"],
    "sched_parity": lambda ev: (
        ev["stats"][0]["sched"]["steps_total"] > 0
        and ev["stats"][0]["mem"]["device_blocks"]["stream"] == 0
        and _notes(ev)["audit"]["orphan_pins"] == 0),
    "hol_attribution": lambda ev: (
        _notes(ev)["top_culprits"][0]["request_id"] == "culprit-b"
        and any(sp[0] == "engine.hol_stall" for sp in ev["spans"])),
    "hol_unified_vs_legacy": lambda ev: len(ev["stats"]) == 2,
    "qos_cancels_expired_before_prefill": lambda ev: (
        ev["log"][0][3] == ["cancelled"] and ev["stats"][0]["deadline_cancelled"] == 1),
    "qos_priority_admission_order": lambda ev: "hot" in _notes(ev)["done_order"][:2],
    "drain_evacuate_then_remote_resume": lambda ev: (
        _notes(ev)["evacuate"]["sessions"] == 1
        and ev["stats"][1]["session_remote_resumes"] == 1),
    "drain_abort_class_is_qos_scoped": lambda ev: (
        [_notes(ev)[k] for k in ("abort_batch", "interactive_running", "abort_all")]
        == [1, True, 1] and all(_streams(ev).values())),
    "session_retention": lambda ev: _notes(ev)["session_metrics"][0] == 1.0,
    "prefix_cache_fleet_cold_import": lambda ev: (
        ev["stats"][1]["prefix_cache_imported_blocks"] > 0 and _notes(ev)["avoided"] > 0),
    "stream_ckpt_records": lambda ev: (
        ev["stats"][0]["stream_ckpt_resumes"] == 1
        and [r[0] for r in ev["records"]].count("del_stream_ckpt") == 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mocker_twin(case):
    jax_run, torch_run = (run_case(root, case) for root in PKGS)
    assert EXPECT[case](torch_run), {k: torch_run[k] for k in ("log", "stats")}
    for key in jax_run:
        assert torch_run[key] == jax_run[key], key


@pytest.mark.parametrize("env", ["DYN_SCHED_LEDGER", "DYN_MEM_LEDGER"])
def test_mocker_twin_ledger_gate_off(env, monkeypatch):
    """test_sched_obs.py / test_mem_obs.py::test_mocker_disabled_omits_stats_block:
    with a ledger's gate off, both packages leave its block out of the
    stats and record nothing."""
    monkeypatch.setenv(env, "0")
    jax_run, torch_run = (run_case(root, "sched_parity") for root in PKGS)
    block = {"DYN_SCHED_LEDGER": "sched", "DYN_MEM_LEDGER": "mem"}[env]
    assert all(block not in s for s in torch_run["stats"])
    assert torch_run == jax_run

