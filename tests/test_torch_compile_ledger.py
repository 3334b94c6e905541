"""The port's compile ledger and bucket warmup (``obs/compile_ledger.py``,
``ModelRunner.warmup``, ``StepProgram``).

The lattice must be JAX's: ``enumerate_buckets`` / ``sig_for_rows`` are
held against the JAX package's for several configs. The ledger's own
accounting twins tests/test_compile_obs.py. On the CPU a step program runs
its body eagerly, so full warmup there makes the same program objects and
warm runs a card would capture: serving after it makes none, and the warm
runs' padding writes touch only the trash block and the trash row.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dynamo_tpu.obs.compile_ledger import enumerate_buckets as j_enumerate
from dynamo_tpu.obs.compile_ledger import sig_for_rows as j_sig_for_rows
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.obs.compile_ledger import (
    WARMUP_MODES,
    BucketSig,
    CompileLedger,
    enumerate_buckets,
    get_compile_ledger,
    sig_for_rows,
)
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _req, _run


@pytest.fixture(autouse=True)
def clean_ledger():
    """Isolate the process-global ledger per test."""
    led = get_compile_ledger()
    led.reset()
    led.configure("lazy")
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the tiny model's warm runs are ms on one thread
    yield led
    torch.set_num_threads(n)
    led.reset()
    led.configure("lazy")


def sig(kind="decode", b=4, t=1, nblk=8, greedy=True, kv="bfloat16"):
    return BucketSig(kind, b, t, nblk, greedy, kv)


# ---------------------------------------------------------------------------
# The lattice is JAX's
# ---------------------------------------------------------------------------

#: the tiny config of tests/test_compile_obs.py, the defaults, the legacy
#: two-launch path, fused windows, and a quantized cache
LATTICE_CONFIGS = {
    "tiny": dict(model="tiny-llama", max_model_len=128, block_size=16, max_batch_size=4,
                 decode_bucket=(2, 4), prefill_chunk=32, num_blocks=64),
    "defaults": dict(),
    "legacy": dict(unified_step=False),
    "window4": dict(decode_window=4),
    "int4-window2-legacy": dict(kv_dtype="int4", decode_window=2, unified_step=False,
                                max_model_len=1000, block_size=8, max_batch_size=48,
                                prefill_chunk=100, max_tokens_per_step=64),
}


def _tuples(sigs):
    return [(s.kind, s.b, s.t, s.nblk, s.greedy, s.kv_dtype) for s in sigs]


@pytest.mark.parametrize("name", sorted(LATTICE_CONFIGS))
def test_enumerate_buckets_matches_jax(name):
    kw = LATTICE_CONFIGS[name]
    got = _tuples(enumerate_buckets(TEngineConfig(**kw)))
    assert got == _tuples(j_enumerate(JEngineConfig(**kw)))
    assert len(got) == len(set(got)) > 0


@pytest.mark.parametrize("name", sorted(LATTICE_CONFIGS))
def test_sig_for_rows_matches_jax_and_lands_in_the_lattice(name):
    kw = LATTICE_CONFIGS[name]
    tec, jec = TEngineConfig(**kw), JEngineConfig(**kw)
    plan = set(enumerate_buckets(tec))
    unified = tec.unified_step and tec.decode_window == 1
    t_cap = min(tec.prefill_chunk, tec.max_model_len, tec.max_tokens_per_step)
    kinds = ["decode", "prefill", "mixed"] + (["window"] if tec.decode_window > 1 else [])
    for kind in kinds:
        for n in sorted({1, 2, 3, 5, tec.max_batch_size}):
            for t_max in (1, 7, 16, 33, tec.prefill_chunk):
                for need in (1, 3, 5, 9, 40, 10_000):
                    for greedy in (True, False):
                        got = sig_for_rows(kind, n, t_max, need, tec, greedy)
                        assert _tuples([got]) == _tuples(
                            [j_sig_for_rows(kind, n, t_max, need, jec, greedy)])
                        # what the engine can dispatch is in the plan
                        reachable = (n <= tec.max_batch_size and t_max <= t_cap
                                     and (kind in ("decode", "window")
                                          or kind == "mixed" and unified
                                          or kind == "prefill" and not unified and n <= 8))
                        if reachable:
                            assert got in plan, got


def test_window_lattice_counts():
    """decode_window=4 adds a window rung per decode rung and keeps the
    legacy prefill rungs: the tiny config's 24 (8 decode + 16 mixed) → 8
    decode + 8 window + 24 prefill (b in 1, 2, 4)."""
    kw = LATTICE_CONFIGS["tiny"]
    base = enumerate_buckets(TEngineConfig(**kw))
    win = enumerate_buckets(TEngineConfig(**kw, decode_window=4))
    count = lambda sigs, k: sum(s.kind == k for s in sigs)  # noqa: E731
    assert (len(base), count(base, "mixed")) == (24, 16)
    assert [count(win, k) for k in ("decode", "window", "prefill", "mixed")] == [8, 8, 24, 0]


# ---------------------------------------------------------------------------
# Ledger accounting (twins of tests/test_compile_obs.py)
# ---------------------------------------------------------------------------

def test_event_schema(clean_ledger):
    led = clean_ledger
    ev = led.record(sig(kind="prefill", t=64), 1.25, ts=1000.0)
    d = ev.to_dict()
    assert (d["kind"], d["b"], d["t"], d["nblk"], d["greedy"]) == ("prefill", 4, 64, 8, True)
    assert d["kv_dtype"] == "bfloat16" and d["source"] == "serve"
    assert d["seconds"] == 1.25 and d["ts"] == pytest.approx(1000.0 - 1.25)
    assert "trace_id" not in d
    assert led.inventory == {sig(kind="prefill", t=64)}
    assert led.record(sig(), 0.5, source="warmup").to_dict()["source"] == "warmup"


def test_disabled_mode_records_nothing(clean_ledger):
    led = clean_ledger
    led.configure("off")
    assert led.enabled is False
    assert led.record(sig(), 1.0) is None
    assert led.events == [] and led.inventory == set()
    with pytest.raises(ValueError):
        led.configure("sometimes")
    assert set(WARMUP_MODES) == {"off", "lazy", "full"}


def test_event_cap_keeps_counters_exact():
    led = CompileLedger(cap=3)
    for i in range(5):
        led.record(sig(nblk=4 * (i + 1)), 0.1)
    assert len(led.events) == 3
    snap = led.snapshot()
    assert snap["events_total"] == 5 and snap["cache_entries"] == 5


def test_coverage_math_and_snapshot(clean_ledger):
    led = clean_ledger
    assert led.coverage() == 0.0
    plan = [sig(nblk=n) for n in (4, 8, 16, 32)]
    led.set_plan(plan)
    assert led.coverage() == 0.0
    led.record(plan[0], 0.2, source="warmup")
    led.record(plan[1], 0.3)
    led.record(sig(kind="mixed", t=64), 0.4)  # off-plan: no coverage credit
    assert led.coverage() == pytest.approx(0.5)
    snap = led.snapshot(events=True)
    assert snap["mode"] == "lazy" and snap["enabled"] is True
    assert snap["cache_entries"] == 3 and snap["events_total"] == 3
    assert snap["warmup_buckets"] == 4 and snap["warmup_coverage"] == pytest.approx(0.5)
    assert snap["compile_seconds_total"] == pytest.approx(0.9)
    assert snap["serve_stall_seconds"] == pytest.approx(0.7)  # warmup excluded
    assert [e["source"] for e in snap["events"]] == ["warmup", "serve", "serve"]


def test_by_bucket_totals(clean_ledger):
    led = clean_ledger
    led.record(sig(), 1.0)
    led.record(sig(), 0.5)
    led.record(sig(kind="prefill", t=16), 2.0)
    bb = led.by_bucket()
    assert bb[sig()] == (2, 1.5)
    assert bb[sig(kind="prefill", t=16)] == (1, 2.0)


# ---------------------------------------------------------------------------
# Warmup on the engine (CPU: the body runs eagerly)
# ---------------------------------------------------------------------------

def _tiny(**kw) -> TEngineConfig:
    d = dict(model="tiny-llama", block_size=4, num_blocks=32, max_batch_size=4,
             max_model_len=32, prefill_chunk=16, decode_bucket=(2, 4))
    d.update(kw)
    return TEngineConfig(**d)


def _mixed_traffic():
    """Greedy and sampled streams of ragged prompts, arriving apart."""
    return [_req(tproto, [3 * i + j for j in range(3 + 4 * i)], f"r{i}", 5 + i,
                 **({"temperature": 0.7, "seed": i} if i % 2 else {}))
            for i in range(3)]


@pytest.mark.parametrize("kw", [{}, {"decode_window": 2}], ids=["unified", "window2"])
def test_full_warmup_then_serving_makes_no_program(clean_ledger, kw):
    core = teng.EngineCore(_tiny(warmup_mode="full", **kw), device="cpu")
    summary = core.warmup()
    led = clean_ledger
    plan = set(enumerate_buckets(core.engine_cfg))
    assert summary["buckets"] == len(plan) == summary["captured"]
    assert (summary["failed"], summary["deadline_skipped"], summary["coverage"]) == (0, 0, 1.0)
    assert led.inventory == plan
    assert all(e.source == "warmup" for e in led.events)
    made = dict(core.runner.programs)
    got, fin = _run(core, _mixed_traffic(), pipelined=True)
    assert fin == set(got)
    assert core.runner.programs == made      # the very same objects, none new
    assert all(e.source == "warmup" for e in led.events)
    # streams equal a lazy engine's
    lazy, _ = _run(teng.EngineCore(_tiny(**kw), device="cpu"), _mixed_traffic())
    assert got == lazy


def test_lazy_mode_records_serve_captures_and_off_records_none(clean_ledger):
    core = teng.EngineCore(_tiny(), device="cpu")
    assert core.warmup() == {"mode": "lazy", "coverage": 0.0,
                             "buckets": len(enumerate_buckets(core.engine_cfg))}
    _run(core, _mixed_traffic())
    led = clean_ledger
    assert led.events and all(e.source == "serve" for e in led.events)
    assert len(led.inventory) == len(core.runner.programs)
    assert 0.0 < led.coverage() < 1.0
    led.reset()
    off = teng.EngineCore(_tiny(warmup_mode="off"), device="cpu")
    assert off.warmup() == {"mode": "off", "coverage": 0.0}
    _run(off, _mixed_traffic())
    assert led.events == [] and led.plan is None and off.runner.programs


def test_warmup_deadline_skips_and_counts_against_coverage(clean_ledger):
    core = teng.EngineCore(_tiny(warmup_mode="full", warmup_deadline=1e-9), device="cpu")
    s = core.warmup()
    assert s["captured"] <= 1 and s["captured"] + s["deadline_skipped"] == s["buckets"]
    assert s["coverage"] == pytest.approx(s["captured"] / s["buckets"])


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_warmup_padding_touches_only_trash_block_and_row(kv_dtype):
    """The warm runs (q_len 0 rows, do_sample off, block tables of zeros)
    leave every cache block but block 0, and every real slot's counts,
    draws and slot_toks, as they were — the padding safety that running
    and capturing a bucket before serving relies on."""
    core = teng.EngineCore(_tiny(kv_dtype=kv_dtype, warmup_mode="full", decode_window=2),
                           device="cpu")
    r = core.runner
    gen = torch.Generator().manual_seed(0)

    def fill(x):
        if x.dtype.is_floating_point:
            x.copy_(torch.rand(x.shape, generator=gen).to(x.dtype))
        else:
            x.copy_(torch.randint(0, 100, x.shape, generator=gen).to(x.dtype))

    caches = [c for cc in (r.cache_k, r.cache_v)
              for c in (cc.values() if isinstance(cc, dict) else [cc])]
    for x in [*caches, r.counts, r.draws, r.slot_toks, r.seeds]:
        fill(x)
    before = [x.clone() for x in [*caches, r.counts, r.draws, r.slot_toks, r.seeds]]
    assert core.warmup()["failed"] == 0 and r.programs
    after = [*caches, r.counts, r.draws, r.slot_toks, r.seeds]
    maxb = core.engine_cfg.max_batch_size
    for i, (b, a) in enumerate(zip(before, after)):
        if i < len(caches):           # [L, NB, ...]: blocks 1.. untouched
            torch.testing.assert_close(a[:, 1:], b[:, 1:], rtol=0, atol=0)
        else:                         # [maxb + 1, ...]: real slots untouched
            torch.testing.assert_close(a[:maxb], b[:maxb], rtol=0, atol=0)
    assert not all(torch.equal(b, a) for b, a in zip(before, after)), \
        "the warm runs wrote nothing at all"


# ---------------------------------------------------------------------------
# Launch counts through replays
# ---------------------------------------------------------------------------

class _StubProgram(teng.StepProgram):
    """A step program whose warm run, capture and replay stand in for the
    card's: the warm run and the capture each 'launch' the route's kernel
    once per layer (as the Python wrapper counts), a replay runs no
    Python at all."""

    LAYERS = 8

    def _launch(self):
        for _ in range(self.LAYERS * self.shape[3]):
            pa.paged_attention.launches_by_kernel["mma_bf16"] += 1

    def _warm(self):
        self._launch()

    def _capture(self):
        self._launch()

    def _replay(self):
        b, _t, _nblk, w, _ = self.shape
        shape = (b,) if w == 1 else (b, w)
        return torch.zeros(shape, dtype=torch.int32), torch.zeros(shape)


@pytest.mark.parametrize("window", [1, 4])
def test_replays_count_the_captured_launches(window):
    runner = teng.EngineCore(_tiny(), device="cpu").runner
    pa.reset_launches()
    pa.paged_attention.launches_by_kernel["mma_f32"] = 5   # earlier, eager
    prog = _StubProgram(runner, 4, 1, 4, window, True)
    # the warm run's and the capture's launches are not counted
    assert pa.paged_attention.launches_by_kernel == {
        k: 5 if k == "mma_f32" else 0 for k in pa.ROUTE_KERNELS}
    assert prog.launches == {k: 8 * window if k == "mma_bf16" else 0
                             for k in pa.ROUTE_KERNELS}
    ints = np.zeros(prog.ints.numel(), np.int32)
    floats = np.zeros((5, 4), np.float32)
    for _ in range(3):
        toks, _ = prog(ints, floats).materialize()
    assert toks.shape == ((4,) if window == 1 else (4, window))
    assert pa.paged_attention.launches_by_kernel["mma_bf16"] == 3 * 8 * window
    pa.reset_launches()                 # keeps its meaning: every count to 0
    prog(ints, floats)
    assert pa.paged_attention.launches_by_kernel["mma_bf16"] == 8 * window
    assert sum(pa.paged_attention.launches_by_kernel.values()) == 8 * window
    pa.reset_launches()


def test_launches_made_restores_counts_on_error():
    pa.reset_launches()
    pa.paged_attention.launches_by_kernel["mma_int8"] = 2
    with pytest.raises(RuntimeError):
        with pa.launches_made() as made:
            pa.paged_attention.launches_by_kernel["mma_int8"] += 7
            raise RuntimeError("capture failed")
    assert made["mma_int8"] == 7
    assert pa.paged_attention.launches_by_kernel["mma_int8"] == 2
    pa.reset_launches()
