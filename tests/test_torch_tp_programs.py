"""Step programs at more than one rank: ``warmup_mode`` lazy and full at
dp x pp x sp x ep x tp > 1, every rank's programs in lockstep, and the one
function that decides where they are CUDA graphs
(``engine.step_graphs``), on the CPU (gloo, processes as ranks, eager
programs: the same program objects, warm runs and posts a card captures).

- The graphs decision over its whole table.
- Full warmup at tp=2 (tiny-llama at f32, a lattice of 12 buckets): every
  rank made the leader's programs in the leader's order, they are the
  lattice of the port's and of JAX's ``enumerate_buckets`` of the same
  config, the summary counts every bucket captured and none failed at
  coverage 1.0, serving makes no program, and the greedy streams equal
  JAX's tp=2 engine's and the port's ``warmup_mode="off"`` streams token
  for token (f32: exact, as tests/test_torch_tp.py holds them).
- A warm run that fails on the leader fails the build with a
  ``TPFailure`` naming the bucket and the rank; the follower exits.
- The leader's bounded wait for a step (``engine.tp.wait_event``) over an
  event that never completes: a dead follower fails it within 2 s, naming
  the rank; live followers and a 1 s group timeout fail it after the
  timeout. So does the wait for the followers' replies (``tp_stats``): a
  follower that hangs or exits fails it.
- A follower that exits while the async engine's step loop is held in a
  call that never returns (a wait on the card behind a collective whose
  peer is gone): the engine's rank watcher fails the open stream within
  2 s, naming the rank, and later requests at once.

The lazy engines at dp=2 x tp=2, pp=2, sp=2 and ep=2 are in
tests/test_torch_tp_programs_lazy.py.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import time
import types

import pytest

from dynamo_tpu.obs.compile_ledger import enumerate_buckets as j_enumerate
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine import tp as ttp
from dynamo_tpu_torch.obs.compile_ledger import enumerate_buckets, get_compile_ledger
from dynamo_tpu_torch.parallel.collectives import TPFailure, TPGroup
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _run
from tests.test_torch_tp import TINY32, _jax_streams, _reqs, tiny32  # noqa: F401
from tests.torch_tp_programs import one_thread  # noqa: F401

#: a 12-bucket lattice (decode rows 2 and 4, mixed chunks of 16 and 32, 4
#: blocks of 16 a row, greedy or not) that serves tests/test_torch_tp.py's
#: three prompts
SHAPE = dict(block_size=16, num_blocks=64, max_batch_size=4, max_model_len=64,
             prefill_chunk=32, decode_bucket=(2, 4))


# ---------------------------------------------------------------------------
# the graphs decision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,setting,graphs,reason", [
    ("cpu", dict(), False, "on the CPU"),
    ("cpu", dict(tp=2, dp=2), False, "on the CPU"),
    ("cpu", dict(tp=2, num_nodes=2), False, "on the CPU"),
    ("cuda", dict(), True, ""),
    ("cuda", dict(dist_backend="gloo"), True, ""),
    ("cuda", dict(tp=2), False, "14f"),
    ("cuda", dict(tp=2, dp=2), False, "14f"),
    ("cuda", dict(tp=2, num_nodes=2), False, "14f"),
    ("cuda", dict(tp=2, quantization="int8", kv_dtype="int4", decode_window=4), False, "14f"),
    ("cuda", dict(tp=2, dist_backend="gloo"), False, "gloo reduces through host memory"),
    ("cuda", dict(dp=2, dist_backend="gloo"), False, "gloo reduces through host memory"),
    ("cuda", dict(pp=2), False, "14g"),
    ("cuda", dict(sp=2), False, "14h"),
    ("cuda", dict(ep=2), False, "16c"),
    ("cuda", dict(tp=2, ep=2), False, "16c"),
], ids=["cpu", "cpu-dp2-tp2", "cpu-tp2-2nodes", "cuda", "cuda-gloo-1rank", "nccl-tp2",
        "nccl-dp2-tp2", "nccl-tp2-2nodes", "nccl-tp2-int8-int4-window", "gloo-tp2",
        "gloo-dp2", "nccl-pp2", "nccl-sp2", "nccl-ep2", "nccl-tp2-ep2"])
def test_step_graphs_decision(device, setting, graphs, reason):
    """One pure function of (config, device type): graphs on the card at
    one rank; eager on the CPU, over gloo, at pp, sp or ep > 1 and, until
    its two-card check passes, over nccl at any tp x dp (over several
    nodes too), each with its reason (pp, sp, ep and tp x dp name the
    ROADMAP items that would bring graphs there)."""
    got = teng.step_graphs(TEngineConfig(**{"dist_backend": "nccl", **setting}), device)
    assert got[0] is graphs and reason in got[1] and bool(got[1]) is not graphs


# ---------------------------------------------------------------------------
# full warmup at tp=2
# ---------------------------------------------------------------------------

def _key(sig) -> list:
    return [sig.b, sig.t, sig.nblk, 1, sig.greedy]


@pytest.fixture(scope="module")
def full_tp2(tiny32, one_thread):  # noqa: F811
    """A tp=2 engine after its full warmup, the ranks' stats before and
    after it served the three prompts, and its streams; then (one
    tensor-parallel engine a process) the same engine with warmup off and
    its streams."""
    jp, full = tiny32
    led = get_compile_ledger()
    led.reset()
    kw = dict(model=TINY32, **SHAPE)
    core = teng.EngineCore(TEngineConfig(**kw, tp=2, dist_backend="gloo", warmup_mode="full"),
                           params=full, device="cpu")
    try:
        out = {"summary": core.warmup(), "plan": list(led.plan), "coverage": led.coverage(),
               "warm_ranks": core.tp_stats()}
        out["streams"], out["fin"] = _run(core, _reqs(tproto), pipelined=True)
        out["ranks"] = core.tp_stats()
        out["ec"] = core.engine_cfg
    finally:
        core.close()
        led.reset()
    off = teng.EngineCore(TEngineConfig(**kw, tp=2, dist_backend="gloo", warmup_mode="off"),
                          params=full, device="cpu")
    try:
        out["off_streams"], _ = _run(off, _reqs(tproto), pipelined=True)
    finally:
        off.close()
    out["jax_streams"] = _jax_streams(jp, **kw, tp=2)
    yield out
    led.reset()
    led.configure("lazy")


def test_full_warmup_at_tp2_makes_the_lattice_on_every_rank(full_tp2):
    warm, ec = full_tp2["warm_ranks"], full_tp2["ec"]
    lattice = sorted(enumerate_buckets(ec), key=lambda s: (s.kind, s.b, s.t, s.nblk, s.greedy))
    assert len(lattice) <= 16
    jax_lattice = j_enumerate(JEngineConfig(model=TINY32, **SHAPE, tp=2))
    assert ([(s.kind, s.b, s.t, s.nblk, s.greedy, s.kv_dtype) for s in lattice]
            == sorted((s.kind, s.b, s.t, s.nblk, s.greedy, s.kv_dtype) for s in jax_lattice))
    leader = [k for k, _ in warm[0]["programs"]]
    assert leader == [_key(s) for s in lattice]
    assert [r["rank"] for r in warm] == [0, 1]
    for r in warm:
        assert [k for k, _ in r["programs"]] == leader
        assert r["graphs"] is False and "on the CPU" in r["graph_reason"]
    s = full_tp2["summary"]
    assert (s["captured"], s["cached"], s["failed"], s["deadline_skipped"]) == (len(lattice), 0,
                                                                               0, 0)
    assert s["coverage"] == 1.0 == full_tp2["coverage"] and s["buckets"] == len(lattice)
    assert s["graphs"] is False and "on the CPU" in s["graph_reason"]


def test_full_warmup_at_tp2_serves_without_making_a_program(full_tp2):
    before = [[k for k, _ in r["programs"]] for r in full_tp2["warm_ranks"]]
    after = full_tp2["ranks"]
    assert [[k for k, _ in r["programs"]] for r in after] == before
    calls = [[c for _, c in r["programs"]] for r in after]
    assert calls[0] == calls[1] and sum(calls[0]) > 0
    assert after[0]["forward_steps"] == after[1]["forward_steps"] > 0


def test_full_warmup_at_tp2_streams_equal_jax_tp2_and_warmup_off(full_tp2):
    got = full_tp2["streams"]
    assert full_tp2["fin"] == set(got) and all(got.values())
    assert got == full_tp2["jax_streams"]
    assert got == full_tp2["off_streams"]


# ---------------------------------------------------------------------------
# a failed warm run, and the bounded wait
# ---------------------------------------------------------------------------

def test_a_failed_warm_run_at_tp2_fails_the_build_naming_bucket_and_rank(tiny32,  # noqa: F811
                                                                        monkeypatch):
    """The leader's warm run of its third bucket raises: ``build_engine``
    fails with a ``TPFailure`` naming the bucket and rank 0, kills the
    follower (blocked in that bucket's first collective, which the leader
    never joins) and leaves the group, all well inside the group's 60 s
    timeout."""
    _, full = tiny32
    made, closed = [], []
    warm = teng.StepProgram._warm

    def failing_warm(prog):
        made.append(prog.shape)
        if len(made) == 3:
            raise RuntimeError("no memory for this bucket")
        warm(prog)

    abandon = teng.EngineCore.abandon

    def recording_abandon(core):
        if core._tp_followers is not None:
            closed.extend(core._tp_followers.procs)
        abandon(core)

    monkeypatch.setattr(teng.StepProgram, "_warm", failing_warm)
    monkeypatch.setattr(teng.EngineCore, "abandon", recording_abandon)
    t0 = time.monotonic()
    with pytest.raises(TPFailure, match=r"warmup of bucket BucketSig\(.*\) failed on rank 0 "
                                        r"\(the leader\): no memory for this bucket"):
        teng.build_engine(TEngineConfig(model=TINY32, **SHAPE, tp=2, dist_backend="gloo",
                                        warmup_mode="full"), params=full, device="cpu")
    assert len(closed) == 1 and not closed[0].is_alive() and closed[0].exitcode is not None
    assert time.monotonic() - t0 < 30
    get_compile_ledger().reset()


@pytest.mark.parametrize("backend,calls", [
    (None, ["abandon"]), ("gloo", ["abandon", "close"]), ("nccl", ["abandon"]),
], ids=["one-rank", "gloo", "nccl"])
def test_a_failed_build_leaves_the_group_over_gloo_only(backend, calls):
    """After a failed warmup ``build_engine`` abandons the engine (kills
    the followers, closes the op channel); it leaves the group over gloo,
    but not over nccl, whose leave would wait for the peers just killed."""
    seen: list[str] = []
    tp = None if backend is None else types.SimpleNamespace(
        backend=backend, close=lambda: seen.append("close"))
    core = types.SimpleNamespace(runner=types.SimpleNamespace(tp=tp),
                                 abandon=lambda: seen.append("abandon"))
    teng.abandon_build(core)
    assert seen == calls


class _NeverDone:
    """An event whose work never completes (a graph waiting on a peer)."""

    def query(self) -> bool:
        return False


def _followers(target, *args) -> ttp.TPFollowers:
    """A leader's handle on one follower process running ``target``
    (``None``: one that holds its end of the pipe and never answers)."""
    ctx = multiprocessing.get_context("spawn")
    f = ttp.TPFollowers.__new__(ttp.TPFollowers)
    ours, theirs = ctx.Pipe()
    if target is None:
        target, args = multiprocessing.connection.wait, ([theirs],)
    proc = ctx.Process(target=target, args=args, daemon=True)
    proc.start()
    theirs.close()
    f.procs, f.conns, f.remote, f._dir = [proc], [ours], {}, "/nonexistent"
    return f


def _group(followers: ttp.TPFollowers, timeout: float) -> TPGroup:
    return TPGroup(rank=0, size=2, device=None, backend="nccl", pg=None,
                   probe=followers.lost, timeout=timeout)


def test_the_wait_for_a_step_fails_at_once_when_a_follower_is_dead():
    f = _followers(os._exit, 3)
    f.procs[0].join(30)
    t0 = time.monotonic()
    with pytest.raises(TPFailure, match="follower rank 1 exited with exit code 3"):
        ttp.wait_event(_NeverDone(), _group(f, 60.0))
    assert time.monotonic() - t0 < 2.0
    f.conns[0].close()


def test_the_wait_for_a_step_fails_after_the_group_timeout_when_followers_live():
    f = _followers(time.sleep, 30)
    try:
        t0 = time.monotonic()
        with pytest.raises(TPFailure, match="timeout of 1 s, every follower alive"):
            ttp.wait_event(_NeverDone(), _group(f, 1.0))
        assert 1.0 <= time.monotonic() - t0 < 3.0
    finally:
        f.kill()


async def test_a_lost_follower_fails_the_streams_while_the_step_loop_is_held(tiny32):  # noqa: F811
    """Over nccl a step whose peer is gone never completes, and a call
    that waits for the card holds the engine's step loop for good. The
    engine's watcher still fails every open stream within 2 s of the
    follower's exit, naming the rank, and later requests at once."""
    import asyncio
    import threading

    _, full = tiny32
    core = teng.EngineCore(TEngineConfig(model=TINY32, **SHAPE, tp=2, dist_backend="gloo",
                                         warmup_mode="off"), params=full, device="cpu")
    engine = teng.AsyncTorchEngine(core)
    entered, hold = threading.Event(), threading.Event()

    def held_step():   # the step loop inside a call that never returns
        entered.set()
        hold.wait(60)

    core.step_begin = held_step
    try:
        stream = engine.generate(_reqs(tproto)[0])
        first = asyncio.ensure_future(stream.__anext__())
        await asyncio.get_running_loop().run_in_executor(None, entered.wait, 30)
        core._tp_followers.procs[0].kill()
        t0 = time.monotonic()
        out = await asyncio.wait_for(first, 10)
        assert time.monotonic() - t0 < 2.0
        assert out.finish_reason == tproto.FinishReason.ERROR
        assert "follower rank 1 exited with exit code" in out.error
        assert engine.down == out.error
        late = [o async for o in engine.generate(_reqs(tproto)[1])]
        assert [o.error for o in late] == [out.error]
    finally:
        hold.set()
        engine._thread.join(10)
        teng.abandon_build(core)   # followers killed, the gloo group left


@pytest.mark.parametrize("target,args,match", [
    (None, (), r"follower rank 1 sent no 'stats' reply within 1 s: it hangs"),
    (os._exit, (4,), r"follower rank 1 did not reply: .*exit code 4"),
], ids=["hangs", "dead"])
def test_the_wait_for_a_reply_is_bounded(target, args, match):
    """The leader's wait for its followers' replies (``tp_stats``) fails
    with ``TPFailure`` when a follower hangs past the timeout or exits,
    instead of waiting forever."""
    f = _followers(target, *args)
    try:
        t0 = time.monotonic()
        with pytest.raises(TPFailure, match=match):
            f.replies("stats", timeout=1.0)
        assert time.monotonic() - t0 < 3.0
    finally:
        f.kill()
