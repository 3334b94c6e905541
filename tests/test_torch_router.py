"""The port's KV-aware router against the JAX package's (its Python
``RadixIndexer``), and the port engine's KV events against the JAX
engine's.

- The cases of tests/test_router.py run on the port's classes (re-bound).
- Seeded random event streams, load metrics and requests go into both
  packages' ``KvRouter``: equal overlap scores, ``ActiveSequences``
  predictions and chosen workers at temperature 0, the approximate
  indexer's TTL included; at temperature > 0 both softmax draws pick the
  same worker for every point of the unit interval (equal probabilities),
  each package with its own seeded generator.
- The synced-sequences mirror works between a port replica and a JAX one.
- On tests/data/tiny-real-llama at f32 on the CPU, the port's engine emits
  the JAX engine's ``BlockStored`` / ``BlockRemoved`` sequence (hashes and
  parents) for the same requests, through evictions and a host tier.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import random
import types
from pathlib import Path

import pytest

import dynamo_tpu.router.events as jev
import dynamo_tpu.router.indexer as jidx
import dynamo_tpu.router.kv_router as jkv
import dynamo_tpu.router.scheduler as jsch
import dynamo_tpu.router.sequence as jseq
import dynamo_tpu.tokens as jtok
import dynamo_tpu_torch.router.events as tev
import dynamo_tpu_torch.router.indexer as tidx
import dynamo_tpu_torch.router.kv_router as tkv
import dynamo_tpu_torch.router.scheduler as tsch
import dynamo_tpu_torch.router.sequence as tseq
import dynamo_tpu_torch.tokens as ttok
from tests import test_router as jax_router_tests
from tests.test_torch_runtime import rebind

PKG = {
    "jax": types.SimpleNamespace(ev=jev, idx=jidx, kv=jkv, sch=jsch, seq=jseq, tok=jtok),
    "torch": types.SimpleNamespace(ev=tev, idx=tidx, kv=tkv, sch=tsch, seq=tseq, tok=ttok),
}


# the synced mirror has a cross-package twin below
ROUTER_CASES = [n for n in dir(jax_router_tests) if n.startswith("test_")
                and n != "test_synced_active_sequences_mirrors_across_replicas"]


@pytest.mark.parametrize("case", ROUTER_CASES)
def test_router_twin(case):
    names = {"BlockRemoved": tev.BlockRemoved, "BlockStored": tev.BlockStored,
             "RouterEvent": tev.RouterEvent, "ApproxKvIndexer": tidx.ApproxKvIndexer,
             "RadixIndexer": tidx.RadixIndexer, "KvRouter": tkv.KvRouter,
             "KvRouterConfig": tkv.KvRouterConfig,
             "DefaultWorkerSelector": tsch.DefaultWorkerSelector,
             "KvScheduler": tsch.KvScheduler, "WorkerLoad": tsch.WorkerLoad,
             "softmax_sample": tsch.softmax_sample,
             "ActiveSequences": tseq.ActiveSequences,
             "compute_block_hashes_for_tokens": ttok.compute_block_hashes_for_tokens}
    names["stored"] = rebind(jax_router_tests.stored, **names)
    names["removed"] = rebind(jax_router_tests.removed, **names)
    rebind(getattr(jax_router_tests, case), **names)()


# ---------------------------------------------------------------------------
# differential: random streams into both routers
# ---------------------------------------------------------------------------

BS = 4


def random_trace(seed: int, n_ops: int = 300) -> list[tuple]:
    """A seeded script of router operations over 4 workers: KV events built
    from real prompts' chained hashes (with parents), removals, load
    metrics, routing decisions, completions and worker removals."""
    rng = random.Random(seed)
    prefixes = [[rng.randrange(1000) for _ in range(rng.randrange(4, 24))] for _ in range(6)]
    workers = [11, 22, 33, 44]
    ops: list[tuple] = []
    live: list[str] = []
    for i in range(n_ops):
        r = rng.random()
        toks = rng.choice(prefixes) + [rng.randrange(1000) for _ in range(rng.randrange(0, 12))]
        if r < 0.35:
            w = rng.choice(workers)
            hashes = jtok.compute_block_hashes_for_tokens(toks, BS)
            if hashes:
                k = rng.randrange(len(hashes))
                j = rng.randrange(k, len(hashes)) + 1
                ops.append(("stored", w, hashes[k:j], hashes[k - 1] if k else None))
        elif r < 0.45:
            w = rng.choice(workers)
            hashes = jtok.compute_block_hashes_for_tokens(toks, BS)
            if hashes:
                ops.append(("removed", w, [rng.choice(hashes)]))
        elif r < 0.55:
            w = rng.choice(workers)
            ops.append(("metrics", {"worker_id": w, "num_waiting": rng.randrange(3),
                                    "kv_total_blocks": 64, "ready": rng.random() > 0.1}))
        elif r < 0.9:
            rid = f"req{i}"
            pool = rng.sample(workers, rng.randrange(1, len(workers) + 1))
            ops.append(("route", rid, toks, sorted(pool)))
            live.append(rid)
        elif r < 0.98 and live:
            ops.append(("complete", live.pop(rng.randrange(len(live)))))
        else:
            ops.append(("remove_worker", rng.choice(workers)))
    return ops


def replay(pkg: str, ops: list[tuple], approx: bool) -> list:
    m = PKG[pkg]
    router = m.kv.KvRouter(m.kv.KvRouterConfig(block_size=BS, use_approx_indexer=approx))
    obs: list = []
    for op in ops:
        kind = op[0]
        if kind == "stored":
            router.apply_events([m.ev.RouterEvent(worker_id=op[1], event=m.ev.BlockStored(
                block_hashes=tuple(op[2]), parent_hash=op[3]))])
        elif kind == "removed":
            router.apply_events([m.ev.RouterEvent(worker_id=op[1], event=m.ev.BlockRemoved(
                block_hashes=tuple(op[2])))])
        elif kind == "metrics":
            router.update_metrics(dict(op[1]))
        elif kind == "route":
            _, rid, toks, pool = op
            hashes = m.tok.compute_block_hashes_for_tokens(toks, BS)
            scores = router.indexer.find_matches(hashes)
            if approx:
                # one clock for both packages: the TTL is read at a fixed time
                router.approx.find_matches(hashes, now=0.0)
            obs.append(("scores", dict(scores.scores), scores.total_blocks))
            wid, overlap = router.find_best_match(rid, toks, worker_ids=pool)
            obs.append(("route", rid, wid, overlap,
                        {w: router.active.active_blocks(w) for w in pool},
                        {w: router.active.request_count(w) for w in pool}))
        elif kind == "complete":
            router.complete(op[1])
            obs.append(("active", router.active.snapshot()))
        elif kind == "remove_worker":
            router.remove_worker(op[1])
            obs.append(("blocks", router.indexer.block_count(),
                        router.indexer.worker_block_count(op[1])))
    return obs


@pytest.mark.parametrize("approx", [False, True], ids=["radix", "approx"])
@pytest.mark.parametrize("seed", range(4))
def test_router_decisions_equal_jax(seed, approx):
    ops = random_trace(seed)
    got, ref = replay("torch", ops, approx), replay("jax", ops, approx)
    assert got == ref
    assert sum(1 for o in got if o[0] == "route") > 50


@pytest.mark.parametrize("seed", range(3))
def test_approx_ttl_equal_jax(seed):
    """The approximate indexer under an explicit clock: routed chains,
    their expiry at the TTL and re-routing, scored alike."""
    out = {}
    for pkg in ("jax", "torch"):
        ax = PKG[pkg].idx.ApproxKvIndexer(ttl_s=10.0)
        r2 = random.Random(seed)
        seen = []
        for step in range(200):
            h = [r2.randrange(50) for _ in range(r2.randrange(1, 6))]
            now = step * 0.5
            if r2.random() < 0.5:
                ax.note_routed(h, worker_id=r2.randrange(3), now=now)
            s = ax.find_matches(h, now=now + r2.random() * 12)
            seen.append((dict(s.scores), s.total_blocks, s.chain_depth))
        out[pkg] = seen
    assert out["torch"] == out["jax"]
    assert any(s[0] for s in out["torch"]) and not all(s[0] for s in out["torch"])


class _FinishedStreams:
    """A client whose every stream is two items, the second the last."""

    def __init__(self, workers: list[int]):
        self.workers = workers

    def instance_ids(self) -> list[int]:
        return list(self.workers)

    async def generate_direct(self, payload, worker_id, request_id):
        yield {"token_ids": [7]}
        yield {"token_ids": [8], "finish_reason": "length"}


async def _sequential_prefix(pkg: str) -> list[tuple]:
    """Two requests of one 40-token prompt through ``KvPushRouter`` over
    workers 11 and 22, the prompt's blocks indexed on 11; each stream is
    read up to its last item and left open, as frontend/migration.py
    leaves its inner stream when it returns. Per request: the decision
    (worker, overlap) and 11's active blocks after the last item."""
    m = PKG[pkg]
    push = m.kv.KvPushRouter(_FinishedStreams([11, 22]), m.kv.KvRouterConfig(block_size=BS))
    toks = list(range(100, 140))
    push.router.apply_events([m.ev.RouterEvent(worker_id=11, event=m.ev.BlockStored(
        block_hashes=tuple(m.tok.compute_block_hashes_for_tokens(toks, BS)), parent_hash=None))])
    decisions = []
    decide = push.router.find_best_match

    def recorded(*a, **kw):
        decisions.append(decide(*a, **kw))
        return decisions[-1]

    push.router.find_best_match = recorded
    seen, open_streams = [], []
    for i in range(2):
        stream = push.generate({"token_ids": toks, "request_id": f"r{i}",
                                "stop_conditions": {"max_tokens": 2}})
        open_streams.append(stream)
        async for item in stream:
            if item.get("finish_reason"):
                break
        seen.append((decisions[-1], push.router.active.active_blocks(11)))
    for stream in open_streams:
        await stream.aclose()
    return seen


async def test_push_router_frees_a_finished_stream_at_its_last_item():
    """The port's router frees a request's load prediction at its stream's
    last item, so a client's next request of the same prefix goes to the
    prefix's worker even while the finished stream's generator is still
    open. The JAX router frees it only when the generator closes: its
    second decision counts the finished request's 11 blocks against the
    prefix's worker and sends the request to the other (ROADMAP, "Gaps in
    the reference"). The first decisions, on equal state, are equal."""
    got = await _sequential_prefix("torch")
    ref = await _sequential_prefix("jax")
    assert got[0] == ref[0][:1] + (0,) and ref[0] == ((11, 10), 11)
    assert got[1] == ((11, 10), 0)
    assert ref[1][0] == (22, 0)


def test_a_purged_workers_late_metrics_do_not_stay():
    """A worker's last load metrics, published just before it left, can
    reach the router after its instance was purged: the next pass drops
    them again, while a worker that comes back keeps its new metrics."""
    push = tkv.KvPushRouter(_FinishedStreams([11, 22]), tkv.KvRouterConfig(block_size=BS))
    for wid in (11, 22):
        push.router.update_metrics({"worker_id": wid, "num_running": 1})
    push._purge_dead({11, 22})
    push._purge_dead({11})
    assert set(push.router.worker_metrics) == {11}
    push.router.update_metrics({"worker_id": 22, "num_running": 1})   # late
    push._purge_dead({11})
    assert set(push.router.worker_metrics) == {11}
    push._purge_dead({11, 22})                                        # back
    push.router.update_metrics({"worker_id": 22, "num_running": 0})
    push._purge_dead({11, 22})
    assert push.router.worker_metrics[22] == {"worker_id": 22, "num_running": 0}


@pytest.mark.parametrize("temperature", [0.5, 2.0, 7.5])
def test_softmax_probabilities_equal_jax(temperature):
    """At temperature > 0 each package draws from its own seeded generator;
    the distributions are equal: with the draw fixed at each of 1000 points
    of [0, 1), both pick the same worker."""
    rng = random.Random(3)
    for _ in range(20):
        costs = {w: rng.uniform(0, 20) for w in rng.sample(range(100), rng.randrange(2, 6))}
        for i in range(1000):
            point = types.SimpleNamespace(random=lambda i=i: i / 1000)
            assert (tsch.softmax_sample(costs, temperature, point)
                    == jsch.softmax_sample(costs, temperature, point))
    # each selector's own generator is seeded alike
    assert (tsch.DefaultWorkerSelector(temperature=1.0).rng.random()
            == jsch.DefaultWorkerSelector(temperature=1.0).rng.random())


async def test_synced_sequences_mirror_across_packages():
    """A port replica and a JAX replica of SyncedActiveSequences on one
    coordinator (the port's): a dispatch recorded on either becomes visible
    in the other's prediction, and a free on either clears both."""
    from dynamo_tpu.transports.client import CoordinatorClient as JClient
    from dynamo_tpu_torch.transports.client import CoordinatorClient as TClient
    from dynamo_tpu_torch.transports.coordinator import CoordinatorServer

    server = CoordinatorServer()
    await server.start()
    ca, cb = await TClient.connect(server.url), await JClient.connect(server.url)
    subj = tseq.active_seq_subject("test", "backend")
    assert subj == jseq.active_seq_subject("test", "backend")
    a, b = tseq.SyncedActiveSequences(ca, subj), jseq.SyncedActiveSequences(cb, subj)
    await a.start()
    await b.start()

    async def until(fn, want):
        for _ in range(100):
            if fn() == want:
                return
            await asyncio.sleep(0.02)
        assert fn() == want

    try:
        a.add_request("r1", 7, prefill_blocks=5, overlap_blocks=2)
        assert a.active_blocks(7) == 7
        await until(lambda: b.active_blocks(7), 7)
        assert b.request_count(7) == 1
        b.add_request("r2", 8, prefill_blocks=3, overlap_blocks=0)
        await until(lambda: a.active_blocks(8), 3)
        a.mark_prefill_complete("r2")
        b.note_decode_progress("r1", 2)
        await until(lambda: (a.active_blocks(7), b.active_blocks(8)),
                    (b.active_blocks(7), a.active_blocks(8)))
        b.free("r1")
        a.free("r2")
        await until(lambda: (a.active_blocks(7), a.active_blocks(8),
                             b.active_blocks(7), b.active_blocks(8)), (0, 0, 0, 0))
    finally:
        await a.close()
        await b.close()
        with contextlib.suppress(Exception):
            await ca.close()
            await cb.close()
        await server.stop()


# ---------------------------------------------------------------------------
# the engine's KV events
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "tests" / "data" / "tiny-real-llama"
REAL32 = "tiny-real-llama-f32-events"


@pytest.fixture(scope="module")
def real32():
    from dynamo_tpu.models import loader as jloader
    from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
    from dynamo_tpu.models.config import ModelConfig as JModelConfig
    from dynamo_tpu_torch.models import loader as tloader
    from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
    from tests.test_torch_engine import _tcfg

    jcfg = dataclasses.replace(JModelConfig.from_hf_config(str(CKPT)),
                               dtype="float32", name=REAL32)
    JAX_PRESETS[REAL32] = jcfg
    TORCH_PRESETS[REAL32] = _tcfg(jcfg)
    yield (jloader.load_params(jcfg, CKPT),
           tloader.load_params(TORCH_PRESETS[REAL32], CKPT, device="cpu"))
    del JAX_PRESETS[REAL32], TORCH_PRESETS[REAL32]


def _event(ev) -> tuple:
    d = ev.to_dict()
    return (d["type"], tuple(d["block_hashes"]), d.get("parent_hash"))


def _events(pkg: str, params, cfg_kw: dict, waves: list[list[list[int]]]):
    """Serve each wave of prompts to completion on one engine of ``pkg``;
    returns (events, streams)."""
    from tests.test_torch_engine import _req, _run

    events: list = []
    if pkg == "jax":
        from dynamo_tpu.engine import engine as eng
        from dynamo_tpu.protocols import common as proto
        from dynamo_tpu.utils.config import EngineConfig
        core = eng.EngineCore(EngineConfig(**cfg_kw), params=params, event_sink=events.append)
    else:
        from dynamo_tpu_torch.engine import engine as eng
        from dynamo_tpu_torch.protocols import common as proto
        from dynamo_tpu_torch.utils.config import EngineConfig
        core = eng.EngineCore(EngineConfig(**cfg_kw), params=params, device="cpu",
                              event_sink=events.append)
    streams = []
    for w, prompts in enumerate(waves):
        reqs = [_req(proto, p, f"w{w}r{i}", 6) for i, p in enumerate(prompts)]
        got, _ = _run(core, reqs)
        streams.append(got)
    return [_event(e) for e in events], streams


def _waves(seed: int, n_waves: int, per_wave: int, shared: int) -> list[list[list[int]]]:
    rng = random.Random(seed)
    base = [rng.randrange(3, 290) for _ in range(shared)]
    return [[base[:rng.randrange(4, shared + 1)] + [rng.randrange(3, 290) for _ in range(
        rng.randrange(1, 14))] for _ in range(per_wave)] for _ in range(n_waves)]


EVENT_CASES = {
    # plenty of blocks: stored events only, shared prefixes deduplicated
    "stored": (dict(num_blocks=128), _waves(0, 2, 4, 16)),
    # a pool of 24 blocks: later waves evict the earlier waves' blocks
    "evicting": (dict(num_blocks=24), _waves(1, 4, 3, 20)),
    # evicted blocks go to a host tier and come back onboarded
    "host_tier": (dict(num_blocks=24, host_kv_blocks=64),
                  _waves(2, 2, 3, 20) + _waves(2, 2, 3, 20)),
}


@pytest.mark.parametrize("case", list(EVENT_CASES))
def test_engine_kv_events_equal_jax(real32, case):
    extra, waves = EVENT_CASES[case]
    kw = dict(model=REAL32, block_size=4, max_batch_size=4, max_model_len=128,
              prefill_chunk=32, decode_bucket=(4,), **extra)
    jev_, jstreams = _events("jax", real32[0], kw, waves)
    tev_, tstreams = _events("torch", real32[1], kw, waves)
    assert tstreams == jstreams
    assert tev_ == jev_
    kinds = {e[0] for e in tev_}
    assert "stored" in kinds
    if case != "stored":
        assert "removed" in kinds
    # parents chain: every stored block after a prompt's first names one
    assert any(e[2] is not None for e in tev_ if e[0] == "stored")
