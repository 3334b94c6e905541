"""The port's session retention against the JAX package's, on the CPU
(tiny-llama at f32 with bridged weights): the ``SessionStore`` pin
lifecycle over a raw pool, and the engine cases of ``tests/test_session.py``
— turn 2 prefills only its suffix and equals a cold recompute, TTL expiry
releases the pins, a cancelled stream is not retained, a demoted session
is re-imported from the host tier after device eviction, and an evacuated
session resumes from the remote store on another engine. Prefill token
counts, avoided tokens, streams, free blocks and the memory ledger's
``session`` pins must equal JAX's.
"""

from __future__ import annotations

import time

import pytest

from dynamo_tpu.engine import prefix_pool as jpp
from dynamo_tpu.engine import session as jses
from dynamo_tpu.kvbm import remote as jremote
from dynamo_tpu.obs import mem_ledger as jml
from dynamo_tpu_torch.engine import prefix_pool as tpp
from dynamo_tpu_torch.engine import session as tses
from dynamo_tpu_torch.kvbm import remote as tremote
from dynamo_tpu_torch.obs import mem_ledger as tml

from tests.test_torch_kvbm import cores, proto_of, req, run, tiny32  # noqa: F401
from tests.test_torch_kvbm_remote import StoreFixture

BS = 4


def _chain(pool, n: int, base: int = 100):
    bids = pool.allocate(n)
    hashes, parent = [], None
    for i, bid in enumerate(bids):
        pool.commit(bid, base + i, parent)
        parent = base + i
        hashes.append(parent)
    return bids, hashes


def _store_script(pp, ses) -> list:
    """tests/test_session.py's SessionStore cases, recorded."""
    out = []
    pool = pp.PrefixPool(num_blocks=16, block_size=BS)
    free0 = pool.num_free
    store = ses.SessionStore(pool, ttl=60.0)
    bids, hashes = _chain(pool, 3)
    entry = store.retain("s1", hashes, now=0.0)
    pool.release(bids)
    out += [entry.pinned, pool.num_free - free0, store.pinned_blocks, store.snapshot()]
    out += [store.claim("s1", now=1.0).tokens, len(store), pool.num_free - free0,
            pool.match_prefix(hashes)]
    pool.release(bids)
    pool = pp.PrefixPool(num_blocks=32, block_size=BS)
    store = ses.SessionStore(pool, ttl=10.0, max_sessions=2)
    for i, sid in enumerate(("a", "b", "c")):
        store.retain(sid, _chain(pool, 2, base=100 * (i + 1))[1], now=float(i))
    sid, entry = store.pop_oldest()
    pool.release(entry.pinned)
    expired = store.pop_expired(now=11.5)
    for _, e in expired:
        pool.release(e.pinned)
    out += [sid, [s for s, _ in expired], store.session_ids(), store.snapshot(),
            store.release_all(), len(store),
            ses.SessionStore(pp.PrefixPool(num_blocks=8, block_size=BS),
                             ttl=60.0).retain("s", [], now=0.0)]
    return out


def test_session_store_matches_jax():
    assert _store_script(tpp, tses) == _store_script(jpp, jses)
    assert tses.session_id_from({"x-session-id": " h "}, {"session_id": "b"}) == "h"
    assert tses.session_id_of({tses.SESSION_KEY: "s1"}) == "s1"
    assert tses.session_id_of({tses.SESSION_KEY: ""}) is None


def _gen(core, toks, rid, session_id=None, max_tokens=4) -> list[int]:
    ann = {"session.id": session_id} if session_id else {}
    return run(core, [req(proto_of(core), toks, rid, max_tokens, annotations=ann)])[rid]


def _metrics(core):
    return (tses if proto_of(core).__name__.startswith("dynamo_tpu_torch") else
            jses).get_session_metrics()


def _ledger(core):
    torch_side = proto_of(core).__name__.startswith("dynamo_tpu_torch")
    return (tml if torch_side else jml).get_mem_ledger()


def _turn2(core, cold) -> dict:
    sm = _metrics(core)
    base = {k: getattr(sm, k).get() for k in ("avoided_tokens", "hits", "lookups")}
    free0 = core.pool.num_free
    p1 = list(range(1, 17))
    out1 = _gen(core, p1, "t1", "s1")
    snap = core.sessions.snapshot()
    pins = _ledger(core).owner_blocks()["session"]
    pre = core.metrics.num_prefill_tokens
    p2 = p1 + out1 + [3, 1, 4, 1, 5, 9, 2, 6]
    out2 = _gen(core, p2, "t2", "s1")
    res = {"out1": out1, "snap": snap, "pins": pins, "out2": out2,
           "prefill2": core.metrics.num_prefill_tokens - pre,
           "cold": _gen(cold, p2, "c"),
           **{k: getattr(sm, k).get() - v for k, v in base.items()},
           "after": core.sessions.snapshot()}
    res["released"] = core.sessions.release_all()
    res["free_back"] = core.pool.num_free == free0
    res["pins_after"] = _ledger(core).owner_blocks()["session"]
    return res


@pytest.fixture()
def ledgers():
    for led in (jml.get_mem_ledger(), tml.get_mem_ledger()):
        led.reset()
    yield


def test_turn2_prefills_only_its_suffix(tiny32, ledgers):
    """Turn 2 under the same session id equals a cold recompute, prefills
    exactly the tokens past turn 1's committed context (the avoided-token
    count), and holds ``session`` pins in the memory ledger until released
    — all as the JAX engine does."""
    kw = dict(num_blocks=64, max_batch_size=2, max_model_len=128, session_ttl=600.0,
              session_tiers=False)
    jres = _turn2(*[cores(tiny32, **kw)[0] for _ in range(2)])
    tres = _turn2(*[cores(tiny32, **kw)[1] for _ in range(2)])
    assert tres == jres
    assert tres["out2"] == tres["cold"] and tres["free_back"]
    committed = ((16 + 4 - 1) // BS) * BS
    assert tres["avoided_tokens"] == committed and tres["snap"]["retained_tokens"] == committed
    assert tres["prefill2"] == 16 + 4 + 8 - committed
    assert tres["pins"] == committed // BS and tres["pins_after"] == 0


def _ttl(core) -> dict:
    free0 = core.pool.num_free
    sm = _metrics(core)
    base = sm.expired.get()
    _gen(core, list(range(1, 17)), "t1", "s1")
    held = len(core.sessions)
    time.sleep(0.05)
    _gen(core, list(range(40, 56)), "t2")  # any traffic drives the sweep
    audit = _ledger(core).audit()
    return {"held": held, "after": len(core.sessions), "expired": sm.expired.get() - base,
            "free_back": core.pool.num_free == free0,
            "orphans": audit["orphan_pins"]}


def test_ttl_expiry_releases_pins(tiny32, ledgers):
    kw = dict(num_blocks=64, max_batch_size=2, max_model_len=128, session_ttl=0.01,
              session_tiers=False)
    jcore, tcore = cores(tiny32, **kw)
    tres, jres = _ttl(tcore), _ttl(jcore)
    assert tres == jres == {"held": 1, "after": 0, "expired": 1, "free_back": True,
                            "orphans": 0}


def _cancel(core) -> tuple:
    p = proto_of(core)
    core.add_request(req(p, list(range(1, 17)), "c1", 8, annotations={"session.id": "s1"}))
    core.step()  # prefill + first token
    core.abort("c1")
    while core.has_work():
        core.step()
    return len(core.sessions), core.pool.num_free


def test_cancelled_stream_is_not_retained(tiny32):
    kw = dict(num_blocks=64, max_batch_size=2, max_model_len=128, session_ttl=600.0)
    jcore, tcore = cores(tiny32, **kw)
    assert _cancel(tcore) == _cancel(jcore)
    assert len(tcore.sessions) == 0


def _demote(core, cold) -> dict:
    sm = _metrics(core)
    base = sm.demoted_blocks.get()
    p1 = list(range(1, 17))
    out1 = _gen(core, p1, "t1", "s1")
    time.sleep(0.05)
    _gen(core, list(range(40, 56)), "t2")  # sweep → demote to the host tier
    staged = sm.demoted_blocks.get() - base
    host_blocks = len(core.kvbm.tiers[0])
    # evict every inactive device copy: turn 2 can only win by re-import
    core.pool.release(core.pool.allocate(core.pool.num_free))
    pre = core.metrics.num_prefill_tokens
    p2 = p1 + out1 + [3, 1, 4, 1, 5]
    out2 = _gen(core, p2, "t3", "s1")
    return {"out1": out1, "staged": staged, "host": host_blocks, "out2": out2,
            "onboarded": core.kvbm.stats.onboarded_blocks,
            "prefill": core.metrics.num_prefill_tokens - pre,
            "cold": _gen(cold, p2, "c")}


def test_demoted_session_is_reimported(tiny32):
    """session_tiers: an expired session's chain is written through to the
    host tier; after the device copies are evicted, turn 2 re-imports it
    and still equals a cold recompute."""
    kw = dict(num_blocks=64, max_batch_size=2, max_model_len=128, session_ttl=0.01,
              session_tiers=True, host_kv_blocks=32)
    jcore, tcore = cores(tiny32, **kw)
    jcold, tcold = cores(tiny32, num_blocks=64, max_batch_size=2, max_model_len=128)
    tres, jres = _demote(tcore, tcold), _demote(jcore, jcold)
    assert tres == jres
    assert tres["staged"] > 0 and tres["onboarded"] > 0 and tres["out2"] == tres["cold"]


def _evacuate(engines, cold) -> dict:
    first, second = engines
    p1 = list(range(1, 17))
    out1 = _gen(first, p1, "t1", "s1")
    ev = first.evacuate_sessions()
    free_back = first.pool.num_free == first.pool.num_blocks - 1
    p2 = p1 + out1 + [7, 7, 7]
    out2 = _gen(second, p2, "t2", "s1")
    return {"out1": out1, "evacuated": ev, "free_back": free_back, "out2": out2,
            "remote_resumes": second.metrics.session_remote_resumes,
            "onboarded": second.kvbm.stats.onboarded_blocks, "cold": _gen(cold, p2, "c")}


def test_evacuated_session_resumes_on_another_engine(tiny32):
    """evacuate_sessions parks a retained turn's blocks and record in the
    remote store; an engine on the same store claims the record for the
    next turn (a remote resume), onboards the chain and equals a cold
    recompute — as with the JAX engine, each package over its own store."""
    res = []
    for side in (0, 1):
        store = StoreFixture((jremote, tremote)[side])
        try:
            kw = dict(num_blocks=64, max_batch_size=2, max_model_len=128,
                      session_ttl=600.0, remote_kv_addr=store.addr)
            engines = [cores(tiny32, **kw)[side] for _ in range(2)]
            res.append(_evacuate(engines, cores(tiny32, num_blocks=64, max_batch_size=2,
                                                max_model_len=128)[side]))
        finally:
            store.close()
    jres, tres = res
    assert tres == jres
    assert tres["evacuated"]["sessions"] == 1 and tres["remote_resumes"] == 1
    assert tres["out2"] == tres["cold"] and tres["free_back"]


def _families(svc_cls, mm_cls, installs) -> dict:
    """The families a service's /metrics text carries after the session,
    prefix-cache and checkpoint families are installed on its registry and
    one sample of each is taken: {family: TYPE}."""
    svc = svc_cls(mm_cls())
    ses, pc, ck = (install(svc.metrics) for install in installs)
    ses.hits.inc()
    ses.active.set(2.0)
    pc.record_onboard(found_blocks=3, imported_blocks=2, block_size=16, seconds=0.01)
    ck.writes.inc()
    out = {}
    for line in svc.metrics.expose().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            if name.startswith(("dynamo_session", "dynamo_prefix_cache", "dynamo_stream_ckpt")):
                out[name] = kind
    return out


def test_metrics_families_on_the_service_registry():
    """The launcher installs the ``dynamo_session_*``, ``dynamo_prefix_cache_*``
    and ``dynamo_stream_ckpt_*`` families on the HTTP service's registry:
    its /metrics text then carries JAX's families, names and types."""
    from dynamo_tpu.frontend.model_manager import ModelManager as JMM
    from dynamo_tpu.frontend.service import HttpService as JSvc
    from dynamo_tpu.kvbm import metrics as jpcm
    from dynamo_tpu.kvbm import stream_ckpt as jck
    from dynamo_tpu_torch.frontend.model_manager import ModelManager as TMM
    from dynamo_tpu_torch.frontend.service import HttpService as TSvc
    from dynamo_tpu_torch.kvbm import metrics as tpcm
    from dynamo_tpu_torch.kvbm import stream_ckpt as tck

    try:
        jfam = _families(JSvc, JMM, (jses.install_session_metrics,
                                     jpcm.install_prefix_cache_metrics,
                                     jck.install_stream_ckpt_metrics))
        tfam = _families(TSvc, TMM, (tses.install_session_metrics,
                                     tpcm.install_prefix_cache_metrics,
                                     tck.install_stream_ckpt_metrics))
    finally:
        # back to private registries for the tests that follow
        for m in (jses, jpcm, jck, tses, tpcm, tck):
            m._metrics = None
    assert tfam == jfam and len(tfam) >= 20


def test_launcher_serves_with_tiers_and_sessions(tmp_path):
    """``launch.run in=batch --device cpu --host-kv-blocks N --disk-kv-path
    DIR --session-ttl S`` serves the trained checkpoint's continuation, on
    an engine with those tiers and sessions."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    prompts = tmp_path / "p.jsonl"
    prompts.write_text(json.dumps({"prompt": "one two three four", "max_tokens": 4}) + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
         "--model", str(root / "tests" / "data" / "tiny-real-llama"), "--device", "cpu",
         "--block-size", "4", "--num-blocks", "16", "--max-model-len", "64",
         "--host-kv-blocks", "32", "--disk-kv-path", str(tmp_path / "kv"),
         "--session-ttl", "5", "--input-jsonl", str(prompts)],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["text"] == " five six seven eight"
    assert (tmp_path / "kv" / "MANIFEST").exists()
