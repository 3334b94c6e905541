"""The port's crash-consistent stream checkpoints against the JAX
package's, on the CPU (tiny-llama at f32 with bridged weights): the record
schema, the records an engine writes as decode commits blocks (equal to
the JAX engine's in every field but ``ts``, every hash already stored when
the record is), the reap at a clean finish, a greedy stream checkpointed by
the JAX engine resumed by the port token for token, and a seeded sampled
stream checkpointed and resumed within the port bit for bit; with the
``engine.ckpt`` span of a traced stream as JAX's.
"""

from __future__ import annotations

import pytest

from dynamo_tpu.kvbm import remote as jremote
from dynamo_tpu.kvbm import stream_ckpt as jck
from dynamo_tpu.obs import tracer as jtracer
from dynamo_tpu_torch.kvbm import remote as tremote
from dynamo_tpu_torch.kvbm import stream_ckpt as tck
from dynamo_tpu_torch.obs import tracer as ttracer

from tests.test_torch_kvbm import cores, proto_of, req, run, tiny32  # noqa: F401
from tests.test_torch_kvbm_remote import StoreFixture

PROMPT = list(range(40, 52))


def test_record_schema_matches_jax():
    for args, kw in ((("r1", [5, 6, 7], [11, 2**64 - 1]),
                      dict(key_data=[1, 2], draws=3, seed=99, prompt_tokens=4)),
                     (("r2", [], []), {})):
        t, j = tck.build_ckpt_record(*args, **kw), jck.build_ckpt_record(*args, **kw)
        assert {k: v for k, v in t.items() if k != "ts"} == \
               {k: v for k, v in j.items() if k != "ts"}
        assert tck.parse_ckpt_record(t) == jck.parse_ckpt_record(t)
    for bad in (None, "nope", {"rid": "x"}, {"generated": ["a"]},
                {"generated": [1], "draws": "zero?"}):
        assert tck.parse_ckpt_record(bad) is None and jck.parse_ckpt_record(bad) is None
    assert (tck.CKPT_GENERATED_KEY, tck.CKPT_DRAWS_KEY) == \
           (jck.CKPT_GENERATED_KEY, jck.CKPT_DRAWS_KEY)


@pytest.fixture(params=["jax", "torch"])
def servers(request):
    """Two stores of one package's server (one for each engine)."""
    mod = jremote if request.param == "jax" else tremote
    stores = [StoreFixture(mod), StoreFixture(mod)]
    yield stores
    for s in stores:
        s.close()


def _checkpointed_run(core, addr: str, rid: str, trace_id: str, **so) -> dict:
    """Step a stream of 16 tokens under stream_ckpt_blocks=1 to its end,
    reading its record from the store after every step."""
    reader = (tremote if proto_of(core).__name__.startswith("dynamo_tpu_torch")
              else jremote).ckpt_client(addr)
    # interactive: a checkpoint every committed block (standard's is 2)
    ann = {"obs.traceparent": f"00-{trace_id}-b7ad6b7169203331-01",
           "qos.priority": "interactive"}
    core.add_request(req(proto_of(core), PROMPT, rid, 16, annotations=ann, **so))
    records, toks, ordered = [], [], True
    while core.has_work():
        for out in core.step().values():
            toks += out.token_ids
        rec = reader.get_stream_ckpt(rid)
        if rec is not None and (not records or rec != records[-1]):
            records.append(rec)
            ordered &= all(h in core.kvbm.ckpt_tier for h in rec["hashes"])
    return {"records": [{k: v for k, v in r.items() if k != "ts"} for r in records],
            "tokens": toks, "ordered": ordered, "reaped": reader.get_stream_ckpt(rid) is None,
            "lag": core.ckpt_lag_blocks()}


def _ckpt_spans(tracer_mod, trace_id: str) -> list:
    return [(s.name, s.attrs) for s in tracer_mod.get_tracer().recorder.iter_spans()
            if s.trace_id == trace_id and s.name == "engine.ckpt"]


def test_engine_records_match_jax_and_reap(tiny32, servers):
    """With stream_ckpt_blocks=1 both engines write the same sequence of
    records (every field but ``ts``: the ledger, the hash chain, the seed's
    two words as key, the draw count), each only once its blocks are in the
    store, and delete the record when the stream finishes; each traced
    checkpoint is an ``engine.ckpt`` span with JAX's attributes. (Both
    servers keep the first value put under a key — a put of a present key
    only refreshes its LRU place — so the store holds a stream's first
    record, written at prefill completion, until the reap; the later
    checkpoints' blocks still reach the store.)"""
    res = []
    for side, store in enumerate(servers):
        kw = dict(num_blocks=32, remote_kv_addr=store.addr, stream_ckpt_blocks=1)
        trace_id = f"{side + 1:032x}"
        res.append(_checkpointed_run(cores(tiny32, **kw)[side], store.addr, "ck1", trace_id,
                                     seed=1234))
        res[-1]["spans"] = _ckpt_spans((jtracer, ttracer)[side], trace_id)
    jres, tres = res
    assert tres == jres
    assert len(tres["records"]) == 1 and tres["ordered"] and tres["reaped"]
    assert tres["records"][-1]["generated"] == tres["tokens"][: len(tres["records"][-1]["generated"])]
    assert tres["records"][0]["key"] == [0, 1234] and tres["records"][0]["prompt_tokens"] == 12
    assert len(tres["spans"]) >= 4  # prefill completion + one a committed block


def _interrupted(core, addr: str, rid: str, steps: int, **so) -> dict:
    """Run ``steps`` engine steps of a 16-token stream and abandon the
    engine with its record stored (a killed worker); the stored record."""
    core.add_request(req(proto_of(core), PROMPT, rid, 16, **so))
    for _ in range(steps):
        core.step()
    rec = (tremote if proto_of(core).__name__.startswith("dynamo_tpu_torch")
           else jremote).ckpt_client(addr).get_stream_ckpt(rid)
    assert rec is not None and 0 < len(rec["generated"]) < 16
    return rec


def _resume(core, rec: dict, rid: str, **so) -> list[int]:
    """The stream resumed from its record: prompt + generated tokens, the
    resume annotations, the tokens still owed."""
    gen = rec["generated"]
    ann = {tck.CKPT_GENERATED_KEY: len(gen), tck.CKPT_DRAWS_KEY: rec["draws"]}
    r = req(proto_of(core), PROMPT + gen, rid, 16 - len(gen), annotations=ann, **so)
    return gen + run(core, [r])[rid]


def test_jax_checkpoint_resumes_greedy_on_the_port(tiny32, servers):
    """A greedy stream checkpointed by the JAX engine and abandoned resumes
    on a fresh torch engine on the same store: it onboards the stored
    blocks (only the suffix after the checkpoint is recomputed) and emits
    the uninterrupted stream token for token."""
    store = servers[0]
    kw = dict(num_blocks=32, remote_kv_addr=store.addr, stream_ckpt_blocks=1)
    rec = _interrupted(cores(tiny32, **kw)[0], store.addr, "g1", 5)
    tcore = cores(tiny32, **kw)[1]
    resumed = _resume(tcore, rec, "g1")
    full = run(cores(tiny32, num_blocks=32)[0], [req(proto_of(cores(tiny32)[0]), PROMPT,
                                                     "g1", 16)])["g1"]
    assert resumed == full
    assert tcore.kvbm.stats.onboarded_blocks > 0 and tcore.metrics.stream_ckpt_resumes == 1


def test_sampled_resume_is_bit_identical_within_the_port(tiny32, servers):
    """A seeded sampled stream checkpointed by the port and abandoned
    resumes on a fresh torch engine with the draw counter and penalty
    counts restored: it emits the uninterrupted run's tokens exactly (the
    sampler's noise is a function of seed and draw)."""
    store = servers[1]
    so = dict(temperature=1.0, seed=77, frequency_penalty=0.5)
    full = run(cores(tiny32, num_blocks=32)[1],
               [req(proto_of(cores(tiny32)[1]), PROMPT, "s1", 16, **so)])["s1"]
    kw = dict(num_blocks=32, remote_kv_addr=store.addr, stream_ckpt_blocks=1)
    rec = _interrupted(cores(tiny32, **kw)[1], store.addr, "s1", 6, **so)
    assert rec["generated"] == full[: len(rec["generated"])]
    tcore = cores(tiny32, **kw)[1]
    assert _resume(tcore, rec, "s1", **so) == full
    assert tcore.kvbm.stats.onboarded_blocks > 0
