"""Speculative decoding in the port (``engine/spec.py`` + the engine's
verify steps): twins of tests/test_spec.py, and the port's spec streams
against the JAX engine's.

Tolerances: tokens exact; hidden states of the verify-shape forward at
atol = rtol = 1e-4 (f32 on both sides, summed in another order, as
tests/test_torch_llama.py). Models run in f32 (``tiny-llama`` with bridged
weights), so greedy streams must be equal token for token: bf16 would
round at other places in XLA and ATen and could flip a near-tie.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.engine import spec as jspec
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.obs import compile_ledger as jled
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine import spec as tspec
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.obs import compile_ledger as tled
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.qos.deadline import NO_SPEC_KEY
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import CKPT, ROOT, _req, _run, _tcfg

TOL = dict(atol=1e-4, rtol=1e-4)
TINY32 = "tiny-llama-f32-spec"
REPETITIVE = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
NON_REPETITIVE = list(range(40, 57))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny model's steps are a few ms on one thread and far slower
    when several test workers each spread torch over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw) -> TEngineConfig:
    d = dict(model="tiny-llama", block_size=4, num_blocks=64, max_batch_size=8,
             max_model_len=256, prefill_chunk=32, decode_bucket=(4, 8))
    d.update(kw)
    return TEngineConfig(**d)


def _spec(**kw) -> TEngineConfig:
    return _cfg(spec_ngram=2, spec_k=4, **kw)


# ---------------------------------------------------------------------------
# propose / accept / greedy_eligible (cases of tests/test_spec.py)
# ---------------------------------------------------------------------------

GREEDY = tproto.SamplingOptions(temperature=0.0)

UNIT_CASES = [
    ("propose", ([1, 2, 3, 9, 1, 2, 3, 5], 2, 4), []),
    ("propose", ([1, 2, 3, 9, 1, 2], 2, 4), [3, 9, 1, 2]),
    ("propose", ([7, 8, 1, 7, 8, 2, 7, 8], 2, 2), [2, 7]),   # most recent match wins
    ("propose", ([1, 2, 3, 1, 2], 2, 1), [3]),                # k caps the continuation
    ("propose", ([1, 2], 2, 4), []),
    ("propose", ([1, 2, 3], 0, 4), []),
    ("propose", ([1, 2, 3], 2, 0), []),
    ("accept", ([5, 10, 11, 12], [10, 11, 12, 13]), [10, 11, 12, 13]),
    ("accept", ([5, 10, 99, 12], [10, 11, 12, 13]), [10, 11]),
    ("accept", ([5, 99], [10, 11]), [10]),
    ("accept", ([5], [10]), [10]),
    ("greedy_eligible", (GREEDY,), True),
    ("greedy_eligible", (tproto.SamplingOptions(temperature=0.7),), False),
    ("greedy_eligible", (tproto.SamplingOptions(),), False),       # temperature unset
    ("greedy_eligible", (tproto.SamplingOptions(temperature=0.0, frequency_penalty=0.2),),
     False),
    ("greedy_eligible", (tproto.SamplingOptions(temperature=0.0, presence_penalty=0.1),),
     False),
    ("greedy_eligible", (tproto.SamplingOptions(temperature=0.0, repetition_penalty=1.3),),
     False),
]


@pytest.mark.parametrize("fn,args,want", UNIT_CASES)
def test_spec_units_match_jax(fn, args, want):
    assert getattr(tspec, fn)(*args) == want
    jargs = tuple(jproto.SamplingOptions(**a.to_dict())
                  if isinstance(a, tproto.SamplingOptions) else a for a in args)
    assert getattr(jspec, fn)(*jargs) == want


# ---------------------------------------------------------------------------
# Port spec streams against the port's plain streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("prompt", [REPETITIVE, NON_REPETITIVE],
                         ids=["repetitive", "non_repetitive"])
def test_spec_greedy_stream_equals_plain(prompt, pipelined):
    plain, _ = _run(teng.EngineCore(_cfg(), device="cpu"), [_req(tproto, prompt, "r", 24)],
                    pipelined=pipelined)
    core = teng.EngineCore(_spec(), device="cpu")
    spec, fin = _run(core, [_req(tproto, prompt, "r", 24)], pipelined=pipelined)
    assert fin == {"r"} and spec == plain and len(spec["r"]) == 24
    assert core.metrics.spec_proposed > 0


def test_spec_acceptance_fires_on_repetition():
    """The tiny random model loops; accepted multi-token steps make fewer
    engine steps than tokens."""
    core = teng.EngineCore(_spec(), device="cpu")
    out, _ = _run(core, [_req(tproto, REPETITIVE, "r", 32)])
    assert len(out["r"]) == 32 and core.metrics.spec_accepted > 0
    assert core.metrics.num_steps < 32
    assert any(k[0] == "verify" for k in core.runner.programs)


def test_spec_max_tokens_exact_mid_acceptance():
    """A stop firing inside an accepted run truncates exactly at budget."""
    core = teng.EngineCore(_spec(), device="cpu")
    out, _ = _run(core, [_req(tproto, [5, 6, 5, 6, 5, 6], "r", 7)])
    assert len(out["r"]) == 7 and core.metrics.spec_accepted > 0


def test_spec_rejection_at_block_boundary_cannot_poison_prefix_pool(monkeypatch):
    """A rejected proposal on a block's last slot, with the request
    finishing on its last accepted token, must not commit that block into
    the prefix pool: its last slot's KV came from the rejected token.
    (block_size 4, prompt 6: the verify chunk [t6, WRONG] covers positions
    6-7; max_tokens 2 finishes at index 7, the last slot of block 1.) A
    same-core re-send of the true 8-token prefix must continue exactly as
    a fresh spec-free engine."""
    prompt = [10, 11, 12, 13, 14, 15]
    plain, _ = _run(teng.EngineCore(_cfg(), device="cpu"), [_req(tproto, prompt, "t", 2)])
    t = plain["t"]
    wrong = t[1] + 1 if t[1] + 1 < 512 else t[1] - 1
    real = teng.propose
    monkeypatch.setattr(teng, "propose", lambda tokens, n, k: (
        [wrong] if len(tokens) == len(prompt) + 1 else real(tokens, n, k)))
    core = teng.EngineCore(_spec(), device="cpu")
    out, _ = _run(core, [_req(tproto, prompt, "a", 2)])
    assert out["a"] == t and core.metrics.spec_proposed > 0
    shared = prompt + t + [42]
    cached, _ = _run(core, [_req(tproto, shared, "b", 8)])
    fresh, _ = _run(teng.EngineCore(_cfg(), device="cpu"), [_req(tproto, shared, "b", 8)])
    assert core.metrics.prefix_hit_blocks > 0
    assert cached["b"] == fresh["b"]


def test_spec_never_verifies_sampled_or_penalised_rows():
    """Sampled and penalised requests beside greedy ones never verify:
    their streams equal a spec-free engine's, and only the greedy row's
    proposals are counted."""
    def reqs():
        return [_req(tproto, [5, 6, 5, 6, 5], "s", 12, temperature=0.9, seed=7),
                _req(tproto, [9, 10, 9, 10, 9], "p", 12, repetition_penalty=1.3),
                _req(tproto, [5, 6, 7, 5, 6, 7, 5, 6], "g", 16)]

    core = teng.EngineCore(_spec(), device="cpu")
    spec, _ = _run(core, reqs())
    plain, _ = _run(teng.EngineCore(_cfg(), device="cpu"), reqs())
    assert spec == plain and core.metrics.spec_proposed > 0
    solo = teng.EngineCore(_spec(), device="cpu")
    _run(solo, reqs()[:2])
    assert solo.metrics.spec_proposed == 0


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_spec_no_spec_annotation_never_verifies(pipelined):
    """A greedy request marked ``qos.no_spec`` (over the wire, through
    ``from_dict``) reserves no lookahead blocks, so it must not verify
    either: its stream crosses several block boundaries and equals the
    spec-free engine's, with no proposal counted and no verify program."""
    def req():
        r = _req(tproto, REPETITIVE, "q", 24)
        r.annotations[NO_SPEC_KEY] = True
        return tproto.PreprocessedRequest.from_dict(r.to_dict())

    plain, _ = _run(teng.EngineCore(_cfg(), device="cpu"), [req()], pipelined=pipelined)
    core = teng.EngineCore(_spec(), device="cpu")
    spec, fin = _run(core, [req()], pipelined=pipelined)
    assert fin == {"q"} and spec == plain and len(spec["q"]) == 24
    assert core.metrics.spec_proposed == 0
    assert not any(k[0] == "verify" for k in core.runner.programs)


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_spec_proposals_capped_to_the_seq_blocks(pipelined):
    """With no lookahead blocks reserved, the planner still verifies but
    caps each chunk to the positions the seq's blocks cover: a position
    past them would write its K/V into the trash block, and the accepted
    tokens' K/V would be in no block of the seq. Streams stay plain."""
    plain, _ = _run(teng.EngineCore(_cfg(), device="cpu"),
                    [_req(tproto, REPETITIVE, "r", 24)], pipelined=pipelined)
    core = teng.EngineCore(_spec(), device="cpu")
    core.sched.spec_lookahead = 0
    real = core.runner.dispatch_verify
    chunk_ends = []

    def covered(rows, chunks):
        for (seq, start, _), c in zip(rows, chunks):
            chunk_ends.append((start + len(c), len(seq.block_ids) * core.runner.engine_cfg.block_size))
        return real(rows, chunks)

    core.runner.dispatch_verify = covered
    spec, _ = _run(core, [_req(tproto, REPETITIVE, "r", 24)], pipelined=pipelined)
    assert spec == plain and core.metrics.spec_accepted > 0
    assert chunk_ends and all(end <= cap for end, cap in chunk_ends), chunk_ends


def test_spec_pipelined_async_engine_matches_sync():
    """AsyncTorchEngine's overlapped loop over a spec engine emits the
    sync engine's streams and engages verify (pause-then-verify entry)."""
    prompts = {"a": ([5, 6, 7, 8, 5, 6, 7, 8], 20), "b": ([11, 12, 11, 12, 11], 15)}
    sync, _ = _run(teng.EngineCore(_spec(), device="cpu"),
                   [_req(tproto, p, rid, n) for rid, (p, n) in prompts.items()])
    engine = teng.AsyncTorchEngine(teng.EngineCore(_spec(), device="cpu"))

    async def go():
        async def one(rid):
            toks = []
            async for out in engine.generate(_req(tproto, prompts[rid][0], rid,
                                                  prompts[rid][1])):
                toks += out.token_ids
            return toks
        try:
            return await asyncio.gather(one("a"), one("b"))
        finally:
            await engine.shutdown()

    a, b = asyncio.run(go())
    assert (a, b) == (sync["a"], sync["b"])
    assert engine.core.metrics.spec_accepted > 0
    assert engine.stats()["spec_proposed"] == engine.core.metrics.spec_proposed


def test_spec_full_warmup_covers_verify():
    """warmup_mode=full captures the verify rungs: serving a spec engine
    then makes no program."""
    led = tled.get_compile_ledger()
    led.reset()
    try:
        core = teng.EngineCore(_spec(warmup_mode="full", max_model_len=64), device="cpu")
        s = core.warmup()
        assert (s["failed"], s["deadline_skipped"], s["coverage"]) == (0, 0, 1.0)
        verify = {k for k in core.runner.programs if k[0] == "verify"}
        assert verify and {k[2] for k in verify} == {2, 4, 5}
        made = dict(core.runner.programs)
        out, _ = _run(core, [_req(tproto, REPETITIVE, "r", 24)], pipelined=True)
        assert core.runner.programs == made and core.metrics.spec_accepted > 0
        assert all(e.source == "warmup" for e in led.events)
    finally:
        led.reset()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(spec_ngram=2, spec_k=4, max_batch_size=32, max_model_len=176, block_size=16,
         prefill_chunk=128),
    dict(spec_ngram=3, spec_k=3),
    dict(spec_ngram=2, spec_k=1, unified_step=False, decode_bucket=(4, 8)),
], ids=["chip", "k3", "k1_legacy"])
def test_verify_lattice_matches_jax(kw):
    t = tled.enumerate_buckets(TEngineConfig(**kw))
    j = jled.enumerate_buckets(JEngineConfig(**kw))
    assert [s.to_dict() for s in t] == [s.to_dict() for s in j]
    assert any(s.kind == "verify" for s in t)
    for n in range(1, 6):
        for rows in (1, 3, 9):
            assert (tled.sig_for_rows("verify", rows, n, 5, TEngineConfig(**kw)).to_dict()
                    == jled.sig_for_rows("verify", rows, n, 5, JEngineConfig(**kw)).to_dict())


@pytest.fixture(scope="module")
def tiny32():
    """tiny-llama at f32 as a preset of both packages, with JAX params
    from a seed bridged into the port."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name=TINY32)
    JAX_PRESETS[TINY32] = jcfg
    TORCH_PRESETS[TINY32] = _tcfg(jcfg)
    jp = jllama.init_params(jcfg, jax.random.key(5))
    yield jcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del JAX_PRESETS[TINY32], TORCH_PRESETS[TINY32]


def test_verify_shape_forward_matches_jax(tiny32):
    """The forward at a verify shape (B=3, T=5, q_start mid-block, every
    position's hidden state) against the JAX forward through its Pallas
    kernel in interpret mode; the K/V written must match too."""
    jcfg, jp, tp = tiny32
    tcfg = TORCH_PRESETS[TINY32]
    rng = np.random.default_rng(7)
    L, nb, bs = tcfg.num_layers, 24, 4
    shape = (L, nb, bs, tcfg.num_kv_heads, tcfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    bt = np.array([[1, 2, 3, 4, 13], [5, 6, 7, 8, 14], [9, 10, 11, 12, 15]], np.int32)
    toks = rng.integers(0, tcfg.vocab_size, size=(3, 5)).astype(np.int32)
    q_start = np.array([6, 13, 9], np.int32)
    q_len = np.array([5, 3, 5], np.int32)
    args = (toks, q_start, q_len, bt)
    jh, jck, jcv = jllama.forward(jp, jcfg, *(jnp.asarray(a) for a in args),
                                  jnp.asarray(ck), jnp.asarray(cv),
                                  attn_impl="pallas_interpret", return_all_hidden=True)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    th = tllama.forward(tp, tcfg, *(torch.from_numpy(a) for a in args), tck, tcv,
                        return_all_hidden=True)
    live = np.arange(5)[None, :] < q_len[:, None]
    np.testing.assert_allclose(th.numpy()[live], np.asarray(jh)[live], **TOL)
    np.testing.assert_allclose(tck[:, 1:].numpy(), np.asarray(jck)[:, 1:], **TOL)
    np.testing.assert_allclose(tcv[:, 1:].numpy(), np.asarray(jcv)[:, 1:], **TOL)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_spec_streams_match_jax_spec(tiny32, kv_dtype):
    """Port spec streams equal the JAX engine's spec streams (tiny-llama
    f32, spec_ngram=2, spec_k=4, same weights) at each kv dtype — int4
    against JAX int4 only — and the plain streams equal JAX's plain ones.
    Over the model-precision cache spec streams also equal the plain ones.
    Over a quantized cache they need not, in either package: a rejected
    proposal's K/V write merges into its block's scale, which requantizes
    the block's rows (at int4 the first stream here leaves the plain one)."""
    _jcfg, jp, tp = tiny32
    kw = dict(model=TINY32, block_size=4, num_blocks=64, max_batch_size=4,
              max_model_len=96, prefill_chunk=16, decode_bucket=(4,), kv_dtype=kv_dtype)
    prompts = [REPETITIVE, NON_REPETITIVE, [11, 12, 11, 12, 11]]
    lens = [20, 14, 17]

    def reqs(proto):
        return [_req(proto, p, f"r{i}", n) for i, (p, n) in enumerate(zip(prompts, lens))]

    tcore = teng.EngineCore(TEngineConfig(**kw, spec_ngram=2, spec_k=4), params=tp,
                            device="cpu")
    tspec_out, _ = _run(tcore, reqs(tproto))
    jcore = jeng.EngineCore(JEngineConfig(**kw, spec_ngram=2, spec_k=4), params=jp)
    jspec_out, _ = _run(jcore, reqs(jproto))
    tplain, _ = _run(teng.EngineCore(TEngineConfig(**kw), params=tp, device="cpu"),
                     reqs(tproto))
    jplain, _ = _run(jeng.EngineCore(JEngineConfig(**kw), params=jp), reqs(jproto))
    assert tspec_out == jspec_out
    assert tplain == jplain
    if kv_dtype == "bfloat16":
        assert tspec_out == tplain
    assert [len(tspec_out[f"r{i}"]) for i in range(3)] == lens
    assert tcore.metrics.spec_proposed == jcore.metrics.spec_proposed > 0
    assert tcore.metrics.spec_accepted == jcore.metrics.spec_accepted


def test_launcher_spec_on_cpu(tmp_path):
    src = tmp_path / "prompts.jsonl"
    src.write_text('{"prompt": "one two three four", "max_tokens": 8}\n')
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
         "--model", str(CKPT), "--device", "cpu", "--block-size", "4",
         "--num-blocks", "64", "--max-model-len", "64", "--max-batch-size", "2",
         "--prefill-chunk", "16", "--spec-ngram", "2", "--spec-k", "4",
         "--input-jsonl", str(src)],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env={**os.environ, "OMP_NUM_THREADS": "1", "DYN_LOG": "info"})
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert '" five six seven eight' in line and '"tokens": 8' in line
