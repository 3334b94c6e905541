"""Multimodal embedding override and the embeddings call in the port:
the tensor wire envelope, ``forward(embed_override=...)``, engine streams
with embedding spans and their validation, and ``embed`` — each against
the JAX package.

Tolerances: f32 hidden states and embeddings at atol = rtol = 1e-4 (both
sides compute in f32 and sum in another order, as
tests/test_torch_llama.py); tokens and error texts exact.

The JAX runner's ``embed`` gives every row of a batch the same block
table (``dynamo_tpu/engine/engine.py``, ``_build_embed_fn``), so in a
batch of more than one input the rows write their K and V over each
other and only the last writer's embedding is right. The port gives each
row its own blocks. So the port is held against JAX one input at a time,
and its batched rows against its own single-input calls.
"""

from __future__ import annotations

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.obs.compile_ledger import get_compile_ledger
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _req, _run, _tcfg

TOL = dict(atol=1e-4, rtol=1e-4)
TINY32 = "tiny-llama-f32-mm"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny32():
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name=TINY32)
    JAX_PRESETS[TINY32] = jcfg
    TORCH_PRESETS[TINY32] = _tcfg(jcfg)
    jp = jllama.init_params(jcfg, jax.random.key(13))
    yield jcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del JAX_PRESETS[TINY32], TORCH_PRESETS[TINY32]


def _kw(**kw):
    d = dict(model=TINY32, block_size=4, num_blocks=96, max_batch_size=4,
             max_model_len=128, prefill_chunk=16, decode_bucket=(4,))
    d.update(kw)
    return d


# ---------------------------------------------------------------------------
# Wire envelope and forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (1, 8), (64, 4096)])
def test_tensor_wire_roundtrip_matches_jax(shape):
    arr = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    d = tproto.tensor_to_wire(arr)
    assert set(d) == {"data", "shape", "dtype"} and d == jproto.tensor_to_wire(arr)
    np.testing.assert_array_equal(tproto.tensor_from_wire(d), arr)
    # float64 converts on the way in: the wire stays float32
    d64 = tproto.tensor_to_wire(arr.astype(np.float64))
    assert d64["dtype"] == "float32" and tproto.tensor_from_wire(d64).dtype == np.float32


def test_forward_embed_override_matches_jax(tiny32):
    """Prefill rows with override spans (one row without any) through both
    forwards: hidden states and the K/V written."""
    jcfg, jp, tp = tiny32
    tcfg = TORCH_PRESETS[TINY32]
    rng = np.random.default_rng(3)
    b, t, h = 3, 8, tcfg.hidden_size
    L, nb, bs = tcfg.num_layers, 16, 4
    shape = (L, nb, bs, tcfg.num_kv_heads, tcfg.head_dim)
    ck = np.zeros(shape, np.float32)
    cv = np.zeros(shape, np.float32)
    bt = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    toks = rng.integers(0, tcfg.vocab_size, size=(b, t)).astype(np.int32)
    q_start, q_len = np.zeros((b,), np.int32), np.array([8, 6, 8], np.int32)
    override = rng.standard_normal((b, t, h)).astype(np.float32)
    mask = np.zeros((b, t), bool)
    mask[0, 2:6] = True
    mask[1, 0:3] = True
    args = (toks, q_start, q_len, bt)
    jh, jck, jcv = jllama.forward(jp, jcfg, *(jnp.asarray(a) for a in args),
                                  jnp.asarray(ck), jnp.asarray(cv), return_all_hidden=True,
                                  embed_override=jnp.asarray(override),
                                  embed_mask=jnp.asarray(mask))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    th = tllama.forward(tp, tcfg, *(torch.from_numpy(a) for a in args), tck, tcv,
                        return_all_hidden=True, embed_override=torch.from_numpy(override),
                        embed_mask=torch.from_numpy(mask))
    live = np.arange(t)[None, :] < q_len[:, None]
    np.testing.assert_allclose(th.numpy()[live], np.asarray(jh)[live], **TOL)
    np.testing.assert_allclose(tck[:, 1:].numpy(), np.asarray(jck)[:, 1:], **TOL)
    np.testing.assert_allclose(tcv[:, 1:].numpy(), np.asarray(jcv)[:, 1:], **TOL)
    # the override moved the overridden rows and nothing else
    plain = tllama.forward(tp, tcfg, *(torch.from_numpy(a) for a in args),
                           torch.zeros(shape), torch.zeros(shape), return_all_hidden=True)
    assert not torch.equal(plain[0], th[0]) and torch.equal(plain[2], th[2])


# ---------------------------------------------------------------------------
# Engine streams with spans
# ---------------------------------------------------------------------------

def _mm_req(proto, prompt, rid, spans, max_tokens=8):
    r = _req(proto, prompt, rid, max_tokens)
    r.mm_embeddings = [{"pos": pos, **proto.tensor_to_wire(e)} for pos, e in spans]
    return r


def _span_reqs(proto, h):
    """Three requests: a span mid-prompt; a 17-token prompt whose span
    (positions 10-16) ends in the length-1 second chunk (prefill_chunk 16);
    two spans in one prompt."""
    rng = np.random.default_rng(21)
    e = lambda k: rng.standard_normal((k, h)).astype(np.float32)  # noqa: E731
    return [_mm_req(proto, [5, 6, 7, 300, 301, 302, 303, 9, 10], "a", [(3, e(4))]),
            _mm_req(proto, [(11 * j) % 400 + 3 for j in range(17)], "tail", [(10, e(7))]),
            _mm_req(proto, [(7 * j) % 300 + 3 for j in range(14)], "two",
                    [(1, e(2)), (8, e(5))])]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_mm_streams_match_jax(tiny32, kv_dtype):
    _jcfg, jp, tp = tiny32
    h = TORCH_PRESETS[TINY32].hidden_size
    core = teng.EngineCore(TEngineConfig(**_kw(kv_dtype=kv_dtype)), params=tp, device="cpu")
    got, fin = _run(core, _span_reqs(tproto, h))
    want, _ = _run(jeng.EngineCore(JEngineConfig(**_kw(kv_dtype=kv_dtype)), params=jp),
                   _span_reqs(jproto, h))
    assert fin == set(got) and got == want
    mm = [k for k in core.runner.programs if "mm" in k]
    assert any(k[1] == 1 for k in mm), mm      # the length-1 tail ran the mm variant
    plain, _ = _run(teng.EngineCore(TEngineConfig(**_kw(kv_dtype=kv_dtype)), params=tp,
                                    device="cpu"),
                    [_req(tproto, r.token_ids, r.request_id, 8)
                     for r in _span_reqs(tproto, h)])
    assert all(got[rid] != plain[rid] for rid in got), "the spans changed nothing"


def test_mm_identity_rows_equal_plain_and_buffer_grows(tiny32):
    """Spans that carry the embedding table's own rows for their tokens
    give the plain prompt's stream exactly. A larger mm bucket remakes the
    runner's one override buffer and drops the mm programs made on the
    old one."""
    _jcfg, _jp, tp = tiny32
    emb = tp["embed"].numpy()
    prompt = [(13 * j) % 500 + 2 for j in range(40)]
    core = teng.EngineCore(TEngineConfig(**_kw(prefill_chunk=32)), params=tp, device="cpu")
    small, _ = _run(core, [_mm_req(tproto, prompt[:10], "s", [(2, emb[prompt[2:6]])])])
    r = core.runner
    small_key = next(k for k in r.programs if "mm" in k)
    assert r._mm_mask.numel() == small_key[0] * small_key[1]
    big, _ = _run(core, [_mm_req(tproto, prompt, "b", [(4, emb[prompt[4:36]])])])
    assert small_key not in r.programs
    assert r._mm_mask.numel() == max(k[0] * k[1] for k in r.programs if "mm" in k) > 64
    plain, _ = _run(teng.EngineCore(TEngineConfig(**_kw(prefill_chunk=32)), params=tp,
                                    device="cpu"),
                    [_req(tproto, prompt[:10], "s", 8), _req(tproto, prompt, "b", 8)])
    assert small["s"] == plain["s"] and big["b"] == plain["b"]


@pytest.mark.parametrize("case", ["past_end", "negative_pos", "wrong_hidden", "not_2d",
                                  "bad_payload"])
def test_mm_validation_errors_match_jax(tiny32, case):
    _jcfg, jp, tp = tiny32
    h = TORCH_PRESETS[TINY32].hidden_size

    def make(proto):
        prompt, pos, emb = [5, 6, 7, 8, 9], 1, np.zeros((4, h), np.float32)
        if case == "past_end":
            pos = 2
        elif case == "negative_pos":
            pos = -1
        elif case == "wrong_hidden":
            emb = np.zeros((4, 32), np.float32)
        elif case == "not_2d":
            emb = np.zeros((4,), np.float32)
        r = _mm_req(proto, prompt, "x", [(pos, emb)])
        if case == "bad_payload":
            r.mm_embeddings[0]["data"] = b"\x00" * 7
        return r

    t = teng.EngineCore(TEngineConfig(**_kw()), params=tp, device="cpu").add_request(
        make(tproto))
    j = jeng.EngineCore(JEngineConfig(**_kw()), params=jp).add_request(make(jproto))
    assert t is not None and j is not None
    assert t.finish_reason == tproto.FinishReason.ERROR and t.error == j.error
    assert ("bad mm_embeddings payload" if case == "bad_payload" else "out of range") in t.error


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

PROMPTS = [[5, 6, 7], [(9 * j) % 400 + 3 for j in range(21)],
           [(5 * j) % 300 + 2 for j in range(40)]]


def test_embed_one_input_matches_jax(tiny32):
    _jcfg, jp, tp = tiny32
    tcore = teng.EngineCore(TEngineConfig(**_kw()), params=tp, device="cpu")
    jcore = jeng.EngineCore(JEngineConfig(**_kw()), params=jp)
    for p in PROMPTS:
        got = tcore.embed([p])
        assert got.shape == (1, TORCH_PRESETS[TINY32].hidden_size) and got.dtype == np.float32
        np.testing.assert_allclose(got, jcore.embed([p]), **TOL)


def test_embed_batch_rows_equal_single_inputs_and_leave_the_pool(tiny32):
    """Each row of a batched call equals the input embedded alone; the call
    touches neither the serving cache nor the pool, and its bucket lands
    in the compile ledger as "embed"."""
    _jcfg, _jp, tp = tiny32
    led = get_compile_ledger()
    led.reset()
    try:
        core = teng.EngineCore(TEngineConfig(**_kw()), params=tp, device="cpu")
        ck = core.runner.cache_k.clone()
        free = core.pool.num_free
        batch = core.embed(PROMPTS)
        assert batch.shape == (3, TORCH_PRESETS[TINY32].hidden_size)
        for i, p in enumerate(PROMPTS):
            np.testing.assert_allclose(batch[i], core.embed([p])[0], rtol=1e-5, atol=1e-5)
        assert torch.equal(core.runner.cache_k, ck) and core.pool.num_free == free
        assert {(s.kind, s.b, s.t) for s in led.inventory} >= {("embed", 4, 64),
                                                             ("embed", 1, 16)}
        with pytest.raises(ValueError, match="exceeds max_model_len"):
            core.embed([[1] * 129])
    finally:
        led.reset()


def test_async_engine_embed_beside_generate(tiny32):
    """AsyncTorchEngine.embed runs on the engine thread between steps of
    a live stream, and gives EngineCore.embed's rows."""
    _jcfg, _jp, tp = tiny32
    engine = teng.AsyncTorchEngine(teng.EngineCore(TEngineConfig(**_kw()), params=tp,
                                                   device="cpu"))

    async def go():
        async def stream():
            toks = []
            async for out in engine.generate(_req(tproto, [3, 4, 5, 6], "g", 16)):
                toks += out.token_ids
            return toks
        try:
            toks, emb = await asyncio.gather(stream(), engine.embed(PROMPTS[:2]))
        finally:
            await engine.shutdown()
        return toks, emb

    toks, emb = asyncio.run(go())
    assert len(toks) == 16
    ref = teng.EngineCore(TEngineConfig(**_kw()), params=tp, device="cpu").embed(PROMPTS[:2])
    np.testing.assert_allclose(emb, ref, rtol=1e-5, atol=1e-5)
