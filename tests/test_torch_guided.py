"""Structured output in the port (``engine/guided.py`` + the engine's
masked steps): the grammar machine, the token masks and the guided vocab
against the JAX package's, and guided streams against the JAX engine's.

Tolerances: exact throughout — masks element for element, tokens token
for token (f32 models, so no bf16 near-tie can flip an argmax). Sampled
guided streams are held to the grammar and to the port's own legacy
path, not to JAX's tokens: the two samplers draw different bits
(tests/test_torch_sampling.py). What they are drawn from is held to JAX:
the allowed set at every step exactly, the masked log-softmax at
atol = rtol = 1e-4.
"""

from __future__ import annotations

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.engine import guided as jguided
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from dynamo_tpu.tokenizer import guided_vocab as jguided_vocab
from dynamo_tpu.tokenizer import load_tokenizer as jload_tokenizer
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine import guided as tguided
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.tokenizer import ByteTokenizer, guided_vocab, load_tokenizer
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import CKPT, _req, _run, _tcfg

TINY32 = "tiny-llama-f32-guided"
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string", "enum": ["ada", "bob"]},
                         "ok": {"type": "boolean"},
                         "tags": {"type": "array", "items": {"type": "number"}}},
          "required": ["name", "ok"]}
PROMPT = list(range(40, 52))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Vocab, machine and masks against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["byte", "tiny-real-llama"])
def test_guided_vocab_matches_jax(which):
    if which == "byte":
        t, j, sizes = ByteTokenizer(), JByteTokenizer(), (512, 600)
    else:
        t, j, sizes = load_tokenizer(str(CKPT)), jload_tokenizer(str(CKPT)), (297, 320)
    for size in sizes:       # the model's vocab, and one padded past the tokenizer's
        got = guided_vocab(t, size)
        assert len(got) == size and got == jguided_vocab(j, size)
    if which != "byte":
        assert got[0] == got[1] == got[2] == ""       # <unk> <s> </s>
        assert any(p.startswith(" ") for p in got)    # byte-level BPE space marker


DOCS = ['{"a": 1}', '[1, 2.5, -3e2]', '"hi"', "true", "null", "42",
        '{"a": {"b": [true, null]}, "c": "x"}', "[]", ' { "a" : [ 1 , 2 ] } ',
        '"esc\\" \\\\ \\n ok"', '{"a" 1}', "[1,, 2]", "{,}", "nulx", '{"a": 1} x',
        '{"a": 1,}', "12.", '{"name": "ada", "ok": true}', '{"name": "eve"',
        '{"ok": false}', '{"name": "bob", "ok": true, "tags": [1, "x"]']


@pytest.mark.parametrize("schema", [None, SCHEMA], ids=["json_object", "json_schema"])
@pytest.mark.parametrize("doc", DOCS)
def test_json_machine_matches_jax(doc, schema):
    """The copy accepts, rejects and completes exactly where JAX's does."""
    def feed(mod):
        m = mod.JsonMachine(schema)
        try:
            m.feed_str(doc)
        except mod.Reject:
            return "reject"
        return m.complete

    assert feed(tguided) == feed(jguided)


@pytest.mark.parametrize("schema", [{}, SCHEMA], ids=["json_object", "json_schema"])
@pytest.mark.parametrize("vocab", ["byte", "tiny-real-llama"])
def test_token_masker_masks_match_jax(vocab, schema):
    """TokenMasker.mask() equals JAX's at every step of a scripted document
    (each step advances both maskers by the same allowed token)."""
    if vocab == "byte":
        pieces, eos = guided_vocab(ByteTokenizer(), 512), [2]
    else:
        tok = load_tokenizer(str(CKPT))
        pieces, eos = guided_vocab(tok, 297), [tok.eos_id]
    t = tguided.TokenMasker(pieces, eos, schema)
    j = jguided.TokenMasker(pieces, eos, schema)
    doc = '{"name": "bob", "ok": true, "tags": [1, 2.5]}'
    steps = 0
    while doc:
        tm, jm = t.mask(), j.mask()
        np.testing.assert_array_equal(tm, jm)
        # the longest allowed piece that continues the script
        tid = max((i for i, p in enumerate(pieces) if p and tm[i] and doc.startswith(p)),
                  key=lambda i: len(pieces[i]))
        t.advance(tid)
        j.advance(tid)
        doc = doc[len(pieces[tid]):]
        steps += 1
    assert t.complete and j.complete and steps > 5
    np.testing.assert_array_equal(t.mask(), j.mask())
    assert t.mask()[eos[0]]


def test_validate_json_output_matches_jax():
    ok = '{"name": "ada", "ok": false, "tags": [3]}'
    assert tguided.validate_json_output(ok, SCHEMA) == jguided.validate_json_output(ok, SCHEMA)
    for bad in ('{"name": "eve", "ok": true}', '{"ok": true}', '{"name": "ada"'):
        for mod in (tguided, jguided):
            with pytest.raises((AssertionError, ValueError)):
                mod.validate_json_output(bad, SCHEMA)


# ---------------------------------------------------------------------------
# Engine streams against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny32():
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name=TINY32)
    JAX_PRESETS[TINY32] = jcfg
    TORCH_PRESETS[TINY32] = _tcfg(jcfg)
    jp = jllama.init_params(jcfg, jax.random.key(11))
    yield jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del JAX_PRESETS[TINY32], TORCH_PRESETS[TINY32]


def _kw(**kw):
    d = dict(model=TINY32, block_size=4, num_blocks=96, max_batch_size=4,
             max_model_len=128, prefill_chunk=16, decode_bucket=(4,))
    d.update(kw)
    return d


def _decode(tokens) -> str:
    return ByteTokenizer(512).decode(tokens)


#: rid -> (prompt, max_tokens, guided_json): a json_object row, a
#: json_schema row and a plain sibling whose 40-token prompt takes 3
#: chunks, so real mixed steps run while the guided rows decode
REQS = {"obj": (PROMPT, 48, {}),
        "sch": ([(7 * j) % 90 for j in range(12)], 64, SCHEMA),
        "p": ([(3 * j) % 90 for j in range(40)], 12, None)}


def _reqs(proto, rids=tuple(REQS)):
    return [_req(proto, REQS[rid][0], rid, REQS[rid][1], guided_json=REQS[rid][2])
            for rid in rids]


@pytest.mark.parametrize("kv_dtype,unified", [("bfloat16", True), ("bfloat16", False),
                                              ("int8", True)],
                         ids=["bfloat16-unified", "bfloat16-legacy", "int8-unified"])
def test_guided_streams_match_jax(tiny32, kv_dtype, unified):
    """Guided (json_object, json_schema) and sibling plain greedy streams
    equal the JAX engine's, token for token, unified and legacy; every
    prefix is grammatical and a document that stopped before its budget
    conforms."""
    jp, tp = tiny32
    kw = _kw(kv_dtype=kv_dtype, unified_step=unified)
    tcore = teng.EngineCore(TEngineConfig(**kw), params=tp, device="cpu")
    got, fin = _run(tcore, _reqs(tproto))
    want, _ = _run(jeng.EngineCore(JEngineConfig(**kw), params=jp), _reqs(jproto))
    assert fin == set(got) and got == want
    for rid in ("obj", "sch"):
        schema, text = REQS[rid][2], _decode(got[rid])
        tguided.JsonMachine(schema).feed_str(text)
        if len(got[rid]) < REQS[rid][1]:
            tguided.validate_json_output(text, schema)
    assert any("masked" in k for k in tcore.runner.programs)
    assert tcore.metrics.guided_mask_steps > 0


def test_guided_beside_plain_leaves_plain_stream_alone(tiny32):
    _jp, tp = tiny32
    solo, _ = _run(teng.EngineCore(TEngineConfig(**_kw()), params=tp, device="cpu"),
                   _reqs(tproto, ("p",)))
    both, _ = _run(teng.EngineCore(TEngineConfig(**_kw()), params=tp, device="cpu"),
                   _reqs(tproto))
    assert both["p"] == solo["p"]


def test_guided_sampled_conforms_and_unified_equals_legacy(tiny32):
    """Sampling over the masked distribution: the output keeps the grammar,
    and the unified step gives the legacy path's stream."""
    _jp, tp = tiny32
    schema = {"type": "array", "items": {"type": "number"}}

    def run(unified):
        core = teng.EngineCore(TEngineConfig(**_kw(unified_step=unified)), params=tp,
                               device="cpu")
        out, _ = _run(core, [_req(tproto, PROMPT, "g", 48, guided_json=schema,
                                  temperature=0.9, seed=3),
                             _req(tproto, [(5 * j) % 70 for j in range(30)], "p", 10)])
        return out

    uni = run(True)
    assert uni == run(False)
    tguided.JsonMachine(schema).feed_str(_decode(uni["g"]))


def test_guided_sampled_masked_distribution_matches_jax(tiny32):
    """What a sampled guided token is drawn from, held to JAX: replaying
    the port's sampled stream through both packages' TokenMaskers gives
    the same allowed set at every step and every sampled token lies in
    it; the masked log-softmax at every step (one forward over prompt +
    stream in each package, same weights) agrees at atol = rtol = 1e-4."""
    jp, tp = tiny32
    schema = {"type": "array", "items": {"type": "number"}}
    core = teng.EngineCore(TEngineConfig(**_kw()), params=tp, device="cpu")
    out, _ = _run(core, [_req(tproto, PROMPT, "g", 48, guided_json=schema,
                              temperature=0.9, seed=3)])
    stream = out["g"]
    pieces, eos = core._guided_pieces()
    t, j = tguided.TokenMasker(pieces, eos, schema), jguided.TokenMasker(pieces, eos, schema)
    masks = []
    for tok in stream:
        tm = t.mask()
        np.testing.assert_array_equal(tm, j.mask())
        assert tm[tok]
        masks.append(tm)
        t.advance(tok)
        j.advance(tok)
    assert sum(int(m.sum()) > 1 for m in masks) >= 5   # steps with a real choice

    # position len(PROMPT) - 1 + i predicts stream[i]
    toks = np.asarray([PROMPT + stream[:-1]], np.int32)
    n, bs = toks.shape[1], 4
    cfg = TORCH_PRESETS[TINY32]
    nblk = -(-n // bs)
    shape = (cfg.num_layers, nblk + 1, bs, cfg.num_kv_heads, cfg.head_dim)
    args = (toks, np.zeros(1, np.int32), np.asarray([n], np.int32),
            np.arange(1, nblk + 1, dtype=np.int32)[None])
    zeros = np.zeros(shape, np.float32)
    jh, _, _ = jllama.forward(jp, JAX_PRESETS[TINY32], *(jax.numpy.asarray(a) for a in args),
                              jax.numpy.asarray(zeros), jax.numpy.asarray(zeros),
                              return_all_hidden=True)
    jl = np.asarray(jllama.logits_from_hidden(jp, JAX_PRESETS[TINY32], jh), np.float32)[0]
    th = tllama.forward(tp, cfg, *(torch.from_numpy(a) for a in args),
                        torch.zeros(shape), torch.zeros(shape), return_all_hidden=True)
    tl = tllama.logits_from_hidden(tp, cfg, th).float().numpy()[0]
    steps = slice(len(PROMPT) - 1, n)
    allowed = np.stack(masks)

    def masked_log_softmax(logits):
        x = np.where(allowed, logits[steps, : allowed.shape[1]], -np.inf)
        x = x - x.max(axis=1, keepdims=True)
        return np.where(allowed, x - np.log(np.exp(x).sum(axis=1, keepdims=True)), 0.0)

    np.testing.assert_allclose(masked_log_softmax(tl), masked_log_softmax(jl),
                               atol=1e-4, rtol=1e-4)


def test_guided_through_pipelined_engine_and_with_spec(tiny32):
    """AsyncTorchEngine's overlapped loop (guided rows run unpipelined)
    and a spec engine (guided rows never verify) give the sync stream."""
    _jp, tp = tiny32
    sync, _ = _run(teng.EngineCore(TEngineConfig(**_kw()), params=tp, device="cpu"),
                   [_req(tproto, PROMPT, "g", 40, guided_json={})])
    spec_core = teng.EngineCore(TEngineConfig(**_kw(spec_ngram=2, spec_k=4)), params=tp,
                                device="cpu")
    spec, _ = _run(spec_core, [_req(tproto, PROMPT, "g", 40, guided_json={})],
                   pipelined=True)
    assert spec == sync and spec_core.metrics.spec_proposed == 0
    engine = teng.AsyncTorchEngine(teng.EngineCore(TEngineConfig(**_kw()), params=tp,
                                                   device="cpu"))

    async def go():
        toks = []
        try:
            async for out in engine.generate(_req(tproto, PROMPT, "g", 40, guided_json={})):
                toks += out.token_ids
        finally:
            await engine.shutdown()
        return toks

    assert asyncio.run(go()) == sync["g"]
    tguided.JsonMachine({}).feed_str(_decode(sync["g"]))
