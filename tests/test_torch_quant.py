"""Weight-only int8 (``dynamo_tpu_torch/models/quant.py`` and the model's
int8 leaves) against ``dynamo_tpu/models/quant.py`` on the CPU.

Tolerances, with their reasons:
- the quantizer: byte for byte (``q``, ``so``, ``sr``), at f32 and bf16
  weights — both packages compute the scale as ``amax * f32(1/127)``
  (JAX's jitted ``amax / 127.0``, rewritten by XLA) and divide by it;
- ``mm``, ``embed_lookup``, ``logits_from_hidden`` over int8 leaves: in f32
  within 1e-6 of the largest output (a sum of 64 products in another
  order); in bf16 within one bf16 ulp (2^-7 relative) of each output plus
  1e-6 of the largest, the rounding the result is cast through (``swiglu``,
  three products and a silu rounded on the way, within 2^-7 of the
  largest output);
- a bf16 int8 forward's logits (2 layers of tiny-real-llama): within 2e-2
  of the largest logit, a few bf16 roundings a layer (2^-8 each);
- engines: identical greedy streams at f32; at tp=2 the streams equal
  JAX's tp=1 int8 streams, or first leave them at a near-tie (the two
  runs' log-probs of the chosen tokens within 1e-4), as
  ``tests/test_torch_tp.py`` holds tp=2 to tp=1.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import quant as jq
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.models.loader import load_params as jload
from dynamo_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.parallel.mesh import shard_params as jshard_params
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.models.loader import load_params as tload
from dynamo_tpu_torch.parallel import mesh as tmesh
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests import torch_tp_rank
from tests.test_torch_engine import CKPT, _req, _tcfg

TINY32 = "tiny-llama-f32-int8"
JCFG = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name=TINY32)
TCFG = _tcfg(JCFG)
NEAR_TIE = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(t, j, path=""):
    """Port tree ``t`` equals JAX tree ``j`` (numpy) bit for bit."""
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _assert_trees_equal(t[k], j[k], f"{path}/{k}")
        return
    assert tuple(t.shape) == j.shape, path
    np.testing.assert_array_equal(_bits(t), _jbits(j), err_msg=path)


def _moe_cfg(dtype):
    return dataclasses.replace(JAX_PRESETS["tiny-moe"], dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["tied", "untied", "moe"])
def test_quantizer_matches_jax_byte_for_byte(model, dtype):
    """q, so and sr of every leaf equal JAX's, on trees where the scale's
    true division and JAX's reciprocal multiply disagree for some
    channels; MoE expert stacks stay float (JAX's warning), the shared
    expert and the router-free matrices are quantized."""
    if model == "moe":
        jcfg = _moe_cfg(dtype)
    else:
        jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype=dtype,
                                   tie_word_embeddings=model == "tied")
    jp = jl.init_params(jcfg, jax.random.key(7))
    full = from_jax_params(_np(jp), device="cpu")
    want = _np(jq.quantize_params_int8(jax.tree.map(jnp.copy, jp), jcfg))
    got = tq.quantize_params_int8(full, _tcfg(jcfg))
    _assert_trees_equal(got, want)
    assert got["layers"]["wq"]["q"].dtype == torch.int8
    if model == "moe":
        for key in ("w_gate", "w_up", "w_down", "router"):
            assert not tq.is_quantized(got["layers"][key]), key
        assert tq.is_quantized(got["layers"]["shared_down"])
    else:
        assert ("lm_head" in got) == (model == "untied")
    # the case trouble: some channel's true quotient is not the reciprocal product
    amax = full["layers"]["wq"].float().abs().amax(dim=-2)
    true_div = amax / torch.full_like(amax, 127.0)
    assert bool((true_div != got["layers"]["wq"]["so"]).any())
    assert torch.equal(got["layers"]["wq"]["so"], torch.clamp_min(amax * (1.0 / 127.0), 1e-12))


def test_dequantize_param_bytes_idempotence_and_refusal():
    jp = jl.init_params(JCFG, jax.random.key(0))
    full = from_jax_params(_np(jp), device="cpu")
    q1 = tq.quantize_params_int8(full, TCFG)
    assert tq.quantize_params_int8(q1, TCFG)["layers"]["wq"] is q1["layers"]["wq"]
    jq1 = jq.quantize_params_int8(jax.tree.map(jnp.copy, jp), JCFG)
    _assert_trees_equal(from_jax_params(_np(jq1), device="cpu"), _np(jq1))   # the bridge
    _assert_trees_equal(tq.dequantize_params(q1), _np(jq.dequantize_params(jq1)))
    assert tq.param_bytes(q1) == jq.param_bytes(jq1)
    assert tq.param_bytes(full) == jq.param_bytes(jp)
    deq = tq.dequantize_params(q1)["layers"]["wq"]
    err = (deq - full["layers"]["wq"]).abs()
    assert bool((err <= q1["layers"]["wq"]["so"][:, None, :] / 2 + 1e-7).all())
    with pytest.raises(ValueError, match="unknown quantization 'fp4'"):
        teng.EngineCore(TEngineConfig(model="tiny-llama", block_size=4, num_blocks=16,
                                      max_batch_size=2, max_model_len=64,
                                      quantization="fp4"), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_building_blocks_match_jax(dtype):
    """mm, the row-quantized embedding lookup and the tied and untied
    logits over the same int8 leaves, with JAX's casts."""
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    out = {}
    for tied in (True, False):
        jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype=dtype,
                                   tie_word_embeddings=tied)
        jp = jq.quantize_params_int8(jl.init_params(jcfg, jax.random.key(2)), jcfg)
        tp = from_jax_params(_np(jp), device="cpu")
        x = rng.standard_normal((3, 5, jcfg.hidden_size)).astype(np.float32)
        jx, tx = jnp.asarray(x, dtype=dtype), torch.from_numpy(x).to(tdt)
        ids = rng.integers(0, jcfg.vocab_size, size=(3, 7)).astype(np.int32)
        out[f"mm tied={tied}"] = (tl.mm(tx, tq.layer_leaf(tp["layers"]["wq"], 1)),
                                  jl.mm(jx, jax.tree.map(lambda a: a[1], jp["layers"]["wq"])))
        out[f"swiglu tied={tied}"] = (
            tl.swiglu(tx, *(tq.layer_leaf(tp["layers"][k], 0)
                            for k in ("w_gate", "w_up", "w_down"))),
            jl.swiglu(jx, *(jax.tree.map(lambda a: a[0], jp["layers"][k])
                            for k in ("w_gate", "w_up", "w_down"))))
        out[f"embed tied={tied}"] = (tl.embed_lookup(tp["embed"], torch.from_numpy(ids), tdt),
                                     jl.embed_lookup(jp["embed"], jnp.asarray(ids), jnp.dtype(dtype)))
        out[f"logits tied={tied}"] = (tl.logits_from_hidden(tp, _tcfg(jcfg), tx[:, 0]),
                                      jl.logits_from_hidden(jp, jcfg, jx[:, 0]))
    for name, (t, j) in out.items():
        assert t.dtype == tdt, name
        got, ref = t.float().numpy(), np.asarray(j).astype(np.float32)
        scale = np.abs(ref).max()
        if dtype == "float32":
            assert np.abs(got - ref).max() <= 1e-6 * scale, name
        elif name.startswith("swiglu"):
            # three products and silu, each rounded to bf16 on the way
            assert np.abs(got - ref).max() <= 2.0**-7 * scale, name
        else:
            assert (np.abs(got - ref) <= 2.0**-7 * np.abs(ref) + 1e-6 * scale).all(), name


# ---------------------------------------------------------------------------
# forward and engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny32():
    """tiny-llama at f32 as a preset of both packages: JAX's float params
    and the port's tree of the same values."""
    JAX_PRESETS[TINY32], TORCH_PRESETS[TINY32] = JCFG, TCFG
    jp = jl.init_params(JCFG, jax.random.key(0))
    yield jp, from_jax_params(_np(jp), device="cpu")
    del JAX_PRESETS[TINY32], TORCH_PRESETS[TINY32]


PROMPTS = [[1, 5, 9, 20, 33], list(range(3, 40)), [7] * 11 + [100, 200, 250]]
MAX_TOKENS = [8, 8, 12]


def _kw(model, **kw):
    d = dict(model=model, block_size=4, num_blocks=64, max_batch_size=8,
             max_model_len=256, prefill_chunk=32, decode_bucket=(4, 8), quantization="int8")
    d.update(kw)
    return d


def _reqs(proto, tag=""):
    return [_req(proto, p, f"{tag}r{i}", m)
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


def _streams(core, proto, pipelined=False):
    """Greedy tokens and their log-probs by request."""
    reqs = _reqs(proto)
    for r in reqs:
        assert core.add_request(r) is None
    toks = {r.request_id: [] for r in reqs}
    lps = {r.request_id: [] for r in reqs}
    pending = None
    while core.has_work() or pending is not None:
        outs = {}
        if pipelined:
            nxt = core.step_begin() if core.has_work() else None
            if pending is not None:
                outs = core.step_finalize(pending)
            pending = nxt
        else:
            outs = core.step()
        for rid, o in outs.items():
            toks[rid] += o.token_ids
            lps[rid] += o.log_probs or []
    return toks, lps


def _jax_streams(jp, **kw):
    # the JAX runner donates the float leaves to its quantizer: give it a copy
    return _streams(jeng.EngineCore(JEngineConfig(**kw), params=jax.tree.map(jnp.copy, jp)),
                    jproto)


def test_int8_forward_matches_jax(tiny32):
    """A ragged prefill (one padding row) then a decode step over the same
    int8 params: hidden states within the f32 forward's 1e-4."""
    jp, _ = tiny32
    jqp = jq.quantize_params_int8(jax.tree.map(jnp.copy, jp), JCFG)
    tqp = from_jax_params(_np(jqp), device="cpu")
    rng = np.random.default_rng(4)
    nb, bs = 24, 4
    shape = (JCFG.num_layers, nb, bs, JCFG.num_kv_heads, JCFG.head_dim)
    jck = jcv = jnp.zeros(shape, jnp.float32)
    tck, tcv = torch.zeros(shape), torch.zeros(shape)
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    steps = [(rng.integers(0, JCFG.vocab_size, size=(3, 8)), [0, 0, 0], [8, 5, 0]),
             (rng.integers(0, JCFG.vocab_size, size=(3, 1)), [8, 5, 0], [1, 1, 0])]
    for toks, qs, ql in steps:
        args = [np.asarray(a, np.int32) for a in (toks, qs, ql, bt)]
        jh, jck, jcv = jl.forward(jqp, JCFG, *(jnp.asarray(a) for a in args), jck, jcv)
        th = tl.forward(tqp, TCFG, *(torch.from_numpy(a) for a in args), tck, tcv)
        live = args[2] > 0
        np.testing.assert_allclose(th.numpy()[live], np.asarray(jh)[live], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tl.logits_from_hidden(tqp, TCFG, th).numpy()[live],
                                   np.asarray(jl.logits_from_hidden(jqp, JCFG, jh))[live],
                                   atol=1e-4, rtol=1e-4)


def test_int8_engine_streams_equal_jax(tiny32):
    """tiny-llama at f32 with int8 weights: the port's engine (quantizing
    the float tree itself, pipelined) gives JAX's int8 engine's greedy
    streams, and they differ from the float engine's somewhere."""
    jp, full = tiny32
    kw = _kw(TINY32)
    core = teng.EngineCore(TEngineConfig(**kw), params=full, device="cpu")
    assert tq.is_quantized(core.runner.params["layers"]["wo"])
    assert core.perf.quantization == "int8"       # the step profiler prices int8 weights
    got, _ = _streams(core, tproto, pipelined=True)
    want, _ = _jax_streams(jp, **kw)
    assert got == want
    plain, _ = _streams(teng.EngineCore(TEngineConfig(**_kw(TINY32, quantization="none")),
                                        params=full, device="cpu"), tproto)
    assert plain != got


def test_int8_bf16_on_the_trained_checkpoint():
    """tiny-real-llama at its bf16 dtype, int8: the forward's logits stay
    within 2e-2 of JAX's largest logit, and the engine continues "one two
    three four" as the float model does, with JAX's int8 engine's greedy
    tokens."""
    from dynamo_tpu_torch.tokenizer import load_tokenizer

    jcfg = JModelConfig.from_hf_config(str(CKPT))
    tcfg = _tcfg(jcfg)
    jqp = jq.quantize_params_int8(jload(jcfg, CKPT), jcfg)
    tqp = tq.quantize_params_int8(tload(tcfg, CKPT, device="cpu"), tcfg)
    _assert_trees_equal(tqp, _np(jqp))
    tok = load_tokenizer(str(CKPT))
    ids = np.asarray([tok.encode("one two three four", add_bos=True)], np.int32)
    n = ids.shape[1]
    shape = (jcfg.num_layers, 8, 4, jcfg.num_kv_heads, jcfg.head_dim)
    args = [ids, np.array([0], np.int32), np.array([n], np.int32),
            np.arange(1, 5, dtype=np.int32)[None]]
    jh, _, _ = jl.forward(jqp, jcfg, *(jnp.asarray(a) for a in args),
                          jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16))
    th = tl.forward(tqp, tcfg, *(torch.from_numpy(a) for a in args),
                    torch.zeros(shape, dtype=torch.bfloat16),
                    torch.zeros(shape, dtype=torch.bfloat16))
    ref = np.asarray(jl.logits_from_hidden(jqp, jcfg, jh)).astype(np.float32)
    got = tl.logits_from_hidden(tqp, tcfg, th).float().numpy()
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    assert got.argmax() == ref.argmax()
    kw = dict(model=str(CKPT), block_size=4, num_blocks=64, max_batch_size=2,
              max_model_len=128, quantization="int8")
    out = {}
    for name, core, proto in (("port", teng.EngineCore(TEngineConfig(**kw), device="cpu"),
                               tproto),
                              ("jax", jeng.EngineCore(JEngineConfig(**kw)), jproto)):
        assert core.add_request(_req(proto, ids[0].tolist(), "c", 8)) is None
        out[name] = []
        while core.has_work():
            for o in core.step().values():
                out[name] += o.token_ids
    assert tok.decode(out["port"]).startswith(" five six seven eight")
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# int8 under tensor parallelism
# ---------------------------------------------------------------------------

def test_int8_shards_equal_jax_quantized_then_placed(tiny32, tmp_path):
    """Each rank of a gloo group of two quantizes its shard of the float
    tree (the row-parallel scales over the group): every leaf equals JAX's
    quantized-then-placed leaves on a tp=2 mesh at that rank's position,
    and shard_params of the port's quantized full tree."""
    jp, full = tiny32
    mesh = make_mesh(JMeshConfig(tp=2))
    placed = jq.quantize_params_int8(jshard_params(jax.tree.map(jnp.copy, jp),
                                                   jl.param_logical_axes(JCFG), mesh), JCFG)
    got = torch_tp_rank.run_ranks(torch_tp_rank.quantize_rank, 2, tmp_path, TCFG, full)
    whole = tq.quantize_params_int8(full, TCFG)
    axes = tmesh.param_logical_axes(TCFG)

    def leaves(tree, path=()):
        if isinstance(tree, dict) and not tq.is_quantized(tree):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif tq.is_quantized(tree):
            for k, v in tree.items():
                yield path + (k,), v
        else:
            yield path, tree

    jleaves = dict(leaves(placed))
    for rank, shard in enumerate(got):
        ref = dict(leaves(tmesh.shard_params(whole, TCFG, rank, 2)))
        for path, arr in leaves(shard):
            leaf_axes = axes
            for key in path[:-1] if path[-1] in ("q", "so", "sr") else path:
                leaf_axes = leaf_axes[key]
            if path[-1] in ("q", "so", "sr"):
                leaf_axes = tmesh.quantized_axes(leaf_axes, path[-1])
            split = [d for d, ax in enumerate(leaf_axes) if tmesh.PARAM_RULES.get(ax) == "model"]
            jshard = next(s for s in jleaves[path].addressable_shards
                          if not split or (s.index[split[0]].start or 0)
                          == rank * s.data.shape[split[0]])
            np.testing.assert_array_equal(arr, np.asarray(jshard.data), err_msg=str(path))
            np.testing.assert_array_equal(arr, ref[path].numpy(), err_msg=str(path))


def test_int8_engine_tp2_matches_jax_tp1(tiny32):
    """The port's EngineCore(tp=2, int8) on the float tree: its streams
    equal JAX's tp=1 int8 engine's, or first leave them at a near-tie."""
    jp, full = tiny32
    kw = _kw(TINY32)
    core = teng.EngineCore(TEngineConfig(**kw, tp=2, dist_backend="gloo", warmup_mode="off"),
                           params=full, device="cpu")
    try:
        got, got_lps = _streams(core, tproto, pipelined=True)
        ranks = core.tp_stats()
    finally:
        core.close()
    want, want_lps = _jax_streams(jp, **kw)
    assert all((r["heads"], r["kv_heads"]) == (2, 1) for r in ranks)
    for rid, toks in got.items():
        j = next((j for j, (a, b) in enumerate(zip(toks, want[rid])) if a != b), None)
        assert j is None or abs(got_lps[rid][j] - want_lps[rid][j]) < NEAR_TIE, (rid, j)
        assert len(toks) == len(want[rid])
