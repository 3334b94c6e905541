"""The port's model math against ``dynamo_tpu.models.llama`` on the same
inputs (numpy, seeded) and weights (bridged), in float32 on the CPU.

Tolerance: atol = rtol = 1e-4. Both sides compute in f32 but sum in a
different order (XLA vs ATen CPU kernels), which moves results by a few
f32 ulps per reduction; 1e-4 leaves room for that across two layers and
still catches any wrong mask, scale, layout or transpose.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.loader import from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
CKPT = Path(__file__).parent / "data" / "tiny-real-llama"
JCFG = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32")
TCFG = ModelConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(ModelConfig)})


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.key(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_building_blocks_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, TCFG.hidden_size)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(TCFG.hidden_size)).astype(np.float32)
    _close(tl.rms_norm(_t(x), _t(w), 1e-5), jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))

    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 5)).astype(np.int32)
    _close(tl.rope(_t(q), _t(pos), 500000.0),
           jl.rope(jnp.asarray(q), jnp.asarray(pos), 500000.0))

    ids = rng.integers(0, TCFG.vocab_size, size=(3, 7)).astype(np.int32)
    _close(tl.embed_lookup(tp["embed"], _t(ids), torch.float32),
           jl.embed_lookup(jp["embed"], jnp.asarray(ids), jnp.float32))

    lw = tp["layers"]
    jw = jp["layers"]
    _close(tl.mm(_t(x), lw["wq"][1]), jl.mm(jnp.asarray(x), jw["wq"][1]))
    _close(tl.swiglu(_t(x), lw["w_gate"][0], lw["w_up"][0], lw["w_down"][0]),
           jl.swiglu(jnp.asarray(x), jw["w_gate"][0], jw["w_up"][0], jw["w_down"][0]))

    hid = rng.standard_normal((3, TCFG.hidden_size)).astype(np.float32)
    _close(tl.logits_from_hidden(tp, TCFG, _t(hid)),
           jl.logits_from_hidden(jp, JCFG, jnp.asarray(hid)))


def test_scatter_gather_and_dense_attention_match_jax():
    rng = np.random.default_rng(1)
    nb, bs, kh, d, b, t, h = 12, 4, 2, 16, 2, 3, 4
    cache = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
    new = rng.standard_normal((b, t, kh, d)).astype(np.float32)
    slots = np.array([[5, 6, 7], [0, 0, 22]], np.int32)   # row 1: two padding writes
    jc = jl._scatter_kv(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(slots))
    tc = _t(cache)
    tl._scatter_kv(tc, _t(new), _t(slots))
    keep = np.ones((nb * bs,), bool)
    keep[0] = False                                        # duplicate writes: any winner
    np.testing.assert_array_equal(tc.numpy().reshape(nb * bs, kh, d)[keep],
                                  np.asarray(jc).reshape(nb * bs, kh, d)[keep])

    bt = np.array([[3, 1, 4], [2, 5, 9]], np.int32)
    _close(tl._gather_kv(tc, _t(bt)), jl._gather_kv(jc, jnp.asarray(bt)))

    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    ctx_k = rng.standard_normal((b, 12, kh, d)).astype(np.float32)
    ctx_v = rng.standard_normal((b, 12, kh, d)).astype(np.float32)
    pos = np.array([[4, 5, 6], [9, 10, 11]], np.int32)
    kv = np.array([7, 11], np.int32)
    _close(tl.paged_attention(*(_t(a) for a in (q, ctx_k, ctx_v, pos, kv))),
           jl.paged_attention(*(jnp.asarray(a) for a in (q, ctx_k, ctx_v, pos, kv))))


@pytest.mark.parametrize("mode", ["prefill", "decode", "mixed"])
def test_forward_matches_jax(params, mode):
    """Whole forward (2 layers): last hidden state and the KV written into
    the cache, for a fresh prefill, a decode step over it, and a ragged
    mixed batch with a padding row."""
    jp, tp = params
    rng = np.random.default_rng({"prefill": 2, "decode": 3, "mixed": 4}[mode])
    L, nb, bs = TCFG.num_layers, 24, 4
    shape = (L, nb, bs, TCFG.num_kv_heads, TCFG.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    if mode == "prefill":
        toks = rng.integers(0, TCFG.vocab_size, size=(3, 8))
        q_start, q_len = np.array([0, 0, 0]), np.array([8, 5, 8])
    elif mode == "decode":
        toks = rng.integers(0, TCFG.vocab_size, size=(3, 1))
        q_start, q_len = np.array([7, 12, 15]), np.array([1, 1, 1])
    else:
        toks = rng.integers(0, TCFG.vocab_size, size=(3, 8))
        q_start, q_len = np.array([9, 0, 0]), np.array([1, 8, 0])
    args = [a.astype(np.int32) for a in (toks, q_start, q_len, bt)]
    jh, jck, jcv = jl.forward(jp, JCFG, *(jnp.asarray(a) for a in args),
                              jnp.asarray(ck), jnp.asarray(cv))
    tck, tcv = _t(ck), _t(cv)
    th = tl.forward(tp, TCFG, *(_t(a) for a in args), tck, tcv)
    live = q_len > 0
    _close(th[live], np.asarray(jh)[live])
    # block 0 takes the padding writes; every other block must match
    _close(tck[:, 1:], np.asarray(jck)[:, 1:])
    _close(tcv[:, 1:], np.asarray(jcv)[:, 1:])


def test_init_params_shapes_and_law():
    jp = jl.init_params(JCFG, jax.random.key(0))
    tp = tl.init_params(TCFG, seed=0, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, a in jleaves:
        keys = [p.key for p in path]
        t = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, keys
        if "norm" in keys[-1]:
            assert bool((t == 1).all())
        else:  # N(0, 1/fan_in): fan_in is the contracted (second-to-last) dim
            fan_in = a.shape[-1] if keys[-1] == "embed" else a.shape[-2]
            assert abs(float(t.std()) * fan_in ** 0.5 - 1) < 0.1, keys
    again = tl.init_params(TCFG, seed=0, device="cpu")
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])


def test_loader_matches_jax_loader():
    from dynamo_tpu.models.config import ModelConfig as JModelConfig
    from dynamo_tpu.models.loader import load_params as jload
    from dynamo_tpu_torch.models.loader import load_params as tload

    for dtype in ("bfloat16", "float32"):
        jcfg = dataclasses.replace(JModelConfig.from_hf_config(str(CKPT)), dtype=dtype)
        tcfg = dataclasses.replace(ModelConfig.from_hf_config(str(CKPT)), dtype=dtype)
        jp = jax.tree.map(np.asarray, jload(jcfg, CKPT))
        tp = tload(tcfg, CKPT, device="cpu")
        for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
            keys = [p.key for p in path]
            t = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
            assert t.dtype == getattr(torch, dtype), keys
            if dtype == "bfloat16":
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)
