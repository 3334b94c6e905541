"""The MoE model family in the port (``moe_mlp``, its leaves, init, the
loader's two checkpoint families, the engine at one device) against the
JAX package's dense-dispatch path (``moe_impl="dense"``, what JAX runs at
ep = 1), on the CPU at ``tiny-moe`` width.

Tolerances, with their reasons:
- ``moe_mlp`` in f32: atol = rtol = 1e-5 (the f32 combine over 8 experts
  and the expert products sum in other orders than XLA's); in bf16: 2e-2
  of the largest output (each expert's output and the shared expert are
  rounded to bf16 on the way, as in JAX);
- expert ids under total routing skew and an exact router tie: equal
  (``lax.top_k`` puts the lower index first on equal values);
- the forward's logits in bf16: within 2e-2 of the largest logit; in f32
  1e-4, as ``tests/test_torch_llama.py`` holds the dense forward;
- the loader: bit for bit; engines: identical greedy streams at f32.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.models.loader import load_params as jload
from dynamo_tpu.models.loader import save_safetensors
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.models.loader import load_params as tload
from dynamo_tpu_torch.parallel import mesh as tmesh
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import ROOT, _tcfg
from tests.test_torch_quant import PROMPTS, _assert_trees_equal, _kw, _np, _streams

MOE32 = "tiny-moe-f32"
JCFG = dataclasses.replace(JAX_PRESETS["tiny-moe"], dtype="float32", name=MOE32)
TCFG = _tcfg(JCFG)


@pytest.fixture(scope="module")
def moe32():
    """tiny-moe at f32 as a preset of both packages: JAX's params and the
    port's tree of the same values."""
    JAX_PRESETS[MOE32], TORCH_PRESETS[MOE32] = JCFG, TCFG
    jp = jl.init_params(JCFG, jax.random.key(0))
    yield jp, from_jax_params(_np(jp), device="cpu")
    del JAX_PRESETS[MOE32], TORCH_PRESETS[MOE32]


def _layer(tree, li):
    return {k: v[li] for k, v in tree["layers"].items()}


def test_moe_leaves_axes_and_init_match_jax():
    """init_params' MoE leaves have JAX's shapes and law (the expert stacks
    drawn a slab at a time), and param_logical_axes equals JAX's."""
    assert tmesh.param_logical_axes(TCFG) == jl.param_logical_axes(JCFG)
    jp = jl.init_params(JCFG, jax.random.key(0))
    tp = tl.init_params(TCFG, seed=0, device="cpu")
    for key, a in jp["layers"].items():
        t = tp["layers"][key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, key
        if "norm" not in key:
            assert abs(float(t.std()) * a.shape[-2] ** 0.5 - 1) < 0.15, key
    stack = TCFG.hidden_size * TCFG.moe_intermediate_size
    mp = pytest.MonkeyPatch()
    try:   # three experts a draw: slabs that do not divide L * E = 16
        mp.setattr(tl, "EXPERT_SLAB_ELEMS", 3 * stack)
        again = tl.init_params(TCFG, seed=0, device="cpu")
        assert torch.equal(again["layers"]["w_up"], tl.init_params(TCFG, seed=0,
                                                                   device="cpu")["layers"]["w_up"])
    finally:
        mp.undo()
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])
    w = again["layers"]["w_up"]
    assert abs(float(w.std()) * TCFG.hidden_size ** 0.5 - 1) < 0.15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax(dtype):
    """Layer 1 of tiny-moe (8 experts, top-2, a shared expert) on 3 x 5
    tokens; again with the experts a slab of 3 at a time."""
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    jp = jl.init_params(jcfg, jax.random.key(3))
    tp = from_jax_params(_np(jp), device="cpu")
    _assert_trees_equal(tp, _np(jp))                     # the bridge, MoE leaves too
    x = np.random.default_rng(0).standard_normal((3, 5, jcfg.hidden_size)).astype(np.float32)
    ref = np.asarray(jl.moe_mlp(jnp.asarray(x, dtype=dtype), _layer(jp, 1), jcfg))
    ref = ref.astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    mp = pytest.MonkeyPatch()
    outs = [tl.moe_mlp(tx, _layer(tp, 1), _tcfg(jcfg))]
    try:
        mp.setattr(tl, "MOE_SLAB_BYTES", 3 * 4 * 15 * jcfg.hidden_size)
        outs.append(tl.moe_mlp(tx, _layer(tp, 1), _tcfg(jcfg)))
    finally:
        mp.undo()
    for got in outs:
        assert got.dtype == tx.dtype
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
        else:
            assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["skew", "tie"])
def test_routing_skew_and_ties_keep_jax_expert_ids(case):
    """Every token routed to expert 3 first (total skew), and an exact
    three-way tie of experts 1, 4 and 6 for the two slots: the port's
    top-k ids equal ``lax.top_k``'s (lower index first on equal values)
    and ``moe_mlp`` equals JAX's."""
    jp = jl.init_params(JCFG, jax.random.key(5))
    lp = _layer(jp, 0)
    h, e = JCFG.hidden_size, JCFG.num_experts
    rng = np.random.default_rng(1)
    v = rng.standard_normal(h).astype(np.float32)
    x = (np.abs(rng.standard_normal((2, 6, 1))) * v + 0.01 * rng.standard_normal((2, 6, h)))
    x = x.astype(np.float32)
    router = 0.01 * rng.standard_normal((h, e)).astype(np.float32)
    if case == "skew":
        router[:, 3] = v
    else:
        for col in (1, 4, 6):
            router[:, col] = v
    lp = dict(lp, router=jnp.asarray(router))
    xt = x.reshape(-1, h)
    jlogits = jnp.asarray(xt) @ lp["router"]
    jv, ji = lax.top_k(jlogits, JCFG.num_experts_per_tok)
    tlogits = torch.from_numpy(xt) @ torch.from_numpy(router)
    tv, ti = tl.top_k(tlogits, JCFG.num_experts_per_tok)
    if case == "skew":
        assert (np.asarray(ji)[:, 0] == 3).all()
    else:
        for logits in (np.asarray(jlogits), tlogits.numpy()):
            ties = logits[:, [1, 4, 6]]
            assert (ties == ties[:, :1]).all()               # an exact tie in both
        assert (np.asarray(ji) == [1, 4]).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    tlp = {k: torch.from_numpy(np.asarray(a).copy()) for k, a in lp.items()}
    np.testing.assert_allclose(tl.moe_mlp(torch.from_numpy(x), tlp, TCFG).numpy(),
                               np.asarray(jl.moe_mlp(jnp.asarray(x), lp, JCFG)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_jax(dtype):
    """A ragged prefill (one padding row), then a decode step, through both
    forwards at tiny-moe width: the logits of the live rows."""
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    tcfg = _tcfg(jcfg)
    jp = jl.init_params(jcfg, jax.random.key(0))
    tp = from_jax_params(_np(jp), device="cpu")
    rng = np.random.default_rng(6)
    shape = (jcfg.num_layers, 24, 4, jcfg.num_kv_heads, jcfg.head_dim)
    jck = jcv = jnp.zeros(shape, dtype)
    tck, tcv = (torch.zeros(shape, dtype=getattr(torch, dtype)) for _ in range(2))
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    for toks, qs, ql in [(rng.integers(0, jcfg.vocab_size, size=(3, 8)), [0, 0, 0], [8, 5, 0]),
                         (rng.integers(0, jcfg.vocab_size, size=(3, 1)), [8, 5, 0], [1, 1, 0])]:
        args = [np.asarray(a, np.int32) for a in (toks, qs, ql, bt)]
        jh, jck, jcv = jl.forward(jp, jcfg, *(jnp.asarray(a) for a in args), jck, jcv)
        th = tl.forward(tp, tcfg, *(torch.from_numpy(a) for a in args), tck, tcv)
        live = args[2] > 0
        ref = np.asarray(jl.logits_from_hidden(jp, jcfg, jh)).astype(np.float32)[live]
        got = tl.logits_from_hidden(tp, tcfg, th).float().numpy()[live]
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        else:
            assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("quantization", ["none", "int8"])
def test_moe_engine_streams_equal_jax(moe32, quantization):
    """tiny-moe at f32 through both engines (int8: the shared expert and
    the attention matrices quantized, the expert stacks not): identical
    greedy streams; the port's runs pipelined."""
    jp, full = moe32
    kw = _kw(MOE32, quantization=quantization)
    core = teng.EngineCore(TEngineConfig(**kw), params=full, device="cpu")
    got, _ = _streams(core, tproto, pipelined=True)
    want, _ = _streams(jeng.EngineCore(JEngineConfig(**kw), params=jax.tree.map(jnp.copy, jp)),
                       jproto)
    assert got == want
    assert all(len(t) > 0 for t in got.values()) and len(got) == len(PROMPTS)


def test_moe_refusals():
    """MoE at tp > 1 and at ep > 1 is served since the expert axis came
    (tests/test_torch_moe_parallel*.py hold those engines to JAX's); an
    expert count that does not divide over ep is refused by name, and so
    are pp with ep (JAX's words: pp composes with dp only) and sp; tp = 1
    is served."""
    base = dict(model="tiny-moe", block_size=4, num_blocks=16, max_batch_size=2,
                max_model_len=64, warmup_mode="off")
    cfg = TORCH_PRESETS["tiny-moe"]
    for mesh in (dict(tp=2), dict(ep=2), dict(tp=2, ep=2), dict(ep=8, dp=2)):
        teng.check_supported(TEngineConfig(**base, **mesh, dist_backend="gloo"), cfg)
    with pytest.raises(ValueError, match="num_experts=8 does not divide over ep=3"):
        teng.EngineCore(TEngineConfig(**base, ep=3, dist_backend="gloo"), device="cpu")
    for setting, match in ((dict(pp=2, ep=2), "pp>1 currently composes only with dp"),
                           (dict(sp=2), "sp > 1")):
        with pytest.raises(ValueError, match=match):
            teng.EngineCore(TEngineConfig(**base, **setting), device="cpu")
    core = teng.EngineCore(TEngineConfig(**base), device="cpu")
    assert core.runner.params["layers"]["w_gate"].shape[:2] == (2, 8)


# ---------------------------------------------------------------------------
# the loader's MoE families
# ---------------------------------------------------------------------------

def _moe_checkpoint(path, cfg, family: str, seed: int) -> None:
    """An HF-layout MoE checkpoint of ``family`` (mixtral or deepseek)
    with random values, and its config.json."""
    rng = np.random.default_rng(seed)
    h, m, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    t = {"model.embed_tokens.weight": (cfg.vocab_size, h), "model.norm.weight": (h,)}
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        t.update({p + "self_attn.q_proj.weight": (cfg.q_size, h),
                  p + "self_attn.k_proj.weight": (cfg.kv_size, h),
                  p + "self_attn.v_proj.weight": (cfg.kv_size, h),
                  p + "self_attn.o_proj.weight": (h, cfg.q_size),
                  p + "input_layernorm.weight": (h,),
                  p + "post_attention_layernorm.weight": (h,)})
        if family == "mixtral":
            t[p + "block_sparse_moe.gate.weight"] = (e, h)
            for x in range(e):
                q = f"{p}block_sparse_moe.experts.{x}."
                t.update({q + "w1.weight": (m, h), q + "w3.weight": (m, h),
                          q + "w2.weight": (h, m)})
        else:
            t[p + "mlp.gate.weight"] = (e, h)
            for name, shape in (("gate_proj", (m, h)), ("up_proj", (m, h)),
                                ("down_proj", (h, m))):
                t[f"{p}mlp.shared_experts.{name}.weight"] = shape
                for x in range(e):
                    t[f"{p}mlp.experts.{x}.{name}.weight"] = shape
    save_safetensors(path / "model.safetensors",
                     {k: rng.standard_normal(s).astype(np.float32) for k, s in t.items()})
    keys = ({"num_local_experts": e} if family == "mixtral"
            else {"n_routed_experts": e, "n_shared_experts": 1})
    (path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": h, "intermediate_size": 2 * m,
        "moe_intermediate_size": m, "num_experts_per_tok": 2,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "tie_word_embeddings": True, **keys}))


@pytest.mark.parametrize("family", ["mixtral", "deepseek"])
def test_moe_loader_matches_jax_loader(tmp_path, family):
    """Both MoE naming families load into the same leaves as JAX's loader,
    bit for bit at f32 and bf16 (the router and expert stacks transposed
    to [in, out]); the family's errors are JAX's."""
    cfg = JModelConfig(name="ckpt-moe", vocab_size=64, hidden_size=16, num_layers=2,
                       num_heads=2, num_kv_heads=2, head_dim=8, num_experts=4,
                       num_experts_per_tok=2, moe_intermediate_size=24,
                       num_shared_experts=int(family == "deepseek"))
    _moe_checkpoint(tmp_path, cfg, family, seed=5)
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(JModelConfig.from_hf_config(str(tmp_path)), dtype=dtype)
        tcfg = dataclasses.replace(TModelConfig.from_hf_config(str(tmp_path)), dtype=dtype)
        assert tcfg.is_moe and tcfg.num_shared_experts == cfg.num_shared_experts
        tp = tload(tcfg, tmp_path, device="cpu")
        _assert_trees_equal(tp, _np(jload(jcfg, tmp_path)))
        assert tp["layers"]["w_down"].shape == (2, 4, 24, 16)
    wrong = dataclasses.replace(tcfg, num_shared_experts=1 - cfg.num_shared_experts)
    if family == "mixtral":
        with pytest.raises(ValueError, match="mixtral-style names"):
            tload(wrong, tmp_path, device="cpu")
    else:
        with pytest.raises(KeyError, match="shared_experts|family=deepseek"):
            tload(dataclasses.replace(wrong, num_shared_experts=2, num_experts=5),
                  tmp_path, device="cpu")
    dense = tmp_path / "dense"
    dense.mkdir()
    save_safetensors(dense / "model.safetensors",
                     {"model.embed_tokens.weight": np.zeros((64, 16), np.float32)})
    with pytest.raises(ValueError, match="no recognized MoE router"):
        tload(tcfg, dense, device="cpu")


def test_launcher_serves_tiny_moe_int8_on_cpu(tmp_path):
    src = tmp_path / "prompts.jsonl"
    src.write_text('{"prompt": "one two three four", "max_tokens": 6}\n')
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
         "--model", "tiny-moe", "--device", "cpu", "--block-size", "4", "--num-blocks", "32",
         "--max-model-len", "64", "--max-batch-size", "2", "--quantization", "int8",
         "--input-jsonl", str(src)],
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["tokens"] == 6
    assert "skipped MoE expert tensors" in res.stderr
