"""MoE across ranks in the port, one process: ``models/moe.py`` (routing,
the dropless and the capacity dispatch, ``expert_capacity``), the
dropless partials of a (tp, ep) mesh summed single-controller, the
param shards on the "model" and "expert" axes, the sharded loader and
init, and the forward's ``moe_impl`` — each against the JAX package's
function on the CPU (meshes of the fake devices ``tests/conftest.py``
provides). Inputs are drawn with numpy from a seed; tiny-moe (8 experts,
top 2, a shared expert, ``moe_intermediate_size`` 64) at f32, and a
variant with no shared expert.

Tolerances, with their reasons:
- f32 routing, dispatches and partial sums: atol = rtol = 1e-5 (the f32
  combine and the expert products sum in other orders than XLA's:
  ``tests/test_torch_moe.py`` holds ``moe_mlp`` to the same);
- expert ids, capacity and shards: exact (the same ``lax.top_k`` tie
  order; slices of the same values);
- bf16 forward logits: within 2e-2 of the largest logit, as
  ``tests/test_torch_moe.py`` holds the bf16 dense forward (each expert's
  output is rounded to bf16 on the way in both packages); f32 forward
  logits 1e-4, as the dense forward.

The multi-rank engines are in ``tests/test_torch_moe_parallel_engine.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import moe as jmoe
from dynamo_tpu.models import quant as jq
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.parallel.mesh import shard_params as jshard_params
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import moe as tmoe
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.models.loader import load_params as tload
from dynamo_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_engine import _tcfg
from tests.test_torch_moe import _moe_checkpoint
from tests.test_torch_quant import _np

TOL = dict(atol=1e-5, rtol=1e-5)
JCFG = dataclasses.replace(JAX_PRESETS["tiny-moe"], dtype="float32", name="tiny-moe-f32-par")
TCFG = _tcfg(JCFG)
SHARED = {"shared": 1, "no_shared": 0}


def _cfgs(shared: int = 1, dtype: str = "float32"):
    jcfg = dataclasses.replace(JCFG, num_shared_experts=shared, dtype=dtype)
    return jcfg, _tcfg(jcfg)


@functools.cache
def _params(shared: int = 1, dtype: str = "float32", seed: int = 0):
    """JAX's params of tiny-moe (with or without the shared expert) and
    the port's full tree of the same values."""
    jcfg, _ = _cfgs(shared, dtype)
    jp = jl.init_params(jcfg, jax.random.key(seed))
    return jp, from_jax_params(_np(jp), device="cpu")


def _layer(tree, li: int = 1):
    return {k: v[li] for k, v in tree["layers"].items()}


def _x(shape=(2, 16), seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*shape, JCFG.hidden_size)).astype(np.float32)


def _skewed(jlp: dict, tlp: dict, expert: int) -> tuple[dict, dict]:
    """Both layers with a router that sends every token of positive
    entries (``abs`` of :func:`_x`) to ``expert`` first
    (tests/test_moe.py's total skew)."""
    bias = np.zeros((JCFG.hidden_size, JCFG.num_experts), np.float32)
    bias[:, expert] = 10.0
    return dict(jlp, router=jnp.asarray(bias)), dict(tlp, router=torch.from_numpy(bias))


# ---------------------------------------------------------------------------
# the bare functions at one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "skew"])
def test_router_topk_matches_jax(case):
    """Ids equal ``lax.top_k``'s (the lower index first on a tie), weights
    within the f32 tolerance."""
    jp, tp = _params()
    jlp, tlp = _layer(jp), _layer(tp)
    if case == "skew":
        jlp, tlp = _skewed(jlp, tlp, 3)
    x = np.abs(_x()) if case == "skew" else _x()
    xt = x.reshape(-1, JCFG.hidden_size)
    ji, jw = jmoe._router_topk(jnp.asarray(xt), jlp, JCFG)
    ti, tw = tmoe._router_topk(torch.from_numpy(xt), tlp, TCFG)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    if case == "skew":
        assert (ti[:, 0] == 3).all()


@pytest.mark.parametrize("shared", SHARED.values(), ids=SHARED.keys())
@pytest.mark.parametrize("case", ["random", "skew"])
def test_moe_mlp_dropless_matches_jax(shared, case):
    """``moe_mlp_dropless`` at ep = 1 against JAX's, and against the dense
    dispatch, under random routing and under total skew (every token's
    first choice is expert 0: the capacity formulation drops there, the
    dropless one stays exact)."""
    jcfg, tcfg = _cfgs(shared)
    jp, tp = _params(shared)
    jlp, tlp = _layer(jp), _layer(tp)
    if case == "skew":
        jlp, tlp = _skewed(jlp, tlp, 0)
    x = np.abs(_x()) if case == "skew" else _x()
    ref = np.asarray(jmoe.moe_mlp_dropless(jnp.asarray(x), jlp, jcfg))
    got = tmoe.moe_mlp_dropless(torch.from_numpy(x), tlp, tcfg)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), tl.moe_mlp(torch.from_numpy(x), tlp, tcfg).numpy(),
                               **TOL)
    if case == "skew":
        capped = tmoe.moe_mlp_ep(torch.from_numpy(x), tlp, tcfg, capacity_factor=1.0)
        assert not np.allclose(capped.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.1])
def test_moe_mlp_ep_matches_jax(capacity_factor):
    """The capacity formulation: at factor 8 nothing drops (equal to the
    dense dispatch); at 0.1 choices drop, the same ones as JAX's (equal
    outputs, and unequal to the dense dispatch)."""
    jp, tp = _params()
    jlp, tlp = _layer(jp), _layer(tp)
    x = _x()
    ref = np.asarray(jmoe.moe_mlp_ep(jnp.asarray(x), jlp, JCFG, capacity_factor))
    got = tmoe.moe_mlp_ep(torch.from_numpy(x), tlp, TCFG, capacity_factor)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    dense = tl.moe_mlp(torch.from_numpy(x), tlp, TCFG).numpy()
    if capacity_factor >= 8:
        np.testing.assert_allclose(got.numpy(), dense, **TOL)
    else:
        assert not np.allclose(got.numpy(), dense, atol=1e-4)


@pytest.mark.parametrize("args", [(64, 8, 2, 1.0), (1, 8, 1, 1.0), (32, 8, 2, 0.1),
                                  (2048, 128, 4, 2.0), (7, 3, 2, 1.25), (0, 8, 2, 8.0)])
def test_expert_capacity_matches_jax(args):
    assert tmoe.expert_capacity(*args) == jmoe.expert_capacity(*args)
    assert tmoe.expert_capacity(*args) % 8 == 0


# ---------------------------------------------------------------------------
# the sharded dropless dispatch, single-controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", SHARED.values(), ids=SHARED.keys())
@pytest.mark.parametrize("tp,ep", [(2, 2), (1, 8)])
@pytest.mark.parametrize("case", ["random", "skew"])
def test_sharded_dropless_partials_sum_to_jax_shard_map(tp, ep, shared, case):
    """The sum of every rank's f32 partial (``dropless_partial`` on the
    rank's shard of the layer: its experts and its slice of their width,
    the shared expert's slice over ep), cast once, equals JAX's
    ``shard_map`` over the same (tp, ep) mesh of fake devices."""
    jcfg, tcfg = _cfgs(shared)
    jp, tp_full = _params(shared)
    jlp, router = _layer(jp), None
    if case == "skew":
        jlp, tlp = _skewed(jlp, _layer(tp_full), 5)
        router = tlp["router"]
    x = np.abs(_x()) if case == "skew" else _x()
    mesh = make_mesh(JMeshConfig(tp=tp, ep=ep))
    ref = np.asarray(jax.jit(lambda a, w: jmoe.moe_mlp_dropless(a, w, jcfg, mesh=mesh))(
        jnp.asarray(x), jlp))
    total = torch.zeros((x.shape[0] * x.shape[1], x.shape[2]), dtype=torch.float32)
    for m in range(tp):
        for e in range(ep):
            lp = _layer(tmesh.shard_params(tp_full, tcfg, m, tp, e, ep))
            if router is not None:   # whole on every rank
                lp["router"] = router
            assert lp["w_gate"].shape == (JCFG.num_experts // ep, JCFG.hidden_size,
                                          JCFG.moe_intermediate_size // tp)
            total += tmoe.dropless_partial(torch.from_numpy(x), lp, tcfg, e, ep)
    np.testing.assert_allclose(total.reshape(x.shape).numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# shards, the sharded loader and init
# ---------------------------------------------------------------------------

def _shard_coords(shard, axes: tuple) -> dict[str, int]:
    """The (model, expert) position of a JAX addressable shard, from its
    slices on the dims those axes split."""
    pos = {}
    for dim, ax in enumerate(axes):
        mesh_axis = tmesh.PARAM_RULES.get(ax)
        if mesh_axis in ("model", "expert"):
            sl = shard.index[dim]
            size = shard.data.shape[dim]
            pos[mesh_axis] = (sl.start or 0) // size
    return pos


def _leaves(tree, axes, path=()):
    """(path, leaf, its logical axes) of a params tree, a quantized leaf's
    tensors on their own axes."""
    if isinstance(axes, dict):
        for k in axes:
            yield from _leaves(tree[k], axes[k], path + (k,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield path + (k,), v, tmesh.quantized_axes(axes, k)
    else:
        yield path, tree, axes


@pytest.mark.parametrize("tp,ep,int8", [(2, 1, False), (1, 2, False), (2, 2, False),
                                        (2, 1, True)])
def test_shard_params_matches_jax_addressable_shards(tp, ep, int8):
    """Every leaf of the rank at (m, e) equals JAX's addressable shard at
    that mesh position, bit for bit; the router is whole (JAX's lies on
    "expert" and its dropless ``shard_fn`` gathers it). int8: JAX's
    quantized-then-placed leaves against the shard of the port's quantized
    full tree."""
    jp, full = _params()
    mesh = make_mesh(JMeshConfig(tp=tp, ep=ep))
    jaxes = jl.param_logical_axes(JCFG)
    placed = jshard_params(jax.tree.map(jnp.copy, jp), jaxes, mesh)
    if int8:
        placed = jq.quantize_params_int8(placed, JCFG)
        full = tq.quantize_params_int8(full, TCFG)
    axes = tmesh.param_logical_axes(TCFG)
    assert axes == jaxes
    shards = {(m, e): tmesh.shard_params(full, TCFG, m, tp, e, ep)
              for m in range(tp) for e in range(ep)}
    whole = dict((p, v) for p, v, _ in _leaves(full, axes))
    checked = 0
    for path, jleaf, leaf_axes in _leaves(placed, axes):
        for shard in jleaf.addressable_shards:
            pos = _shard_coords(shard, leaf_axes)
            for (m, e), tree in shards.items():
                if pos.get("model", m) != m or pos.get("expert", e) != e:
                    continue
                got = dict((p, v) for p, v, _ in _leaves(tree, axes))[path]
                if path[-1] == "router":
                    np.testing.assert_array_equal(got.numpy(), whole[path].numpy())
                    continue
                assert tuple(got.shape) == shard.data.shape, path
                np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data),
                                              err_msg=str(path))
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("family", ["mixtral", "deepseek"])
def test_sharded_loader_and_init_equal_shard_params(tmp_path, family):
    """``load_params`` at each (m, e) of (2, 2) reads the rank's experts
    and width only, and equals ``shard_params`` of the full load;
    ``init_params`` at each (m, e) equals ``shard_params`` of the full
    draw (the same draws, the rank keeps its slice), with slabs of three
    experts."""
    cfg = JModelConfig(name="ckpt-moe", vocab_size=64, hidden_size=16, num_layers=2,
                       num_heads=2, num_kv_heads=2, head_dim=8, num_experts=4,
                       num_experts_per_tok=2, moe_intermediate_size=24,
                       num_shared_experts=int(family == "deepseek"))
    _moe_checkpoint(tmp_path, cfg, family, seed=7)
    tcfg = TModelConfig.from_hf_config(str(tmp_path))
    full = tload(tcfg, tmp_path, device="cpu")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tl, "EXPERT_SLAB_ELEMS", 3 * 16 * 24)
        drawn = tl.init_params(tcfg, seed=2, device="cpu")
        for m in range(2):
            for e in range(2):
                for got, want in ((tload(tcfg, tmp_path, device="cpu", rank=m, tp=2,
                                         expert=e, ep=2), tmesh.shard_params(full, tcfg, m, 2, e, 2)),
                                  (tl.init_params(tcfg, seed=2, device="cpu", rank=m, tp=2,
                                                  expert=e, ep=2),
                                   tmesh.shard_params(drawn, tcfg, m, 2, e, 2))):
                    axes = tmesh.param_logical_axes(tcfg)
                    for (path, a, _), (_, b, _) in zip(_leaves(got, axes), _leaves(want, axes),
                                                       strict=True):
                        assert torch.equal(a, b), (m, e, path)
                    assert got["layers"]["w_up"].shape == (2, 2, 16, 12)
                    assert got["layers"]["router"].shape == (2, 16, 4)
    finally:
        mp.undo()


def test_check_tp_names_each_moe_dim():
    """A MoE model is checked on its per-expert width over tp (the shared
    experts' width is a multiple of it) and its experts over ep, not on
    the dense ``intermediate_size``."""
    tmesh.check_tp(dataclasses.replace(TCFG, intermediate_size=7), 2, 2)
    with pytest.raises(ValueError, match="num_experts=8 does not divide over ep=3"):
        tmesh.check_tp(TCFG, 1, 3)
    with pytest.raises(ValueError, match="moe_intermediate_size=63 does not divide over tp=2"):
        tmesh.check_tp(dataclasses.replace(TCFG, moe_intermediate_size=63), 2)
    dense = dataclasses.replace(TCFG, num_experts=0, intermediate_size=7)
    with pytest.raises(ValueError, match="intermediate_size=7 does not divide over tp=2"):
        tmesh.check_tp(dense, 2)


# ---------------------------------------------------------------------------
# the forward's moe_impl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,moe_impl", [("float32", "ep"), ("float32", "ep_capacity"),
                                            ("bfloat16", "ep")])
def test_forward_moe_impl_matches_jax(dtype, moe_impl):
    """A ragged prefill (one padding row), then a decode step, through both
    forwards with ``moe_impl`` "ep" (dropless) or "ep_capacity" at one
    device: the logits of the live rows."""
    jcfg, tcfg = _cfgs(1, dtype)
    jp, tp = _params(1, dtype)
    rng = np.random.default_rng(6)
    shape = (jcfg.num_layers, 24, 4, jcfg.num_kv_heads, jcfg.head_dim)
    jck = jcv = jnp.zeros(shape, dtype)
    tck, tcv = (torch.zeros(shape, dtype=getattr(torch, dtype)) for _ in range(2))
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    for toks, qs, ql in [(rng.integers(0, jcfg.vocab_size, size=(3, 8)), [0, 0, 0], [8, 5, 0]),
                         (rng.integers(0, jcfg.vocab_size, size=(3, 1)), [8, 5, 0], [1, 1, 0])]:
        args = [np.asarray(a, np.int32) for a in (toks, qs, ql, bt)]
        jh, jck, jcv = jl.forward(jp, jcfg, *(jnp.asarray(a) for a in args), jck, jcv,
                                  moe_impl=moe_impl)
        th = tl.forward(tp, tcfg, *(torch.from_numpy(a) for a in args), tck, tcv,
                        moe_impl=moe_impl)
        live = args[2] > 0
        ref = np.asarray(jl.logits_from_hidden(jp, jcfg, jh)).astype(np.float32)[live]
        got = tl.logits_from_hidden(tp, tcfg, th).float().numpy()[live]
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        else:
            assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    with pytest.raises(ValueError, match="unknown moe_impl"):
        tl.forward(tp, tcfg, *(torch.from_numpy(a) for a in args), tck, tcv, moe_impl="x")


def test_top_k_ties_in_routing_match_lax():
    """An exact three-way router tie: the dropless dispatch's ids are
    ``lax.top_k``'s (lower index first) and its output equals JAX's."""
    jp, tp = _params()
    jlp, tlp = _layer(jp, 0), _layer(tp, 0)
    h, e = JCFG.hidden_size, JCFG.num_experts
    rng = np.random.default_rng(1)
    v = rng.standard_normal(h).astype(np.float32)
    x = (np.abs(rng.standard_normal((2, 6, 1))) * v).astype(np.float32)
    router = 0.01 * rng.standard_normal((h, e)).astype(np.float32)
    for col in (2, 5, 7):
        router[:, col] = v
    jlp, tlp = dict(jlp, router=jnp.asarray(router)), dict(tlp, router=torch.from_numpy(router))
    xt = x.reshape(-1, h)
    _, ji = lax.top_k(jnp.asarray(xt) @ jlp["router"], 2)
    ti, _ = tmoe._router_topk(torch.from_numpy(xt), tlp, TCFG)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(
        tmoe.moe_mlp_dropless(torch.from_numpy(x), tlp, TCFG).numpy(),
        np.asarray(jmoe.moe_mlp_dropless(jnp.asarray(x), jlp, JCFG)), **TOL)
