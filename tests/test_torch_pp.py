"""Pipeline parallelism of the port (``models/llama.forward_pp``, the
stage layout of ``parallel/mesh.py``) against the JAX package's "pipe"
mesh axis, on the CPU: each stage is a process of its own over a gloo
group (``tests/torch_pp_rank.py``), and JAX runs on a pp=2 mesh of the
fake CPU devices ``tests/conftest.py`` provides. tiny-llama and tiny-moe
at f32 (2 layers: a layer a stage).

Tolerances, with their reasons:
- ``shard_params``, the stage's draws and the stage's loader: exact
  (slices of the same values);
- the forward at pp=2: atol = rtol = 1e-4 (``FWD_TOL``), as
  ``tests/test_torch_tp.py`` holds the forward at tp=2; JAX attends
  through its Pallas kernel in interpret mode in the microbatched
  schedule and through its dense path in the sequential one (ROADMAP,
  gaps in the reference), the port through its kernel's plain version in
  both;
- the stages' caches: 1e-4 too, every block but the trash block 0, which
  JAX's bubble ticks write and the port's idle stages do not;
- an int8 cache written in a chunk's sub-chunks: byte for byte against
  JAX's scatter in the same order (the requantization between
  sub-chunks follows JAX's pp=2, not one scatter of the chunk).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import quant as jq
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dynamo_tpu.parallel.mesh import kv_cache_spec, make_mesh
from dynamo_tpu.parallel.mesh import shard_params as jshard_params
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.cache import KVCacheSpec
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.parallel import mesh as tmesh
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests import torch_pp_rank, torch_tp_rank
from tests.test_torch_engine import CKPT, _tcfg
from tests.test_torch_quant import _np

FWD_TOL = dict(atol=1e-4, rtol=1e-4)
JCFG = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name="tiny-llama-f32-pp")
TCFG = _tcfg(JCFG)
JMOE = dataclasses.replace(JAX_PRESETS["tiny-moe"], dtype="float32", name="tiny-moe-f32-pp")
TMOE = _tcfg(JMOE)


@functools.cache
def _params(moe: bool = False):
    """JAX's params and the port's full tree of the same values."""
    jcfg = JMOE if moe else JCFG
    jp = jl.init_params(jcfg, jax.random.key(3))
    return jp, tloader.from_jax_params(_np(jp), device="cpu")


def _mesh():
    return make_mesh(JMeshConfig(pp=2))


# ---------------------------------------------------------------------------
# the stage layout
# ---------------------------------------------------------------------------

def _stage_of(shard) -> int:
    """The stage of a JAX addressable shard of a "layers" leaf."""
    sl = shard.index[0]
    return (sl.start or 0) // (sl.stop - (sl.start or 0))


@pytest.mark.parametrize("moe", [False, True], ids=["llama", "moe"])
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_shard_params_over_a_stage_matches_jax(moe, quantized):
    """Stage s's shard of every "layers" leaf (both tensors of an int8
    leaf) equals JAX's addressable shard at position s of the "pipe" axis,
    bit for bit; the leaves JAX replicates over "pipe" are stage 0's alone
    (a later stage holds only its layers)."""
    jcfg, tcfg = (JMOE, TMOE) if moe else (JCFG, TCFG)
    jp, full = _params(moe)
    placed = jshard_params(jax.tree.map(jnp.copy, jp), jl.param_logical_axes(jcfg), _mesh())
    if quantized:   # JAX's engine quantizes the placed tree; the layout carries over
        placed = jq.quantize_params_int8(placed, jcfg)
        full = tq.quantize_params_int8(full, tcfg)
    shards = [tmesh.shard_params(full, tcfg, 0, 1, stage=s, pp=2) for s in range(2)]
    assert set(shards[1]) == {"layers"} and set(shards[0]) == set(full)
    for key, leaf in placed["layers"].items():
        jleaves = leaf if isinstance(leaf, dict) else {None: leaf}
        for sub, jleaf in jleaves.items():
            for shard in jleaf.addressable_shards:
                got = shards[_stage_of(shard)]["layers"][key]
                got = got if sub is None else got[sub]
                np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data),
                                              err_msg=f"{key}/{sub}")
    for key in ("embed", "final_norm"):
        a, b = shards[0][key], full[key]
        assert (tq.param_bytes(a) == tq.param_bytes(b)
                and all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b))))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("moe", [False, True], ids=["llama", "moe"])
def test_a_stage_draws_only_its_layers(moe):
    """``init_params(stage=s, pp=2)`` equals ``shard_params`` of the full
    draw (the same generator, every layer's draw made and the other
    stage's dropped), and the stages' layer bytes add up to the whole."""
    cfg = TMOE if moe else TCFG
    full = tl.init_params(cfg, seed=5, device="cpu")
    for s in range(2):
        got = tl.init_params(cfg, seed=5, device="cpu", stage=s, pp=2)
        want = tmesh.shard_params(full, cfg, 0, 1, stage=s, pp=2)
        assert set(got) == set(want)
        for x, y in zip(_leaves(got), _leaves(want)):
            assert torch.equal(x, y)
    halves = [tq.param_bytes(tl.init_params(cfg, seed=5, device="cpu", stage=s, pp=2)["layers"])
              for s in range(2)]
    assert halves[0] == halves[1] and sum(halves) == tq.param_bytes(full["layers"])


def test_a_stage_loads_only_its_layers():
    """The loader reads stage s's layers of the checkpoint (and, past the
    first stage, no embeddings), equal to ``shard_params`` of the whole
    load."""
    cfg = TModelConfig.from_hf_config(str(CKPT))
    full = tloader.load_params(cfg, CKPT, device="cpu")
    for s in range(2):
        got = tloader.load_params(cfg, CKPT, device="cpu", stage=s, pp=2)
        want = tmesh.shard_params(full, cfg, 0, 1, stage=s, pp=2)
        assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
        for key in got["layers"]:
            assert torch.equal(got["layers"][key], want["layers"][key]), key
        assert got["layers"]["wq"].shape[0] == cfg.num_layers // 2


def test_cache_spec_is_per_stage():
    one = KVCacheSpec.for_model(TCFG, 10, 4, kv_dtype="int8")
    two = KVCacheSpec.for_model(TCFG, 10, 4, kv_dtype="int8", pp=2)
    assert two.num_layers == TCFG.num_layers // 2
    assert 2 * two.bytes_per_block() == one.bytes_per_block()
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        KVCacheSpec.for_model(TCFG, 10, 4, pp=3)


# ---------------------------------------------------------------------------
# the forward at pp=2, two gloo processes
# ---------------------------------------------------------------------------

NB, BS = 24, 4
BT = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]], np.int32)


def _steps(vocab: int):
    """A ragged prefill chunk of 8 (a row whose 3 tokens end inside an
    earlier sub-chunk, a padding row), then a decode step on its cache."""
    rng = np.random.default_rng(5)
    steps = [
        (rng.integers(0, vocab, size=(4, 8)), np.array([0, 0, 0, 0]), np.array([8, 3, 0, 6]), BT),
        (rng.integers(0, vocab, size=(4, 1)), np.array([8, 3, 0, 6]), np.array([1, 1, 0, 1]), BT),
    ]
    return [tuple(a.astype(np.int32) for a in s) for s in steps]


#: case -> (moe, microbatches): auto (2·pp = 4: four sub-chunks of 2, four
#: rows of 1), a target of 3 (the largest divisor below it: 2), and 1 (the
#: sequential schedule)
CASES = {"auto": (False, 0), "mb3": (False, 3), "sequential": (False, 1), "moe": (True, 0)}


def _microbatches(b: int, t: int, mb: int) -> int:
    target = mb or 4
    axis = t if t > 1 else b
    return max(d for d in range(1, min(target, axis) + 1) if axis % d == 0)


@pytest.fixture(scope="module")
def pp_ranks(tmp_path_factory):
    cases = {name: ((TMOE if moe else TCFG), _params(moe)[1], mb, _steps(JCFG.vocab_size))
             for name, (moe, mb) in CASES.items()}
    return torch_tp_rank.run_ranks(torch_pp_rank.forward_pp_rank, 2,
                                   tmp_path_factory.mktemp("pp"), cases, NB, BS)


def _jax_forward(moe: bool, mb: int):
    jcfg = JMOE if moe else JCFG
    mesh = _mesh()
    jparams = jshard_params(_params(moe)[0], jl.param_logical_axes(jcfg), mesh)
    shape = (jcfg.num_layers, NB, BS, jcfg.num_kv_heads, jcfg.head_dim)
    ck = cv = jax.device_put(jnp.zeros(shape, jnp.float32),
                             jax.sharding.NamedSharding(mesh, kv_cache_spec()))
    fwd = jax.jit(functools.partial(jl.forward, cfg=jcfg, attn_impl="pallas_interpret",
                                    mesh=mesh, pp_microbatches=mb))
    out = []
    for toks, qs, ql, bt in _steps(jcfg.vocab_size):
        h, ck, cv = fwd(jparams, token_ids=jnp.asarray(toks), q_start=jnp.asarray(qs),
                        q_len=jnp.asarray(ql), block_tables=jnp.asarray(bt), cache_k=ck,
                        cache_v=cv)
        out.append((np.asarray(h), np.asarray(jl.logits_from_hidden(jparams, jcfg, h))))
    return out, (np.asarray(ck), np.asarray(cv))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_pp2_matches_jax(pp_ranks, case):
    """A prefill chunk split along T (the row of 3 tokens sees only its
    own positions in the later sub-chunks), then a decode step split
    along B, through the port's forward as two gloo stages against JAX's
    ``forward_pp`` on a pp=2 mesh (its interpret-mode kernel): stage 0's
    final hidden states and logits, each stage's cache (its layer), and
    each stage's kernel calls: (L/pp)·m a step."""
    moe, mb = CASES[case]
    want, (jck, jcv) = _jax_forward(moe, mb)
    steps = _steps(JCFG.vocab_size)
    for stage, got in enumerate(pp_ranks):
        results, counts, (tck, tcv) = got[case]
        for (toks, _, ql, _), res, ref, (calls, micro) in zip(steps, results, want, counts):
            m = _microbatches(*toks.shape, mb)
            assert (calls, micro) == (m * JCFG.num_layers // 2, m), (stage, toks.shape)
            if stage == 0:
                live = ql > 0
                for a, b in zip(res, ref):
                    np.testing.assert_allclose(a[live], b[live], **FWD_TOL)
        for mine, theirs in zip((tck, tcv), (jck, jcv)):
            assert mine.shape[0] == 1
            np.testing.assert_allclose(mine[0, 1:], theirs[stage, 1:], **FWD_TOL)
        if stage:
            assert all(r is None for r in results)


def test_sub_chunk_scatters_of_an_int8_block_equal_jax():
    """An int8 (and int4) cache written by a chunk's sub-chunks in order,
    as a pp=2 stage writes it, holds JAX's bytes for the same writes in
    the same order; its blocks that straddle sub-chunks were requantized
    between them, so they differ from one scatter of the whole chunk."""
    from dynamo_tpu.models.llama import _scatter_kv as jscatter

    rng = np.random.default_rng(11)
    nb, bs, kh, d, t, m = 6, 4, 2, 16, 8, 4
    vals = rng.standard_normal((2, t, kh, d)).astype(np.float32)
    vals[:, t // 2:] *= 3.0                       # later sub-chunks widen the scale
    slots = np.array([[4 + i for i in range(t)], [12 + i for i in range(t)]], np.int32)
    for kind, dt in (("int8", np.int8), ("int4", np.uint8)):
        dp = d // 2 if kind == "int4" else d
        zeros_q = np.zeros((nb, bs, kh, dp), dt)
        zeros_s = np.zeros((nb, kh), np.float32)
        jc = {"q": jnp.asarray(zeros_q), "s": jnp.asarray(zeros_s)}
        tc = {"q": torch.from_numpy(zeros_q.copy()), "s": torch.from_numpy(zeros_s.copy())}
        whole = {"q": torch.from_numpy(zeros_q.copy()), "s": torch.from_numpy(zeros_s.copy())}
        tm = t // m
        for c in range(m):
            cols = slice(c * tm, (c + 1) * tm)
            jc = jscatter(jc, jnp.asarray(vals[:, cols]), jnp.asarray(slots[:, cols]))
            tl._scatter_kv(tc, torch.from_numpy(vals[:, cols]), torch.from_numpy(slots[:, cols]))
        tl._scatter_kv(whole, torch.from_numpy(vals), torch.from_numpy(slots))
        np.testing.assert_array_equal(tc["q"].numpy(), np.asarray(jc["q"]))
        np.testing.assert_array_equal(tc["s"].numpy(), np.asarray(jc["s"]))
        assert not torch.equal(tc["q"], whole["q"]), kind


# ---------------------------------------------------------------------------
# refusals, in both packages
# ---------------------------------------------------------------------------

BASE = dict(block_size=4, num_blocks=16, max_batch_size=2, max_model_len=64)


def _port(**kw):
    d = dict(BASE, dist_backend="gloo", warmup_mode="off")
    d.update(kw)
    return teng.EngineCore(TEngineConfig(**d), device="cpu")


@pytest.mark.parametrize("setting,match", [
    (dict(model="tiny-llama", pp=3), "divisible"),  # JAX: at the placement
    (dict(model="tiny-llama", pp=2, tp=2), "pp>1 currently composes only with dp"),
    (dict(model="tiny-moe", pp=2, ep=2), "pp>1 currently composes only with dp"),
    (dict(model="tiny-llama", pp=2, sp=2), "pp>1 currently composes only with dp"),
    (dict(model="tiny-llama", pp=2, spec_ngram=2), "spec_ngram requires pp=1"),
], ids=["layers", "tp", "ep", "sp", "spec"])
def test_pp_refusals_in_both_packages(setting, match):
    """What JAX's EngineCore refuses at pp > 1, the port refuses in the
    same words, before any stage starts."""
    with pytest.raises(ValueError, match=match):
        jeng.EngineCore(JEngineConfig(**BASE, **setting))
    with pytest.raises(ValueError, match=match):
        _port(**setting)
    if setting.get("pp") == 3:
        with pytest.raises(ValueError, match="num_layers=2 not divisible by pp=3"):
            _port(**setting)


def test_pp_refusals_of_the_port():
    """pp with CUDA graphs (the stages' steps are eager), and
    ``pp_microbatches`` below 0."""
    with pytest.raises(ValueError, match="CUDA graphs"):
        _port(model="tiny-llama", pp=2, warmup_mode="lazy")
    with pytest.raises(ValueError, match="pp_microbatches must be >= 0"):
        _port(model="tiny-llama", pp=2, pp_microbatches=-1)
