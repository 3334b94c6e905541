"""Ring attention of the port (``ops/ring_attention.py``, the ring prefill
step ``models/llama.forward_ring``) against the JAX package's, on the CPU.

- The op: the port's ``ring_attention_sharded`` (its seq ranks run in
  turn in this process) against JAX's on a seq mesh of the same size of
  the fake CPU devices ``tests/conftest.py`` provides, and against dense
  causal attention (JAX's test's own reference), at JAX's tolerances
  (``tests/test_ring_attention.py``): 2e-5, and 2e-4 at the bench
  geometry (kh=8, d=128).
- The real hop: two seq ranks as gloo processes (``tests/torch_sp_rank.py``)
  run a ring prefill step and a decode step through the port's forward
  against JAX's ``forward`` with ``sp_prefill`` on an sp=2 mesh (its
  interpret-mode kernel for the decode step): hidden states within 1e-4
  (``FWD_TOL``, as ``tests/test_torch_tp.py`` holds the forward at tp=2),
  every cache block but the trash block 0 within 1e-4 at f32; at int8
  JAX's payload, its scales within one f32 rounding (rtol 1e-6: the two
  packages' f32 products of K and V differ in their last bits, which an
  abs-max scale carries), and byte for byte JAX's one scatter of the
  whole prompt a layer of the same K and V.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dynamo_tpu.engine.cache import KVCacheSpec as JKVCacheSpec
from dynamo_tpu.engine.cache import allocate_cache as jallocate_cache
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.ops.ring_attention import ring_attention_sharded as jring
from dynamo_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.parallel.mesh import shard_params as jshard_params
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.ops import ring_attention as tra
from tests import torch_sp_rank, torch_tp_rank
from tests.test_ring_attention import _dense_causal
from tests.test_torch_engine import _tcfg
from tests.test_torch_quant import _np

TOL = dict(atol=2e-5, rtol=2e-5)
BENCH_TOL = dict(atol=2e-4, rtol=2e-4)
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
JCFG = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name="tiny-llama-f32-sp")
TCFG = _tcfg(JCFG)


@functools.cache
def _seq_mesh(sp: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:sp]), ("seq",))


def _qkv(seed: int, b: int, t: int, h: int, kh: int, d: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))


def _both(q, k, v, sp: int, kv_len=None):
    """The port's ring and JAX's on an sp mesh, and JAX's dense causal
    attention, as numpy."""
    tkl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got = tra.ring_attention_sharded(*(torch.from_numpy(x) for x in (q, k, v)), sp, tkl).numpy()
    jkl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    want = np.asarray(jring(_seq_mesh(sp))(*jargs, jkl))
    dense = np.asarray(_dense_causal(*jargs, jkl))
    return got, want, dense


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2)])
def test_ring_attention_matches_jax_and_dense(h, kh, sp):
    got, want, dense = _both(*_qkv(0, 2, 64, h, kh, 32), sp)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense, **TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_ragged_kv_len(sp):
    """Row 0 is valid to 40 of 64: its rows past that attend nothing of
    their own chunk's future and stay finite (the l == 0 guard)."""
    got, want, dense = _both(*_qkv(1, 2, 64, 4, 4, 32), sp, [40, 64])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[0, :40], dense[0, :40], **TOL)
    np.testing.assert_allclose(got[1], dense[1], **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_bench_geometry_ragged(sp):
    got, want, dense = _both(*_qkv(7, 2, 64, 8, 8, 128), sp, [48, 64])
    np.testing.assert_allclose(got, want, **BENCH_TOL)
    np.testing.assert_allclose(got[0, :48], dense[0, :48], **BENCH_TOL)
    np.testing.assert_allclose(got[1], dense[1], **BENCH_TOL)
    assert np.isfinite(got).all()


def test_tiles_of_query_positions_merge_to_the_whole(monkeypatch):
    """A hop's scores made 3 query positions at a time (a tile that does
    not divide the chunk) give the untiled result: the online-softmax
    merge is elementwise over query positions."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 2, 64, 8, 2, 32))
    kl = torch.tensor([40, 64], dtype=torch.int32)
    whole = tra.ring_attention_sharded(q, k, v, 2, kl)
    monkeypatch.setattr(tra, "RING_TILE_BYTES", 4 * 2 * 8 * 32 * 3)
    np.testing.assert_allclose(tra.ring_attention_sharded(q, k, v, 2, kl).numpy(),
                               whole.numpy(), **TOL)


def test_a_rank_keeps_every_chunk_it_held():
    """``keep`` collects each chunk a rank held, once, named by the rank it
    came from: sorted, they are the whole K and V (what the ring prefill
    writes into the cache)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 32, 4, 2, 16))
    sp, t = 4, 8
    chunks = [(k[:, i * t:(i + 1) * t], v[:, i * t:(i + 1) * t]) for i in range(sp)]
    held_by = [2]

    def hop(kc, vc):
        held_by[0] = (held_by[0] - 1) % sp
        return chunks[held_by[0]]

    keep: list = []
    tra.ring_attention(q[:, 2 * t:3 * t], *chunks[2], seq_rank=2, sp=sp, hop=hop, keep=keep)
    assert [src for src, _, _ in keep] == [2, 1, 0, 3]
    keep.sort(key=lambda c: c[0])
    assert torch.equal(torch.cat([c[1] for c in keep], 1), k)
    assert torch.equal(torch.cat([c[2] for c in keep], 1), v)


def test_ring_prefill_metrics_are_jax_names():
    """The port's family registers exactly tools/lint_metrics.py's
    RING_PREFILL_METRICS, as JAX's does."""
    from dynamo_tpu.obs.ring_prefill import RingPrefillMetrics as JMetrics
    from dynamo_tpu_torch.obs.ring_prefill import (
        RingPrefillMetrics,
        get_ring_prefill_metrics,
        install_ring_prefill_metrics,
    )
    from dynamo_tpu_torch.utils.metrics import MetricsRegistry
    from tools.lint_metrics import RING_PREFILL_METRICS

    def names(m):
        return sorted(x.name.removeprefix("dynamo_") for x in m.registry._metrics.values())

    assert names(RingPrefillMetrics()) == names(JMetrics()) == sorted(RING_PREFILL_METRICS)
    reg = MetricsRegistry()
    assert install_ring_prefill_metrics(reg) is get_ring_prefill_metrics()
    assert get_ring_prefill_metrics().registry is reg


# ---------------------------------------------------------------------------
# the ring prefill step over two seq ranks, each a gloo process
# ---------------------------------------------------------------------------

NB, BS = 24, 4
BT = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10], [11, 12, 13, 14, 15]], np.int32)


@functools.cache
def _params():
    jp = jl.init_params(JCFG, jax.random.key(5))
    return jp, tloader.from_jax_params(_np(jp), device="cpu")


def _steps():
    """A ring prefill step of fresh prompts (16, 6 and 0 tokens: a padding
    row; T = 16 splits 8 a rank), then a decode step on the cache it
    wrote."""
    rng = np.random.default_rng(9)
    v = JCFG.vocab_size
    steps = [
        (rng.integers(0, v, size=(3, 16)), np.array([0, 0, 0]), np.array([16, 6, 0]), BT, True),
        (rng.integers(0, v, size=(3, 1)), np.array([16, 6, 0]), np.array([1, 1, 0]), BT, False),
    ]
    return [(*(a.astype(np.int32) for a in s[:4]), s[4]) for s in steps]


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory):
    return torch_tp_rank.run_ranks(torch_sp_rank.ring_rank, 2, tmp_path_factory.mktemp("sp"),
                                   2, TCFG, _params()[1], _steps(), ("", "int8"), NB, BS)


def _jax_forward(kv_dtype: str):
    """JAX's hidden states and caches after each step of ``_steps``."""
    mesh = make_mesh(JMeshConfig(sp=2))
    jparams = jshard_params(_params()[0], jl.param_logical_axes(JCFG), mesh)
    spec = JKVCacheSpec.for_model(JCFG, NB, BS, kv_dtype=kv_dtype or "bfloat16")
    ck, cv = jallocate_cache(spec, mesh)
    out = []
    for toks, qs, ql, bt, ring in _steps():
        fwd = jax.jit(functools.partial(jl.forward, cfg=JCFG, attn_impl="pallas_interpret",
                                        mesh=mesh, sp_prefill=ring))
        h, ck, cv = fwd(jparams, token_ids=jnp.asarray(toks), q_start=jnp.asarray(qs),
                        q_len=jnp.asarray(ql), block_tables=jnp.asarray(bt), cache_k=ck,
                        cache_v=cv)
        out.append((np.asarray(h), [jax.tree.map(np.asarray, c) for c in (ck, cv)]))
    return out


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_ring_prefill_forward_matches_jax(ring_ranks, kv_dtype):
    """Both seq ranks return the rows' last-token hidden states of the ring
    step and of the decode step after it, equal to JAX's; the ring step
    calls the attention kernel on no layer, the decode step on every one;
    a rank hopped (sp - 1) x L times, its live rows' chunk of K and V a
    hop (the padding row holds no prompt and is left out). Each
    rank's cache (replicated over seq) after each step: at f32 JAX's; at
    int8 JAX's payload and its scales to the last bit of the f32 K and V
    (the two packages' f32 products differ there), see below."""
    want = _jax_forward(kv_dtype)
    t_local = 8
    hop_bytes = 2 * 2 * t_local * JCFG.num_kv_heads * JCFG.head_dim * 4
    for rank, got in enumerate(ring_ranks):
        res, (hops, nbytes) = got[kv_dtype]
        for (hidden, calls, caches), (ref, jcaches), ring in zip(res, want, (True, False)):
            np.testing.assert_allclose(hidden[:2], ref[:2], **FWD_TOL)
            assert not (ring and hidden[2].any()), "the padding row's hidden is zeros"
            assert calls == (0 if ring else JCFG.num_layers), (rank, ring, calls)
            for tc, jc in zip(caches, jcaches):
                if kv_dtype == "int8":
                    assert np.array_equal(tc["q"][:, 1:], jc["q"][:, 1:])
                    np.testing.assert_allclose(tc["s"][:, 1:], jc["s"][:, 1:], rtol=1e-6, atol=0)
                else:
                    np.testing.assert_allclose(tc[:, 1:], jc[:, 1:], **FWD_TOL)
        assert hops == JCFG.num_layers and nbytes == hops * hop_bytes


def test_ring_prefill_int8_cache_is_one_scatter_of_the_prompt(ring_ranks):
    """A ring step writes an int8 cache as JAX's one ``_scatter_kv`` of the
    whole prompt a layer: byte for byte JAX's scatter of the same K and V
    (the ring step's f32 cache holds them), though each rank computed
    only its half of them. A scatter per chunk would requantize the
    blocks a chunk boundary cuts (T/sp = 8 here splits rows that blocks
    of 4 hold whole, and the int8 scale of block 2 of row 1 would be set
    before its second half arrived)."""
    from dynamo_tpu.models.llama import _scatter_kv as jscatter

    toks, qs, ql, bt, _ = _steps()[0]
    t = toks.shape[1]
    pos = np.arange(t)[None, :]
    slot = np.where(pos < ql[:, None], bt[np.arange(3)[:, None], pos // BS] * BS + pos % BS, 0)
    for got in ring_ranks:
        f32_caches = got[""][0][0][2]
        int8_caches = got["int8"][0][0][2]
        for f32, int8 in zip(f32_caches, int8_caches):
            for layer in range(JCFG.num_layers):
                flat = f32[layer].reshape(NB * BS, JCFG.num_kv_heads, JCFG.head_dim)
                new = np.where((pos < ql[:, None])[..., None, None], flat[slot], 0.0)
                zeros = {"q": jnp.zeros(int8["q"].shape[1:], jnp.int8),
                         "s": jnp.zeros(int8["s"].shape[1:], jnp.float32)}
                want = jscatter(zeros, jnp.asarray(new, jnp.float32), jnp.asarray(slot))
                assert np.array_equal(int8["q"][layer, 1:], np.asarray(want["q"])[1:])
                assert np.array_equal(int8["s"][layer, 1:], np.asarray(want["s"])[1:])


def test_ring_pass_hands_each_rank_its_predecessors_tensor(ring_ranks):
    for rank, got in enumerate(ring_ranks):
        assert (got["pass"] == float((rank - 1) % 2)).all()
