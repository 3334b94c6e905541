"""Tensor parallelism of the port (``dynamo_tpu_torch/parallel/``, the
engine's followers) against the JAX package's "model" mesh axis, on the
CPU: every rank is a process of its own over a gloo group, and JAX runs on
a tp=2 mesh of the fake CPU devices ``tests/conftest.py`` provides.

Tolerances, with their reasons:
- ``paged_attention_sharded`` (the kernel's plain version on each rank's
  heads) against JAX's shard_map'd Pallas kernel in interpret mode:
  atol = rtol = 2e-5, as ``tests/test_ops.py`` holds the sharded kernel
  against the dense path (online against one-pass softmax sums);
- ``shard_params`` and the sharded loader: exact (slices of the same
  values);
- the forward at tp=2: atol = rtol = 1e-4, as ``tests/test_torch_llama.py``
  holds the one-device forward (XLA and ATen sum the halves of ``wo`` and
  ``w_down`` in other orders);
- engines: identical greedy streams at f32. JAX cannot place
  ``tiny-real-llama``'s vocab of 297 on two devices (``device_put`` needs a
  divisible dim), so there the port's tp=2 streams are held to JAX's tp=1
  ones. int4 is no token oracle (ROADMAP Queue 3): the port's int4 tp=2
  streams are held to JAX's int4 tp=2 streams and to themselves.

Each engine at tp=2 starts a follower process (a few seconds), so the
multi-process tests are few.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dynamo_tpu.parallel.mesh import kv_cache_spec, make_mesh
from dynamo_tpu.parallel.mesh import shard_params as jshard_params
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.cache import KVCacheSpec
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.obs.compile_ledger import get_compile_ledger
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.parallel import mesh as tmesh
from dynamo_tpu_torch.parallel.collectives import TPFailure
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests import torch_tp_rank
from tests.test_torch_engine import CKPT, REAL32, ROOT, _req, _run, _tcfg, real32  # noqa: F401
from tests.test_torch_kv_quant import _quant_case, _t

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
TINY32 = "tiny-llama-f32-tp"
JCFG = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name=TINY32)
TCFG = _tcfg(JCFG)


@pytest.fixture(scope="module")
def tiny32():
    """tiny-llama at f32 as a preset of both packages: JAX's params and the
    port's full tree of the same values."""
    JAX_PRESETS[TINY32], TORCH_PRESETS[TINY32] = JCFG, TCFG
    jp = jl.init_params(JCFG, jax.random.key(0))
    yield jp, tloader.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del JAX_PRESETS[TINY32], TORCH_PRESETS[TINY32]


def _mesh():
    return make_mesh(JMeshConfig(tp=2))


# ---------------------------------------------------------------------------
# paged_attention_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_paged_attention_sharded_matches_jax(kind):
    """tests/test_ops.py's sharded case (b=2, t=4, h=8, kh=2, d=64), over the
    model-precision, int8 and packed-int4 caches: the port's per-rank
    launches (plain on the CPU) against JAX's shard_map'd kernel on a tp=2
    mesh, and against the port's unsharded call."""
    rng = np.random.default_rng(3)
    geo = dict(b=2, t=4, h=8, kh=2, d=64, nb=32, bs=16, nblk=4)
    if kind == "float":
        b, t, h, kh, d, nb, bs, nblk = geo.values()
        q = rng.standard_normal((b, t, h, d)).astype(np.float32)
        k = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
        v = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
        bt = (rng.permutation(nb - 1)[: b * nblk].reshape(b, nblk) + 1).astype(np.int32)
        qs = rng.integers(0, nblk * bs - t, size=(b,)).astype(np.int32)
        kl = (qs + t).astype(np.int32)
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
    else:
        q, (kq, ks), (vq, vs), bt, qs, kl = _quant_case(rng, kind, **geo)
        jk = {"q": jnp.asarray(kq), "s": jnp.asarray(ks)}
        jv = {"q": jnp.asarray(vq), "s": jnp.asarray(vs)}
        tk, tv = {"q": _t(kq), "s": _t(ks)}, {"q": _t(vq), "s": _t(vs)}
    ref = jpa.paged_attention_sharded(_mesh(), jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                      jnp.asarray(qs), jnp.asarray(kl), interpret=True)
    args = (_t(q), tk, tv, _t(bt), _t(qs), _t(kl))
    out = tpa.paged_attention_sharded(*args, tp=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
    np.testing.assert_allclose(out.numpy(), tpa.paged_attention(*args).numpy(), **ATTN_TOL)
    # each rank's cache holds only its heads, scales included
    half = tpa.shard_heads(tk, 1, 2)
    payload = half["q"] if kind != "float" else half
    assert payload.shape[2] == 1 and payload.is_contiguous()
    if kind != "float":
        assert torch.equal(half["s"], tk["s"][:, 1:])
    with pytest.raises(ValueError, match="divide"):
        tpa.paged_attention_sharded(*args, tp=4)


# ---------------------------------------------------------------------------
# the parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [True, False])
def test_shard_params_matches_jax(tied):
    """Rank r's shard of every leaf equals JAX's addressable shard at
    position r of the "model" axis, bit for bit (lm_head on its vocab
    columns when the embeddings are not tied)."""
    jcfg = dataclasses.replace(JCFG, tie_word_embeddings=tied)
    tcfg = _tcfg(jcfg)
    jp = jl.init_params(jcfg, jax.random.key(1))
    full = tloader.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    placed = jshard_params(jp, jl.param_logical_axes(jcfg), _mesh())
    assert tmesh.param_logical_axes(tcfg) == jl.param_logical_axes(jcfg)
    shards = [tmesh.shard_params(full, tcfg, r, 2) for r in range(2)]

    def walk(jnode, tnodes, axes, path):
        if isinstance(axes, dict):
            for key in axes:
                walk(jnode[key], [t[key] for t in tnodes], axes[key], f"{path}/{key}")
            return
        split = [dim for dim, ax in enumerate(axes) if tmesh.PARAM_RULES.get(ax) == "model"]
        for shard in jnode.addressable_shards:
            rank = 0
            if split:
                sl = shard.index[split[0]]
                rank = (sl.start or 0) // (sl.stop - (sl.start or 0))
            got = tnodes[rank].numpy()
            assert got.shape == shard.data.shape, path
            np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=path)

    walk(placed, shards, jl.param_logical_axes(jcfg), "")


def test_vocab_that_does_not_divide_is_padded_and_masked(real32):  # noqa: F811
    """tiny-real-llama's vocab of 297 over tp=2: JAX refuses the placement;
    the port pads the last piece with zero rows, the sharded loader reads
    each rank's slice equal to ``shard_params`` of the full tree, and the
    vocab-parallel lookup and logits gather equal the one-device ones bit
    for bit on the CPU (run as two ranks in one process)."""
    cfg = TORCH_PRESETS[REAL32]
    jcfg = JAX_PRESETS[REAL32]
    with pytest.raises(ValueError, match="divisible"):
        jshard_params(real32[0], jl.param_logical_axes(jcfg), _mesh())
    full = real32[1]
    shards = [tloader.load_params(cfg, CKPT, device="cpu", rank=r, tp=2) for r in range(2)]
    for r, shard in enumerate(shards):
        ref = tmesh.shard_params(full, cfg, r, 2)
        for path in (("embed",), ("layers", "wq"), ("layers", "wo"), ("layers", "w_down")):
            a, b = shard, ref
            for key in path:
                a, b = a[key], b[key]
            assert torch.equal(a, b), (r, path)
    assert shards[1]["embed"].shape[0] == 149 and not shards[1]["embed"][148].any()

    class Rank:   # two ranks in one process: the sum over ranks done by hand
        def __init__(self, rank):
            self.rank, self.size = rank, 2

        def all_reduce_sum(self, x):
            return x

    ids = torch.tensor([[0, 148, 149, 296, 5]])
    parts = [teng.llama.embed_lookup(s["embed"], ids, torch.float32, Rank(r))
             for r, s in enumerate(shards)]
    assert torch.equal(parts[0] + parts[1], full["embed"][ids])
    hidden = torch.randn(3, cfg.hidden_size, generator=torch.Generator().manual_seed(0))
    pieces = [hidden @ s["embed"].T for s in shards]
    glued = torch.cat(pieces, dim=-1)[:, : cfg.vocab_size]
    assert torch.equal(glued, hidden @ full["embed"].T)


def test_cache_spec_is_per_rank():
    one = KVCacheSpec.for_model(TCFG, 10, 4, kv_dtype="int8")
    two = KVCacheSpec.for_model(TCFG, 10, 4, kv_dtype="int8", tp=2)
    assert two.num_kv_heads == TCFG.num_kv_heads // 2
    assert 2 * two.bytes_per_block() == one.bytes_per_block()
    with pytest.raises(ValueError, match="divide"):
        KVCacheSpec.for_model(TCFG, 10, 4, tp=4)


# ---------------------------------------------------------------------------
# the forward at tp=2, two gloo processes
# ---------------------------------------------------------------------------

def test_forward_tp2_matches_jax(tiny32, tmp_path):
    """A prefill chunk (ragged, with a padding row), then a decode step over
    the cache it wrote, through the port's forward as two gloo ranks, each
    in a process of its own, against JAX's forward on a tp=2 mesh through
    its shard_map'd kernel (Pallas interpret): every rank's hidden states
    and gathered logits."""
    jp, full = tiny32
    rng = np.random.default_rng(5)
    nb, bs = 24, 4
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    steps = [
        (rng.integers(0, TCFG.vocab_size, size=(3, 8)), np.array([0, 0, 0]),
         np.array([8, 5, 0]), bt),
        (rng.integers(0, TCFG.vocab_size, size=(3, 1)), np.array([8, 5, 0]),
         np.array([1, 1, 0]), bt),
    ]
    steps = [tuple(a.astype(np.int32) for a in s) for s in steps]

    mesh = _mesh()
    jparams = jshard_params(jp, jl.param_logical_axes(JCFG), mesh)
    shape = (JCFG.num_layers, nb, bs, JCFG.num_kv_heads, JCFG.head_dim)
    cache = jax.device_put(jnp.zeros(shape, jnp.float32),
                           jax.sharding.NamedSharding(mesh, kv_cache_spec()))
    jck = jcv = cache
    fwd = jax.jit(functools.partial(jl.forward, cfg=JCFG, attn_impl="pallas_interpret",
                                    mesh=mesh))
    want = []
    for toks, qs, ql, btab in steps:
        h, jck, jcv = fwd(jparams, token_ids=jnp.asarray(toks), q_start=jnp.asarray(qs),
                          q_len=jnp.asarray(ql), block_tables=jnp.asarray(btab),
                          cache_k=jck, cache_v=jcv)
        want.append((np.asarray(h), np.asarray(jl.logits_from_hidden(jparams, JCFG, h))))

    got = torch_tp_rank.run_ranks(torch_tp_rank.forward_rank, 2, tmp_path, TCFG, full,
                                  steps, nb, bs)
    for rank_out in got:
        for (th, tl), (jh, jlg), (_, _, ql, _) in zip(rank_out, want, steps):
            live = ql > 0
            np.testing.assert_allclose(th[live], jh[live], **FWD_TOL)
            np.testing.assert_allclose(tl[live], jlg[live], **FWD_TOL)
    for (h0, l0), (h1, l1) in zip(*got):   # replicated: every rank holds the same
        np.testing.assert_array_equal(h0, h1)
        np.testing.assert_array_equal(l0, l1)


# ---------------------------------------------------------------------------
# engines at tp=2
# ---------------------------------------------------------------------------

PROMPTS = [[1, 5, 9, 20, 33], list(range(3, 40)), [7] * 11 + [100, 200, 250]]
MAX_TOKENS = [8, 8, 12]


def _cfg(model, **kw):
    d = dict(model=model, block_size=4, num_blocks=64, max_batch_size=8,
             max_model_len=256, prefill_chunk=32, decode_bucket=(4, 8))
    d.update(kw)
    return d


def _reqs(proto, tag=""):
    return [_req(proto, p, f"{tag}r{i}", m) for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]


def _jax_streams(jparams, **kw):
    got, _ = _run(jeng.EngineCore(JEngineConfig(**kw), params=jparams), _reqs(jproto))
    return got


def _port_core(params, **kw):
    return teng.EngineCore(TEngineConfig(**kw, tp=2, dist_backend="gloo", warmup_mode="off"),
                           params=params, device="cpu")


@pytest.mark.parametrize("kv_dtype,pipelined", [("bfloat16", True), ("int8", False)])
def test_engine_tp2_matches_jax_tp2(tiny32, kv_dtype, pipelined):
    """Greedy streams of the port's EngineCore(tp=2) equal JAX's
    EngineCore(tp=2) on tiny-llama at f32 (the pipelined loop feeds decode
    rows their in-flight tokens through the leader's broadcast). Every rank
    launched the same forward steps on 2 of the 4 heads, 1 of the 2 kv
    heads. Blocks export whole (every kv head, as from one process), and
    every op of the disaggregated handoff runs: a chain staged and
    released, a stream opened and closed, a pull with no shard answered
    -1 (nothing mutated), the shard server started."""
    from dynamo_tpu_torch.tokens import TokenBlockSequence

    jp, full = tiny32
    kw = _cfg(TINY32, kv_dtype=kv_dtype)
    core = _port_core(full, **kw)
    try:
        got, fin = _run(core, _reqs(tproto), pipelined=pipelined)
        assert fin == set(got)
        ranks = core.tp_stats()
        hashes = TokenBlockSequence.from_tokens(PROMPTS[1], 4).sequence_hashes()
        blocks = core.export_blocks(hashes)
        whole = KVCacheSpec.for_model(TCFG, 1, 4, kv_dtype=kv_dtype)
        assert len(blocks) == len(hashes) == 9
        if kv_dtype == "int8":
            assert all(b.shape == (whole.bytes_per_block(),) for _, _, b in blocks)
        else:
            assert all(b.shape == (2, TCFG.num_layers, 4, 2, TCFG.head_dim)
                       for _, _, b in blocks)
        params = {"xfer_id": "y", "block_hashes": hashes, "shards": []}
        assert core.run_op("kv_stage", {"xfer_id": "x", "hashes": hashes}) == 9
        core.run_op("kv_release", {"xfer_id": "x"})
        assert core.run_op("kv_stream_begin", {"xfer_id": "s", "request_id": "r",
                                                "hashes": hashes}) == 9
        assert core.run_op("kv_stream_end", {"xfer_id": "s"}) == 0
        core.run_op("kv_prefetch", {"params": params})
        assert core.run_op("kv_import", {"params": params}) == -1
        assert core.start_shard_server("127.0.0.1").startswith("127.0.0.1:")
        assert not core._staged_pins.get("x")
    finally:
        core.stop_shard_server()
        core.close()
    assert got == _jax_streams(jp, tp=2, **kw)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert len({r["forward_steps"] for r in ranks}) == 1 and ranks[0]["forward_steps"] > 0
    assert all((r["heads"], r["kv_heads"], r["cache_kv_heads"]) == (2, 1, 1) for r in ranks)
    assert all(r["collectives"] > 0 for r in ranks)


def test_engine_tp2_int4_matches_jax_and_itself(tiny32):
    """int4 is no token oracle: the port's tp=2 streams equal JAX's int4
    tp=2 streams, and the same requests again on the same engine (prefix
    caching off, so they prefill anew) give the same streams."""
    jp, full = tiny32
    kw = _cfg(TINY32, kv_dtype="int4", enable_prefix_caching=False)
    core = _port_core(full, **kw)
    try:
        first, _ = _run(core, _reqs(tproto, "a"))
        again, _ = _run(core, _reqs(tproto, "b"))
    finally:
        core.close()
    assert list(first.values()) == list(again.values())
    assert list(first.values()) == list(_jax_streams(jp, tp=2, **kw).values())


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_engine_tp2_on_an_undivided_vocab(real32, kv_dtype):  # noqa: F811
    """tiny-real-llama (vocab 297) at f32: the port's tp=2 engine, its
    vocab padded to 2 x 149 rows, gives JAX's tp=1 streams (JAX refuses
    tp=2 here)."""
    jp, full = real32
    kw = _cfg(REAL32, kv_dtype=kv_dtype)
    core = _port_core(full, **kw)
    try:
        got, _ = _run(core, _reqs(tproto), pipelined=True)
    finally:
        core.close()
    assert got == _jax_streams(jp, **kw)
    with pytest.raises(ValueError, match="divisible"):
        jeng.EngineCore(JEngineConfig(**kw, tp=2), params=jp)


def test_a_follower_that_fails_fails_the_leader_with_its_traceback(tiny32):
    """A follower that raises (here on an op it does not know) sends its
    traceback and exits; the leader's next step raises at once, with the
    traceback and the exit code, instead of hanging; close still returns."""
    _, full = tiny32
    core = _port_core(full, **_cfg(TINY32))
    procs = list(core._tp_followers.procs)
    try:
        core.runner.tp.post("no-such-op")
        core.add_request(_reqs(tproto)[0])
        with pytest.raises(TPFailure, match=r"(?s)exit code 1.*no-such-op"):
            core.step()
    finally:
        core.close()
    assert not any(p.is_alive() for p in procs)


# ---------------------------------------------------------------------------
# refusals and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting,match", [
    (dict(tp_devices=(0, 0), dist_backend="nccl", num_blocks=64), "need dist_backend='gloo'"),
    (dict(tp_devices=(0, 0), num_blocks=0), "explicit num_blocks"),
    (dict(warmup_mode="lazy"), "CUDA graphs"),
    (dict(warmup_mode="full"), "CUDA graphs"),
    (dict(pp=2), "pp>1 currently composes only with dp"),
    (dict(model="tiny-moe", ep=3), "num_experts=8 does not divide over ep=3"),
    (dict(sp=2, tp_devices=(0, 0)), "of each of the sp = 2 seq ranks"),
    (dict(tp_devices=(0,)), "one card for each"),
    (dict(dist_backend="mpi"), "unknown dist_backend"),
])
def test_tp_refusals(setting, match):
    kw = dict(model="tiny-llama", block_size=4, num_blocks=16, max_batch_size=2,
              max_model_len=64, tp=2, dist_backend="gloo", warmup_mode="off")
    kw.update(setting)
    if "warmup_mode" in setting:
        # refused until warmup came to every mesh: the engine builds and
        # warms up, its programs eager on the CPU, the reason given; the
        # process-global ledger starts empty (an earlier test's engine may
        # have captured buckets of the same lattice)
        get_compile_ledger().reset()
        core = teng.EngineCore(TEngineConfig(**kw), device="cpu")
        try:
            summary = core.warmup()
            assert summary["graphs"] is False and match in summary["graph_reason"]
            assert summary["mode"] == setting["warmup_mode"]
            assert summary["coverage"] == (1.0 if setting["warmup_mode"] == "full" else 0.0)
        finally:
            core.close()
            get_compile_ledger().reset()
        return
    with pytest.raises(ValueError, match=match):
        teng.EngineCore(TEngineConfig(**kw), device="cpu")


def test_kv_heads_that_do_not_divide_are_refused_by_both_packages():
    """tiny-llama's 2 kv heads over tp=4: JAX's EngineCore cannot place
    its KV cache (the kv heads sit on "model") and raises at construction;
    the port refuses by name before any follower starts."""
    kw = dict(model="tiny-llama", block_size=4, num_blocks=16, max_batch_size=2,
              max_model_len=64)
    with pytest.raises(ValueError, match="implies that the global size"):
        jeng.EngineCore(JEngineConfig(**kw, tp=4))
    with pytest.raises(ValueError, match="num_kv_heads=2 does not divide over tp=4: the KV "
                                         "cache shards its kv heads"):
        teng.EngineCore(TEngineConfig(**kw, tp=4, dist_backend="gloo", warmup_mode="off"),
                        device="cpu")


def test_tp_refusals_that_need_the_model_or_the_device():
    """kv heads that do not divide (neither package's engine serves them)
    and nccl on the CPU raise before any follower starts."""
    base = dict(model="tiny-llama", block_size=4, num_blocks=16, max_batch_size=2,
                max_model_len=64, warmup_mode="off")
    with pytest.raises(ValueError, match="num_kv_heads=2 does not divide over tp=4"):
        teng.EngineCore(TEngineConfig(**base, tp=4, dist_backend="gloo"), device="cpu")
    with pytest.raises(ValueError, match="dist_backend='gloo'"):
        teng.EngineCore(TEngineConfig(**base, tp=2, dist_backend="nccl"), device="cpu")
    with pytest.raises(ValueError, match="num_heads=4 does not divide over tp=3"):
        tmesh.check_tp(dataclasses.replace(TCFG, num_kv_heads=3), 3)


def test_launcher_tp2_on_cpu(tmp_path):
    src = tmp_path / "prompts.jsonl"
    src.write_text('{"prompt": "one two three four", "max_tokens": 8}\n')
    base = [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
            "--model", str(CKPT), "--device", "cpu", "--block-size", "4",
            "--num-blocks", "64", "--max-model-len", "128", "--max-batch-size", "2",
            "--tp", "2", "--dist-backend", "gloo", "--input-jsonl", str(src)]
    res = subprocess.run(base + ["--warmup-mode", "off"], cwd=ROOT, capture_output=True,
                         text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    line = res.stdout.strip().splitlines()[-1]
    assert '" five six seven eight' in line and '"tokens": 8' in line
    # the default --warmup-mode lazy serves at tp=2 too (eager steps on the CPU)
    res = subprocess.run(base, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().splitlines()[-1] == line
