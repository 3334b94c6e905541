"""Tensor-parallel engines at parity with one rank, on the CPU: the port's
sharded block mover (``kvbm/transfer.TPTransferEngine``, two gloo ranks a
process each), ``export_blocks`` / ``import_blocks`` and the disaggregated
handoff of a tp=2 engine, against JAX's tp=2 engine on the conftest's
fake devices and the port's own tp=1 engine (tiny-llama at f32 with
bridged weights, tests/test_torch_kvbm.tiny32).

JAX's engine at one process presents whole blocks (every kv head) to
``export_blocks`` and its tiers; so does the port's leader, whatever its
tp, and blocks cross between tp=2 and tp=1 engines.

Tolerances, with their reasons:
- the mover's blocks: byte for byte against ``BlockTransferEngine`` over
  an unsharded cache of the same content (each byte one rank's plus
  zeros), at bf16, int8 and int4, packed and dequantized; after an inject
  every rank's heads equal that mover's inject into the whole cache;
- ``export_blocks`` at tp=2 against JAX's tp=2: atol 1e-5 (f32 K and V
  one projection and rope from hidden states the two packages sum in
  other orders; tests/test_torch_tp.py holds the forward at 1e-4);
- streams: identical greedy tokens;
- ``paged_attention_sharded`` on a (data, model) = (2, 2) mesh against
  JAX's shard_map'd kernel in interpret mode: 2e-5, as
  tests/test_torch_tp.py holds it on the model axis alone.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu.parallel.mesh import MeshConfig as JMeshConfig
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.kvbm import transfer as ttr
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.tokens import TokenBlockSequence
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests import torch_tp_rank
from tests.test_torch_kv_quant import _quant_case, _t
from tests.test_torch_kvbm import engine_kw, make_caches, req, run, tiny32  # noqa: F401

EXPORT_ATOL = 1e-5
#: prompts of 6 whole blocks of 4 (and one token past them)
PROMPTS = {name: [(k * j + c) % 500 for j in range(25)]
           for name, (k, c) in {"a": (17, 5), "b": (13, 40), "c": (11, 90)}.items()}
HASHES = {name: TokenBlockSequence.from_tokens(p, 4).sequence_hashes()
          for name, p in PROMPTS.items()}


# ---------------------------------------------------------------------------
# the per-rank launch on the data axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_paged_attention_sharded_on_data_and_model(kind):
    """Rows over "data" and heads over "model" (dp = tp = 2): four launches
    of the kernel's plain version on their rows and heads against JAX's
    kernel shard_map'd over both axes, and against the port's unsharded
    call; rows that do not divide are refused."""
    rng = np.random.default_rng(11)
    geo = dict(b=4, t=4, h=8, kh=2, d=64, nb=32, bs=16, nblk=4)
    q, (kq, ks), (vq, vs), bt, qs, kl = _quant_case(rng, "int8" if kind == "float" else kind,
                                                   **geo)
    if kind == "float":
        k = rng.standard_normal(kq.shape).astype(np.float32)
        v = rng.standard_normal(vq.shape).astype(np.float32)
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
    else:
        jk = {"q": jnp.asarray(kq), "s": jnp.asarray(ks)}
        jv = {"q": jnp.asarray(vq), "s": jnp.asarray(vs)}
        tk, tv = {"q": _t(kq), "s": _t(ks)}, {"q": _t(vq), "s": _t(vs)}
    mesh = make_mesh(JMeshConfig(dp=2, tp=2))
    ref = jpa.paged_attention_sharded(mesh, jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                      jnp.asarray(qs), jnp.asarray(kl), interpret=True)
    args = (_t(q), tk, tv, _t(bt), _t(qs), _t(kl))
    out = tpa.paged_attention_sharded(*args, tp=2, dp=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), tpa.paged_attention(*args).numpy(),
                               atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="does not divide over dp=3"):
        tpa.paged_attention_sharded(*args, tp=2, dp=3)


# ---------------------------------------------------------------------------
# the sharded block mover, two ranks
# ---------------------------------------------------------------------------

KINDS = ("bfloat16", "int8", "int4")
IDS = [3, 1, 6]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Each kind's whole caches, the blocks injected, and what the two
    ranks (each holding one of the 2 kv heads) extracted and kept."""
    rng = np.random.default_rng(7)
    cases, whole = {}, {}
    for kind in KINDS:
        _, (tk, tv) = make_caches(kind, rng)
        _, (sk, sv) = make_caches(kind, rng)          # a second content to inject
        ref = ttr.BlockTransferEngine()
        packed = ref.extract(sk, sv, IDS)
        floats = [b.astype(np.float32) for b in ref.extract(sk, sv, IDS, dequant=True)] \
            if kind != "bfloat16" else [ttr.block_to_f32(b) for b in packed]
        cases[kind] = (tk, tv, IDS, [packed, floats])
        whole[kind] = (tk, tv)
    got = torch_tp_rank.run_ranks(torch_tp_rank.transfer_rank, 2,
                                  tmp_path_factory.mktemp("transfer"), cases)
    return cases, whole, got


def _cache_np(c):
    if isinstance(c, dict):
        return {k: v.numpy() for k, v in c.items()}
    return torch_tp_rank._bits(c)


@pytest.mark.parametrize("kind", KINDS)
def test_tp_transfer_assembles_whole_blocks(sharded, kind):
    """Blocks gathered from two ranks' kv heads are byte-equal to
    ``BlockTransferEngine``'s extract of the unsharded cache (packed, and
    float32 with ``dequant`` for a quantized one); blocks injected through
    the ranks leave each rank's heads equal to that mover's inject into
    the whole cache, for blocks of the cache's own format and f32 blocks
    (quantized on each rank, per head)."""
    cases, whole, got = sharded
    tk, tv = (c.clone() if not isinstance(c, dict) else {k: v.clone() for k, v in c.items()}
              for c in whole[kind])
    ref = ttr.BlockTransferEngine()
    want = [[b.tobytes() for b in ref.extract(tk, tv, IDS)]]
    if kind != "bfloat16":
        want.append([b.tobytes() for b in ref.extract(tk, tv, IDS, dequant=True)])
    leader = got[0][kind]
    assert leader[0] == want
    for blocks in cases[kind][3]:
        ref.inject(tk, tv, IDS, blocks)
    for rank in (0, 1):
        for mine, full in zip(got[rank][kind][1:3], (tk, tv)):
            theirs = _cache_np(torch_tp_rank._heads(full, rank, 2))
            if isinstance(theirs, dict):
                for key in ("q", "s"):
                    np.testing.assert_array_equal(mine[key], theirs[key])
            else:
                np.testing.assert_array_equal(mine, theirs)
    stats = leader[3]
    assert stats["extracts"] == len(want) and stats["injects"] == 2
    assert stats["gather_bytes"] > 0 and stats["scatter_bytes"] > 0


# ---------------------------------------------------------------------------
# engines: export, import, handoff
# ---------------------------------------------------------------------------

def _kw(**kw) -> dict:
    return engine_kw(num_blocks=64, **kw)


@pytest.fixture(scope="module")
def tp2(tiny32):  # noqa: F811
    """The port's tp=2 engine over tiny32's weights (one tensor-parallel
    engine a process: every engine case below shares it)."""
    core = teng.EngineCore(TEngineConfig(**_kw(), tp=2, dist_backend="gloo",
                                         warmup_mode="off"), params=tiny32[1], device="cpu")
    yield core
    core.stop_shard_server()
    core.close()


def _tp1(tiny32):  # noqa: F811
    return teng.EngineCore(TEngineConfig(**_kw()), params=tiny32[1], device="cpu")


def _export(core, name: str) -> tuple[list[int], list]:
    proto = jproto if isinstance(core, jeng.EngineCore) else tproto
    toks = run(core, [req(proto, PROMPTS[name], f"src-{name}", 6)])[f"src-{name}"]
    return toks, core.export_blocks(HASHES[name])


def _receive(core, name: str, plan) -> dict:
    """Serve prompt ``name`` on ``core`` after clearing its prefix cache
    and importing ``plan``: its tokens, the blocks imported and the tokens
    prefilled."""
    core.pool.clear()
    n = core.import_blocks(plan)
    pre = core.metrics.num_prefill_tokens
    toks = run(core, [req(tproto, PROMPTS[name], f"dst-{name}", 6)])[f"dst-{name}"]
    return {"imported": n, "tokens": toks, "prefill": core.metrics.num_prefill_tokens - pre}


def test_export_blocks_tp2_matches_jax_tp2(tiny32, tp2):  # noqa: F811
    """The same prompt through the port's and JAX's tp=2 engines: equal
    greedy tokens, and ``export_blocks`` gives the same chain of whole
    blocks ([2, L, BS, KH, D] f32, every kv head) within EXPORT_ATOL."""
    jcore = jeng.EngineCore(JEngineConfig(**_kw(), tp=2), params=tiny32[0])
    jtoks, jplan = _export(jcore, "a")
    ttoks, tplan = _export(tp2, "a")
    assert ttoks == jtoks
    assert [(h, p) for h, p, _ in tplan] == [(h, p) for h, p, _ in jplan]
    assert len(tplan) == len(HASHES["a"]) == 6
    for (_, _, t), (_, _, j) in zip(tplan, jplan):
        assert t.shape == np.asarray(j).shape == (2, 2, 4, 2, 16) and t.dtype == np.float32
        np.testing.assert_allclose(t, np.asarray(j), atol=EXPORT_ATOL, rtol=0)


@pytest.mark.parametrize("direction", ["tp2->tp1", "tp1->tp2"])
def test_blocks_cross_tp2_and_tp1(tiny32, tp2, direction):  # noqa: F811
    """A chain exported by one engine and imported by the other, whose
    prefix cache was cleared: the receiver prefills only the token past
    the imported blocks and gives its own stream of the prompt."""
    one = _tp1(tiny32)
    src, dst = (tp2, one) if direction == "tp2->tp1" else (one, tp2)
    name = "b" if direction == "tp2->tp1" else "c"
    own = run(dst, [req(tproto, PROMPTS[name], f"own-{name}", 6)])[f"own-{name}"]
    _, plan = _export(src, name)
    got = _receive(dst, name, plan)
    assert got == {"imported": 6, "tokens": own, "prefill": 1}


def test_disagg_prefill_at_tp2_decoded_at_tp1(tiny32, tp2):  # noqa: F811
    """The handoff's core ops across a tp=2 prefill engine and a tp=1
    decode engine: the prefill side stages the chain (whole blocks from
    both ranks) and serves it from its shard server (one shard: the whole
    box), the decode side pulls and imports it and decodes the prompt as
    a local prefill would, prefilling one token; the release returns
    every pin."""
    one = _tp1(tiny32)
    own = run(one, [req(tproto, PROMPTS["a"], "own", 6)])["own"]
    one.pool.clear()
    run(tp2, [req(tproto, PROMPTS["a"], "prefill", 1)])
    free0 = tp2.pool.num_free
    assert tp2.run_op("kv_stage", {"xfer_id": "x1", "hashes": HASHES["a"]}) == 6
    addr = tp2.start_shard_server("127.0.0.1")
    params = {"xfer_id": "x1", "block_hashes": HASHES["a"],
              "shards": [{"addr": addr, "box": list(tp2.my_box())}]}
    assert tp2.my_box() == (0, 2, 0, 2)
    one.run_op("kv_prefetch", {"params": params})
    assert one.run_op("kv_import", {"params": params}) == 6
    tp2.run_op("kv_release", {"xfer_id": "x1"})
    assert tp2.pool.num_free == free0
    assert not tp2._staged_pins
    pre = one.metrics.num_prefill_tokens
    got = run(one, [req(tproto, PROMPTS["a"], "decode", 6)])["decode"]
    assert got == own and one.metrics.num_prefill_tokens - pre == 1
    assert tp2.transfer.stats.snapshot()["gather_bytes"] > 0
