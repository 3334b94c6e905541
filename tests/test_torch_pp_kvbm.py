"""Block moves of a pipeline-parallel engine, on the CPU: the port's
block mover over a cache split by layers (``kvbm/transfer.TPTransferEngine``,
two gloo stages a process each), ``export_blocks`` / ``import_blocks`` of
a pp=2 engine against the port's pp=1 engine, and the host tier's round
trip against JAX's pp=2 engine (tiny-llama at f32 with bridged weights,
tests/test_torch_kvbm.tiny32).

Host blocks are whole blocks (every layer) at any pp, so blocks move
freely between engines of any pp.

Tolerances, with their reasons:
- the mover's blocks: byte for byte against ``BlockTransferEngine`` over
  an unsharded cache of the same content (each byte one stage's plus
  zeros), at bf16, int8 and int4, packed and dequantized; after an inject
  each stage's layers equal that mover's inject into the whole cache;
- ``export_blocks`` at pp=2 against pp=1: byte for byte (each stage runs
  its layer on the same rows in the same order as one device does);
- streams and tier counts: identical.
"""

from __future__ import annotations

import numpy as np
import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.kvbm import transfer as ttr
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests import torch_pp_rank, torch_tp_rank
from tests.test_torch_kvbm import (  # noqa: F401
    engine_kw,
    make_caches,
    offload_onboard,
    req,
    run,
    tiny32,
)
from tests.test_torch_tp_parity import HASHES, IDS, PROMPTS, _cache_np

KINDS = ("bfloat16", "int8", "int4")


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Each kind's whole caches, the blocks injected, and what the two
    stages (each holding one of the 2 layers) extracted and kept."""
    rng = np.random.default_rng(9)
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
    got = torch_tp_rank.run_ranks(torch_pp_rank.transfer_pp_rank, 2,
                                  tmp_path_factory.mktemp("transfer-pp"), cases)
    return cases, whole, got


@pytest.mark.parametrize("kind", KINDS)
def test_pp_transfer_assembles_whole_blocks(staged, kind):
    """Blocks gathered from two stages' layers are byte-equal to
    ``BlockTransferEngine``'s extract of the unsharded cache (packed, and
    float32 with ``dequant`` for a quantized one); blocks injected through
    the stages leave each stage's layers equal to that mover's inject into
    the whole cache, for blocks of the cache's own format and f32 blocks
    (quantized on each stage, per layer)."""
    cases, whole, got = staged
    tk, tv = (c.clone() if not isinstance(c, dict) else {k: v.clone() for k, v in c.items()}
              for c in whole[kind])
    ref = ttr.BlockTransferEngine()
    want = [[b.tobytes() for b in ref.extract(tk, tv, IDS)]]
    if kind != "bfloat16":
        want.append([b.tobytes() for b in ref.extract(tk, tv, IDS, dequant=True)])
    assert got[0][kind][0] == want
    for blocks in cases[kind][3]:
        ref.inject(tk, tv, IDS, blocks)
    for stage in (0, 1):
        for mine, full in zip(got[stage][kind][1:3], (tk, tv)):
            theirs = _cache_np(torch_pp_rank._layers(full, stage, 2))
            if isinstance(theirs, dict):
                for key in ("q", "s"):
                    np.testing.assert_array_equal(mine[key], theirs[key])
            else:
                np.testing.assert_array_equal(mine, theirs)


def _port(tiny32, **kw):  # noqa: F811
    return teng.EngineCore(TEngineConfig(**engine_kw(**kw), dist_backend="gloo",
                                         warmup_mode="off"), params=tiny32[1], device="cpu")


def test_export_at_pp2_is_byte_equal_to_pp1_and_blocks_cross(tiny32):  # noqa: F811
    """The same prompt through the port's pp=1 and pp=2 engines: equal
    tokens and byte-equal whole blocks (every layer) from
    ``export_blocks``; the pp=2 engine's chain, imported by the pp=1
    engine after its prefix cache is cleared, prefills one token and gives
    the prompt's stream, and the other way round."""
    one = teng.EngineCore(TEngineConfig(**engine_kw()), params=tiny32[1], device="cpu")
    two = _port(tiny32, pp=2)
    try:
        out = {}
        for name, core in (("one", one), ("two", two)):
            toks = run(core, [req(tproto, PROMPTS["a"], f"{name}-a", 6)])[f"{name}-a"]
            out[name] = (toks, core.export_blocks(HASHES["a"]))
        assert out["one"][0] == out["two"][0]
        assert len(out["two"][1]) == len(HASHES["a"]) == 6
        for (h1, p1, b1), (h2, p2, b2) in zip(out["one"][1], out["two"][1]):
            assert (h1, p1) == (h2, p2) and b1.shape == b2.shape == (2, 2, 4, 2, 16)
            assert b1.tobytes() == b2.tobytes()
        for src, dst, name in ((two, one, "b"), (one, two, "c")):
            own = run(dst, [req(tproto, PROMPTS[name], f"own-{name}", 6)])[f"own-{name}"]
            run(src, [req(tproto, PROMPTS[name], f"src-{name}", 6)])
            plan = src.export_blocks(HASHES[name])
            dst.pool.clear()
            assert dst.import_blocks(plan) == 6
            pre = dst.metrics.num_prefill_tokens
            got = run(dst, [req(tproto, PROMPTS[name], f"dst-{name}", 6)])[f"dst-{name}"]
            assert got == own and dst.metrics.num_prefill_tokens - pre == 1
        moved = two.transfer.stats.snapshot()
        assert moved["gather_bytes"] > 0 and moved["scatter_bytes"] > 0
    finally:
        two.close()


def test_offload_onboard_pp2_matches_jax_pp2(tiny32):  # noqa: F811
    """A prompt's blocks evicted to the host tier by fillers and onboarded
    for the prompt again, on an int8 cache: JAX pp=2's streams, offloaded
    and onboarded counts and prefill tokens; the tier holds whole blocks
    (every layer) and each stage's cache its layer."""
    kw = engine_kw(num_blocks=13, kv_dtype="int8", host_kv_blocks=64)
    jres = offload_onboard(jeng.EngineCore(JEngineConfig(**kw, pp=2), params=tiny32[0]))
    core = _port(tiny32, pp=2, num_blocks=13, kv_dtype="int8", host_kv_blocks=64)
    try:
        tres = offload_onboard(core)
        host = core.kvbm.tiers[0]
        assert host.spec.num_layers == 2 and core.runner.spec.num_layers == 1
    finally:
        core.close()
    assert tres == jres
    assert tres["offloaded"] > 0 and tres["onboarded"] > 0 and tres["second"] == tres["first"]
