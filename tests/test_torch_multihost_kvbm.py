"""Rank-local KVBM tiers of the port's engine over two nodes
(kvbm/distributed.py) against the JAX package's single-process engine, on
tests/multihost_rank.py's tier workload (JAX's ``run_kvbm_workload``:
prompt A, four fillers that churn A out of a 12-block device pool, A
again), tiny-llama at f32 with bridged weights, CPU gloo.

- tp=2 x dp=2 over two nodes with a host tier: both A streams equal each
  other and JAX's, blocks cycled out and back (the counters equal JAX's);
  each rank's host tier holds its box of a block (one of the two kv
  heads: half the whole block's bytes), and no rank gathered a block.
- (tests/test_torch_multihost_g4.py: a disk tier under ``rank{k}`` that
  spills to the remote store, with voted plans.)
- A disk tier written for one shard is purged when another shard (another
  topology) opens it: JAX's fingerprint string, both packages'.
"""

from __future__ import annotations

import asyncio
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.engine.cache import KVCacheSpec as JKVCacheSpec
from dynamo_tpu.kvbm import distributed as jdist
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine.cache import KVCacheSpec
from dynamo_tpu_torch.kvbm import distributed as tdist
from dynamo_tpu_torch.kvbm.pools import DiskBlockPool
from dynamo_tpu_torch.protocols import common as tproto
from tests.test_torch_multihost import box_stub
from tests.test_torch_tp import TCFG, TINY32, tiny32  # noqa: F401
from tests.torch_mh import KVBM_CFG, kvbm_workload, multi_node, node_output


def _jax_kvbm(jp) -> dict:
    """JAX's single-process engine on the tier workload (its ``single``
    mode of tests/multihost_rank.py)."""
    async def run():
        engine = jeng.AsyncJaxEngine(jeng.EngineCore(
            JEngineConfig(model=TINY32, **KVBM_CFG), params=jp))
        try:
            return await kvbm_workload(engine, jproto)
        finally:
            await engine.shutdown()

    return asyncio.run(run())


def test_two_nodes_host_tier_holds_each_ranks_box(tiny32):  # noqa: F811
    jp, full = tiny32

    async def run(engine):
        out = await kvbm_workload(engine, tproto)
        out["ranks"] = await engine.run_op("tp_stats", {})
        await engine.shutdown()
        return out

    jax_ref = ThreadPoolExecutor(1).submit(_jax_kvbm, jp)   # beside the nodes
    with multi_node(dict(model=TINY32, **KVBM_CFG), params=full) as (engine, _, procs):
        multi = asyncio.run(run(engine))
        whole = engine.core.runner.block_spec.bytes_per_block()
    rc, out = node_output(procs[0])
    assert rc == 0, out
    single = jax_ref.result()
    assert multi["offloaded"] > 0 and multi["onboarded"] > 0
    assert (multi["offloaded"], multi["onboarded"]) == (single["offloaded"], single["onboarded"])
    assert multi["a2"] == multi["a1"]
    assert multi["a1"] == single["a1"] and multi["a2"] == single["a2"]
    for r in multi["ranks"]:
        blocks, nbytes = r["tiers"]["host"]
        assert blocks == multi["offloaded"] and nbytes == blocks * whole // 2, r["tiers"]
        assert r["block_moves"] == 0     # no block crossed a rank


def test_a_disk_tier_of_another_shard_is_purged(tmp_path):
    """rank k's disk tier is fingerprinted ``model|shard(L..,H..)`` (JAX's
    string for the same box); a tier opened for another box purges what
    the first wrote, so no rank ever reads another shard's bytes."""
    spec = KVCacheSpec.for_model(TCFG, 16, 4)
    jspec = JKVCacheSpec(num_layers=spec.num_layers, num_blocks=16, block_size=4,
                         num_kv_heads=spec.num_kv_heads, head_dim=spec.head_dim,
                         dtype=spec.dtype)
    fps = []
    for k in range(2):
        group = box_stub(tp=2, model_rank=k)
        box = tdist.local_box(group, spec.num_layers, spec.num_kv_heads)
        local, fp = tdist.local_block_spec(spec, box)
        jlocal, jfp = jdist.local_block_spec(jspec, box_stub(tp=2, model_rank=k, jax_spec=jspec))
        assert fp == jfp and (local.num_layers, local.num_kv_heads) == (
            jlocal.num_layers, jlocal.num_kv_heads)
        fps.append((local, fp))
    (local, fp0), (_, fp1) = fps
    path = tmp_path / "rank0"
    tier = DiskBlockPool(local, path, fingerprint=f"{TINY32}|{fp0}")
    block = np.ones((2, local.num_layers, 4, local.num_kv_heads, local.head_dim), np.uint16)
    tier.put(7, block)
    assert 7 in DiskBlockPool(local, path, fingerprint=f"{TINY32}|{fp0}")
    other = DiskBlockPool(local, path, fingerprint=f"{TINY32}|{fp1}")
    assert 7 not in other and len(other) == 0 and not list(path.glob("*.kvb"))
    assert dataclasses.replace(local, num_kv_heads=2).bytes_per_block() == \
        2 * local.bytes_per_block()
