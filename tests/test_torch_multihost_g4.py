"""The port's engine over two nodes (tp=2, one rank a node) with rank-local
disk tiers that spill to a shared remote store (kvbm/distributed.py,
``kvbm/remote.py``'s server), on tests/multihost_rank.py's tier workload
(JAX's ``run_kvbm_workload``), tiny-llama at f32 with bridged weights,
CPU gloo: each rank's disk tier of four blocks sits under ``rank{k}``
with its shard's fingerprint, the store holds each rank's box under a
namespace of its own, onboard plans are voted (``vote_plans``: the
store's answers may differ between ranks), and A's streams equal each
other and JAX's single-process stream of the same prompt.
"""

from __future__ import annotations

import asyncio

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.kvbm import remote as tremote
from dynamo_tpu_torch.protocols import common as tproto
from tests.test_torch_engine import _run
from tests.test_torch_kvbm_remote import StoreFixture
from tests.test_torch_tp import TCFG, TINY32, tiny32  # noqa: F401
from tests.torch_mh import MH_CFG, _req, kvbm_workload, multi_node, node_output


def test_two_nodes_disk_and_remote_tiers_vote(tiny32, tmp_path):  # noqa: F811
    jp, full = tiny32
    store = StoreFixture(tremote, capacity_bytes=1 << 22)
    box_bytes = TCFG.num_layers * 2 * 4 * 1 * TCFG.head_dim * 4    # f32, 1 of 2 kv heads
    setting = dict(model=TINY32, **{**MH_CFG, "dp": 1, "num_blocks": 13},
                   disk_kv_path=str(tmp_path / "kv"), disk_kv_bytes=4 * box_bytes,
                   remote_kv_addr=store.addr)
    try:
        async def run(engine):
            out = await kvbm_workload(engine, tproto)
            out["ranks"] = await engine.run_op("tp_stats", {})
            out["vote"] = engine.core.kvbm.vote_plans
            await engine.shutdown()
            return out

        with multi_node(setting, params=full) as (engine, _, procs):
            multi = asyncio.run(run(engine))
        rc, out = node_output(procs[0])
        namespaces = {ns for ns, _ in store.server._store}
    finally:
        store.close()
    assert rc == 0, out
    assert multi["vote"] and multi["offloaded"] > 0 and multi["onboarded"] > 0
    assert multi["a2"] == multi["a1"]
    cfg = JEngineConfig(model=TINY32, **{**MH_CFG, "dp": 1})
    prompt_a = [(100 + i) % 250 for i in range(24)]
    want, _ = _run(jeng.EngineCore(cfg, params=jp), [_req(jproto, prompt_a, "a1", 6)])
    assert multi["a1"] == want["a1"]
    for k, r in enumerate(multi["ranks"]):
        disk = r["tiers"]["disk"]
        assert 0 < disk[0] <= 4 and disk[1] == disk[0] * box_bytes, r["tiers"]
        files = list((tmp_path / "kv" / f"rank{k}").glob("*.kvb"))
        assert len(files) == disk[0]
        manifest = (tmp_path / "kv" / f"rank{k}" / "MANIFEST").read_text()
        assert manifest.startswith(f"{TINY32}|shard(L0:2,H{k}:{k + 1})|")
    # the spill reached the store, one namespace a rank's shard
    assert len(namespaces) == 2
