"""The disaggregated handoff with an engine over two nodes, on the CPU
(tests/test_multihost.py's north-star composition, tests/multihost_rank.py's
24-token prompt): tiny-llama at f32 with bridged weights, tp=2 over two
nodes, one rank a node.

- A prefill engine over two nodes stages the prompt's blocks on both
  ranks (each its box: one of the two kv heads), one transfer in one shot
  and one streamed wave by wave, and serves them from two shard servers
  (the leader's, and node 1's, listed from its ``ready``); a one-node
  decode engine pulls every box from both, injects them and generates.
- A one-node prefill engine feeds a decode engine over two nodes: each
  rank pulls and injects its own box.

Every decode stream equals the single-process aggregated one (the port's
and JAX's), and the pulls touched both shard servers.
"""

from __future__ import annotations

import asyncio

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.disagg import sharded
from dynamo_tpu_torch.disagg.handlers import PrefillHandler
from dynamo_tpu_torch.disagg.receiver import pull_and_import
from dynamo_tpu_torch.disagg.source import KvTransferSource
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _run
from tests.test_torch_tp import TINY32, tiny32  # noqa: F401
from tests.torch_mh import MH_CFG, _req, collect, multi_node, node_output

PROMPT = list(range(60, 84))      # 24 tokens = 6 blocks of 4
SETTING = dict(model=TINY32, **{**MH_CFG, "dp": 1})
ONE_NODE = dict(model=TINY32, **{**MH_CFG, "dp": 1, "tp": 1}, warmup_mode="off")


class _Ctx:
    def is_cancelled(self):
        return False


def _want(jp, full) -> list[int]:
    """The single-process aggregated stream: the port's, equal to JAX's."""
    jgot, _ = _run(jeng.EngineCore(JEngineConfig(**SETTING), params=jp),
                   [_req(jproto, PROMPT, "dx", 6)])
    tgot, _ = _run(teng.EngineCore(TEngineConfig(**ONE_NODE), params=full, device="cpu"),
                   [_req(tproto, PROMPT, "dx", 6)])
    assert tgot == jgot
    return tgot["dx"]


def _count_fetches(monkeypatch) -> list[str]:
    seen: list[str] = []
    fetch = sharded.ShardClient.fetch

    def counted(self, *a, **kw):
        seen.append(self.addr)
        return fetch(self, *a, **kw)

    monkeypatch.setattr(sharded.ShardClient, "fetch", counted)
    return seen


def test_prefill_over_two_nodes_feeds_a_one_node_decode(tiny32, monkeypatch):  # noqa: F811
    jp, full = tiny32
    seen = _count_fetches(monkeypatch)

    async def run(prefill_engine):
        source = KvTransferSource(prefill_engine, advertise_host="127.0.0.1",
                                  extra_shards=prefill_engine.core.follower_shards())
        source.start()
        out = {}
        try:
            for stream in (False, True):
                handler = PrefillHandler(prefill_engine, source, block_size=4, stream=stream)
                items = [i async for i in handler.generate(
                    _req(tproto, PROMPT, f"p{int(stream)}", 6).to_dict(), _Ctx())]
                params = items[-1]["kv_transfer_params"]
                decode = teng.AsyncTorchEngine(teng.EngineCore(
                    TEngineConfig(**ONE_NODE), params=full, device="cpu"))
                try:
                    out[stream] = (len(params["shards"]),
                                   await pull_and_import(decode, params),
                                   await collect(decode, _req(tproto, PROMPT, "dx", 6)))
                finally:
                    await decode.shutdown()
            out["stats"] = await prefill_engine.run_op("tp_stats", {})
        finally:
            await source.stop()
            await prefill_engine.shutdown()
        return out

    with multi_node(SETTING, params=full, hello_extra={"disagg_role": "prefill"}) as (
            engine, _, procs):
        out = asyncio.run(run(engine))
    rc, log = node_output(procs[0])
    assert rc == 0, log
    want = _want(jp, full)
    shards, injected, toks = out[False]
    assert shards == 2 and injected == 5 and toks == want   # (24 - 1) // 4 blocks
    shards, injected, toks = out[True]
    assert shards == 2 and injected == 5 and toks == want
    assert len(set(seen)) >= 2                 # both shard servers answered
    assert all(r["block_moves"] == 0 for r in out["stats"])


def test_one_node_prefill_feeds_a_decode_over_two_nodes(tiny32, monkeypatch):  # noqa: F811
    jp, full = tiny32
    seen = _count_fetches(monkeypatch)

    async def run(decode):
        prefill = teng.AsyncTorchEngine(teng.EngineCore(TEngineConfig(**ONE_NODE), params=full,
                                                        device="cpu"))
        source = KvTransferSource(prefill, advertise_host="127.0.0.1")
        source.start()
        try:
            items = [i async for i in PrefillHandler(prefill, source, block_size=4).generate(
                _req(tproto, PROMPT, "p", 6).to_dict(), _Ctx())]
            params = items[-1]["kv_transfer_params"]
            injected = await pull_and_import(decode, params)
            toks = await collect(decode, _req(tproto, PROMPT, "dx", 6))
            ranks = await decode.run_op("tp_stats", {})
        finally:
            await source.stop()
            await prefill.shutdown()
            await decode.shutdown()
        return params, injected, toks, ranks

    with multi_node(SETTING, params=full) as (engine, _, procs):
        params, injected, toks, ranks = asyncio.run(run(engine))
    rc, log = node_output(procs[0])
    assert rc == 0, log
    assert len(params["shards"]) == 1 and injected == 5
    assert toks == _want(jp, full)
    # the leader fetched its box here; node 1's rank fetched its own there
    assert seen and all(r["block_moves"] == 0 for r in ranks)
