"""The port's engine over two nodes against the JAX package's single-process
engine: tests/multihost_rank.py's workload (3 greedy requests, block size
4, ``decode_bucket=(4, 8)``, ``decode_window=2``, ``prefill_chunk=32``)
on tiny-llama at f32 with bridged weights, tp=2 x dp=2 = 4 ranks, node 0
(this process: ranks 0-1) and node 1 (a process: ranks 2-3) over CPU gloo.
The leader serves through ``AsyncTorchEngine`` with the op channel's
broadcast as its op sink, as JAX's leader does.

Every greedy stream must equal JAX's single-process tp=2 x dp=2 engine's
and the port's one-node engine's, token for token (f32: identical greedy
streams); every rank runs the same forward steps; at shutdown every
follower, local and remote, exits 0 and none is killed (ROADMAP Queue 3
item 13's guard on the CPU).
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _run
from tests.test_torch_tp import TINY32, tiny32  # noqa: F401
from tests.torch_mh import MH_CFG, mh_reqs, multi_node, node_output, serve_all


def test_two_nodes_serve_jax_single_process_streams(tiny32):  # noqa: F811
    jp, full = tiny32
    kw = dict(model=TINY32, **MH_CFG)

    async def serve(engine):
        got = await serve_all(engine, mh_reqs(tproto))
        ranks = await engine.run_op("tp_stats", {})
        await engine.shutdown()
        return got, ranks

    # JAX's single-process streams on a thread of their own, while the
    # nodes start and serve
    jax_ref = ThreadPoolExecutor(1).submit(
        lambda: _run(jeng.EngineCore(JEngineConfig(**kw), params=jp), mh_reqs(jproto))[0])
    with multi_node(kw, params=full) as (engine, channel, procs):
        multi, ranks = asyncio.run(serve(engine))
        stops = engine.core.shutdown_stats
        frames = channel.frames
    rc, out = node_output(procs[0])

    want = jax_ref.result()
    assert set(multi) == {"mh0", "mh1", "mh2"}
    for rid in want:
        assert multi[rid] == want[rid], f"stream {rid} diverged across nodes"
        assert len(multi[rid]) == 6 + int(rid[-1])   # exact max_tokens each
    core = teng.EngineCore(TEngineConfig(**kw, dist_backend="gloo", warmup_mode="off"),
                           params=full, device="cpu")
    try:
        one, _ = _run(core, mh_reqs(tproto), pipelined=True)
    finally:
        core.close()
    assert one == multi

    # node 1 holds world ranks 2 and 3 (replica 1); every rank ran the same
    # forward steps, and no rank moved a block
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert [r["data_rank"] for r in ranks] == [0, 0, 1, 1]
    assert len({r["forward_steps"] for r in ranks}) == 1 and ranks[0]["forward_steps"] > 0
    assert all(r["block_moves"] == 0 for r in ranks)
    # the op stream reached node 1: its hello, one frame an op, the stop
    assert frames > 3
    # item 13: the leader left its group first; every follower exited 0
    assert stops["killed"] == 0 and stops["exit_codes"] == [0], stops
    assert rc == 0 and "FOLLOWER_READY rank=1" in out and "FOLLOWER_DONE" in out, out
