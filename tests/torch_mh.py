"""Helpers of the multi-host twins (tests/test_torch_multihost*.py): the
port's engine over several "nodes" — the test's process is node 0 (the
leader), each other node a process of ``python -m
dynamo_tpu_torch.parallel.multihost`` on localhost over CPU gloo — and
the workloads of JAX's tests/multihost_rank.py.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import subprocess
import sys
from pathlib import Path

from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.parallel import multihost as mh
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.utils_process import free_port

REPO = str(Path(__file__).resolve().parent.parent)

#: JAX's engine_cfg of tests/multihost_rank.py (tp=2 x dp=2, windows of 2)
MH_CFG = dict(block_size=4, num_blocks=64, max_batch_size=8, max_model_len=128,
              prefill_chunk=32, decode_bucket=(4, 8), tp=2, dp=2, decode_window=2)
#: its kvbm mode: a tight pool (12 usable blocks) and a host tier
KVBM_CFG = {**MH_CFG, "num_blocks": 13, "host_kv_blocks": 64}


def mh_reqs(proto) -> list:
    """multihost_rank.make_reqs: three greedy requests."""
    reqs = []
    for i in range(3):
        r = proto.PreprocessedRequest(
            token_ids=[3 * i + j for j in range(5 + i)],
            stop_conditions=proto.StopConditions(max_tokens=6 + i, ignore_eos=True),
            sampling_options=proto.SamplingOptions(temperature=0.0))
        r.request_id = f"mh{i}"
        reqs.append(r)
    return reqs


def _req(proto, prompt: list[int], rid: str, max_tokens: int):
    r = proto.PreprocessedRequest(
        token_ids=prompt,
        stop_conditions=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=proto.SamplingOptions(temperature=0.0))
    r.request_id = rid
    return r


async def collect(engine, req) -> list[int]:
    toks: list[int] = []
    async for out in engine.generate(req):
        assert out.error is None, out.error
        toks.extend(out.token_ids)
    return toks


async def serve_all(engine, reqs) -> dict[str, list[int]]:
    res = await asyncio.gather(*(collect(engine, r) for r in reqs))
    return {r.request_id: t for r, t in zip(reqs, res)}


async def kvbm_workload(engine, proto) -> dict:
    """multihost_rank.run_kvbm_workload: prompt A, four disjoint fillers
    that churn A out of the device pool, prompt A again; both A streams
    and the tier counters."""
    prompt_a = [(100 + i) % 250 for i in range(24)]
    first = await collect(engine, _req(proto, prompt_a, "a1", 6))
    for i in range(4):
        await collect(engine, _req(proto, [(200 + 30 * i + j) % 250 for j in range(24)],
                                   f"f{i}", 4))
    second = await collect(engine, _req(proto, prompt_a, "a2", 6))
    kvbm = engine.core.kvbm
    return {"a1": first, "a2": second, "offloaded": kvbm.stats.offloaded_blocks,
            "onboarded": kvbm.stats.onboarded_blocks}


def start_nodes(op_port: int, num_nodes: int) -> list[subprocess.Popen]:
    """Nodes 1..num_nodes-1 as processes, each following the leader's op
    channel at ``op_port``."""
    env = {**os.environ, "PYTHONPATH": REPO, "DYN_LOG": "warning", "JAX_PLATFORMS": "cpu"}
    return [subprocess.Popen(
        [sys.executable, "-u", "-m", "dynamo_tpu_torch.parallel.multihost",
         "--op-addr", f"127.0.0.1:{op_port}", "--node-rank", str(k), "--device", "cpu",
         "--timeout", "120"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(1, num_nodes)]


def node_output(proc: subprocess.Popen, timeout: float = 60.0) -> tuple[int, str]:
    """A node's exit code and output, once it exits."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        return -9, out
    return proc.returncode, out


@contextlib.contextmanager
def multi_node(setting: dict, params=None, num_nodes: int = 2, hello_extra: dict | None = None):
    """The port's engine of ``setting`` (EngineConfig keywords) over
    ``num_nodes`` nodes: yields (AsyncTorchEngine, channel, node procs).
    The engine must be shut down inside; the nodes are awaited after."""
    channel = mh.LeaderOpChannel(0, num_nodes - 1, leader_addr=f"127.0.0.1:{free_port()}")
    if hello_extra:
        channel.hello_extra.update(hello_extra)
    procs = start_nodes(channel.port, num_nodes)
    try:
        channel.accept_followers(120)
        ec = TEngineConfig(**setting, dist_backend="gloo", warmup_mode="off",
                           num_nodes=num_nodes)
        engine = teng.build_engine(ec, params=params, device="cpu", channel=channel)
        yield engine, channel, procs
    finally:
        channel.close()
        for p in procs:
            if p.poll() is None:
                with contextlib.suppress(subprocess.TimeoutExpired):
                    p.wait(30)
            if p.poll() is None:
                p.kill()
