"""The port's worker over two nodes, as processes on the CPU: a coordinator
and, twice, two ``components.worker --device cpu --num-nodes 2 --tp 2``
processes (``--node-rank 0`` and ``1``) serving tests/data/tiny-real-llama
at f32 over gloo, one rank a node, with the worker's default
``--warmup-mode lazy`` (eager programs on the CPU).

- Each engine registers ONE instance (the leader's; node 1 registers
  nothing and prints ``FOLLOWER_READY``).
- Greedy streams through the leader equal a one-node engine's of the same
  checkpoint at f32 (the engine a one-node worker serves, here in
  process), token for token.
- Killing node 1 mid-stream fails the stream with an error at once (the
  group's collectives see the closed connection; its timeout is 60 s),
  not a hang, and later requests fail at once too.
- SIGTERM on a leader drains it and stops its node: both exit 0.
"""

from __future__ import annotations

import asyncio
import time

from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.runtime.client import EndpointClient
from dynamo_tpu_torch.runtime.protocols import EndpointId
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.utils.config import RuntimeConfig
from tests.test_torch_engine import REAL32, _run, real32  # noqa: F401
from tests.torch_mh import _req
from tests.utils_process import ManagedProcess, free_port

CKPT = "tests/data/tiny-real-llama"
SHAPE = ["--block-size", "4", "--num-blocks", "64", "--max-model-len", "128",
         "--max-batch-size", "8", "--prefill-chunk", "32"]
ARGS = ["--engine", "torch", "--device", "cpu", "--model", CKPT, "--dtype", "float32",
        *SHAPE, "--tp", "2", "--dist-backend", "gloo",
        "--num-nodes", "2", "--health-interval", "0", "--no-kv-events"]
PROMPTS = [[10 + i for i in range(9)], [40, 41, 42, 43, 44], [7] * 13]


def _nodes(url: str, component: str) -> list[ManagedProcess]:
    return [ManagedProcess(["-m", "dynamo_tpu_torch.components.worker", "--coordinator", url,
                            *ARGS, "--component", component, "--node-rank", str(k)],
                           name=f"{component}{k}").start() for k in range(2)]


def _payload(prompt: list[int], rid: str, max_tokens: int) -> dict:
    d = _req(tproto, prompt, rid, max_tokens).to_dict()
    d["model"] = CKPT
    return d


async def _drive(url: str, kill_b1) -> dict:
    rt = await DistributedRuntime.create(RuntimeConfig(coordinator_url=url))
    out: dict = {}
    try:
        clients = {}
        for comp in ("a", "b"):
            c = await EndpointClient.create(rt, EndpointId.parse(f"dyn://dynamo.{comp}.generate"))
            await c.wait_for_instances(30)
            await asyncio.sleep(0.3)       # any second instance would show by now
            clients[comp] = c
            out[f"instances_{comp}"] = len(c.instance_ids())

        async def stream(comp, prompt, rid, max_tokens, on_first=None):
            c = clients[comp]
            toks, err = [], None
            try:
                async for item in c.generate_direct(_payload(prompt, rid, max_tokens),
                                                    c.instance_ids()[0], rid):
                    toks.extend(item.get("token_ids") or [])
                    if item.get("error"):
                        err = item["error"]
                    if on_first is not None and toks:
                        on_first()
                        on_first = None
            except Exception as exc:  # noqa: BLE001 - the stream's failure is the result
                err = repr(exc)
            return toks, err

        got = await asyncio.gather(*(stream("a", p, f"a{i}", 8)
                                     for i, p in enumerate(PROMPTS)))
        out["a"] = {f"a{i}": toks for i, (toks, _) in enumerate(got)}
        out["a_errors"] = [e for _, e in got if e]
        t0 = time.monotonic()
        toks, err = await stream("b", PROMPTS[0], "b0", 100, on_first=kill_b1)
        out["b"] = (len(toks), err, time.monotonic() - t0)
        out["b_after"] = (await stream("b", PROMPTS[1], "b1", 4))[1]
        for c in clients.values():
            await c.close()
    finally:
        await rt.shutdown()
    return out


def test_two_worker_nodes_serve_fail_and_stop(real32):  # noqa: F811
    coord_port = free_port()
    coordinator = ManagedProcess(
        ["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
         "--port", str(coord_port)], name="coordinator").start()
    coordinator.wait_for_line("COORDINATOR_READY", 30)
    url = f"tcp://127.0.0.1:{coord_port}"
    a, b = _nodes(url, "a"), _nodes(url, "b")
    try:
        for leader, node in (a, b):
            node.wait_for_line("FOLLOWER_READY rank=1", 90)
            leader.wait_for_line("WORKER_READY", 90)
        out = asyncio.run(_drive(url, b[1].kill_hard))
        assert out["instances_a"] == 1 and out["instances_b"] == 1
        assert "WORKER_READY" not in a[1].logs() and "WORKER_READY" not in b[1].logs()

        core = teng.EngineCore(TEngineConfig(model=REAL32, **dict(
            block_size=4, num_blocks=64, max_model_len=128, max_batch_size=8,
            prefill_chunk=32), warmup_mode="off"), params=real32[1], device="cpu")
        want, _ = _run(core, [_req(tproto, p, f"a{i}", 8) for i, p in enumerate(PROMPTS)],
                       pipelined=True)
        assert not out["a_errors"] and out["a"] == want

        n, err, seconds = out["b"]
        assert err is not None and "op channel down" in err and n < 100 and seconds < 30, out["b"]
        assert "op channel down" in out["b_after"]

        a[0].proc.send_signal(15)
        assert a[0].proc.wait(60) == 0, a[0].logs()[-3000:]
        assert a[1].proc.wait(60) == 0, a[1].logs()[-3000:]
        assert "WORKER_DRAINED" in a[0].logs() and "FOLLOWER_DONE rank=1" in a[1].logs()
    finally:
        for p in (*a, *b):
            p.stop()
        coordinator.stop()
