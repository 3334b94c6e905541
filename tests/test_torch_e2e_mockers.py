"""Twins of ``tests/test_e2e_mockers.py`` on the port's processes: the
coordinator, ``--engine mocker`` workers and the frontend of
``dynamo_tpu_torch``, driven over HTTP.

Each case is the JAX test function itself, re-bound so that every process
it spawns runs the port's module of the same name (:class:`PortProcess`).
What a case observes from outside (the coordinator's published metrics,
its keys) it reads through the JAX package's client, which speaks the same
wire. Two more cases hold the port's frontend to keeping a removed
model's pipeline for its replacement, and to outliving a short lease
while it starts.
"""

from __future__ import annotations

import asyncio
import time
import types

import pytest

import tests.test_e2e_mockers as jax_e2e
from tests.utils_process import ManagedProcess, free_port


class PortProcess(ManagedProcess):
    """A ManagedProcess that runs ``-m dynamo_tpu_torch.<module>`` where it
    is given ``-m dynamo_tpu.<module>``."""

    def __init__(self, args: list[str], name: str = "proc", env: dict | None = None):
        args = [a.replace("dynamo_tpu.", "dynamo_tpu_torch.", 1)
                if a.startswith("dynamo_tpu.") else a for a in args]
        super().__init__(args, name=name, env=env)


def on_port(fn):
    """``fn`` (a JAX test or fixture function) spawning the port's processes."""
    g = dict(fn.__globals__)
    g["ManagedProcess"] = PortProcess
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


@pytest.fixture(scope="module")
def cluster():
    """tests/test_e2e_mockers.py's cluster: a coordinator, two mocker
    workers and the frontend, the port's."""
    yield from on_port(jax_e2e.cluster.__wrapped__)()


def test_model_discovered(cluster):
    on_port(jax_e2e.test_model_discovered)(cluster)


def test_chat_completion_roundtrip(cluster):
    on_port(jax_e2e.test_chat_completion_roundtrip)(cluster)


def test_concurrent_requests_complete(cluster):
    on_port(jax_e2e.test_concurrent_requests_complete)(cluster)


def test_kv_routing_prefix_affinity(cluster):
    on_port(jax_e2e.test_kv_routing_prefix_affinity)(cluster)


def test_worker_death_migration(cluster):
    on_port(jax_e2e.test_worker_death_migration)(cluster)


def test_client_disconnect_aborts_generation():
    on_port(jax_e2e.test_client_disconnect_aborts_generation)()


def test_coordinator_restart_recovery():
    on_port(jax_e2e.test_coordinator_restart_recovery)()


def test_workers_run_the_port():
    """The processes the twins spawn are the port's modules."""
    p = PortProcess(["-m", "dynamo_tpu.components.worker", "--engine", "mocker"])
    assert p.args[2:4] == ["-m", "dynamo_tpu_torch.components.worker"]
    assert p.args[4:] == ["--engine", "mocker"]


# ---------------------------------------------------------------------------
# The frontend across a model's gap (the fault tests/test_torch_chaos.py's
# mid-decode smoke found)
# ---------------------------------------------------------------------------

async def test_frontend_keeps_a_removed_models_pipeline_for_its_replacement():
    """When a model's last instance leaves, the frontend drops the model
    but keeps its pipeline open: the endpoint client a migrating stream
    waits on still watches, sees the replacement, and the replacement
    re-registers the model over the same pipeline."""
    import json

    from dynamo_tpu_torch.components.frontend import ModelWatcher, parse_args
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.runtime.protocols import MODEL_PREFIX
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    from dynamo_tpu_torch.transports.coordinator import CoordinatorServer
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    server = CoordinatorServer()
    await server.start()
    card = json.dumps({"name": "m", "endpoint": "dynamo.backend.generate",
                       "tokenizer": "tiny-llama", "kv_events": False}).encode()

    async def handler(payload, ctx):
        yield {"token_ids": [1], "finish_reason": "length"}

    async def worker():
        rt = await DistributedRuntime.create(RuntimeConfig(coordinator_url=server.url))
        await rt.namespace("dynamo").component("backend").endpoint("generate").serve(handler)
        await rt.client.put(f"{MODEL_PREFIX}/m/{rt.instance_id:016x}", card,
                            lease_id=rt.primary_lease.id)
        return rt

    async def until(pred, timeout=10.0):
        deadline = asyncio.get_running_loop().time() + timeout
        while not pred():
            assert asyncio.get_running_loop().time() < deadline, "timed out"
            await asyncio.sleep(0.02)

    front = await DistributedRuntime.create(RuntimeConfig(coordinator_url=server.url))
    models = ModelManager()
    watcher = ModelWatcher(front, models, parse_args(["--router-mode", "round_robin"]))
    a = b = None
    try:
        await watcher.start()
        a = await worker()
        await until(lambda: models.get("m") is not None)
        generate = models.get("m").generate
        client = watcher._pipelines["m"][0]
        await a.shutdown()
        await until(lambda: models.get("m") is None)
        assert "m" in watcher._parked and not client.instance_ids()
        b = await worker()
        await until(lambda: models.get("m") is not None)
        assert models.get("m").generate is generate
        assert client.instance_ids() == [b.instance_id]
        assert "m" not in watcher._parked
    finally:
        for rt in (b, front):
            if rt is not None:
                await rt.shutdown()
        await server.stop()


def test_frontend_outlives_a_short_lease_at_startup():
    """The frontend imports its checkpoint client (which brings torch)
    before the runtime grants its lease: under a 0.6 s lease it comes up
    and stays up, its lease kept alive."""
    from tests.utils_process import free_port

    coord_port, http_port = free_port(), free_port()
    url = f"tcp://127.0.0.1:{coord_port}"
    coordinator = PortProcess(["-m", "dynamo_tpu.transports.coordinator", "--host",
                               "127.0.0.1", "--port", str(coord_port)],
                              name="coordinator").start()
    frontend = None
    try:
        coordinator.wait_for_line("COORDINATOR_READY", 20)
        frontend = PortProcess(["-m", "dynamo_tpu.components.frontend", "--coordinator", url,
                                "--host", "127.0.0.1", "--port", str(http_port)],
                               name="frontend", env={"DYN_LEASE_TTL_S": "0.6"}).start()
        frontend.wait_for_line("FRONTEND_READY", 30)
        time.sleep(2.0)
        assert frontend.proc.poll() is None, frontend.logs()[-3000:]
        assert "no longer alive" not in frontend.logs(), frontend.logs()[-3000:]
    finally:
        if frontend is not None:
            frontend.stop()
        coordinator.stop()
