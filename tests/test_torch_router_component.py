"""Twins of ``tests/test_router_component.py`` on the port: the standalone
KV-aware router (``dynamo_tpu_torch/components/router.py``) over a pool of
the port's mocker workers, and the standalone KV store
(``components/kv_store.py``) with its side of discovery
(``kvbm/remote.register_store``).

The router cases are the JAX test functions, re-bound so that every
process they spawn runs the port's module of the same name and their
client is the port's runtime. ``test_wedged_worker_loses_traffic_e2e``
(``tests/test_health.py``, slow there and here) drives the worker's
``--wedgeable`` hook through the router.
"""

from __future__ import annotations

import asyncio
import time
import types

import pytest

import tests.test_health as jax_health
import tests.test_router_component as jax_rc
from dynamo_tpu.kvbm import remote as jremote
from dynamo_tpu_torch.kvbm import remote as tremote
from dynamo_tpu_torch.protocols import common as tproto
from tests.utils_process import ManagedProcess, free_port


class PortProcess(ManagedProcess):
    """A ManagedProcess that runs ``-m dynamo_tpu_torch.<module>`` where it
    is given ``-m dynamo_tpu.<module>``."""

    def __init__(self, args: list[str], name: str = "proc", env: dict | None = None):
        args = [a.replace("dynamo_tpu.", "dynamo_tpu_torch.", 1)
                if a.startswith("dynamo_tpu.") else a for a in args]
        super().__init__(args, name=name, env=env)


async def call_router(coord_url: str, reqs, concurrent: bool = False) -> None:
    """tests/test_router_component.py's ``_call_router`` with the port's
    runtime as the caller."""
    from dynamo_tpu_torch.runtime.client import EndpointClient, PushRouter
    from dynamo_tpu_torch.runtime.protocols import EndpointId
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    rt = await DistributedRuntime.create(RuntimeConfig(coordinator_url=coord_url))
    try:
        client = await EndpointClient.create(rt, EndpointId("dynamo", "router", "generate"))
        deadline = time.time() + 20
        while not client.instance_ids() and time.time() < deadline:
            await asyncio.sleep(0.1)
        push = PushRouter(client)

        async def one(req):
            async for _ in push.generate(req.to_dict(), req.request_id):
                pass

        if concurrent:
            await asyncio.gather(*(one(r) for r in reqs))
        else:
            for req in reqs:
                await one(req)
    finally:
        await rt.shutdown()


def on_port(fn):
    """``fn`` (a JAX test or fixture function) on the port's processes,
    requests and caller."""
    g = dict(fn.__globals__)
    g.update(ManagedProcess=PortProcess, _call_router=call_router,
             PreprocessedRequest=tproto.PreprocessedRequest,
             SamplingOptions=tproto.SamplingOptions, StopConditions=tproto.StopConditions)
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


@pytest.fixture(scope="module")
def router_cluster():
    """A coordinator, two mocker workers as the pool and the router, the
    port's."""
    yield from on_port(jax_rc.router_cluster.__wrapped__)()


async def test_prefix_heavy_traffic_concentrates(router_cluster):
    await on_port(jax_rc.test_prefix_heavy_traffic_concentrates)(router_cluster)


async def test_distinct_prefixes_spread(router_cluster):
    await on_port(jax_rc.test_distinct_prefixes_spread)(router_cluster)


async def test_router_restart_warm_start():
    await on_port(jax_rc.test_router_restart_warm_start)()


@pytest.mark.slow
async def test_wedged_worker_loses_traffic_e2e():
    """tests/test_health.py's wedged-worker case on the port's workers
    (``--wedgeable``) and router; the JAX runtime is the caller."""
    await on_port(jax_health.test_wedged_worker_loses_traffic_e2e)()


# ---------------------------------------------------------------------------
# The KV store's side of discovery
# ---------------------------------------------------------------------------

class KeyRecorder:
    """A coordinator client that records what it is asked to put."""

    def __init__(self):
        self.puts = []

    async def put(self, key, value, lease_id=0):
        self.puts.append((key, value, lease_id))


async def test_register_store_writes_the_jax_key_and_value():
    got = []
    for mod in (jremote, tremote):
        rec = KeyRecorder()
        await mod.register_store(rec, 0x1A2B, "10.0.0.7:9301", lease_id=5)
        got.append(rec.puts)
    assert got[1] == got[0] == [(f"{tremote.REMOTE_PREFIX}/0000000000001a2b",
                                 b"10.0.0.7:9301", 5)]


async def test_discover_store_finds_the_store_process_and_loses_it():
    """The port's store process registers lease-bound: ``discover_store``
    finds its address, and loses it once the process dies and its lease
    expires. A mocker worker given that store (its client imports torch)
    registers under a 1 s lease: the worker imports its engine's modules
    before the lease is granted, so the import does not starve the
    lease's keepalives."""
    from dynamo_tpu_torch.transports.client import CoordinatorClient

    coord_port, store_port = free_port(), free_port()
    url = f"tcp://127.0.0.1:{coord_port}"
    coordinator = PortProcess(["-m", "dynamo_tpu.transports.coordinator", "--host",
                               "127.0.0.1", "--port", str(coord_port)],
                              name="coordinator").start()
    store = worker = None
    try:
        coordinator.wait_for_line("COORDINATOR_READY", 20)
        store = PortProcess(["-m", "dynamo_tpu.components.kv_store", "--host", "127.0.0.1",
                             "--port", str(store_port), "--coordinator", url],
                            name="kv_store", env={"DYN_LEASE_TTL_S": "1.0"}).start()
        assert f"port={store_port}" in store.wait_for_line("KV_STORE_READY", 20)
        client = await CoordinatorClient.connect(url)
        try:
            addr = await tremote.discover_store(client)
            assert addr == f"127.0.0.1:{store_port}"
            worker = PortProcess(["-m", "dynamo_tpu.components.worker", "--engine", "mocker",
                                  "--coordinator", url, "--block-size", "4",
                                  "--num-blocks", "64", "--remote-kv-addr", addr],
                                 name="worker", env={"DYN_LEASE_TTL_S": "1.0"}).start()
            worker.wait_for_line("WORKER_READY", 30)
            await asyncio.sleep(2.0)
            assert worker.proc.poll() is None, worker.logs()[-3000:]
            assert await client.get_prefix("dyn/instances/")
            store.kill_hard()
            deadline = time.time() + 15
            while await tremote.discover_store(client) is not None:
                assert time.time() < deadline, "a dead store stayed advertised"
                await asyncio.sleep(0.2)
        finally:
            await client.close()
    finally:
        for p in (worker, store):
            if p is not None:
                p.stop()
        coordinator.stop()
