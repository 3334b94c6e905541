"""The port's transports (wire framing, coordinator, client) against the JAX
package's: frames byte for byte, and the op sequences of
tests/test_coordinator.py run with each package's server under the other's
client, observed equal to the JAX pair's run of the same sequence."""

from __future__ import annotations

import asyncio
import struct

import pytest

from dynamo_tpu.transports import client as jax_client
from dynamo_tpu.transports import coordinator as jax_coord
from dynamo_tpu.transports import wire as jax_wire
from dynamo_tpu_torch.transports import client as torch_client
from dynamo_tpu_torch.transports import coordinator as torch_coord
from dynamo_tpu_torch.transports import wire as torch_wire

PKGS = {"jax": (jax_coord, jax_client), "torch": (torch_coord, torch_client)}
# (server package, client package); every pair is held to the JAX pair
PAIRS = [("torch", "jax"), ("jax", "torch"), ("torch", "torch")]
PAIR_IDS = [f"{s}_server-{c}_client" for s, c in PAIRS]

FRAMES = [
    {"t": "req", "id": 1, "op": "put", "key": "a/b", "value": b"v1", "lease": 0},
    {"t": "data", "id": 7, "d": {"token_ids": [1, 2, 3], "log_probs": [-0.5, -1.25e-9],
                                 "finish_reason": None, "nested": {"x": [True, False]}}},
    {"t": "msg", "s": "kv_events.dynamo.backend", "seq": 2 ** 40, "p": b"\x00" * 300},
    {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1,
              2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
              -2 ** 31 - 1, -2 ** 63]},
    {"floats": [0.0, -0.0, 1.5, 1e300, -2.5e-308, float("inf"), 3.141592653589793]},
    {"tuple": (1, "two", (3.0, None)), "empty": {}, "list": [], "str": "é" * 40},
    {"big_str": "x" * 70000, "big_bytes": b"y" * 70000, "many": list(range(20))},
    {"map16": {f"k{i}": i for i in range(20)}},
    [None, True, False, b"", "", {"a": {"b": {"c": [b"deep"]}}}],
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_encode_frame_bytes_equal_jax(i):
    obj = FRAMES[i]
    got = torch_wire.encode_frame(obj)
    assert got == jax_wire.encode_frame(obj)
    (n,) = struct.unpack(">I", got[:4])
    assert n == len(got) - 4


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
async def test_connection_decodes_other_package(writer, reader):
    """A MsgpackConnection of one package reads every frame the other's
    sends (tuples read back as lists, as msgpack does)."""
    w_mod = torch_wire if writer == "torch" else jax_wire
    r_mod = torch_wire if reader == "torch" else jax_wire
    got: list = []
    done = asyncio.Event()

    async def on_conn(r, w):
        conn = r_mod.MsgpackConnection(r, w)
        for _ in FRAMES:
            got.append(await conn.recv())
        assert await conn.recv() is None  # clean EOF
        conn.close()
        done.set()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    conn = await w_mod.MsgpackConnection.connect("127.0.0.1", port)
    for f in FRAMES:
        await conn.send(f)
    conn.close()
    await asyncio.wait_for(done.wait(), 10)
    server.close()
    await server.wait_closed()
    import msgpack

    assert got == [msgpack.unpackb(msgpack.packb(f, use_bin_type=True), raw=False)
                   for f in FRAMES]


def test_non_str_map_key_refused_alike():
    """A map with an int key: the port's codec refuses it on decode, as
    msgpack's ``strict_map_key`` does for the JAX package."""
    import msgpack

    payload = msgpack.packb({1: b"x"}, use_bin_type=True)
    frame = struct.pack(">I", len(payload)) + payload

    async def read(mod):
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        return await mod.MsgpackConnection(reader, None).recv()

    for mod in (jax_wire, torch_wire):
        with pytest.raises((ValueError, TypeError)):
            asyncio.run(read(mod))


# ---------------------------------------------------------------------------
# Coordinator scenarios (tests/test_coordinator.py): each returns what its
# client observed; the mixed pairs must observe what the JAX pair does.
# ---------------------------------------------------------------------------

def _ev(ev) -> tuple:
    return (ev.op, ev.key, ev.value, ev.initial)


async def sc_kv(S, C):
    server = S.CoordinatorServer()
    await server.start()
    c = await C.CoordinatorClient.connect(server.url)
    obs = []
    try:
        await c.put("a/b", b"v1")
        obs.append(await c.get("a/b"))
        obs.append(await c.get("a/missing"))
        await c.put("a/c", b"v2")
        obs.append(sorted((await c.get_prefix("a/")).items()))
        obs.append(await c.delete("a/b"))
        obs.append(await c.delete("a/b"))
        obs.append(await c.create("lock/x", b"me"))
        obs.append(await c.create("lock/x", b"other"))
        obs.append(await c.get("lock/x"))
    finally:
        await c.close()
        await server.stop()
    return obs


async def sc_watch(S, C):
    server = S.CoordinatorServer()
    await server.start()
    c = await C.CoordinatorClient.connect(server.url)
    obs = []
    try:
        await c.put("w/pre", b"existing")
        watch = await c.watch_prefix("w/")
        obs.append(_ev(await asyncio.wait_for(watch.queue.get(), 2)))
        await c.put("w/new", b"x")
        obs.append(_ev(await asyncio.wait_for(watch.queue.get(), 2)))
        await c.delete("w/new")
        obs.append(_ev(await asyncio.wait_for(watch.queue.get(), 2)))
        await watch.cancel()
        await c.put("w/after", b"y")
        await asyncio.sleep(0.1)
        obs.append(watch.queue.qsize())
    finally:
        await c.close()
        await server.stop()
    return obs


async def sc_lease(S, C):
    server = S.CoordinatorServer()
    await server.start()
    c = await C.CoordinatorClient.connect(server.url)
    obs = []
    try:
        lease = await c.lease_grant(ttl=0.5, keepalive=False)
        await c.put("inst/1", b"alive", lease_id=lease.id)
        watch = await c.watch_prefix("inst/")
        obs.append(_ev(await asyncio.wait_for(watch.queue.get(), 2)))
        obs.append(_ev(await asyncio.wait_for(watch.queue.get(), 3)))  # expiry
        obs.append(await c.get("inst/1"))
        ka = await c.lease_grant(ttl=0.6, keepalive=True)
        await c.put("ka/1", b"x", lease_id=ka.id)
        await asyncio.sleep(1.5)  # several ttl periods
        obs.append(await c.get("ka/1"))
        await ka.revoke(c)
        await asyncio.sleep(0.1)
        obs.append(await c.get("ka/1"))
    finally:
        await c.close()
        await server.stop()
    return obs


async def sc_pubsub_queue(S, C):
    server = S.CoordinatorServer()
    await server.start()
    c = await C.CoordinatorClient.connect(server.url)
    c2 = await C.CoordinatorClient.connect(server.url)
    obs = []
    try:
        s1 = await c.subscribe("events.kv.*")
        s2 = await c2.subscribe("events.kv.worker1")
        obs.append(await c.publish("events.kv.worker1", b"payload"))
        obs.append(await asyncio.wait_for(s1.queue.get(), 2))
        obs.append(await asyncio.wait_for(s2.queue.get(), 2))
        obs.append(await c.publish("events.load.worker1", b"nope"))
        await asyncio.sleep(0.05)
        obs.append((s1.queue.qsize(), s2.queue.qsize()))
        await c.queue_push("prefill", b"req1")
        await c.queue_push("prefill", b"req2")
        obs.append(await c.queue_len("prefill"))
        obs.append([await c.queue_pop("prefill") for _ in range(3)])
    finally:
        await c2.close()
        await c.close()
        await server.stop()
    return obs


async def sc_reconnect(S, C):
    """Auto-reconnect restores the watch (with a reset) and KV; hooks run;
    requests fail fast while the coordinator is down."""
    server = S.CoordinatorServer("127.0.0.1", 0)
    port = await server.start()
    client = await C.CoordinatorClient.connect(f"tcp://127.0.0.1:{port}", auto_reconnect=True)
    obs, events, hooks = [], [], []
    try:
        await client.put("reconn/a", b"1")
        watch = await client.watch_prefix("reconn/")

        async def consume():
            async for ev in watch:
                events.append(ev)

        task = asyncio.create_task(consume())
        await asyncio.sleep(0.1)
        obs.append([e.op for e in events])

        async def hook():
            hooks.append("ran")

        client.on_reconnected.append(hook)
        await server.stop()
        await asyncio.sleep(0.2)
        try:
            await client.get("reconn/a")
            obs.append("no error")
        except (jax_client.CoordinatorError, torch_client.CoordinatorError) as exc:
            obs.append(type(exc).__name__)
        server2 = S.CoordinatorServer("127.0.0.1", port)
        await server2.start()
        deadline = asyncio.get_running_loop().time() + 10
        while client.reconnects == 0:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.1)
        obs.append(list(hooks))
        await client.put("reconn/b", b"2")
        await asyncio.sleep(0.2)
        obs.append([(e.op, e.key) for e in events])
        obs.append(await client.get("reconn/b"))
        task.cancel()
        await server2.stop()
    finally:
        await client.close()
    return obs


async def sc_poison(S, C):
    """Without auto-reconnect a watch ends when the coordinator goes."""
    server = S.CoordinatorServer("127.0.0.1", 0)
    port = await server.start()
    client = await C.CoordinatorClient.connect(f"tcp://127.0.0.1:{port}")
    try:
        watch = await client.watch_prefix("x/")
        await server.stop()

        async def drain():
            return [ev.op async for ev in watch]

        return await asyncio.wait_for(drain(), 5)
    finally:
        await client.close()


async def sc_durable_resume(S, C):
    """A subscriber whose connection drops resumes from its last sequence
    number and receives what was published meanwhile, once."""
    server = S.CoordinatorServer("127.0.0.1", 0)
    port = await server.start()
    url = f"tcp://127.0.0.1:{port}"
    sub_client = await C.CoordinatorClient.connect(url, auto_reconnect=True)
    pub_client = await C.CoordinatorClient.connect(url)
    obs = []
    try:
        sub = await sub_client.subscribe("events.*")
        await pub_client.publish("events.a", b"m1")
        await asyncio.sleep(0.1)
        obs.append(sub.queue.get_nowait())
        sub_client._conn.close()
        await asyncio.sleep(0.2)
        await pub_client.publish("events.a", b"m2")
        await pub_client.publish("other.subject", b"zz")
        await pub_client.publish("events.b", b"m3")
        got = []
        while len(got) < 2:
            got.append(await asyncio.wait_for(sub.queue.get(), 10))
        obs.append(got)
        obs.append(sub.gap)
        await pub_client.publish("events.c", b"m4")
        obs.append(await asyncio.wait_for(sub.queue.get(), 5))
        obs.append(sub.queue.empty())
    finally:
        await sub_client.close()
        await pub_client.close()
        await server.stop()
    return obs


async def sc_gap(S, C):
    """A restarted coordinator cannot replay: the subscription flags a gap
    and live delivery resumes."""
    server = S.CoordinatorServer("127.0.0.1", 0)
    port = await server.start()
    url = f"tcp://127.0.0.1:{port}"
    sub_client = await C.CoordinatorClient.connect(url, auto_reconnect=True)
    obs = []
    try:
        sub = await sub_client.subscribe("ev.*")
        pub = await C.CoordinatorClient.connect(url)
        await pub.publish("ev.x", b"1")
        await asyncio.sleep(0.1)
        obs.append(sub.queue.get_nowait())
        await pub.close()
        await server.stop()
        await asyncio.sleep(0.2)
        server2 = S.CoordinatorServer("127.0.0.1", port)
        await server2.start()
        deadline = asyncio.get_running_loop().time() + 10
        while sub_client.reconnects == 0:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.1)
        obs.append(sub.gap)
        pub2 = await C.CoordinatorClient.connect(url)
        await pub2.publish("ev.y", b"2")
        obs.append(await asyncio.wait_for(sub.queue.get(), 5))
        await pub2.close()
        await server2.stop()
    finally:
        await sub_client.close()
    return obs


SCENARIOS = {
    "kv_create": sc_kv,
    "watch": sc_watch,
    "lease_expiry_keepalive": sc_lease,
    "pubsub_wildcard_queue": sc_pubsub_queue,
    "auto_reconnect": sc_reconnect,
    "poison_without_reconnect": sc_poison,
    "durable_resume": sc_durable_resume,
    "gap_on_restart": sc_gap,
}
_REF: dict[str, list] = {}


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(SCENARIOS))
async def test_coordinator_across_packages(name, pair):
    scenario = SCENARIOS[name]
    if name not in _REF:
        _REF[name] = await scenario(PKGS["jax"][0], PKGS["jax"][1])
    s, c = pair
    got = await scenario(PKGS[s][0], PKGS[c][1])
    # CoordinatorError is the same name in both packages
    assert got == _REF[name]
