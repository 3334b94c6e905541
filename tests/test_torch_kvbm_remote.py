"""The port's remote (G4) block tier against the JAX package's, on the CPU:
the port's msgpack codec against ``msgpack.packb(use_bin_type=True)``
under hypothesis, the port's ``RemoteBlockPool`` over the JAX
``RemoteBlockServer`` and JAX's client over the port's server (blocks,
session and checkpoint records), namespace isolation, an outage degrading
to misses, the host → disk → remote cascade, and a JAX engine's blocks
onboarded by a torch engine through one store (twin of
``tests/test_kvbm_remote.py::test_cross_engine_prefix_sharing``).
"""

from __future__ import annotations

import asyncio
import threading

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.kvbm import pools as jpools
from dynamo_tpu.kvbm import remote as jremote
from dynamo_tpu.kvbm import transfer as jtr
from dynamo_tpu_torch.kvbm import pools as tpools
from dynamo_tpu_torch.kvbm import remote as tremote
from dynamo_tpu_torch.utils import msgpack as tmsgpack

from tests.test_torch_kvbm import (  # noqa: F401 - tiny32 is a fixture
    as_bytes,
    cores,
    float_block,
    offload_onboard,
    proto_of,
    req,
    run,
    specs,
    tiny32,
)


class StoreFixture:
    """A RemoteBlockServer (either package's) on an event loop thread of
    its own: the engine-side clients are synchronous."""

    def __init__(self, server_mod, capacity_bytes: int = 1 << 20):
        self.mod = server_mod
        self.loop = asyncio.new_event_loop()
        self.server = server_mod.RemoteBlockServer(capacity_bytes=capacity_bytes)
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()
        self.port = asyncio.run_coroutine_threadsafe(
            self.server.start("127.0.0.1", 0), self.loop).result(10)
        self.addr = f"127.0.0.1:{self.port}"

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(5)


@pytest.fixture(params=["jax", "torch"])
def store(request):
    s = StoreFixture(jremote if request.param == "jax" else tremote)
    yield s
    s.close()


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

_scalars = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40)
            | st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=8), inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_msgpack_bytes_equal_msgpack(obj):
    """packb gives msgpack's bytes (str as str, bytes as bin, every int and
    length at its smallest encoding); unpackb reads them back as
    ``msgpack.unpackb(raw=False)`` does."""
    want = msgpack.packb(obj, use_bin_type=True)
    assert tmsgpack.packb(obj) == want
    assert tmsgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("obj", [
    0x7F, 0x80, -0x20, -0x21, 0xFF, 0x100, -0x80, -0x81, 0xFFFF, 0x10000,
    -0x8000, -0x8001, 2**32 - 1, 2**32, -2**31, -2**31 - 1, 2**64 - 1, -2**63,
    "x" * 31, "x" * 32, "x" * 255, "x" * 256, "é" * 40000, b"y" * 255, b"y" * 256,
    b"y" * 70000, [0] * 15, [0] * 16, list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"rid": "r", "generated": [1, 2], "hashes": [2**64 - 1], "key": None, "ts": 1.5},
    float("inf"), float("-inf"), -0.0, (1, "a"),
])
def test_msgpack_boundaries(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert tmsgpack.packb(obj) == want
    assert tmsgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_msgpack_refuses_what_msgpack_refuses():
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            tmsgpack.packb(bad)
    with pytest.raises(TypeError):
        tmsgpack.packb(object())
    with pytest.raises(ValueError):
        tmsgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError):
        tmsgpack.unpackb(msgpack.packb("abc")[:-1])


# ---------------------------------------------------------------------------
# client and server across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client", ["jax", "torch"])
def test_blocks_and_records_across_packages(store, client):
    """Every op from either package's client against either package's
    server: a block put by one client reads back through the other with
    the same bytes, session and checkpoint records round-trip, the server
    counts alike."""
    jspec, tspec = specs("bfloat16")
    jpool = jremote.RemoteBlockPool(jspec, store.addr, fingerprint="m")
    tpool = tremote.RemoteBlockPool(tspec, store.addr, fingerprint="m")
    writer, reader = (jpool, tpool) if client == "jax" else (tpool, jpool)
    rng = np.random.default_rng(0)
    j, t = float_block(rng, "bfloat16")
    writer.put(7, j if writer is jpool else t)
    assert 7 in reader and 8 not in reader
    assert as_bytes(reader.get(7)) == as_bytes(j)
    assert reader.get(8) is None
    assert len(reader) == 1 and reader.occupancy() == (1, j.nbytes)
    assert writer.put_session("sess", [1, 2**63 + 5], tokens=12)
    got = reader.get_session("sess")
    assert got["hashes"] == [1, 2**63 + 5] and got["tokens"] == 12
    rec = {"rid": "r1", "generated": [5, 6], "hashes": [11], "key": [0, 7],
           "draws": 2, "seed": 7, "prompt_tokens": 4, "ts": 1e12}
    assert writer.put_stream_ckpt("r1", rec)
    assert reader.get_stream_ckpt("r1", ttl=0) == rec
    reader.del_stream_ckpt("r1")
    assert writer.get_stream_ckpt("r1", ttl=0) is None
    stats = store.server.stats.to_dict()
    assert stats["stores"] == 3 and stats["hits"] >= 3


def test_remote_get_converts_across_kv_dtypes(store):
    """One namespace serves engines of one model at any kv dtype: a float
    block read by an int8 or int4 engine arrives as ``quantize_block``'s
    bytes, a packed block read by a float engine dequantized — in both
    packages alike. A float block of another float dtype arrives in the
    engine's own (JAX hands it on as it is, and its host arena casts it on
    the put: the same bytes)."""
    rng = np.random.default_rng(1)
    j, t = float_block(rng, "float32")
    jremote.RemoteBlockPool(specs("float32")[0], store.addr, fingerprint="m").put(3, j)
    jremote.RemoteBlockPool(specs("int8")[0], store.addr, fingerprint="m").put(
        4, jtr.quantize_block(j, "int8"))
    for kind in ("float32", "bfloat16", "int8", "int4"):
        jspec, tspec = specs(kind)
        jp = jremote.RemoteBlockPool(jspec, store.addr, fingerprint="m")
        tp = tremote.RemoteBlockPool(tspec, store.addr, fingerprint="m")
        for h in (3, 4):
            want = jtr.ensure_block_format(jp.get(h), jspec)
            if not jspec.quantized:
                want = want.astype(jnp.dtype(jspec.dtype))
            assert as_bytes(tp.get(h)) == as_bytes(want), (kind, h)


def test_namespace_isolation_and_outage(store):
    rng = np.random.default_rng(2)
    _, tspec = specs("float32")
    a = tremote.RemoteBlockPool(tspec, store.addr, fingerprint="model-a")
    b = tremote.RemoteBlockPool(tspec, store.addr, fingerprint="model-b")
    assert tremote.tier_namespace(tspec, "m") == jremote.tier_namespace(specs("float32")[0], "m")
    a.put(5, float_block(rng)[1])
    assert 5 in a and 5 not in b and b.get(5) is None
    dead = tremote.RemoteBlockPool(tspec, "127.0.0.1:1", timeout=0.2)  # nothing listens
    dead.put(1, float_block(rng)[1])     # dropped silently
    assert dead.get(1) is None and 1 not in dead and len(dead) == 0
    assert not dead.put_stream_ckpt("r", {"generated": []})
    assert dead.get_session("s") is None


def test_server_lru_eviction_matches_jax():
    """The byte-budgeted LRU: the same puts, gets and evictions on both
    packages' servers."""
    _, tspec = specs("float32")
    nbytes = int(np.prod(tpools.block_shape(tspec))) * 4
    seen = []
    rng = np.random.default_rng(3)
    blocks = [float_block(rng)[1] for _ in range(3)]
    for mod in (jremote, tremote):
        small = StoreFixture(mod, capacity_bytes=2 * nbytes)
        try:
            pool = tremote.RemoteBlockPool(tspec, small.addr)
            pool.put(1, blocks[0])
            pool.put(2, blocks[1])
            assert pool.get(1) is not None   # touch 1 → 2 becomes LRU
            pool.put(3, blocks[2])
            seen.append(([h in pool for h in (1, 2, 3)], small.server.stats.to_dict()))
        finally:
            small.close()
    assert seen[0] == seen[1] and seen[1][0] == [True, False, True]


def test_full_cascade_host_disk_remote(tmp_path, store):
    """A block pushed through host → disk → remote stays retrievable by the
    chain walk the offload manager makes; JAX's pools read each tier's
    content back the same."""
    jspec, tspec = specs("float32")
    nbytes = int(np.prod(tpools.block_shape(tspec))) * 4
    remote = tremote.RemoteBlockPool(tspec, store.addr, fingerprint="m")
    disk = tpools.DiskBlockPool(tspec, tmp_path, capacity_bytes=nbytes,
                                fingerprint="m", overflow=remote)
    host = tpools.HostBlockPool(tspec, capacity_blocks=1, overflow=disk)
    rng = np.random.default_rng(5)
    blocks = {h: float_block(rng)[1] for h in (1, 2, 3)}
    for h, b in blocks.items():
        host.put(h, b)
    assert 3 in host and 2 in disk and 1 in remote
    jdisk = jpools.DiskBlockPool(jspec, tmp_path, capacity_bytes=nbytes, fingerprint="m")
    jrem = jremote.RemoteBlockPool(jspec, store.addr, fingerprint="m")
    assert as_bytes(jdisk.get(2)) == as_bytes(blocks[2])
    assert as_bytes(jrem.get(1)) == as_bytes(blocks[1])
    for h, b in blocks.items():
        got = next(x for x in (t.get(h) for t in (host, disk, remote)) if x is not None)
        assert as_bytes(got) == as_bytes(b)


# ---------------------------------------------------------------------------
# engines across packages through one store
# ---------------------------------------------------------------------------

def test_engine_onboards_what_a_jax_engine_stored(tiny32, store):
    """A JAX engine computes a prompt and its pool churn pushes the blocks
    to the store (offload) while publish-on-commit pushes them as they
    form; a torch engine on the same store then onboards them and
    continues as the JAX engine did, with the JAX engine's counts on the
    same round trip (twin of ``test_cross_engine_prefix_sharing`` and
    ``test_engine_offload_onboard_via_remote_tier``)."""
    prompt = list(range(300, 324))
    kw = dict(num_blocks=13, remote_kv_addr=store.addr)
    jcore, _ = cores(tiny32, **kw, global_prefix_cache=True)
    first = run(jcore, [req(proto_of(jcore), prompt, "a")])
    run(jcore, [req(proto_of(jcore), [400 + 30 * i + j for j in range(24)], f"f{i}", 4)
                for i in range(4)])
    assert store.server.stats.stores > 0 and jcore.kvbm.stats.published_blocks > 0
    _, tcore = cores(tiny32, **kw)
    second = run(tcore, [req(proto_of(tcore), prompt, "b")])
    assert tcore.kvbm.stats.onboarded_blocks == 5
    assert second["b"] == first["a"]
    # the same round trip on one engine of each package, each through a
    # fresh store of the fixture's package
    res = []
    for side in (0, 1):
        own = StoreFixture(store.mod)
        try:
            res.append(offload_onboard(cores(tiny32, num_blocks=13,
                                             remote_kv_addr=own.addr)[side]))
        finally:
            own.close()
    assert res[1] == res[0] and res[1]["second"] == res[1]["first"]
