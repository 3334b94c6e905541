"""Remote (G4) KV block tier: a shared block store service + client tier —
port of ``dynamo_tpu/kvbm/remote.py``.

Blocks move host→host over a framed TCP data plane: ``[u32 len][msgpack]``
frames, the port's own codec (utils/msgpack.py) giving the JAX package's
bytes, so the port's client talks to the JAX package's server and the other
way round. A shared store lets any engine onboard a prefix that another
engine computed, and keeps KV across host restarts.

Server: :class:`RemoteBlockServer` — asyncio, byte-budgeted LRU store,
multi-client, one request/response per frame.

Client: :class:`RemoteBlockPool` — the standard tier protocol
(``put/get/__contains__/len/stats``), so it chains after host/disk in the
offload cascade. The engine's tier calls are synchronous (engine-core
thread, between device dispatches), so the client speaks blocking sockets
with short timeouts; a dead store degrades to misses rather than stalling
the serving loop.

Keys are ``(namespace, seq_hash)``: the namespace (model fingerprint +
logical block geometry) partitions the store so two models never exchange
blocks. A store is given to engines by its address, or found in the
coordinator where it was advertised (``discover_store``: the worker's
``--remote-kv-addr auto``, the frontend's checkpoint lookup; the JAX
package's ``components/kv_store.py`` advertises one, the port's store
does not yet)::

    python -m dynamo_tpu_torch.kvbm.remote --port 7070 --capacity-gib 4
"""

from __future__ import annotations

import asyncio
import hashlib
import socket
import struct
import threading
import time
from collections import OrderedDict

import numpy as np

from dynamo_tpu_torch.engine.cache import KVCacheSpec
from dynamo_tpu_torch.kvbm.pools import TierStats
from dynamo_tpu_torch.kvbm.transfer import HOST_FLOAT, ensure_block_format
from dynamo_tpu_torch.utils import msgpack
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("kvbm.remote")

# Coordinator key prefix under which running stores advertise themselves
# (lease-bound: a dead store disappears and engines fall back to local tiers).
REMOTE_PREFIX = "kvbm/remote"


class RemoteBlockServer:
    """Byte-budgeted LRU block store speaking framed msgpack.

    Ops: ``{"op": "put", "ns": str, "h": int, "data": bytes}`` → ``{"ok": True}``
         ``{"op": "get", "ns": str, "h": int}`` → ``{"ok": True, "data": bytes | None}``
         ``{"op": "has", "ns": str, "h": int}`` → ``{"ok": True, "has": bool}``
         ``{"op": "del", "ns": str, "h": int}`` → ``{"ok": True, "deleted": bool}``
         ``{"op": "stats"}`` → ``{"ok": True, ...counters}``
    """

    def __init__(self, capacity_bytes: int = 4 << 30):
        self.capacity_bytes = capacity_bytes
        self._store: OrderedDict[tuple[str, int], bytes] = OrderedDict()
        self._bytes = 0
        self.stats = TierStats()
        self._server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self.port: int | None = None

    # -- store ------------------------------------------------------------
    def _put(self, ns: str, h: int, data: bytes) -> None:
        key = (ns, h)
        if key in self._store:
            self._store.move_to_end(key)
            return
        while self._bytes + len(data) > self.capacity_bytes and self._store:
            _, victim = self._store.popitem(last=False)
            self._bytes -= len(victim)
            self.stats.evictions += 1
        self._store[key] = data
        self._bytes += len(data)
        self.stats.stores += 1

    def _get(self, ns: str, h: int) -> bytes | None:
        self.stats.lookups += 1
        data = self._store.get((ns, h))
        if data is not None:
            self._store.move_to_end((ns, h))
            self.stats.hits += 1
        return data

    def _answer(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "put":
            self._put(msg["ns"], msg["h"], msg["data"])
            return {"ok": True}
        if op == "get":
            return {"ok": True, "data": self._get(msg["ns"], msg["h"])}
        if op == "has":
            return {"ok": True, "has": (msg["ns"], msg["h"]) in self._store}
        if op == "del":
            victim = self._store.pop((msg["ns"], msg["h"]), None)
            if victim is not None:
                self._bytes -= len(victim)
            return {"ok": True, "deleted": victim is not None}
        if op == "stats":
            return {"ok": True, "blocks": len(self._store), "bytes": self._bytes,
                    **self.stats.to_dict()}
        return {"ok": False, "error": f"unknown op {op!r}"}

    # -- service ----------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    header = await reader.readexactly(4)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                (length,) = struct.unpack(">I", header)
                payload = await reader.readexactly(length)
                out = msgpack.packb(self._answer(msgpack.unpackb(payload)))
                writer.write(struct.pack(">I", len(out)) + out)
                await writer.drain()
        except Exception:
            log.exception("kv store client connection failed")
        finally:
            self._writers.discard(writer)
            writer.close()

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("remote KV block store on %s:%d (%.1f GiB)",
                 host, self.port, self.capacity_bytes / (1 << 30))
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Drop live client connections too: wait_closed() waits for
            # handlers, and engine clients hold persistent connections.
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()
            self._server = None


# ---------------------------------------------------------------------------
# Client tier
# ---------------------------------------------------------------------------

def tier_namespace(spec: KVCacheSpec, fingerprint: str = "") -> str:
    """Model identity + LOGICAL block geometry — deliberately without the
    storage dtype: blocks on the wire are self-describing by byte length,
    so engines of one model at different kv dtypes share a namespace and
    convert at the ``get`` boundary. The JAX package's string."""
    return (f"{fingerprint}|{spec.num_layers}x{spec.block_size}"
            f"x{spec.num_kv_heads}x{spec.head_dim}")


def _record_hash(key: str) -> int:
    """The store key of a session or checkpoint record."""
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")


class RemoteBlockPool:
    """Tier-protocol client for a :class:`RemoteBlockServer`.

    Synchronous (engine-core thread); one persistent connection with
    reconnect-once per call. Failures degrade to misses/drops; ``len`` and
    ``__contains__`` ask the server (the store is shared)."""

    name = "remote"
    # Shared across engines: contains/get results can change under our feet
    # (kvbm/offload.py: the _on_evict dedup skip).
    shared = True

    # After a failed call, skip the store entirely for this long — an
    # outage must cost ONE connect timeout per window, not one per call.
    BREAKER_SECONDS = 30.0

    def __init__(self, spec: KVCacheSpec, addr: str, fingerprint: str = "",
                 timeout: float = 1.0):
        self.spec = spec
        host, _, port = addr.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._ns = tier_namespace(spec, fingerprint)
        self._timeout = timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._broken_until = 0.0
        self._last_len = 0
        self.stats = TierStats()
        # Byte length → stored format, for the self-describing wire blocks.
        # Packed kinds first; float payloads at an ambiguous itemsize
        # resolve to the spec's own dtype (listed first).
        L, bs, kh, d = spec.num_layers, spec.block_size, spec.num_kv_heads, spec.head_dim
        elems = 2 * L * bs * kh * d
        scales = 2 * L * kh * 4
        self._formats: dict[int, str] = {elems + scales: "int8", elems // 2 + scales: "int4"}
        for fdt in (spec.dtype, "bfloat16", "float32"):
            self._formats.setdefault(elems * np.dtype(HOST_FLOAT[fdt]).itemsize, fdt)

    # -- wire -------------------------------------------------------------
    def _connect(self) -> socket.socket:
        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _call(self, msg: dict) -> dict | None:
        """One request/response; reconnects once on a broken connection;
        returns None when the store is unreachable. A failure opens the
        circuit breaker: calls return None at once until it expires."""
        with self._lock:
            if time.monotonic() < self._broken_until:
                return None
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    payload = msgpack.packb(msg)
                    self._sock.sendall(struct.pack(">I", len(payload)) + payload)
                    (length,) = struct.unpack(">I", self._recv_exact(4))
                    return msgpack.unpackb(self._recv_exact(length))
                except (OSError, ValueError, struct.error):
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    if attempt == 1:
                        self._broken_until = time.monotonic() + self.BREAKER_SECONDS
                        log.warning("remote KV store %s:%d unreachable; skipping it "
                                    "for %.0fs", *self._addr, self.BREAKER_SECONDS)
                        return None
        return None

    def _recv_exact(self, n: int) -> bytes:
        assert self._sock is not None
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise OSError("connection closed")
            buf += chunk
        return buf

    # -- tier protocol -----------------------------------------------------
    def put(self, seq_hash: int, block: np.ndarray) -> None:
        resp = self._call({"op": "put", "ns": self._ns, "h": seq_hash,
                           "data": np.ascontiguousarray(block).tobytes()})
        if resp is None:
            log.debug("remote KV store unreachable; dropping block %x", seq_hash)
            return
        self.stats.stores += 1

    def get(self, seq_hash: int) -> np.ndarray | None:
        self.stats.lookups += 1
        resp = self._call({"op": "get", "ns": self._ns, "h": seq_hash})
        data = resp.get("data") if resp else None
        if data is None:
            return None
        fmt = self._formats.get(len(data))
        if fmt is None:  # unknown geometry/format — treat as a miss
            log.warning("remote block %x has %d bytes, matching no known "
                        "format for %s", seq_hash, len(data), self._ns)
            return None
        self.stats.hits += 1
        if fmt in ("int8", "int4"):
            block = np.frombuffer(data, np.uint8)
        else:
            spec = self.spec
            block = np.frombuffer(data, HOST_FLOAT[fmt]).reshape(
                2, spec.num_layers, spec.block_size, spec.num_kv_heads, spec.head_dim)
        # This engine's native format here, so downstream consumers (onboard
        # plans, host-tier puts) see homogeneous blocks.
        return ensure_block_format(block, self.spec)

    # -- session records ---------------------------------------------------
    # A retained session's resumable record — its committed hash chain —
    # rides the same generic put/get ops under the "|s" namespace suffix,
    # beside its KV blocks (which go through put()).

    def put_session(self, session_id: str, seq_hashes: list[int],
                    tokens: int = 0) -> bool:
        rec = msgpack.packb({"hashes": [int(h) for h in seq_hashes],
                             "tokens": int(tokens), "ts": time.time()})
        resp = self._call({"op": "put", "ns": self._ns + "|s",
                           "h": _record_hash(session_id), "data": rec})
        return bool(resp and resp.get("ok"))

    def get_session(self, session_id: str) -> dict | None:
        """The stored record for ``session_id`` — ``{"hashes": [...],
        "tokens": n, "ts": ...}`` — or None (no record / store down)."""
        resp = self._call({"op": "get", "ns": self._ns + "|s",
                           "h": _record_hash(session_id)})
        data = resp.get("data") if resp else None
        if data is None:
            return None
        try:
            rec = msgpack.unpackb(data)
        except Exception:
            log.warning("undecodable session record for %r", session_id)
            return None
        return rec if isinstance(rec, dict) else None

    # -- stream checkpoints -------------------------------------------------
    # Records live in a FIXED spec-independent namespace, so a process with
    # no KVCacheSpec can look one up by request id (ckpt_client). TTL is
    # enforced lazily on get: a crashed worker never deletes its records.

    CKPT_NAMESPACE = "stream|ckpt"

    def put_stream_ckpt(self, request_id: str, record: dict) -> bool:
        resp = self._call({"op": "put", "ns": self.CKPT_NAMESPACE,
                           "h": _record_hash(request_id), "data": msgpack.packb(record)})
        return bool(resp and resp.get("ok"))

    def get_stream_ckpt(self, request_id: str, ttl: float | None = None) -> dict | None:
        """The live checkpoint record for ``request_id``, or None (no
        record / expired / store down). Expired records are deleted and
        counted on the dynamo_stream_ckpt_expired counter."""
        from dynamo_tpu_torch.kvbm.stream_ckpt import (
            DEFAULT_CKPT_TTL_S, get_stream_ckpt_metrics, parse_ckpt_record)

        resp = self._call({"op": "get", "ns": self.CKPT_NAMESPACE,
                           "h": _record_hash(request_id)})
        data = resp.get("data") if resp else None
        if data is None:
            return None
        try:
            rec = parse_ckpt_record(msgpack.unpackb(data))
        except Exception:
            rec = None
        if rec is None:
            log.warning("undecodable stream checkpoint for %r", request_id)
            return None
        ttl = DEFAULT_CKPT_TTL_S if ttl is None else ttl
        if ttl > 0 and rec["ts"] and time.time() - rec["ts"] > ttl:
            get_stream_ckpt_metrics().expired.inc(1)
            self.del_stream_ckpt(request_id)
            return None
        return rec

    def del_stream_ckpt(self, request_id: str) -> None:
        self._call({"op": "del", "ns": self.CKPT_NAMESPACE, "h": _record_hash(request_id)})

    def __contains__(self, seq_hash: int) -> bool:
        resp = self._call({"op": "has", "ns": self._ns, "h": seq_hash})
        return bool(resp and resp.get("has"))

    def __len__(self) -> int:
        # Metrics-path call: last-known value on failure, never a stall.
        resp = self._call({"op": "stats"})
        if resp:
            self._last_len = int(resp.get("blocks", 0))
        return self._last_len

    def occupancy(self) -> tuple[int, int]:
        """(resident blocks, resident bytes) server-wide — the mem-ledger
        tier row; last-known/zero on failure."""
        resp = self._call({"op": "stats"})
        if resp:
            self._last_len = int(resp.get("blocks", 0))
            return self._last_len, int(resp.get("bytes", 0))
        return self._last_len, 0

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


# ---------------------------------------------------------------------------
# Discovery
# ---------------------------------------------------------------------------

async def discover_store(client) -> str | None:
    """First advertised store address, or None."""
    got = await client.get_prefix(REMOTE_PREFIX + "/")
    for _, v in sorted(got.items()):
        return v.decode()
    return None


def ckpt_client(addr: str, timeout: float = 1.0) -> RemoteBlockPool:
    """A record-only client for processes with no KVCacheSpec. Checkpoint
    records live in the fixed spec-independent namespace, so the stand-in
    geometry here is never consulted — only the record ops are valid."""
    spec = KVCacheSpec(num_blocks=1, block_size=1, num_layers=1,
                       num_kv_heads=1, head_dim=2)
    return RemoteBlockPool(spec, addr, timeout=timeout)


def main(argv: list[str] | None = None) -> None:
    """Serve a block store until interrupted (``--port 0`` picks a free
    port; the address is logged)."""
    import argparse

    from dynamo_tpu_torch.utils.logging import configure_logging

    p = argparse.ArgumentParser("kv block store (torch)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--capacity-gib", type=float, default=4.0)
    ns = p.parse_args(argv)
    configure_logging()

    async def serve() -> None:
        server = RemoteBlockServer(capacity_bytes=int(ns.capacity_gib * (1 << 30)))
        await server.start(ns.host, ns.port)
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
