"""Wire framing: length-prefixed msgpack messages over TCP.

Fills the role of the reference's TwoPartCodec framing
(reference: lib/runtime/src/pipeline/network/codec/two_part.rs): each frame
is ``[u32 big-endian length][msgpack payload]``. All control and data planes
(coordinator RPC, request push, response streams) speak this one framing.

Copy of ``dynamo_tpu/transports/wire.py`` over the port's own codec
(``utils/msgpack.py``): every frame is the bytes ``msgpack.packb(obj,
use_bin_type=True)`` gives, so peers of either package interoperate.
``send_frame`` / ``recv_frame`` are the same frame on a blocking socket
(the JAX package keeps them in ``parallel/multihost.py``), for the KV
handoff's shard server and client (disagg/sharded.py).
"""

from __future__ import annotations

import asyncio
import socket
import struct
from typing import Any

from dynamo_tpu_torch.utils import msgpack

MAX_FRAME = 256 * 1024 * 1024  # hard cap against corrupt length prefixes


class Frame:
    """Message type tags (the 't' field of every frame)."""

    # coordinator RPC
    REQUEST = "req"
    RESPONSE = "resp"
    # server→client push
    WATCH_EVENT = "watch"
    PUBSUB_MSG = "msg"
    # endpoint data plane
    CALL = "call"          # open a request stream to an endpoint
    DATA = "data"          # one streamed response item
    END = "end"            # stream complete
    ERR = "err"            # stream error
    CANCEL = "cancel"      # caller → callee: stop a stream
    PING = "ping"
    PONG = "pong"


def encode_frame(obj: Any) -> bytes:
    payload = msgpack.packb(obj)
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)}")
    return struct.pack(">I", len(payload)) + payload


def send_frame(sock: socket.socket, obj: Any) -> None:
    """One frame on a blocking socket (the synchronous form of
    :meth:`MsgpackConnection.send`, for threads that own a plain socket)."""
    sock.sendall(encode_frame(obj))


def recv_frame(sock: socket.socket) -> Any | None:
    """Read one frame from a blocking socket; None on clean EOF (also
    mid-frame: the peer went away). The payload is received into one
    buffer, so a frame of many MiB costs no per-chunk concatenation."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise ValueError(f"oversized frame: {length}")
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    return msgpack.unpackb(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


class MsgpackConnection:
    """One framed duplex connection."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._wlock = asyncio.Lock()

    @classmethod
    async def connect(cls, host: str, port: int) -> "MsgpackConnection":
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def send(self, obj: Any) -> None:
        data = encode_frame(obj)
        async with self._wlock:
            self.writer.write(data)
            await self.writer.drain()

    async def recv(self) -> Any | None:
        """Read one frame; None on clean EOF."""
        try:
            header = await self.reader.readexactly(4)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        (length,) = struct.unpack(">I", header)
        if length > MAX_FRAME:
            raise ValueError(f"oversized frame: {length}")
        try:
            payload = await self.reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        return msgpack.unpackb(payload)

    @property
    def peer(self) -> str:
        info = self.writer.get_extra_info("peername")
        return f"{info[0]}:{info[1]}" if info else "?"

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass

    async def wait_closed(self) -> None:
        try:
            await self.writer.wait_closed()
        except Exception:
            pass
