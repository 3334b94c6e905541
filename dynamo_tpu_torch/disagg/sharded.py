"""Sharded KV handoff: per-rank staging, shard servers, box-sliced pulls —
copy of ``dynamo_tpu/disagg/sharded.py``.

The data path between a prefill engine and a decode engine:

- ``StagingStore``  — host-memory staging of each rank's LOCAL cache shard
  of the pinned blocks, keyed by transfer id. Entries may be filled in one
  shot (the ``kv_stage`` op) or grow wave by wave while the prefill is
  still running (``begin``/``append``/``finalize`` driven by the per-chunk
  ``kv_stage_wave`` ops); ``wait_for`` gives serve threads a consistent
  snapshot of whatever prefix is staged so far.
- ``ShardServer``   — a daemon thread serving box-sliced reads of staged
  shards over the framed sync-socket protocol (``transports/wire.py``'s
  ``send_frame``/``recv_frame``: a big-endian u32 length, then msgpack). A
  connection may issue many requests (one per wave); a mid-stream client
  disconnect closes only that connection, never the staged transfer.
- ``ShardClient``   — the decode side: a persistent per-shard connection
  with bounded reconnect/retry, pulling exactly the intersecting slices of
  the waves that are ready.

Boxes are global (layer_start, layer_end, head_start, head_end) extents.
The port's engines hold the whole cache in one process, so each is the
1-shard case of the protocol (its box is the whole cache); engines with
more than one rank are refused by the engine (ROADMAP item 14).

bf16 on the wire: a staged bf16 shard is its uint16 bit patterns (numpy has
no bfloat16, ``kvbm/transfer.py``), and its pull reply names the dtype
"bfloat16" as the JAX package's server does for its ``ml_dtypes`` arrays; a
reply that says "bfloat16" reads back as uint16. So either package's
client pulls either package's blocks with the same bytes.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.kvbm.transfer import HOST_FLOAT, block_to_f32, f32_to_host
from dynamo_tpu_torch.transports.wire import recv_frame, send_frame
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("disagg.sharded")

Box = tuple[int, int, int, int]  # (layer_start, layer_end, head_start, head_end)


def box_intersection(a: Box, b: Box) -> Box | None:
    ls, le = max(a[0], b[0]), min(a[1], b[1])
    hs, he = max(a[2], b[2]), min(a[3], b[3])
    if ls >= le or hs >= he:
        return None
    return (ls, le, hs, he)


def wire_dtype(dtype: np.dtype) -> str:
    """The dtype name a pull reply carries for staged data of ``dtype``
    (bf16 bits are "bfloat16")."""
    return "bfloat16" if np.dtype(dtype) == np.uint16 else str(np.dtype(dtype))


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype a pull reply's dtype name reads as ("bfloat16":
    uint16 bits)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


@dataclass
class Staged:
    """One rank's staged shard of a transfer: data[n, 2, L_loc, bs, H_loc, hd]
    covering ``box`` of the global (layer, head) space, for ``hashes`` (with
    ``parents`` the chain links import needs).

    A streamed transfer declares the full expected chain up front (``begin``)
    and grows ``n_ready`` as waves land; only rows below ``n_ready`` are
    published (append never touches them again), so serve threads may read
    them without copying. ``ready`` is set once the transfer is complete (or
    dropped)."""

    ready: threading.Event = field(default_factory=threading.Event)
    hashes: list[int] = field(default_factory=list)
    parents: list[int | None] = field(default_factory=list)
    data: np.ndarray | None = None
    box: Box = (0, 0, 0, 0)
    dtype: str = "bfloat16"
    n_ready: int = 0
    complete: bool = False
    dropped: bool = False


class StagingStore:
    """Thread-safe xfer_id → Staged. Entries may be created by an early
    pull (placeholder), by the one-shot stage op (``fill``), or by a
    streamed transfer (``begin`` + per-wave ``append`` + ``finalize``)."""

    def __init__(self) -> None:
        self._entries: dict[str, Staged] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def get_or_create(self, xfer_id: str) -> Staged:
        with self._lock:
            entry = self._entries.get(xfer_id)
            if entry is None:
                entry = self._entries[xfer_id] = Staged()
            return entry

    # -- streamed path -------------------------------------------------
    def begin(self, xfer_id: str, hashes: list[int],
              parents: list[int | None], box: Box, dtype: str) -> None:
        """Declare the full expected chain of a streamed transfer. The data
        array is allocated lazily on the first append (its per-block shape
        isn't known until a wave is extracted)."""
        entry = self.get_or_create(xfer_id)
        with self._cond:
            if entry.dropped:
                return
            entry.hashes, entry.parents = list(hashes), list(parents)
            entry.box, entry.dtype = box, dtype
            entry.n_ready, entry.complete = 0, False
            self._cond.notify_all()

    def append(self, xfer_id: str, start: int, wave: np.ndarray) -> bool:
        """Publish one wave of rows [start, start+len(wave)). Waves must be
        contiguous with what's already staged (start ≤ n_ready); a gap means
        the caller lost a wave and the stream is broken — refused."""
        entry = self.get_or_create(xfer_id)
        with self._cond:
            if entry.dropped or entry.complete:
                return False
            if start > entry.n_ready:
                log.warning("staging %s: wave gap (start %d > ready %d)",
                            xfer_id, start, entry.n_ready)
                return False
            stop = start + wave.shape[0]
            if stop > len(entry.hashes):
                return False
            if entry.data is None:
                entry.data = np.empty((len(entry.hashes), *wave.shape[1:]),
                                      dtype=wave.dtype)
                entry.dtype = wire_dtype(wave.dtype)
            entry.data[start:stop] = wave
            entry.n_ready = max(entry.n_ready, stop)
            self._cond.notify_all()
            return True

    def finalize(self, xfer_id: str, covered: int) -> None:
        """Close a streamed transfer at ``covered`` blocks (the voted
        minimum of its ranks: may trim waves a minority of ranks staged)."""
        entry = self.get_or_create(xfer_id)
        with self._cond:
            if not entry.dropped:
                entry.n_ready = min(entry.n_ready, covered)
                entry.complete = True
            self._cond.notify_all()
        entry.ready.set()

    def wait_for(self, xfer_id: str, want: int | None,
                 timeout: float) -> tuple | None:
        """Block until ``want`` blocks are staged (or the transfer is
        complete/dropped), then return a consistent snapshot
        ``(hashes[:m], parents[:m], data view [:m], box, dtype)`` of the
        published prefix. ``want=None`` waits for completion (the
        whole-transfer pull). Returns None on timeout/drop/empty."""
        entry = self.get_or_create(xfer_id)
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if entry.dropped:
                    return None
                if entry.complete or (want is not None and entry.n_ready >= want):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cond.wait(left)
            m = entry.n_ready if want is None else min(want, entry.n_ready)
            if entry.data is None or m == 0:
                return None
            return (entry.hashes[:m], entry.parents[:m], entry.data[:m],
                    entry.box, entry.dtype)

    # -- one-shot path -------------------------------------------------
    def fill(self, xfer_id: str, hashes: list[int], parents: list[int | None],
             data: np.ndarray, box: Box) -> None:
        entry = self.get_or_create(xfer_id)
        with self._cond:  # publish all fields atomically (see snapshot)
            entry.hashes, entry.parents = hashes, parents
            entry.dtype = wire_dtype(data.dtype)
            entry.data, entry.box = data, box
            entry.n_ready, entry.complete = len(hashes), True
            self._cond.notify_all()
        entry.ready.set()

    def snapshot(self, xfer_id: str):
        """Consistent read of a staged entry's published prefix (or None if
        nothing is staged). Reading under the same lock fill()/append()
        publish under means readers see all-or-nothing, never fresh data
        paired with a stale dtype/box."""
        entry = self.get_or_create(xfer_id)
        with self._lock:
            if entry.data is None or entry.n_ready == 0:
                return None
            m = entry.n_ready
            return (entry.hashes[:m], entry.parents[:m], entry.data[:m],
                    entry.box, entry.dtype)

    def drop(self, xfer_id: str) -> None:
        with self._cond:
            entry = self._entries.pop(xfer_id, None)
            if entry is not None:
                entry.dropped = True
                entry.data = None
                self._cond.notify_all()
        if entry is not None:
            entry.ready.set()  # unblock any waiter; it will see data=None

    def drop_if_empty(self, xfer_id: str) -> None:
        """Remove a never-filled placeholder (created by a pull that raced
        ahead of — or outlived — the stage op) so late/retried pulls can't
        grow the store unboundedly."""
        with self._lock:
            entry = self._entries.get(xfer_id)
            if entry is not None and entry.data is None:
                del self._entries[xfer_id]


class ShardServer:
    """Serve box-sliced reads of staged shards. One per prefill engine.

    Protocol (framed msgpack); a connection may carry MANY requests back to
    back (the streamed consumer reuses one socket per shard across waves):
      request  {"xfer_id", "ls", "le", "hs", "he"[, "start", "stop"]}
               — no "stop": wait for the complete transfer; with "stop":
               wait until blocks [start, stop) are staged and serve exactly
               that window of the chain (a wave pull racing the staging of
               later waves).
      reply    {"hashes", "parents", "box": [ls, le, hs, he], "dtype",
               "start": s} then one {"i": idx, "d": bytes} frame per block
               (idx relative to "start"; the requested slice,
               C-contiguous), then {"end": true}
      release  {"xfer_id", "release": true} → {"ok": true} — the decode
               side's done-ack: ``on_release`` forwards it to the
               KvTransferSource, which unpins.
      error    {"error": msg}

    A client disconnect (clean EOF or reset) mid-conversation closes only
    that connection; the staged transfer stays, so the consumer can
    reconnect and retry the same window."""

    def __init__(self, store: StagingStore, host: str = "0.0.0.0",
                 stage_timeout: float = 60.0, on_release=None):
        self.store = store
        self.stage_timeout = stage_timeout
        self.on_release = on_release
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, 0))
        self.port = self._server.getsockname()[1]
        self._server.listen(32)
        self._stop = False
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._accept_loop, name="kv-shard-server", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop accepting, close every open connection (their serve threads
        end on the closed socket) and join the accept thread."""
        self._stop = True
        try:
            # shutdown wakes a thread blocked in accept(); close alone may not
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(5.0)

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_one, args=(conn,),
                             name="kv-shard-conn", daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                req = recv_frame(conn)
                if req is None:  # client done with this connection
                    return
                if req.get("release"):
                    if self.on_release is not None:
                        self.on_release(req["xfer_id"])
                    send_frame(conn, {"ok": True})
                    continue
                if not self._serve_pull(conn, req):
                    continue  # application error sent; connection reusable
        except (BrokenPipeError, ConnectionResetError, ConnectionAbortedError):
            # Mid-stream client disconnect: only this connection dies; the
            # staged transfer is untouched and a reconnect can re-pull.
            log.debug("shard client disconnected mid-stream")
        except Exception as exc:  # noqa: BLE001 — a handler thread must not
            # die silently; best-effort error frame, then close.
            if not self._stop:
                log.warning("shard serve failed: %s", exc)
            try:
                send_frame(conn, {"error": f"shard serve failed: {exc}"})
            except OSError:
                pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_pull(self, conn: socket.socket, req: dict) -> bool:
        """Answer one pull request; False means an error frame was sent and
        the connection stays usable for the next request."""
        xid = req["xfer_id"]
        start = int(req.get("start", 0))
        stop = req.get("stop")  # None → wait for the complete transfer
        snap = self.store.wait_for(xid, stop, self.stage_timeout)
        if snap is None:
            self.store.drop_if_empty(xid)
            send_frame(conn, {"error": f"transfer {xid} not staged "
                                       "(expired, trimmed, or never registered)"})
            return False
        hashes, parents, data, box, dtype = snap
        m = len(hashes)
        if start >= m:
            send_frame(conn, {"error": f"window [{start}:{stop}) beyond "
                                       f"staged prefix {m}"})
            return False
        end = m if stop is None else min(int(stop), m)
        want = (req["ls"], req["le"], req["hs"], req["he"])
        inter = box_intersection(want, box)
        if inter is None:
            send_frame(conn, {"error": f"no overlap: want {want}, have {box}"})
            return False
        ls, le, hs, he = inter
        sl = data[start:end, :,
                  ls - box[0]:le - box[0], :, hs - box[2]:he - box[2], :]
        send_frame(conn, {"hashes": hashes[start:end],
                          "parents": parents[start:end],
                          "box": list(inter), "dtype": dtype, "start": start})
        for i in range(sl.shape[0]):
            send_frame(conn, {"i": i,
                              "d": np.ascontiguousarray(sl[i]).tobytes()})
        send_frame(conn, {"end": True})
        return True


def send_release(addr: str, xfer_id: str, timeout: float = 10.0) -> None:
    """Tell the transfer's owner (the shard server listed first, shards[0])
    the pull is done: it unpins and unstages."""
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=timeout) as conn:
        conn.settimeout(timeout)
        send_frame(conn, {"xfer_id": xfer_id, "release": True})
        recv_frame(conn)


class ShardClient:
    """Persistent connection to one shard server with bounded
    reconnect/retry. Socket-level failures (reset, timeout, truncated
    stream) reconnect with exponential backoff; application error frames
    (no such transfer, no box overlap) raise immediately — retrying can't
    fix them. NOT thread-safe: the streamed consumer chains its wave
    fetches on one thread per transfer."""

    def __init__(self, addr: str, timeout: float = 30.0, retries: int = 3,
                 backoff: float = 0.05):
        self.addr = addr
        self.timeout = timeout
        self.retries = max(1, retries)
        self.backoff = backoff
        self._conn: socket.socket | None = None

    def _connect(self) -> socket.socket:
        host, _, port = self.addr.rpartition(":")
        conn = socket.create_connection((host, int(port)), timeout=self.timeout)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(self.timeout)
        return conn

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def fetch(self, xfer_id: str, box: Box, start: int | None = None,
              stop: int | None = None) -> tuple[list[int], list[int | None],
                                                np.ndarray, Box]:
        """Pull blocks [start, stop) of the slice of ``box`` this shard
        holds (the whole staged transfer when stop is None). Synchronous."""
        last: Exception | None = None
        for attempt in range(self.retries):
            if attempt:
                time.sleep(self.backoff * (2 ** (attempt - 1)))
            try:
                if self._conn is None:
                    self._conn = self._connect()
                return self._fetch_once(self._conn, xfer_id, box, start, stop)
            except (OSError, EOFError) as exc:
                last = exc
                self.close()
        raise RuntimeError(f"shard pull {self.addr} failed after "
                           f"{self.retries} attempt(s): {last}")

    def _fetch_once(self, conn: socket.socket, xfer_id: str, box: Box,
                    start: int | None, stop: int | None):
        # Chaos: an injected disconnect/error lands inside fetch()'s retry
        # loop (ChaosInjectedError is a ConnectionError, i.e. a retryable
        # OSError) — a shard dying mid-wave without killing a real server.
        chaos.inject("disagg.pull", addr=self.addr, xfer_id=xfer_id)
        req = {"xfer_id": xfer_id, "ls": box[0], "le": box[1],
               "hs": box[2], "he": box[3]}
        if start is not None:
            req["start"] = int(start)
        if stop is not None:
            req["stop"] = int(stop)
        send_frame(conn, req)
        meta = recv_frame(conn)
        if meta is None:
            raise EOFError("connection closed before reply")  # retryable
        if "error" in meta:
            raise RuntimeError(f"shard pull {self.addr} failed: {meta['error']}")
        got: Box = tuple(meta["box"])  # type: ignore[assignment]
        n = len(meta["hashes"])
        dtype = host_dtype(meta["dtype"])
        out = None  # [n, flat] — reshaped by assemble_local (bs/hd caller-known)
        count = 0
        while True:
            frame = recv_frame(conn)
            if frame is None:
                raise EOFError(f"truncated stream: got {count}/{n} blocks")
            if frame.get("end"):
                break
            arr = np.frombuffer(frame["d"], dtype=dtype)
            if out is None:
                out = np.empty((n, arr.size), dtype=dtype)
            out[frame["i"]] = arr
            count += 1
        if count != n or (out is None and n):
            raise EOFError(f"shard pull {self.addr}: got {count}/{n} blocks")
        if out is None:
            out = np.empty((0, 0), dtype=dtype)
        return meta["hashes"], meta["parents"], out, got


def fetch_slice(addr: str, xfer_id: str, box: Box, timeout: float = 30.0,
                start: int | None = None, stop: int | None = None,
                ) -> tuple[list[int], list[int | None], np.ndarray, Box]:
    """One-shot pull of the slice of ``box`` one shard server holds — a
    throwaway ShardClient (callers that pull many waves should hold a
    ShardClient and reuse its connection)."""
    client = ShardClient(addr, timeout=timeout, retries=2)
    try:
        return client.fetch(xfer_id, box, start, stop)
    finally:
        client.close()


def assemble_local(my_box: Box, pieces: list[tuple[np.ndarray, Box]],
                   n: int, bs: int, hd: int, dtype: str) -> np.ndarray | None:
    """Place fetched slices into this rank's [n, 2, myL, bs, myH, hd] block
    array, in the host format of the cache dtype name ``dtype`` ("float32",
    "bfloat16" as uint16 bits, "float16"); a piece of another float format
    (f32 staged by a quantized cache, say) converts as the JAX package's
    cast into its model dtype does (f32 → bf16 rounds to nearest even).
    Returns None (fetch incomplete) unless the pieces tile my box exactly."""
    ls, le, hs, he = my_box
    want = np.dtype(HOST_FLOAT[dtype])
    out = np.empty((n, 2, le - ls, bs, he - hs, hd), dtype=want)
    covered = np.zeros((le - ls, he - hs), dtype=bool)
    for flat, box in pieces:
        bl, bL, bh, bH = box[0], box[1], box[2], box[3]
        if flat.dtype != want:
            flat = f32_to_host(block_to_f32(flat), dtype)
        block = flat.reshape(n, 2, bL - bl, bs, bH - bh, hd)
        out[:, :, bl - ls:bL - ls, :, bh - hs:bH - hs, :] = block
        covered[bl - ls:bL - ls, bh - hs:bH - hs] = True
    if not covered.all():
        return None
    return out
