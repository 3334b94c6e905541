"""Multi-host engines: one engine of R ranks over N nodes — port of
``dynamo_tpu/parallel/multihost.py``.

The JAX package runs one SPMD program over every host: its leader
broadcasts each state-changing op (add, abort, step, ...) and every
follower host replays the same scheduler. The port's engine is single
controller (engine/tp.py): the leader runs the only scheduler and posts
each step's program key to its follower ranks, whose inputs arrive by
broadcast over the group. Over several nodes that stays so:

- node k holds world ranks ``[k R/N, (k+1) R/N)`` (JAX's process-major
  device order; R that N does not divide is refused by name,
  :func:`node_ranks`). Node 0's process is rank 0, the leader, and spawns
  its other ranks as a one-node engine does; node k's process
  (:func:`follower_loop`) is rank ``k R/N`` and spawns the rest of its
  node's ranks.
- Every remote rank gets its messages — step keys, block moves, stats —
  over a framed socket to the leader (:class:`FrameConn`: the pipe's
  ``send`` / ``recv`` / ``poll``, so ``TPGroup.post``, ``recv`` and
  ``reply`` serve both kinds), opened on the leader's op channel
  (:class:`LeaderOpChannel`).
- The group forms over ``tcp://leader_addr`` (:func:`initialize_distributed`,
  with one warm-up all-reduce while the ranks are in lockstep).
- A remote rank's runner takes its step programs' form, CUDA graphs or
  eager (``engine.step_graphs``: eager at more than one rank for now),
  from the hello's config, whose fields (the axes, ``dist_backend``,
  ``warmup_mode``) are the leader's: every rank reaches the leader's
  answer and makes the leader's programs.
- The leader's liveness probe (``engine/tp.TPFollowers.lost``), which its
  wait for a step polls over nccl, covers the remote ranks: a rank's
  control connection that closes, or speaks unasked (a failing rank's
  traceback), names that rank.
- Each node's process keeps JAX's node connection: it reads the leader's
  ``hello`` (the engine essentials, ``_HELLO_FIELDS``, and the model's
  config), acks ``ready`` (with its ranks' shard servers on a prefill
  engine), and counts the op stream the leader's ``AsyncTorchEngine``
  broadcasts (``add``, ``abort``, ``reap``, ``step``, ``exec``,
  ``fail_all``) until ``stop`` or a clean EOF. The port's followers keep no
  scheduler, so they replay none of it: anything that depends on a
  follower's clock (``reap``'s ``now``) lives on the leader alone. The
  stream's use is JAX's failure rule: a lost node makes the next broadcast
  raise, and the engine stops with ``OpChannelDown``.

``num_blocks`` is agreed by a MIN over every rank as the group forms
(``TPGroup.agree_min``, before any rank sizes its pool), the role JAX's
hello plays for it; the hello carries the leader's value too.

Leader discovery goes through the coordination store under
``multinode/{group}/leader``, bound to the leader's lease
(:func:`publish_leader_addr` / :func:`resolve_leader_addr`).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import io
import json
import socket
import struct
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any

from dynamo_tpu_torch.transports.wire import encode_frame, recv_frame, send_frame
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("multihost")

LEADER_KEY_FMT = "multinode/{group}/leader"
#: the one attention implementation of the port (the hand-written kernel on
#: the card, its plain version on the CPU): what the hello's ``attn_impl``
#: carries, JAX's field of the same name
ATTN_IMPL = "mma"


@dataclass(frozen=True)
class MultiNodeConfig:
    """Analog of the reference's MultiNodeConfig (engines.rs:29-44). The op
    channel's port is not part of it: the leader binds port 0 and publishes
    the port it got (:func:`publish_leader_addr`)."""

    num_nodes: int = 1
    node_rank: int = 0
    # host:port of the group's rendezvous (rank 0's TCP store).
    leader_addr: str = ""


def node_ranks(world: int, num_nodes: int, node_rank: int) -> range:
    """The world ranks node ``node_rank`` holds: ``[k R/N, (k+1) R/N)``."""
    if num_nodes < 1 or world % num_nodes:
        raise ValueError(
            f"an engine of {world} ranks (dp x pp x sp x ep x tp) cannot be spread "
            f"over {num_nodes} nodes: the nodes must divide the ranks")
    per = world // num_nodes
    return range(node_rank * per, (node_rank + 1) * per)


def vote_min(n: int, group=None) -> int:
    """Engine-wide minimum of a per-rank count — the all-or-nothing
    primitive that keeps nondeterministic effects (IO failures, shared-store
    hit/miss) rank-consistent: every rank truncates its plan to the minimum.
    A MIN all-reduce over the engine's world group (``TPGroup.agree_min``);
    the identity without one or at one rank. Every rank must call it at the
    same point of the leader's posts (it is a collective)."""
    if group is None or group.world_size <= 1:
        return n
    return group.agree_min(n)


def initialize_distributed(mn: MultiNodeConfig, rank: int, ec, device,
                           timeout: float | None = None):
    """Join the engine's group as world ``rank`` through the rendezvous at
    ``tcp://leader_addr``, then run one all-reduce over the world while the
    ranks are still in lockstep from the rendezvous: a backend's first
    collective is a rendezvous of its own with a timeout, and deferring it
    to the engine's first real one lets uneven setup times (weights, cache)
    blow its window (JAX's reason for the same warm-up). Returns the rank's
    ``TPGroup``."""
    import torch

    from dynamo_tpu_torch.parallel.collectives import DEFAULT_TIMEOUT_S, init_tp_group

    group = init_tp_group(rank, ec.tp, ec.dist_backend, f"tcp://{mn.leader_addr}",
                          device, timeout=timeout or DEFAULT_TIMEOUT_S, dp=ec.dp,
                          ep=ec.ep, pp=ec.pp, sp=ec.sp)
    x = torch.ones(1, dtype=torch.float32, device=device)
    group._run(torch.distributed.all_reduce, x, group=group._world)
    if int(x.item()) != group.world_size:
        raise RuntimeError(f"collective warm-up wrong: {x.item()} != {group.world_size}")
    log.info("group up: rank %d of %d over %s", rank, group.world_size, mn.leader_addr)
    return group


# ---------------------------------------------------------------------------
# Leader discovery over the coordination service
# ---------------------------------------------------------------------------

async def publish_leader_addr(client, group: str, leader_addr: str,
                              op_port: int = 0, lease_id: int = 0) -> None:
    """Rank 0: advertise the rendezvous address AND the (already-bound)
    op-channel port, lease-bound (the reference's leader bootstrap,
    lib/runtime/src/utils/leader_worker_barrier.rs)."""
    payload = json.dumps({"leader_addr": leader_addr, "op_port": op_port})
    await client.put(LEADER_KEY_FMT.format(group=group), payload.encode(), lease_id)


async def resolve_leader_addr(client, group: str, timeout: float = 60.0) -> tuple[str, int]:
    """Nodes > 0: poll the coordination service for (leader_addr, op_port)."""
    deadline = time.monotonic() + timeout
    key = LEADER_KEY_FMT.format(group=group)
    while time.monotonic() < deadline:
        val = await client.get(key)
        if val:
            obj = json.loads(bytes(val).decode())
            return obj["leader_addr"], int(obj.get("op_port", 0))
        await asyncio.sleep(0.2)
    raise TimeoutError(f"no leader address published at {key} within {timeout}s")


# ---------------------------------------------------------------------------
# Framed sockets with the pipe's contract
# ---------------------------------------------------------------------------

def _tuples(x: Any) -> Any:
    """msgpack reads a tuple back as a list: a message's nested lists as
    tuples again (what a pipe's pickle would have kept)."""
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    return x


class FrameConn:
    """One framed socket (``transports/wire.py``'s frames over the port's
    msgpack) with ``multiprocessing.Connection``'s ``send`` / ``recv`` /
    ``poll`` / ``close``: a remote rank's control channel, so the group's
    ``post`` / ``recv`` / ``reply`` serve pipes and sockets alike. ``recv``
    raises ``EOFError`` when the peer is gone, as a pipe's does; a message
    (a tuple) comes back as a tuple. Sends are serialised by a lock; the
    frames and bytes sent and received are counted."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._lock = threading.Lock()
        self.frames_sent = self.bytes_sent = 0
        self.frames_recv = self.bytes_recv = 0

    def send(self, obj: Any) -> None:
        data = encode_frame(obj)
        with self._lock:
            self.sock.sendall(data)
            self.frames_sent += 1
            self.bytes_sent += len(data)

    def recv(self) -> Any:
        try:
            obj = recv_frame(self.sock)
        except OSError as exc:
            raise EOFError(f"connection lost: {exc}") from exc
        if obj is None:
            raise EOFError("peer closed the connection")
        self.frames_recv += 1
        return _tuples(obj) if isinstance(obj, list) else obj

    def poll(self, timeout: float = 0.0) -> bool:
        import select

        try:
            ready, _, _ = select.select([self.sock], [], [], timeout)
        except (OSError, ValueError):
            return False
        return bool(ready)

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self.sock.close()


class LeaderOpChannel:
    """Rank 0's op channel: accepts the other nodes' connections (one each,
    JAX's op channel) and every remote rank's control connection, sends the
    hello, collects the nodes' ``ready`` acks, and broadcasts the op stream.

    ``broadcast`` is called from the engine-core thread; sends block
    (frames are tiny and the nodes read eagerly). A lost node makes it
    raise: its ranks have left every collective, and the engine cannot
    continue."""

    def __init__(self, port: int, num_followers: int, leader_addr: str = ""):
        self.num_followers = num_followers
        #: host:port of the group's rendezvous (``tcp://`` init of the ranks)
        self.leader_addr = leader_addr
        #: extra hello fields (``disagg_role`` for a prefill engine)
        self.hello_extra: dict = {}
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", port))  # port 0 → OS-assigned, race-free
        self.port = self._server.getsockname()[1]
        self._server.listen(64)
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self.ready_infos: list[dict] = []
        self.frames = self.bytes = 0

    def _accept(self, kind: str, timeout: float) -> tuple[socket.socket, dict]:
        self._server.settimeout(timeout)
        conn, addr = self._server.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(timeout)
        first = recv_frame(conn)
        conn.settimeout(None)
        if not isinstance(first, dict) or first.get("op") != kind:
            conn.close()
            raise RuntimeError(f"op channel: expected a {kind!r} connection, got {first!r}")
        log.info("%s connection from %s: %s", kind, addr, first)
        return conn, first

    def accept_followers(self, timeout: float = 300.0) -> None:
        """Accept the ``num_followers`` other nodes (node 1..N-1, any order)."""
        while len(self._conns) < self.num_followers:
            conn, _ = self._accept("node", timeout)
            self._conns.append(conn)
            log.info("node %d/%d connected", len(self._conns), self.num_followers)

    def accept_ranks(self, ranks, timeout: float = 300.0) -> dict[int, FrameConn]:
        """Accept the control connection of each world rank in ``ranks``
        (each names its rank in its first frame)."""
        want, out = set(ranks), {}
        while len(out) < len(want):
            conn, first = self._accept("rank", timeout)
            rank = int(first["rank"])
            if rank not in want or rank in out:
                conn.close()
                raise RuntimeError(f"op channel: unexpected rank connection {rank}")
            out[rank] = FrameConn(conn)
        return out

    def wait_ready(self, timeout: float = 600.0) -> list[dict]:
        """Block until every node has acked readiness (its ranks' runners
        built). Returns the ready payloads (``ready_infos`` keeps them): a
        prefill engine's list its ranks' shard servers (``shards``, each
        ``{"addr", "box"}``)."""
        self.ready_infos = []
        for conn in self._conns:
            conn.settimeout(timeout)
            ack = recv_frame(conn)
            if not isinstance(ack, dict) or ack.get("op") != "ready":
                raise RuntimeError(f"follower node sent {ack!r} instead of ready")
            conn.settimeout(None)
            self.ready_infos.append(ack)
        log.info("all %d follower nodes ready", self.num_followers)
        return self.ready_infos

    def shards(self) -> list[dict]:
        """The follower nodes' shard servers, ``[{"addr", "box"}, ...]``."""
        return [s for info in self.ready_infos for s in info.get("shards", [])]

    def broadcast(self, op: dict) -> None:
        data = encode_frame(op)
        with self._lock:
            dead = []
            for conn in self._conns:
                try:
                    conn.sendall(data)
                    self.frames += 1
                    self.bytes += len(data)
                except OSError as exc:
                    log.error("follower node send failed (%s); dropping conn", exc)
                    dead.append(conn)
            for conn in dead:
                self._conns.remove(conn)
                conn.close()
            if dead:
                # A lost node's ranks stop taking part in collectives: the
                # next step would fail or hang. Fail loudly.
                raise RuntimeError(
                    f"lost {len(dead)} follower node connection(s); multi-host "
                    "engine cannot continue")

    def close(self) -> None:
        """Tell every node the engine is stopping (best effort), then close
        the connections. Idempotent."""
        with contextlib.suppress(RuntimeError):
            self.broadcast({"op": "stop"})
        for conn in self._conns:
            with contextlib.suppress(OSError):
                conn.close()
        self._conns = []
        with contextlib.suppress(OSError):
            self._server.close()


def connect_to_leader(host: str, port: int, timeout: float = 300.0) -> socket.socket:
    deadline = time.monotonic() + timeout
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            sock = socket.create_connection((host, port), timeout=10.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            return sock
        except OSError as exc:
            last = exc
            time.sleep(0.3)
    raise TimeoutError(f"could not reach leader op channel {host}:{port}: {last}")


# ---------------------------------------------------------------------------
# The hello
# ---------------------------------------------------------------------------

# Every setting all ranks of one engine must agree on: what shapes the
# programs, the group, or the decisions the followers' block moves mirror.
# ONE list, consumed by both leader_hello and engine_config_from_hello, so a
# new field cannot be added to one side and silently default on the other.
# JAX's fields first (``dtype`` and ``attn_impl`` are not EngineConfig
# fields of the port: the model's dtype and the port's one attention
# implementation), then the port's own.
_HELLO_FIELDS = (
    "model", "dtype", "attn_impl", "allow_random_weights", "quantization",
    "kv_dtype", "num_blocks", "block_size",
    "max_batch_size", "max_model_len", "prefill_chunk", "max_tokens_per_step",
    "decode_bucket", "decode_window", "seed", "enable_prefix_caching",
    "dp", "pp", "tp", "ep", "sp", "pp_microbatches",
    # KVBM tiers: every rank's tier cascade mirrors the leader's decisions,
    # so every rank must build the same one (the remote store's
    # nondeterminism is voted: OffloadManager.vote_plans).
    "host_kv_blocks", "disk_kv_path", "disk_kv_bytes", "remote_kv_addr",
    "spec_ngram", "spec_k",
    # the port's: the group and the attention kernel's split count
    "num_nodes", "dist_backend", "ring_prefill_threshold", "attn_num_splits",
    "unified_step", "global_prefix_cache", "warmup_mode",
)


def leader_hello(engine_cfg, model_cfg=None) -> dict:
    """The engine essentials every rank must agree on, as resolved by the
    leader, and the model's config (``model_cfg``: the followers serve
    the model the leader's process resolved, dtype overrides included)."""
    out: dict[str, Any] = {"op": "hello"}
    for f in _HELLO_FIELDS:
        if f == "dtype":
            v = model_cfg.dtype if model_cfg is not None else None
        elif f == "attn_impl":
            v = ATTN_IMPL
        else:
            v = getattr(engine_cfg, f)
        out[f] = list(v) if isinstance(v, tuple) else v
    if model_cfg is not None:
        out["model_cfg"] = dataclasses.asdict(model_cfg)
    return out


def engine_config_from_hello(hello: dict):
    """Build the follower's EngineConfig from the leader's hello frame."""
    from dynamo_tpu_torch.utils.config import EngineConfig

    if hello.get("attn_impl", ATTN_IMPL) != ATTN_IMPL:
        raise ValueError(f"the leader's attention implementation {hello['attn_impl']!r} "
                         f"is not the port's {ATTN_IMPL!r}")
    names = {f.name for f in dataclasses.fields(EngineConfig)}
    kw = {f: hello[f] for f in _HELLO_FIELDS if f in names}
    kw["decode_bucket"] = tuple(kw["decode_bucket"])
    return EngineConfig(**kw)


def model_config_from_hello(hello: dict):
    """The model's config the leader resolved (the hello's ``model_cfg``)."""
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(**hello["model_cfg"])


# ---------------------------------------------------------------------------
# A remote rank, and a follower node's process
# ---------------------------------------------------------------------------

def params_to_bytes(params: dict) -> bytes:
    """A rank's shard of the params as bytes, for its control connection."""
    import torch

    buf = io.BytesIO()
    torch.save(params, buf)
    return buf.getvalue()


def params_from_bytes(data: bytes, device) -> dict:
    import torch

    return torch.load(io.BytesIO(bytes(data)), map_location=device, weights_only=True)


class RemoteRank:
    """One world rank of a follower node: its control connection to the
    leader, its group and its runner."""

    def __init__(self, rank: int, hello: dict, op_addr: tuple[str, int], device: str,
                 advertise_host: str = "127.0.0.1"):
        import torch

        self.rank = rank
        self.runner = None
        self.conn = FrameConn(connect_to_leader(*op_addr))
        self.conn.send({"op": "rank", "rank": rank})
        self.group = None
        ec = engine_config_from_hello(hello)
        cfg = model_config_from_hello(hello)
        dev = torch.device(device)
        params = None
        if hello.get("params"):
            kind, blob = self.conn.recv()
            if kind != "params":
                raise RuntimeError(f"rank {rank}: expected its params, got {kind!r}")
            params = params_from_bytes(blob, dev)
        mn = MultiNodeConfig(ec.num_nodes, 0, hello["leader_addr"])
        self.group = initialize_distributed(mn, rank, ec, dev)
        self.group.conns = [self.conn]
        from dynamo_tpu_torch.engine.engine import ModelRunner

        self.runner = ModelRunner(cfg, ec, params=params, device=dev, tp=self.group)
        del params
        self.info: dict[str, Any] = {"rank": rank}
        blocks = self.runner.blocks
        if hello.get("disagg_role") == "prefill" and blocks is not None and blocks.serves:
            # this rank serves its box of staged transfers, at this host's
            # address on the route to the leader
            self.info["shard"] = {"addr": blocks.start_shard_server(advertise_host),
                                  "box": list(blocks.box)}

    def follow(self) -> dict:
        """Follow the leader until ``stop``; returns this rank's kernel
        launches by route and forward steps (program calls, a window's
        steps each)."""
        try:
            self.runner.follow()
            stats = self.runner.tp_stats()
            return {"launches": stats["launches_by_kernel"],
                    "forward_steps": stats["forward_steps"]}
        finally:
            self.close()

    def close(self) -> None:
        if self.runner is not None and self.runner.blocks is not None:
            self.runner.blocks.close()
        if self.group is not None:
            self.group.close()
            self.group = None
        self.conn.close()


def _fail(conn, rank: int) -> None:
    with contextlib.suppress(OSError, EOFError):
        conn.send(("error", rank, traceback.format_exc()))


def rank_main(rank: int, hello: dict, op_addr: tuple[str, int], device: str,
              advertise_host: str, pipe) -> None:
    """A follower node's other ranks: one process each (``spawn``), which
    reports ``("ready", info)`` or ``("error", traceback)`` to the node's
    process and follows the leader until ``stop``."""
    me = None
    try:
        me = RemoteRank(rank, hello, op_addr, device, advertise_host)
        pipe.send(("ready", me.info))
    except BaseException:
        tb = traceback.format_exc()
        with contextlib.suppress(OSError):
            pipe.send(("error", tb))
        if me is not None:
            _fail(me.conn, rank)
        raise SystemExit(1) from None
    try:
        me.follow()
    except BaseException:
        _fail(me.conn, rank)
        raise SystemExit(1) from None


def _node_devices(n: int, device: str | None, tp_devices: tuple[int, ...]) -> list[str]:
    """This node's rank devices: ``device`` for each on the CPU, else
    ``cuda:tp_devices[i]`` (default ``cuda:i``)."""
    if device is not None and str(device).startswith("cpu"):
        return ["cpu"] * n
    ids = tp_devices or tuple(range(n))
    if len(ids) != n:
        raise ValueError(f"tp_devices {ids} must name one card for each of this node's "
                         f"{n} ranks")
    return [f"cuda:{i}" for i in ids]


def follower_loop(sock: socket.socket, node_rank: int, device: str | None = None,
                  tp_devices: tuple[int, ...] = ()) -> dict:
    """A follower node's process: read the leader's hello, host this node's
    ranks (this process is the first; the others are spawned), ack
    ``ready`` with their shard servers, and follow the leader until it
    posts ``stop`` (or its connections close). ``sock`` is connected to the
    leader's op channel. Returns what the node saw (op frames and bytes,
    its setup seconds) and what its first rank ran (kernel launches by
    route, forward steps)."""
    import torch.multiprocessing as mp

    from dynamo_tpu_torch.utils import msgpack

    send_frame(sock, {"op": "node", "node_rank": node_rank})
    hello = recv_frame(sock)
    t0 = time.perf_counter()
    if not isinstance(hello, dict) or hello.get("op") != "hello":
        raise RuntimeError(f"expected hello from leader, got {hello!r}")
    world = hello["dp"] * hello["pp"] * hello["sp"] * hello["ep"] * hello["tp"]
    ranks = node_ranks(world, hello["num_nodes"], node_rank)
    devices = _node_devices(len(ranks), device, tuple(tp_devices))
    op_addr = (sock.getpeername()[0], sock.getpeername()[1])
    advertise = sock.getsockname()[0]
    ctx = mp.get_context("spawn")
    procs, pipes = [], []
    for rank, dev in zip(list(ranks)[1:], devices[1:]):
        ours, theirs = ctx.Pipe()
        proc = ctx.Process(target=rank_main, name=f"node{node_rank}-rank-{rank}", daemon=True,
                           args=(rank, hello, op_addr, dev, advertise, theirs))
        proc.start()
        theirs.close()
        procs.append(proc)
        pipes.append(ours)
    seen = {"frames": 0, "bytes": 0}
    me = None
    try:
        try:
            me = RemoteRank(ranks[0], hello, op_addr, devices[0], advertise)
        except BaseException:
            if me is not None:
                _fail(me.conn, ranks[0])
            raise
        infos = [me.info]
        for rank, pipe in zip(list(ranks)[1:], pipes):
            kind, payload = pipe.recv()
            if kind != "ready":
                raise RuntimeError(f"rank {rank} failed to start:\n{payload}")
            infos.append(payload)
        shards = [i["shard"] for i in infos if "shard" in i]
        ready = {"op": "ready", "node_rank": node_rank, "ranks": list(ranks), "shards": shards,
                 "setup_s": time.perf_counter() - t0}
        if len(shards) == 1:   # JAX's one-shard form too
            ready["shard_addr"], ready["shard_box"] = shards[0]["addr"], shards[0]["box"]
        send_frame(sock, ready)
        print(f"FOLLOWER_READY rank={node_rank}", flush=True)

        def read_ops() -> None:
            # the op stream: drained (a full socket buffer would block the
            # leader's broadcast) and counted, not replayed (the leader's
            # scheduler is the only one); stop or EOF ends it
            while True:
                try:
                    header = _read_exact(sock, 4)
                except OSError:
                    header = None
                if header is None:
                    return
                (n,) = struct.unpack(">I", header)
                try:
                    payload = _read_exact(sock, n)
                except OSError:
                    payload = None
                if payload is None:
                    return
                seen["frames"] += 1
                seen["bytes"] += 4 + n
                op = msgpack.unpackb(bytes(payload))
                if isinstance(op, dict) and op.get("op") == "stop":
                    return

        reader = threading.Thread(target=read_ops, name="op-stream", daemon=True)
        reader.start()
        seen["setup_s"] = ready["setup_s"]
        seen.update(me.follow())
        me = None
    except BaseException:
        if me is not None:
            _fail(me.conn, ranks[0])
            me.close()
        raise
    finally:
        for proc in procs:
            proc.join(timeout=30.0)
            if proc.is_alive():
                log.warning("node %d: rank process %s did not stop: killing it",
                            node_rank, proc.name)
                proc.kill()
                proc.join(timeout=10.0)
        for pipe in pipes:
            pipe.close()
    log.info("leader stopped; node %d done (%d op frames, %d bytes)", node_rank,
             seen["frames"], seen["bytes"])
    return seen


def _read_exact(sock: socket.socket, n: int) -> bytearray | None:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            return None
        got += k
    return buf


def main(argv=None) -> None:
    """``python -m dynamo_tpu_torch.parallel.multihost --op-addr HOST:PORT
    --node-rank K [--device cpu] [--tp-devices 0,1]``: a follower node
    without the distributed runtime (the worker's ``--num-nodes`` finds the
    leader through the coordinator instead)."""
    import argparse

    from dynamo_tpu_torch.utils.logging import configure_logging

    p = argparse.ArgumentParser("dynamo-multihost-node")
    p.add_argument("--op-addr", required=True, help="the leader's op channel host:port")
    p.add_argument("--node-rank", type=int, required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--tp-devices", default=None)
    p.add_argument("--timeout", type=float, default=300.0)
    ns = p.parse_args(argv)
    configure_logging()
    host, port = ns.op_addr.rsplit(":", 1)
    sock = connect_to_leader(host, int(port), timeout=ns.timeout)
    tp_devices = tuple(int(d) for d in ns.tp_devices.split(",")) if ns.tp_devices else ()
    seen = follower_loop(sock, ns.node_rank, ns.device, tp_devices)
    sock.close()
    print(f"FOLLOWER_DONE rank={ns.node_rank} {json.dumps(seen)}", flush=True)


if __name__ == "__main__":
    main()
