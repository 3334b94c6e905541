"""The processes of a tensor-, expert-, sequence-, pipeline- and
data-parallel engine.

Rank 0, the leader, is the process that builds the ``EngineCore``: it runs
the scheduler and the step loop, and samples. Ranks 1..dp*pp*sp*ep*tp-1, the
followers, are processes it starts (``spawn``: CUDA forbids ``fork`` once
initialised) and joins at shutdown. A follower joins the group
(parallel/collectives.py), builds its shard of the params and of the KV
cache, and runs ``ModelRunner.follow``: for each step the leader posts the
program's key on a pipe, broadcasts the step's inputs over the group, and
every rank runs the same forward on its shard. World rank
``(((d*pp + s)*sp + q)*ep + e)*tp + m`` holds model shard ``m`` of expert
shard ``e`` of seq rank ``q`` of pipeline stage ``s`` of data replica
``d`` (JAX's "data" axis: params and cache replicated over it; its
"expert" axis: the MoE expert stacks split over it, attention and cache
replicated; its "seq" axis: params and cache replicated, a ring prefill
step's positions split over it; its "pipe" axis: the layers and their
cache split over it, stage 0 embedding and the last stage's hidden coming
back to it).

A follower's params: given a full tree, the leader cuts each follower's
shard and hands it over through host memory at the spawn; without one,
each rank draws (``llama.init_params``) or loads (``loader.load_params``)
its own shard, and no rank holds the whole tree.

The pipe is the followers' way back too: a follower that fails sends its
traceback before it exits, and the leader's next collective fails at once
(gloo sees the closed connection) or after the group's timeout, with the
follower's traceback and exit code in its message. A follower whose
leader is gone sees the pipe close and exits.

Over several nodes (``num_nodes > 1``, parallel/multihost.py) the leader
spawns only its own node's ranks ``[0, R/N)``; node k's process hosts
ranks ``[k R/N, (k+1) R/N)``. A remote rank's channel is a framed socket
with the pipe's contract (``multihost.FrameConn``), opened on the leader's
op channel, and the group forms over ``tcp://``. Its traceback, when it
sends one, reaches the leader's failure message as a local follower's
does; its exit code cannot.

Over nccl a step's collectives run on the card asynchronously, and no
collective fails at once when a peer dies: an eager one waits for it
until NCCL's watchdog times it out, one inside a CUDA graph forever (the
watchdog does not watch captured work). The leader then waits for a
step's outputs by polling (:func:`wait_event`), and between polls asks
its followers whether they live (:meth:`TPFollowers.lost`: the exit code
of a local follower's process, the closed channel of a remote rank), so a
lost follower fails the step with its rank and exit code instead of
hanging it.

At shutdown the leader drops its CUDA graphs (over nccl a communicator
that a live graph uses cannot be destroyed), posts ``stop``, leaves the
group at once (a rank's ``destroy_process_group`` over nccl waits for its
peers'), then joins its own node's followers; each follower drops its
graphs and leaves on the ``stop`` it reads, a remote node's ranks too.
After a lost rank, over nccl, nobody leaves: the leader kills its own
node's followers and closes the op channel (``EngineCore.abandon``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
import traceback
from typing import Any

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.parallel.collectives import (
    DEFAULT_TIMEOUT_S,
    TPFailure,
    TPGroup,
    init_tp_group,
    rank_coords,
)
from dynamo_tpu_torch.parallel.mesh import check_pp, check_tp, shard_params
from dynamo_tpu_torch.utils.config import EngineConfig
from dynamo_tpu_torch.utils.device import resolve_device
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("engine.tp")

#: seconds the leader waits for a follower to exit after ``stop``
JOIN_TIMEOUT_S = 30.0
#: seconds between two liveness probes while the leader waits for a step
#: or for its followers' replies
PROBE_S = 0.05


def engine_ranks(ec: EngineConfig) -> int:
    """The processes of an engine: one a (data replica, stage, seq rank,
    expert shard, model shard)."""
    return ec.dp * ec.pp * ec.sp * ec.ep * ec.tp


def tp_devices(ec: EngineConfig, device: str | torch.device | None) -> list[torch.device]:
    """Each of this node's ranks' device: every rank on the CPU for
    ``device="cpu"`` (gloo only), else its i-th rank on
    ``cuda:tp_devices[i]`` (default ``cuda:i``). A node holds R /
    ``num_nodes`` of the engine's R ranks."""
    dev = resolve_device(device)
    n_ranks = engine_ranks(ec) // ec.num_nodes
    if dev.type == "cpu":
        if ec.dist_backend != "gloo":
            raise ValueError(f"tensor-parallel ranks on the CPU need dist_backend='gloo', "
                             f"got {ec.dist_backend!r}")
        return [dev] * n_ranks
    ids = ec.tp_devices or tuple(range(n_ranks))
    n = torch.cuda.device_count()
    if any(not 0 <= i < n for i in ids):
        raise ValueError(f"tp_devices {ids}: this host has {n} CUDA devices")
    return [torch.device("cuda", i) for i in ids]


def _to(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    return params.to(device)


class TPFollowers:
    """The leader's handle on its follower processes: their pipes, their
    state for failure messages, and their shutdown."""

    def __init__(self, ec: EngineConfig, cfg: ModelConfig, devices: list[torch.device],
                 params: dict | None, init_method: str | None = None):
        self._dir = tempfile.mkdtemp(prefix="dyn-tp-")
        self.init_method = init_method or "file://" + os.path.join(self._dir, "rendezvous")
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs: list = []
        self.conns: list = []
        #: the remote ranks' channels (framed sockets), after the local pipes
        self.remote: dict[int, Any] = {}
        #: the last stop's seconds and the followers it had to kill
        self.shutdown = {"seconds": 0.0, "killed": 0, "exit_codes": []}
        try:
            for rank in range(1, len(devices)):
                shard = None
                if params is not None:   # the rank's shard, through host memory
                    shard = _to(_shard(params, cfg, ec, rank), torch.device("cpu"))
                ours, theirs = ctx.Pipe()
                self.conns.append(ours)
                proc = ctx.Process(target=follower_main, name=f"tp-rank-{rank}", daemon=True,
                                   args=(rank, ec, cfg, str(devices[rank]), self.init_method,
                                         shard, theirs))
                proc.start()
                theirs.close()
                self.procs.append(proc)
        except BaseException:
            self.stop()
            raise

    def add_remote(self, conns: dict) -> None:
        """The remote ranks' channels, by world rank (after the local ones)."""
        self.remote = dict(sorted(conns.items()))
        self.conns = self.conns[:len(self.procs)] + list(self.remote.values())

    @staticmethod
    def _traceback(conn) -> tuple[str | None, bool]:
        """A follower's traceback if it sent one, and whether its channel
        is closed."""
        tb, closed = None, False
        try:
            while conn.poll():
                msg = conn.recv()
                if msg[0] == "error":
                    tb = msg[2]
        except (EOFError, OSError):
            closed = True
        return tb, closed

    def report(self) -> str:
        """What the leader knows of each follower: its traceback if it sent
        one, its exit code if it exited (each local one is given a few
        seconds to), and of a remote one whether its channel is closed."""
        parts = []
        for rank, (proc, conn) in enumerate(zip(self.procs, self.conns), 1):
            proc.join(timeout=5.0)
            tb, _ = self._traceback(conn)
            state = "alive" if proc.exitcode is None else f"exit code {proc.exitcode}"
            parts.append(f"follower rank {rank}: {state}"
                         + (f", traceback:\n{tb}" if tb else ""))
        for rank, conn in self.remote.items():
            tb, closed = self._traceback(conn)
            state = "channel closed" if closed else "channel open"
            parts.append(f"remote follower rank {rank}: {state}"
                         + (f", traceback:\n{tb}" if tb else ""))
        return "; ".join(parts)

    def lost(self, remote: bool = True) -> str | None:
        """The liveness probe: None while every follower lives, else a
        message naming the first one gone: a local follower whose process
        exited (its exit code and traceback), with ``remote`` a remote rank
        whose channel closed or spoke unasked (a follower sends only replies
        the leader waits for, and its traceback when it fails). No join and
        no wait."""
        for rank, (proc, conn) in enumerate(zip(self.procs, self.conns), 1):
            if proc.exitcode is not None:
                tb, _ = self._traceback(conn)
                return (f"follower rank {rank} exited with exit code {proc.exitcode}"
                        + (f", traceback:\n{tb}" if tb else ""))
        for rank, conn in self.remote.items() if remote else ():
            if conn.poll():
                tb, closed = self._traceback(conn)
                return (f"remote follower rank {rank}: "
                        + ("channel closed" if closed else "failed")
                        + (f", traceback:\n{tb}" if tb else ""))
        return None

    def replies(self, kind: str, timeout: float = DEFAULT_TIMEOUT_S) -> list:
        """One ``kind`` reply from each follower, in rank order, within
        ``timeout`` seconds in all: a follower that hangs (its ops run in
        order, so a reply waits for every op posted before it) or whose
        process exits fails the wait with ``TPFailure``."""
        out = []
        ranks = [*range(1, len(self.procs) + 1), *self.remote]
        deadline = time.monotonic() + timeout
        for rank, conn in zip(ranks, self.conns):
            while not conn.poll(PROBE_S):
                # a remote rank's channel may hold its reply already: only
                # the local processes are probed here
                gone = self.lost(remote=False)
                if gone or time.monotonic() > deadline:
                    raise TPFailure(f"follower rank {rank} sent no {kind!r} reply"
                                    + (f": {gone}" if gone else
                                       f" within {timeout:g} s: it hangs"))
            try:
                msg = conn.recv()
            except (EOFError, OSError) as exc:
                raise TPFailure(f"follower rank {rank} did not reply: {exc!r}; "
                                + self.report()) from exc
            if msg[0] != kind:
                raise TPFailure(f"follower rank {rank} replied {msg[0]!r}, expected "
                                f"{kind!r}: " + (msg[2] if msg[0] == "error" else str(msg)))
            out.append(msg[1])
        return out

    def stop(self, group: TPGroup | None = None) -> None:
        """Tell every follower to stop, leave ``group`` (the leader's) at
        once, then join each local follower (killing one that outlives
        ``JOIN_TIMEOUT_S``) and close the channels. ``shutdown`` records
        the seconds it took and the followers killed."""
        t0 = time.perf_counter()
        killed = 0
        for conn in self.conns:
            with contextlib.suppress(OSError):
                conn.send(("stop",))
        if group is not None:
            group.close()
        for rank, proc in enumerate(self.procs, 1):
            proc.join(timeout=JOIN_TIMEOUT_S)
            if proc.is_alive():
                log.warning("tensor-parallel follower rank %d did not stop: killing it", rank)
                proc.kill()
                killed += 1
                proc.join(timeout=JOIN_TIMEOUT_S)
        for conn in self.conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        self.shutdown = {"seconds": time.perf_counter() - t0, "killed": killed,
                         "exit_codes": [p.exitcode for p in self.procs]}

    def kill(self) -> None:
        """Kill every local follower at once and close the channels (the
        way out after a lost rank: no ``stop``, no group teardown)."""
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=5.0)
        for conn in self.conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)


def _shard(params: dict, cfg: ModelConfig, ec: EngineConfig, rank: int) -> dict:
    _, s, _, e, m = rank_coords(rank, ec.tp, ec.ep, ec.pp, ec.sp)
    return shard_params(params, cfg, m, ec.tp, e, ec.ep, s, ec.pp)


def start_tp(ec: EngineConfig, cfg: ModelConfig, device: str | torch.device | None,
             params: dict | None, channel=None) -> tuple[TPGroup, TPFollowers, dict | None]:
    """Start the followers of a ``dp`` x ``pp`` x ``sp`` x ``ep`` x
    ``tp``-rank engine and join the group as its leader. Returns the
    leader's group, the followers' handle and the leader's shard of
    ``params`` (a full tree, or None to build them on every rank).

    Over several nodes ``channel`` is the leader's op channel
    (``multihost.LeaderOpChannel``, the other nodes accepted): the leader
    spawns its node's ranks, sends every node the hello, accepts the
    remote ranks' channels (handing each its shard of ``params`` over it),
    and the group forms at ``tcp://channel.leader_addr``."""
    check_tp(cfg, ec.tp, ec.ep)
    check_pp(cfg, ec.pp)
    devices = tp_devices(ec, device)
    init = f"tcp://{channel.leader_addr}" if channel is not None else None
    followers = TPFollowers(ec, cfg, devices, params, init)
    try:
        if channel is not None:
            from dynamo_tpu_torch.parallel import multihost as mh

            hello = {**mh.leader_hello(ec, cfg), **channel.hello_extra,
                     "leader_addr": channel.leader_addr, "params": params is not None}
            channel.broadcast(hello)
            conns = channel.accept_ranks(range(len(devices), engine_ranks(ec)))
            if params is not None:
                for rank, conn in conns.items():
                    conn.send(("params", mh.params_to_bytes(
                        _to(_shard(params, cfg, ec, rank), torch.device("cpu")))))
            followers.add_remote(conns)
            group = mh.initialize_distributed(
                mh.MultiNodeConfig(ec.num_nodes, 0, channel.leader_addr), 0, ec, devices[0])
        else:
            group = init_tp_group(0, ec.tp, ec.dist_backend, followers.init_method, devices[0],
                                  dp=ec.dp, ep=ec.ep, pp=ec.pp, sp=ec.sp)
    except BaseException as exc:
        report = followers.report()
        followers.stop()
        raise TPFailure(f"the tensor-parallel group did not form: {exc}; {report}") from exc
    group.conns = followers.conns
    group.report = followers.report
    group.probe = followers.lost
    if params is not None:
        params = _shard(params, cfg, ec, 0)
    return group, followers, params


def wait_event(event, group: TPGroup) -> None:
    """The leader's wait for a step's outputs behind ``event`` (a CUDA
    event, or anything with its ``query``) when its ranks' collectives run
    on the card asynchronously (nccl): a spin on the event that yields the
    GIL between queries (a blocking ``synchronize`` spins too, so no sleep
    adds to a step's latency), and every ``PROBE_S`` seconds the group's
    liveness probe. Raises ``TPFailure`` naming the rank when a follower
    is gone, and when the event has not completed within the group's
    timeout while every follower lives (a rank that hangs)."""
    t0 = probed = time.monotonic()
    while not event.query():
        time.sleep(0)
        now = time.monotonic()
        if now - probed < PROBE_S:
            continue
        probed = now
        gone = group.probe() if group.probe is not None else None
        if gone:
            raise TPFailure(f"a step of the engine of {group.world_size} ranks cannot "
                            f"complete: {gone}")
        if now - t0 > group.timeout:
            raise TPFailure(f"a step of the engine of {group.world_size} ranks did not "
                            f"complete within the group's timeout of {group.timeout:g} s, "
                            "every follower alive: a rank hangs")


def follower_main(rank: int, ec: EngineConfig, cfg: ModelConfig, device: str,
                  init_method: str, params: dict | None, conn) -> None:
    """A follower process: join the group, build this rank's runner, and
    follow the leader until it posts ``stop`` (or its pipe closes)."""
    group = None
    try:
        dev = torch.device(device)
        if ec.num_nodes > 1:   # the group of an engine over several nodes
            from dynamo_tpu_torch.parallel import multihost as mh

            group = mh.initialize_distributed(
                mh.MultiNodeConfig(ec.num_nodes, 0, init_method.removeprefix("tcp://")),
                rank, ec, dev)
        else:
            group = init_tp_group(rank, ec.tp, ec.dist_backend, init_method, dev, dp=ec.dp,
                                  ep=ec.ep, pp=ec.pp, sp=ec.sp)
        group.conns = [conn]
        from dynamo_tpu_torch.engine.engine import ModelRunner

        runner = ModelRunner(cfg, ec, params=None if params is None else _to(params, dev),
                             device=dev, tp=group)
        del params
        runner.follow()
    except BaseException:
        with contextlib.suppress(OSError):
            conn.send(("error", rank, traceback.format_exc()))
        raise SystemExit(1) from None
    finally:
        if group is not None:
            group.close()
        conn.close()
