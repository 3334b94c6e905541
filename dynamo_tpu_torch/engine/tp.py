"""The processes of a tensor-, expert-, pipeline- and data-parallel engine.

Rank 0, the leader, is the process that builds the ``EngineCore``: it runs
the scheduler and the step loop, and samples. Ranks 1..dp*pp*ep*tp-1, the
followers, are processes it starts (``spawn``: CUDA forbids ``fork`` once
initialised) and joins at shutdown. A follower joins the group
(parallel/collectives.py), builds its shard of the params and of the KV
cache, and runs ``ModelRunner.follow``: for each step the leader posts the
program's key on a pipe, broadcasts the step's inputs over the group, and
every rank runs the same forward on its shard. World rank
``((d*pp + s)*ep + e)*tp + m`` holds model shard ``m`` of expert shard
``e`` of pipeline stage ``s`` of data replica ``d`` (JAX's "data" axis:
params and cache replicated over it; its "expert" axis: the MoE expert
stacks split over it, attention and cache replicated; its "pipe" axis:
the layers and their cache split over it, stage 0 embedding and the last
stage's hidden coming back to it).

A follower's params: given a full tree, the leader cuts each follower's
shard and hands it over through host memory at the spawn; without one,
each rank draws (``llama.init_params``) or loads (``loader.load_params``)
its own shard, and no rank holds the whole tree.

The pipe is the followers' way back too: a follower that fails sends its
traceback before it exits, and the leader's next collective fails at once
(gloo sees the closed connection) or after the group's timeout, with the
follower's traceback and exit code in its message. A follower whose
leader is gone sees the pipe close and exits.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import traceback
from typing import Any

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.parallel.collectives import (
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


def engine_ranks(ec: EngineConfig) -> int:
    """The processes of an engine: one a (data replica, stage, expert
    shard, model shard)."""
    return ec.dp * ec.pp * ec.ep * ec.tp


def tp_devices(ec: EngineConfig, device: str | torch.device | None) -> list[torch.device]:
    """Each world rank's device: every rank on the CPU for ``device="cpu"``
    (gloo only), else rank r on ``cuda:tp_devices[r]`` (default
    ``cuda:r``)."""
    dev = resolve_device(device)
    n_ranks = engine_ranks(ec)
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
                 params: dict | None):
        self._dir = tempfile.mkdtemp(prefix="dyn-tp-")
        self.init_method = "file://" + os.path.join(self._dir, "rendezvous")
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs: list = []
        self.conns: list = []
        try:
            for rank in range(1, engine_ranks(ec)):
                shard = None
                if params is not None:   # the rank's shard, through host memory
                    _, s, e, m = rank_coords(rank, ec.tp, ec.ep, ec.pp)
                    shard = _to(shard_params(params, cfg, m, ec.tp, e, ec.ep, s, ec.pp),
                                torch.device("cpu"))
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

    def report(self) -> str:
        """What the leader knows of each follower: its traceback if it sent
        one, its exit code if it exited (each is given a few seconds to)."""
        parts = []
        for rank, (proc, conn) in enumerate(zip(self.procs, self.conns), 1):
            proc.join(timeout=5.0)
            tb = None
            with contextlib.suppress(EOFError, OSError):
                while conn.poll():
                    msg = conn.recv()
                    if msg[0] == "error":
                        tb = msg[2]
            state = "alive" if proc.exitcode is None else f"exit code {proc.exitcode}"
            parts.append(f"follower rank {rank}: {state}"
                         + (f", traceback:\n{tb}" if tb else ""))
        return "; ".join(parts)

    def replies(self, kind: str) -> list:
        """One ``kind`` reply from each follower, in rank order."""
        out = []
        for rank, conn in enumerate(self.conns, 1):
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

    def stop(self) -> None:
        """Tell every follower to stop, join it (killing one that outlives
        ``JOIN_TIMEOUT_S``) and close the pipes."""
        for conn in self.conns:
            with contextlib.suppress(OSError):
                conn.send(("stop",))
        for rank, proc in enumerate(self.procs, 1):
            proc.join(timeout=JOIN_TIMEOUT_S)
            if proc.is_alive():
                log.warning("tensor-parallel follower rank %d did not stop: killing it", rank)
                proc.kill()
                proc.join(timeout=JOIN_TIMEOUT_S)
        for conn in self.conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)


def start_tp(ec: EngineConfig, cfg: ModelConfig, device: str | torch.device | None,
             params: dict | None) -> tuple[TPGroup, TPFollowers, dict | None]:
    """Start the followers of a ``dp`` x ``pp`` x ``ep`` x ``tp``-rank engine
    and join the group as its leader. Returns the leader's group, the
    followers' handle and the leader's shard of ``params`` (a full tree,
    or None to build them on every rank)."""
    check_tp(cfg, ec.tp, ec.ep)
    check_pp(cfg, ec.pp)
    devices = tp_devices(ec, device)
    followers = TPFollowers(ec, cfg, devices, params)
    try:
        group = init_tp_group(0, ec.tp, ec.dist_backend, followers.init_method, devices[0],
                              dp=ec.dp, ep=ec.ep, pp=ec.pp)
    except BaseException as exc:
        report = followers.report()
        followers.stop()
        raise TPFailure(f"the tensor-parallel group did not form: {exc}; {report}") from exc
    group.conns = followers.conns
    group.report = followers.report
    if params is not None:
        params = shard_params(params, cfg, 0, ec.tp, 0, ec.ep, 0, ec.pp)
    return group, followers, params


def follower_main(rank: int, ec: EngineConfig, cfg: ModelConfig, device: str,
                  init_method: str, params: dict | None, conn) -> None:
    """A follower process: join the group, build this rank's runner, and
    follow the leader until it posts ``stop`` (or its pipe closes)."""
    group = None
    try:
        dev = torch.device(device)
        group = init_tp_group(rank, ec.tp, ec.dist_backend, init_method, dev, dp=ec.dp,
                              ep=ec.ep, pp=ec.pp)
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
