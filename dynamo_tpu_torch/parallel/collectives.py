"""A tensor-parallel group over ``torch.distributed``: its two collectives
and the leader's control channel to its followers.

Everything the model needs across ranks is built from ``all_reduce``
and ``broadcast``, the two that gloo documents for CUDA tensors: the
partial products of ``wo`` and ``w_down`` are summed, a vocab-parallel
embedding row or logit slice is gathered by summing each rank's piece
written into a zeroed buffer (:meth:`TPGroup.gather_vocab`; no
``all_gather``), the int8 quantizer's per-channel abs-max over a
row-parallel shard is an ``all_reduce`` with ``MAX``
(:meth:`TPGroup.all_reduce_max`), and the leader's step inputs are
broadcast.

gloo reduces CUDA tensors through host memory, so its collectives cannot
be captured in a CUDA graph: a tensor-parallel engine runs eager steps.
Every collective blocks the calling thread until it is done; the group
counts them and the host seconds they took.

The group is the process's default ``torch.distributed`` group: one
tensor-parallel engine a process.
"""

from __future__ import annotations

import datetime
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")

#: seconds a collective (and the group's rendezvous) may wait for a peer
#: before it fails, so that a rank that diverges fails the run instead of
#: hanging it
DEFAULT_TIMEOUT_S = 60.0


class TPFailure(RuntimeError):
    """A collective or the control channel failed: a peer died, hung past
    the timeout or left the protocol. The message carries what the leader
    knows of its followers (exit codes, tracebacks)."""


@dataclass
class TPGroup:
    """One rank's membership of a tensor-parallel group."""

    rank: int
    size: int
    device: torch.device
    backend: str
    pg: Any                                  # the torch.distributed ProcessGroup
    #: the control channel: the leader's connections to ranks 1..size-1,
    #: or a follower's one connection to the leader
    conns: list = field(default_factory=list)
    #: the leader's description of its followers' state, for failures
    report: Callable[[], str] | None = None
    collectives: int = 0
    collective_s: float = 0.0

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def _failed(self, exc: BaseException) -> TPFailure:
        what = f"rank {self.rank} of a tensor-parallel group of {self.size}: {exc}"
        if self.report is not None:
            what += "; " + self.report()
        return TPFailure(what)

    def _run(self, fn, x: torch.Tensor, **kw) -> None:
        t0 = time.perf_counter()
        try:
            fn(x, group=self.pg, **kw)
        except RuntimeError as exc:
            raise self._failed(exc) from exc
        finally:
            self.collectives += 1
            self.collective_s += time.perf_counter() - t0

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` (contiguous) over the ranks, in place; returns it."""
        self._run(dist.all_reduce, x, op=dist.ReduceOp.SUM)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` (contiguous) into every rank's, in place (a
        bool tensor travels as its bytes)."""
        self._run(dist.broadcast, x.view(torch.uint8) if x.dtype == torch.bool else x,
                  src=src)
        return x

    def gather_vocab(self, local: torch.Tensor, vocab: int) -> torch.Tensor:
        """The full [..., vocab] tensor from each rank's [..., per] piece of
        a vocab-parallel result (the last piece zero-padded past
        ``vocab``): the pieces written into a zeroed buffer and summed, so
        every element is one rank's value plus zeros, bit for bit."""
        per = local.shape[-1]
        full = local.new_zeros((*local.shape[:-1], per * self.size))
        full[..., self.rank * per: (self.rank + 1) * per] = local
        return self.all_reduce_sum(full)[..., :vocab]

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's ``x``, in a new tensor."""
        out = x.contiguous().clone()
        self._run(dist.all_reduce, out, op=dist.ReduceOp.MAX)
        return out

    def agree_min(self, n: int) -> int:
        """The least of every rank's ``n`` (each rank writes its own into a
        zeroed vector, summed)."""
        v = torch.zeros(self.size, dtype=torch.int64, device=self.device)
        v[self.rank] = n
        return int(self.all_reduce_sum(v).min())

    # -- control channel (host messages, no collective) -------------------
    def post(self, *msg) -> None:
        """Leader: send ``msg`` to every follower."""
        try:
            for c in self.conns:
                c.send(msg)
        except OSError as exc:
            raise self._failed(exc) from exc

    def recv(self) -> tuple:
        """Follower: the leader's next message (blocks; EOF when the leader
        is gone)."""
        return self.conns[0].recv()

    def reply(self, *msg) -> None:
        """Follower: send ``msg`` to the leader."""
        self.conns[0].send(msg)

    def reset_stats(self) -> None:
        self.collectives, self.collective_s = 0, 0.0

    def close(self) -> None:
        """Leave the group (destroys the process's default group)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def init_tp_group(rank: int, size: int, backend: str, init_method: str,
                  device: torch.device, timeout: float = DEFAULT_TIMEOUT_S) -> TPGroup:
    """Join a tensor-parallel group of ``size`` ranks as ``rank``, on
    ``device`` (set as the process's current card first), through
    ``init_method`` (``file://`` or ``tcp://host:port``). nccl needs a
    card a rank; gloo takes CPU and CUDA tensors."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown dist backend {backend!r} (supported: {', '.join(BACKENDS)})")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device a rank, got {device}")
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a torch.distributed group: "
                           "one tensor-parallel engine a process")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return TPGroup(rank=rank, size=size, device=device, backend=backend,
                   pg=dist.group.WORLD)
