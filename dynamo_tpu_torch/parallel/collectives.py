"""The ranks of a tensor-, expert-, sequence-, pipeline- and
data-parallel engine over ``torch.distributed``: their collectives and
the leader's control channel to its followers.

Everything the model needs across ranks is built from ``all_reduce``
and ``broadcast``, the two that gloo documents for CUDA tensors: the
partial products of ``wo`` and ``w_down`` are summed, a vocab-parallel
embedding row or logit slice is gathered by summing each rank's piece
written into a zeroed buffer (:meth:`TPGroup.gather_vocab`; no
``all_gather``), the int8 quantizer's per-channel abs-max over a
row-parallel shard is an ``all_reduce`` with ``MAX``
(:meth:`TPGroup.all_reduce_max`), and the leader's step inputs are
broadcast.

KV blocks move between the ranks and the leader's host memory with two
more (:meth:`TPGroup.gather_parts`, :meth:`TPGroup.broadcast_bytes`): a
rank's part of whole blocks (its kv heads, its stage's layers) written
into a zeroed buffer of whole blocks and summed into the leader's (a
reduce, byte for byte: each byte is one rank's plus zeros), and the
leader's blocks broadcast to every rank as bytes. On gloo these buffers
are CPU tensors.

Pipeline stages (JAX's "pipe" axis) pass activations point to point
(:meth:`TPGroup.send_stage`, :meth:`TPGroup.recv_stage`): a microbatch's
hidden from stage s to s + 1 (JAX's ``ppermute``), and the last stage's
hidden to stage 0, which samples (JAX's ``psum`` over "pipe", whose other
terms are zeros). Seq ranks (its "seq" axis) pass their K/V chunks round
the ring of a ring prefill step the same way (:meth:`TPGroup.ring_pass`:
both directions posted as one batch, ``batch_isend_irecv``, before
either is waited for). gloo's point-to-point ops take CPU tensors only, so on gloo a
card's tensor goes through host memory; nccl takes it as it is.

Over nccl (one card a rank) a step's collectives run on the card
asynchronously, and a CUDA graph can hold them: the group's communicators
are formed by one eager all-reduce each as the group forms
(:func:`init_tp_group`), since NCCL makes a communicator at a group's
first collective and cannot inside a capture. Whether a step program is
captured is engine/engine.py's ``step_graphs``: at more than one rank
not yet (ROADMAP item 14f). gloo reduces CUDA tensors through host
memory, which a graph cannot hold, and every gloo collective blocks the
calling thread until it is done. The group counts the eager collectives
and the host seconds they took (``collectives``, ``collective_s``), the
block moves apart, and the collectives its programs' graph replays ran
(``graph_collectives``: a capture's collectives, added at each replay).

Data parallelism (JAX's "data" mesh axis), pipeline parallelism (its
"pipe" axis), sequence parallelism (its "seq" axis) and expert
parallelism (its "expert" axis) multiply the ranks: an engine of ``dp`` x
``pp`` x ``sp`` x ``ep`` x ``tp`` ranks, world rank
``(((d*pp + s)*sp + q)*ep + e)*tp + m`` holding model shard ``m`` of
expert shard ``e`` of seq rank ``q`` of stage ``s`` of data replica ``d``
(:func:`rank_coords`, JAX's axis order; at pp = sp = ep = 1 this is
``d*tp + m``; pp composes with dp only, as in JAX, so at pp > 1 it is
``d*pp + s``). Five kinds of group:

- the *model group* (``rank``, ``size``, ``pg``: the ``tp`` ranks of one
  (d, q, e)): the attention's ``wo`` sum, the vocab-parallel embedding and
  logits, the int8 quantizer's row-parallel abs-max, the head gathers of
  block moves. Attention is replicated over "expert", as in JAX: the
  expert ranks of one model shard compute the same heads on the same
  rows and hold the same cache;
- the *MoE group* (``moe_pg``: the ``tp`` x ``ep`` ranks of one (d, q)):
  one f32 sum per MoE layer completes both the expert combine and the
  TEP contraction of the per-expert width (:meth:`all_reduce_moe`; at
  ep = 1 it is the model group). Each seq rank's group has its own
  tokens in a ring step;
- the *data group* (``data_pg``: the ``dp`` ranks holding shard (q, e,
  m)): the attention rows a replica computed (:meth:`TPGroup.gather_rows`);
- the *seq group* (``seq_pg``: the ``sp`` ranks of one (d, e, m)): the
  ring of a ring prefill step, where each holds a chunk of the prompt's
  positions and the K/V chunks rotate (:meth:`TPGroup.ring_pass`, JAX's
  ``ppermute``: point to point, through host memory on gloo), and the
  last-token rows brought together (:meth:`TPGroup.sum_seq`). Params and
  cache are replicated over it, as JAX replicates them over "seq": every
  step that does not ring runs on every seq rank as on one rank;
- the *block group* (``block_pg``: the ``pp`` x ``tp`` ranks of one
  (d, e); at pp = 1 the model group): the parts of whole blocks summed
  into the leader's (:meth:`TPGroup.gather_parts`).

The step inputs the leader broadcasts reach the whole world. The world is
the process's default ``torch.distributed`` group: one engine a process.
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
    """One rank's membership of an engine's ranks: ``rank`` of ``size`` in
    its model group (what the attention shards by), expert shard
    ``expert_rank`` of ``ep``, seq rank ``seq_rank`` of ``sp``, pipeline
    stage ``stage`` of ``pp``, replica ``data_rank`` of ``dp``,
    ``world_rank`` of ``world_size`` in all."""

    rank: int
    size: int
    device: torch.device
    backend: str
    pg: Any                                  # the model group's ProcessGroup
    #: the control channel: the leader's connections to world ranks
    #: 1..world_size-1, or a follower's one connection to the leader
    conns: list = field(default_factory=list)
    #: the leader's description of its followers' state, for failures
    report: Callable[[], str] | None = None
    dp: int = 1
    data_rank: int = 0
    data_pg: Any = None                      # this shard's data group (dp > 1)
    world_pg: Any = None                     # every rank (None: the model group)
    ep: int = 1
    expert_rank: int = 0
    moe_pg: Any = None                       # this replica's MoE group (None: the model group)
    pp: int = 1
    stage: int = 0
    block_pg: Any = None                     # this (d, e)'s block group (None: the model group)
    sp: int = 1
    seq_rank: int = 0
    seq_pg: Any = None                       # this (d, e, m)'s seq group (sp > 1)
    #: seconds a collective may wait for a peer, and a step's device work
    #: for the ranks (engine/tp.wait_event)
    timeout: float = DEFAULT_TIMEOUT_S
    #: the leader's liveness probe of its followers (engine/tp.py): None
    #: while every follower lives, else a message naming the one gone
    probe: Callable[[], str | None] | None = None
    collectives: int = 0
    collective_s: float = 0.0
    #: the collectives inside graph replays: each replay adds its capture's
    graph_collectives: int = 0
    #: block moves (gather_parts, broadcast_bytes): calls, bytes, host seconds
    block_moves: int = 0
    block_bytes: int = 0
    block_s: float = 0.0
    #: microbatches this pipeline stage ran through its layers
    microbatches: int = 0
    #: ring hops (ring_pass; counted with the collectives too): calls,
    #: bytes sent, host seconds
    ring_hops: int = 0
    ring_bytes: int = 0
    ring_s: float = 0.0

    @property
    def world_size(self) -> int:
        return self.size * self.ep * self.sp * self.pp * self.dp

    def _rank_at(self, stage: int, seq: int) -> int:
        return ((((self.data_rank * self.pp + stage) * self.sp + seq) * self.ep
                 + self.expert_rank) * self.size + self.rank)

    def stage_rank(self, stage: int) -> int:
        """The world rank of stage ``stage`` at this rank's other
        coordinates."""
        return self._rank_at(stage, self.seq_rank)

    def seq_peer(self, seq: int) -> int:
        """The world rank of seq rank ``seq`` (mod ``sp``) at this rank's
        other coordinates."""
        return self._rank_at(self.stage, seq % self.sp)

    @property
    def world_rank(self) -> int:
        return self.stage_rank(self.stage)

    @property
    def moe_size(self) -> int:
        """The ranks of the MoE group: tp x ep."""
        return self.size * self.ep

    @property
    def leader(self) -> bool:
        return self.world_rank == 0

    @property
    def _world(self):
        return self.world_pg if self.world_pg is not None else self.pg

    def _failed(self, exc: BaseException) -> TPFailure:
        what = (f"rank {self.world_rank} of an engine of {self.world_size} ranks "
                f"(tp={self.size}, ep={self.ep}, sp={self.sp}, pp={self.pp}, dp={self.dp}): "
                f"{exc}")
        if self.report is not None:
            what += "; " + self.report()
        return TPFailure(what)

    def _run(self, fn, x: torch.Tensor, group=None, block: bool = False, **kw) -> None:
        t0 = time.perf_counter()
        try:
            fn(x, group=self.pg if group is None else group, **kw)
        except RuntimeError as exc:
            raise self._failed(exc) from exc
        finally:
            dt = time.perf_counter() - t0
            if block:
                self.block_moves += 1
                self.block_bytes += x.numel() * x.element_size()
                self.block_s += dt
            else:
                self.collectives += 1
                self.collective_s += dt

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` (contiguous) over the model group, in place; returns
        it."""
        if self.size > 1:
            self._run(dist.all_reduce, x, op=dist.ReduceOp.SUM)
        return x

    def all_reduce_moe(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` (contiguous) over the MoE group (the tp x ep ranks of
        this data replica), in place; returns it."""
        if self.moe_size > 1:
            self._run(dist.all_reduce, x,
                      group=self.moe_pg if self.moe_pg is not None else self.pg,
                      op=dist.ReduceOp.SUM)
        return x

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The leader's ``x`` (contiguous) into every rank's, in place (a
        bool tensor travels as its bytes)."""
        self._run(dist.broadcast, x.view(torch.uint8) if x.dtype == torch.bool else x,
                  group=self._world, src=0)
        return x

    def gather_rows(self, local: torch.Tensor, rows: int) -> torch.Tensor:
        """The full [rows, ...] tensor from each data replica's [rows/dp,
        ...] piece (replica d's rows ``[d rows/dp, (d+1) rows/dp)``): the
        pieces written into a zeroed buffer and summed over the data
        group, each element one replica's value plus zeros."""
        per = local.shape[0]
        full = local.new_zeros((rows, *local.shape[1:]))
        full[self.data_rank * per: (self.data_rank + 1) * per] = local
        self._run(dist.all_reduce, full, group=self.data_pg, op=dist.ReduceOp.SUM)
        return full

    @property
    def block_device(self) -> torch.device:
        """Where block moves stage their buffers: host memory on gloo, the
        rank's card on nccl."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def gather_parts(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum the ``buf`` of every rank of the block group (uint8 bytes of
        whole blocks, zeros outside the rank's own heads and layers) into
        the leader's, in place: the leader's is then every head's and
        every layer's bytes (a reduce to the leader, in replica 0)."""
        if self.size * self.pp > 1:
            self._run(dist.reduce, buf, group=self.block_pg, block=True,
                      op=dist.ReduceOp.SUM, dst=0)
        return buf

    def send_stage(self, x: torch.Tensor, stage: int) -> None:
        """Send ``x`` to stage ``stage`` of this replica (its bytes, through
        host memory on gloo)."""
        buf = x.contiguous().view(torch.uint8)
        if buf.device != self.block_device:
            buf = buf.to(self.block_device)
        self._run(dist.send, buf, group=self._world, dst=self.stage_rank(stage))

    def recv_stage(self, shape: tuple, dtype: torch.dtype, stage: int) -> torch.Tensor:
        """The ``shape`` x ``dtype`` tensor stage ``stage`` of this replica
        sends, on this rank's device."""
        n = int(torch.Size(shape).numel()) * torch.empty((), dtype=dtype).element_size()
        buf = torch.empty(n, dtype=torch.uint8, device=self.block_device)
        self._run(dist.recv, buf, group=self._world, src=self.stage_rank(stage))
        return buf.to(self.device).view(dtype).reshape(shape)

    def ring_pass(self, x: torch.Tensor) -> torch.Tensor:
        """One hop of the seq ring (JAX's ``ppermute`` of ring attention):
        send ``x`` to seq rank ``q + 1`` and return what seq rank ``q - 1``
        sent, a tensor of ``x``'s shape and dtype on this rank's device.
        Both directions are posted as one batch before either is waited
        for (``batch_isend_irecv``: one NCCL group, as NCCL asks of a send
        and a receive between the same two ranks), so the ring cannot
        deadlock; on gloo the bytes go through host memory."""
        out = x.contiguous().view(torch.uint8).reshape(-1)
        if out.device != self.block_device:
            out = out.to(self.block_device)
        into = torch.empty_like(out)
        t0 = time.perf_counter()
        try:
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out, self.seq_peer(self.seq_rank + 1), self._world),
                dist.P2POp(dist.irecv, into, self.seq_peer(self.seq_rank - 1), self._world)])
            for req in reqs:
                req.wait()
        except RuntimeError as exc:
            raise self._failed(exc) from exc
        finally:
            dt = time.perf_counter() - t0
            self.collectives += 1
            self.collective_s += dt
            self.ring_hops += 1
            self.ring_bytes += out.numel()
            self.ring_s += dt
        return into.to(self.device).view(x.dtype).reshape(x.shape)

    def sum_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` (contiguous) over the seq group, in place; returns it."""
        if self.sp > 1:
            self._run(dist.all_reduce, x, group=self.seq_pg, op=dist.ReduceOp.SUM)
        return x

    def broadcast_bytes(self, buf: torch.Tensor) -> torch.Tensor:
        """The leader's ``buf`` (uint8 bytes) into every rank's, in place."""
        self._run(dist.broadcast, buf, group=self._world, block=True, src=0)
        return buf

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
        """The least of every rank's ``n``, over the world (each rank
        writes its own into a zeroed vector, summed)."""
        v = torch.zeros(self.world_size, dtype=torch.int64, device=self.device)
        v[self.world_rank] = n
        self._run(dist.all_reduce, v, group=self._world, op=dist.ReduceOp.SUM)
        return int(v.min())

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

    def step_counts(self) -> tuple:
        """The counters a step program's body moves (collectives and
        their host seconds, microbatches, ring hops), to be put back with
        :meth:`restore_step_counts` after a warm run or a capture."""
        return (self.collectives, self.collective_s, self.microbatches,
                self.ring_hops, self.ring_bytes, self.ring_s)

    def restore_step_counts(self, counts: tuple) -> None:
        (self.collectives, self.collective_s, self.microbatches,
         self.ring_hops, self.ring_bytes, self.ring_s) = counts

    def reset_stats(self) -> None:
        self.collectives, self.collective_s, self.graph_collectives = 0, 0.0, 0
        self.block_moves, self.block_bytes, self.block_s = 0, 0, 0.0
        self.microbatches = 0
        self.ring_hops, self.ring_bytes, self.ring_s = 0, 0, 0.0

    def close(self) -> None:
        """Leave the group (destroys the process's default group)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_coords(world_rank: int, tp: int, ep: int = 1, pp: int = 1,
                sp: int = 1) -> tuple[int, int, int, int, int]:
    """(data replica d, stage s, seq rank q, expert shard e, model shard m)
    of a world rank, ``world_rank = (((d*pp + s)*sp + q)*ep + e)*tp + m``."""
    rest, m = divmod(world_rank, tp)
    rest, e = divmod(rest, ep)
    rest, q = divmod(rest, sp)
    d, s = divmod(rest, pp)
    return d, s, q, e, m


def init_tp_group(rank: int, size: int, backend: str, init_method: str,
                  device: torch.device, timeout: float = DEFAULT_TIMEOUT_S,
                  dp: int = 1, ep: int = 1, pp: int = 1, sp: int = 1) -> TPGroup:
    """Join an engine of ``dp`` x ``pp`` x ``sp`` x ``ep`` x ``size`` ranks
    as world rank ``rank`` (coordinates :func:`rank_coords`), on ``device``
    (set as the process's current card first), through ``init_method``
    (``file://`` or ``tcp://host:port``). nccl needs a card a rank; gloo
    takes CPU and CUDA tensors. Every rank makes every model, MoE, data,
    seq and block group that is not the whole world, in one order
    (``new_group`` is collective)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown dist backend {backend!r} (supported: {', '.join(BACKENDS)})")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device a rank, got {device}")
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a torch.distributed group: "
                           "one tensor-parallel engine a process")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    td = datetime.timedelta(seconds=timeout)
    world = size * ep * sp * pp * dp
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=td)
    d, s, q, e, m = rank_coords(rank, size, ep, pp, sp)

    def at(r, st, y, x, i):
        return (((r * pp + st) * sp + y) * ep + x) * size + i

    def group(ranks: list[int]):
        return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks, timeout=td)

    cells = [(r, st, y) for r in range(dp) for st in range(pp) for y in range(sp)]
    models = {(r, st, y, x): group([at(r, st, y, x, i) for i in range(size)])
              for r, st, y in cells for x in range(ep)}
    moes = {(r, st, y): group([at(r, st, y, x, i) for x in range(ep) for i in range(size)])
            for r, st, y in cells}
    datas = {(st, y, x, i): group([at(r, st, y, x, i) for r in range(dp)])
             for st in range(pp) for y in range(sp) for x in range(ep)
             for i in range(size)} if dp > 1 else {}
    seqs = {(r, st, x, i): group([at(r, st, y, x, i) for y in range(sp)])
            for r in range(dp) for st in range(pp) for x in range(ep)
            for i in range(size)} if sp > 1 else {}
    blocks = {(r, x): group([at(r, st, 0, x, i) for st in range(pp) for i in range(size)])
              for r in range(dp) for x in range(ep)} if pp > 1 else {}
    g = TPGroup(rank=m, size=size, device=device, backend=backend, pg=models[d, s, q, e],
                dp=dp, data_rank=d, data_pg=datas.get((s, q, e, m)),
                world_pg=dist.group.WORLD, ep=ep, expert_rank=e, moe_pg=moes[d, s, q],
                pp=pp, stage=s, block_pg=blocks.get((d, e)),
                sp=sp, seq_rank=q, seq_pg=seqs.get((d, s, e, m)), timeout=timeout)
    if backend == "nccl":
        # NCCL makes a group's communicator at its first collective, which
        # a CUDA graph's capture cannot hold: one all-reduce over each group
        # of this rank now, while the ranks are in lockstep. Every rank
        # takes the kinds in one order (each kind partitions the ranks), so
        # no rank waits on a group its peers reach later. Not counted.
        x = torch.zeros(1, device=device)
        for pg in (g.world_pg, g.pg, g.moe_pg, g.data_pg, g.seq_pg, g.block_pg):
            if pg is not None:
                dist.all_reduce(x, group=pg)
    return g
