"""KVBM for engines over several nodes: rank-local tiers — port of
``dynamo_tpu/kvbm/distributed.py``.

The JAX package's multi-host engine replays one op stream on every host,
so every process's offload manager makes the same decisions; each process
extracts and injects only its ADDRESSABLE shard of the cache and keeps its
own host/disk tier of shard-slices. The union of the ranks' tiers is the
block store, and no block crosses a host.

The port keeps that data layout under its single controller
(engine/tp.py): the leader's ``OffloadManager`` decides, and posts each
rank's half in step order, so every rank's tier cascade sees the same
puts and lookups as the leader's:

- a rank's *box* (:func:`local_box`) is its stage's layers × its model
  shard's kv heads of the global cache; replicas over data, seq and expert
  each hold a copy, as JAX's processes do;
- its tiers hold that box a block (:func:`local_block_spec`, with JAX's
  fingerprint ``shard(L{a}:{b},H{c}:{d})``), the disk tier under
  ``rank{world rank}`` (with one rank a node, JAX's ``rank{process}``);
- the leader's :class:`ShardedBlockTransferEngine` extracts and injects
  its own box and posts ``kv_extract`` / ``kv_inject`` to every rank
  (quantized caches move packed int8/int4 boxes; a block of another kind
  converts at the inject boundary, :func:`~dynamo_tpu_torch.kvbm.transfer.prepare_inject`);
- :class:`TierMirror` posts the manager's tier puts (``kv_store``) and
  lookups (``kv_lookup``, voted down to the engine-wide minimum when a
  tier can answer differently on different ranks: the shared remote store,
  a disk tier a restart may have purged);
- :class:`RankBlocks` is a follower's half: its tiers, the blocks it
  extracted and the ones it is about to inject, and on a prefill engine
  its staging store and shard server (disagg/sharded.py), on a decode
  engine its pulls.

No block crosses a node on offload or onboard: the leader's extract
gathers nothing (its group's ``block_moves`` stay 0).
"""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path

import numpy as np

from dynamo_tpu_torch.disagg.sharded import Box
from dynamo_tpu_torch.engine.cache import KVCacheSpec
from dynamo_tpu_torch.kvbm.transfer import BlockTransferEngine
from dynamo_tpu_torch.parallel.multihost import vote_min
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("kvbm.distributed")

#: a vote of a rank that does not constrain it (a replica that stages nothing)
NO_LIMIT = 1 << 62


def local_box(group, num_layers: int, num_kv_heads: int) -> Box:
    """The (layer, kv head) extents of the global cache that ``group``'s
    rank holds: its stage's layers ``[s L/pp, (s+1) L/pp)`` and its model
    shard's heads ``[m KH/tp, (m+1) KH/tp)``."""
    per_l, per_h = num_layers // group.pp, num_kv_heads // group.size
    return (group.stage * per_l, (group.stage + 1) * per_l,
            group.rank * per_h, (group.rank + 1) * per_h)


def local_block_spec(spec: KVCacheSpec, box: Box) -> tuple[KVCacheSpec, str]:
    """A rank's tier geometry and shard fingerprint: ``spec`` (the whole
    cache's) cut to ``box``'s layers and kv heads, so tier arenas size to
    the shard stored (``kv_dtype`` carries through: a quantized engine's
    tiers hold packed shards); the fingerprint pins the box, so a disk tier
    written for one shard of one topology is never read by another."""
    l0, l1, h0, h1 = box
    local = dataclasses.replace(spec, num_layers=l1 - l0, num_kv_heads=h1 - h0)
    return local, f"shard(L{l0}:{l1},H{h0}:{h1})"


def build_tiers(spec: KVCacheSpec, ec, fingerprint: str, disk_path: str | None
                ) -> tuple[list, object]:
    """The tier cascade host → disk → remote over blocks of ``spec`` (each
    tier spills its LRU victims to the next, lookups walk the chain
    top-down). Returns the tiers and the remote one (or None)."""
    from dynamo_tpu_torch.kvbm.pools import DiskBlockPool, HostBlockPool

    remote = None
    if ec.remote_kv_addr:
        from dynamo_tpu_torch.kvbm.remote import RemoteBlockPool

        remote = RemoteBlockPool(spec, ec.remote_kv_addr, fingerprint=fingerprint)
    disk = (DiskBlockPool(spec, disk_path, ec.disk_kv_bytes, fingerprint=fingerprint,
                          overflow=remote)
            if disk_path else None)
    tiers: list = []
    if ec.host_kv_blocks > 0:
        # (``disk or remote`` would skip an empty disk tier: a pool with no
        # blocks has len 0)
        spill = disk if disk is not None else remote
        tiers.append(HostBlockPool(spec, ec.host_kv_blocks, overflow=spill))
    tiers += [t for t in (disk, remote) if t is not None]
    return tiers, remote


def rank_disk_path(path: str | None, world_rank: int) -> str | None:
    """A rank's disk tier directory: ``rank{k}`` under the configured one,
    so ranks that share a filesystem never share a MANIFEST or a file."""
    return str(Path(path) / f"rank{world_rank}") if path else None


class ShardedBlockTransferEngine(BlockTransferEngine):
    """The leader's block mover over a cache spread over nodes: it moves its
    own box, and posts the same move to every other rank, which moves its
    own (:class:`RankBlocks`)."""

    def __init__(self, group) -> None:
        super().__init__()
        self.group = group

    def extract(self, cache_k, cache_v, ids: list[int], dequant: bool = False,
                span_attrs: dict | None = None, serve: bool = False) -> list[np.ndarray]:
        """This rank's box of blocks ``ids``; every rank extracts its own
        (``serve``: only the ranks that serve staged transfers)."""
        self.group.post("kv_extract", list(ids), dequant, serve)
        return super().extract(cache_k, cache_v, ids, dequant, span_attrs)

    def inject(self, cache_k, cache_v, ids: list[int], blocks: list[np.ndarray],
               span_attrs: dict | None = None) -> None:
        """Write this rank's ``blocks`` (its box) at ``ids``; every other
        rank writes the blocks its last ``kv_lookup`` / ``kv_load_pull``
        found."""
        self.group.post("kv_inject", list(ids))
        super().inject(cache_k, cache_v, ids, blocks, span_attrs)


class TierMirror:
    """The leader's side of the rank-local tiers: the offload manager's
    tier puts and lookups, posted so every rank makes them on its own."""

    def __init__(self, group, tiers: list) -> None:
        self.group = group
        self.tiers = tiers

    def store(self, pairs: list[tuple[object, int]]) -> None:
        """Each rank puts the blocks of its last extract, in order, into
        ``(tier, hash)``'s tier of its cascade."""
        if pairs:
            self.group.post("kv_store", [(self.tiers.index(t), int(h)) for t, h in pairs])

    def lookup(self, hashes: list[int], n: int, vote: bool) -> int:
        """Each rank looks ``hashes`` up in its cascade (the leader's walk,
        hit or miss, in order) and keeps the first ``n`` for the coming
        inject; with ``vote`` the plan shrinks to the least count of
        leading hits over every rank. Returns the plan's length."""
        self.group.post("kv_lookup", [int(h) for h in hashes], n, vote)
        return vote_min(n, self.group) if vote else n


class RankBlocks:
    """A follower rank's half of the block moves of an engine over several
    nodes: its tier cascade (its box of each block), the blocks of its last
    extract (``out``) and the ones its next inject writes (``load``), its
    staged transfers and shard server, its pulls. ``handle`` runs one of the
    leader's ``kv_*`` posts."""

    def __init__(self, runner) -> None:
        ec, cfg, group = runner.engine_cfg, runner.cfg, runner.tp
        self.runner = runner
        self.group = group
        self.box = local_box(group, cfg.num_layers, cfg.num_kv_heads)
        self.spec = runner.spec
        _, shard_fp = local_block_spec(runner.block_spec, self.box)
        self.fingerprint = f"{ec.model}|{shard_fp}"
        self.tiers, _ = (build_tiers(self.spec, ec, self.fingerprint,
                                     rank_disk_path(ec.disk_kv_path, group.world_rank))
                         if ec.host_kv_blocks > 0 or ec.disk_kv_path or ec.remote_kv_addr
                         else ([], None))
        #: replica 0's ranks (data, seq and expert 0) stage and serve their box
        self.serves = group.data_rank == 0 and group.seq_rank == 0 and group.expert_rank == 0
        self.mover = BlockTransferEngine()
        self.out: list[np.ndarray] | str | None = None
        self.load: list | None = None
        self._staging = None
        self._staged: dict[str, int] = {}
        self._server = None
        self._pulls: dict[tuple, dict] = {}
        self._clients: dict[str, dict] = {}
        runner.tiers = self.tiers

    # -- the ops ---------------------------------------------------------
    def handle(self, op: str, args: tuple) -> None:
        getattr(self, "_" + op)(*args)

    def _kv_extract(self, ids, dequant: bool, serve: bool) -> None:
        if serve and not self.serves:
            self.out = "skip"
            return
        r = self.runner
        try:
            self.out = self.mover.extract(r.cache_k, r.cache_v, list(ids), dequant)
        except Exception:  # noqa: BLE001 — the vote (or the next op) handles it
            log.exception("rank %d: extract failed", self.group.world_rank)
            self.out = None

    def _kv_store(self, pairs) -> None:
        if not isinstance(self.out, list) or len(self.out) < len(pairs):
            raise RuntimeError(f"rank {self.group.world_rank}: no extracted blocks for "
                               f"{len(pairs)} tier puts")
        for (tier, h), block in zip(pairs, self.out):
            self.tiers[tier].put(h, block)
        self.out = None

    def _lookup(self, h: int):
        """The leader's ``OffloadManager._lookup`` on this rank's cascade."""
        for tier in self.tiers:
            block = tier.get(h)
            if block is not None:
                return block
        return None

    def _kv_lookup(self, hashes, n: int, vote: bool) -> None:
        found = [self._lookup(h) for h in hashes]
        if vote:
            lead = next((i for i, b in enumerate(found) if b is None), len(found))
            n = self.group.agree_min(min(n, lead))
        self.load = found[:n]

    def _kv_inject(self, ids) -> None:
        load, self.load = self.load, None
        if load is None or len(load) != len(ids) or any(b is None for b in load):
            raise RuntimeError(
                f"rank {self.group.world_rank}: {len(ids)} blocks to inject, "
                f"{'none' if load is None else sum(b is not None for b in load)} found")
        r = self.runner
        self.mover.inject(r.cache_k, r.cache_v, list(ids), load)

    def _kv_vote(self, kind: str, arg) -> None:
        if kind == "out":     # an extract's blocks (arg: how many the leader asked)
            local = (arg if self.out == "skip"
                     else arg if isinstance(self.out, list) and len(self.out) == arg else 0)
            self.group.agree_min(local)
        elif kind == "staged":    # a streamed transfer's staged prefix, then its close
            xfer = arg
            local = self._staged.get(xfer, 0) if self.serves else NO_LIMIT
            covered = self.group.agree_min(local)
            if self.serves and xfer in self._staged:
                self._staged.pop(xfer)
                self.staging.finalize(xfer, covered)
        elif kind == "pulled":    # a pull's fetch (arg: its key)
            slot = self._pulls.get(tuple(arg))
            if slot is not None:
                slot["thread"].join()
            self.group.agree_min(1 if slot is not None and slot["result"] is not None else 0)
        else:
            raise ValueError(f"unknown vote {kind!r}")

    # -- staging (a prefill engine's transfers) ---------------------------
    @property
    def staging(self):
        if self._staging is None:
            from dynamo_tpu_torch.disagg.sharded import StagingStore

            self._staging = StagingStore()
        return self._staging

    def start_shard_server(self, advertise_host: str) -> str:
        if self._server is None:
            from dynamo_tpu_torch.disagg.sharded import ShardServer

            self._server = ShardServer(self.staging)
        return f"{advertise_host}:{self._server.port}"

    def _kv_stage_fill(self, xfer: str, hashes, parents, n: int) -> None:
        out, self.out = self.out, None
        if self.serves and n and isinstance(out, list):
            self.staging.fill(xfer, list(hashes), list(parents), np.stack(out[:n]), self.box)

    def _kv_stage_begin(self, xfer: str, hashes, parents) -> None:
        if self.serves:
            self.staging.begin(xfer, list(hashes), list(parents), self.box, self.spec.dtype)
            self._staged[xfer] = 0

    def _kv_stage_append(self, xfer: str, start: int, stop: int) -> None:
        out, self.out = self.out, None
        if (self.serves and self._staged.get(xfer) == start and isinstance(out, list)
                and self.staging.append(xfer, start, np.stack(out))):
            self._staged[xfer] = stop

    def _kv_unstage(self, xfer: str) -> None:
        self._staged.pop(xfer, None)
        if self._staging is not None:
            self._staging.drop(xfer)

    # -- pulls (a decode engine's imports) --------------------------------
    def _kv_pull(self, params: dict, start, stop) -> None:
        """Start fetching this rank's box of a window of a transfer on a
        thread (one thread lineage a transfer, as the leader's)."""
        from dynamo_tpu_torch.disagg.sharded import fetch_box

        xfer = params["xfer_id"]
        key = (xfer, start, stop)
        prev = self._clients.setdefault(xfer, {"clients": {}, "last": None})
        last = prev["last"]
        slot: dict = {}
        spec = self.spec

        def run() -> None:
            if last is not None:
                last["thread"].join()
            slot["result"] = fetch_box(params, self.box, spec.block_size, spec.head_dim,
                                       spec.dtype, start, stop, prev["clients"])

        t = threading.Thread(target=run, name="kv-prefetch", daemon=True)
        slot["thread"] = t
        self._pulls[key] = slot
        prev["last"] = slot
        t.start()

    def _kv_load_pull(self, key, hashes) -> None:
        slot = self._pulls.pop(tuple(key), None)
        result = slot["result"] if slot is not None else None
        if result is None:
            self.load = None
            return
        by_hash = {h: result[2][i] for i, h in enumerate(result[0])}
        self.load = [by_hash.get(h) for h in hashes]

    def _kv_pull_close(self, xfer: str) -> None:
        state = self._clients.pop(xfer, None)
        for key in [k for k in self._pulls if k[0] == xfer]:
            self._pulls.pop(key)
        if state is None:
            return
        for client in state["clients"].values():
            client.close()
        last = state["last"]
        if last is not None and last["thread"].is_alive():
            last["thread"].join(timeout=5.0)

    # -- lifetime ----------------------------------------------------------
    def occupancy(self) -> dict:
        """Each tier's (blocks, bytes) on this rank."""
        return {t.name: list(t.occupancy()) for t in self.tiers}

    def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.close()
        for xfer in list(self._clients):
            self._kv_pull_close(xfer)
