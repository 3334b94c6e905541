"""Prefill-side KV transfer source: stage, advertise, expire — copy of
``dynamo_tpu/disagg/source.py``.

Registering a transfer is one ``kv_stage`` core op: the prefill engine pins
the chain's blocks in its pool and copies them to host staging
(``EngineCore.stage_export``), where its shard server (disagg/sharded.py)
serves box-sliced pulls. The transfer params advertise the shard list, so
a decode engine assembles its own box from it.

Streamed transfers (``register_streaming``) flip the order: the transfer is
registered ONCE up front with the full expected hash chain, then the
engine's step loop stages each committed prefill chunk as a wave
(``kv_stage_wave``) while later chunks are still computing; wave
completions are announced to the PrefillHandler so the decode side can
pull blocks that exist before the prompt is done.

Transfers expire after a TTL measured from their last progress (stream
registration, wave landing, or stream end), so an aborted decode — or a
prefill that dies mid-stream — can't leak pinned device blocks.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("disagg")


@dataclass
class _Transfer:
    seq_hashes: list[int]     # covered chain prefix (staged + pinned)
    deadline: float


class KvTransferSource:
    def __init__(self, engine: AsyncTorchEngine, ttl_s: float = 60.0,
                 advertise_host: str = "127.0.0.1",
                 extra_shards: list[dict] | None = None):
        """``extra_shards``: further shard endpoints
        ``[{"addr": "host:port", "box": [ls, le, hs, he]}, ...]`` listed
        after this engine's own (the JAX package's multi-host followers).
        This engine's shard server is started here and listed FIRST —
        shards[0] is where the decode side sends the release ack."""
        self.engine = engine
        self.ttl_s = ttl_s
        self.advertise_host = advertise_host
        self.extra_shards = extra_shards or []
        self.shards: list[dict] | None = None
        self._transfers: dict[str, _Transfer] = {}
        self._gc_task: asyncio.Task | None = None
        self._wave_queues: dict[str, asyncio.Queue] = {}
        self._listener_loop: asyncio.AbstractEventLoop | None = None

    def start(self) -> None:
        if self._gc_task is None:
            self._gc_task = asyncio.create_task(self._gc_loop())

    async def stop(self) -> None:
        if self._gc_task is not None:
            self._gc_task.cancel()
            self._gc_task = None
        for xid in list(self._transfers):
            await self._release(xid)
        self.engine.core.stop_shard_server()
        self.shards = None

    # ------------------------------------------------------------------
    def _ensure_shards(self) -> list[dict]:
        if self.shards is None:
            core = self.engine.core
            loop = asyncio.get_running_loop()

            def on_release(xid: str) -> None:  # shard-server thread → loop
                loop.call_soon_threadsafe(
                    lambda: loop.create_task(self.release(xid)))

            addr = core.start_shard_server(self.advertise_host,
                                           on_release=on_release)
            self.shards = [{"addr": addr, "box": list(core.my_box())},
                           *self.extra_shards]
        return self.shards

    async def register(self, seq_hashes: list[int]) -> dict | None:
        """Stage the device-resident prefix of ``seq_hashes``; returns the
        kv_transfer_params (id + covered hashes + shard endpoints) or None
        if nothing is resident (e.g. prompt shorter than one block)."""
        if not seq_hashes:
            return None
        await chaos.ainject("disagg.stage", blocks=len(seq_hashes))
        shards = self._ensure_shards()
        xid = uuid.uuid4().hex
        covered_n = await self.engine.run_op(
            "kv_stage", {"xfer_id": xid, "hashes": seq_hashes})
        if not covered_n:
            return None
        covered = seq_hashes[:covered_n]
        self._transfers[xid] = _Transfer(
            seq_hashes=covered, deadline=time.monotonic() + self.ttl_s)
        return {"xfer_id": xid, "block_hashes": covered, "shards": shards}

    # -- streamed registration -----------------------------------------
    def _ensure_stream_listener(self) -> None:
        """Hook the engine's wave staging (AsyncTorchEngine._run) to this
        source: wave completions are marshaled from the engine thread onto
        the event loop and fanned out to the per-transfer queues the
        PrefillHandler consumes."""
        loop = asyncio.get_running_loop()
        if self._listener_loop is loop:
            return
        self._listener_loop = loop

        def on_wave(xid: str, staged: int) -> None:  # engine-core thread
            q = self._wave_queues.get(xid)
            xfer = self._transfers.get(xid)
            if xfer is not None:
                # A live stream is making progress — a slow prefill must
                # not expire its own transfer mid-stream (TTL measures
                # time since last progress; see _gc_loop).
                xfer.deadline = time.monotonic() + self.ttl_s
            if q is not None:
                loop.call_soon_threadsafe(q.put_nowait, ("wave", staged))

        self.engine.core._stream_listener = on_wave

    async def register_streaming(self, request_id: str, seq_hashes: list[int],
                                 events: asyncio.Queue) -> dict | None:
        """Open a streamed transfer for ``request_id``'s full expected hash
        chain BEFORE prefill runs. Waves land via the engine's per-chunk
        stage hook and are announced as ``("wave", staged_count)`` items on
        ``events``. Returns the announce params (id + chain + shard
        endpoints) or None for an empty chain."""
        if not seq_hashes:
            return None
        await chaos.ainject("disagg.stage", blocks=len(seq_hashes))
        shards = self._ensure_shards()
        self._ensure_stream_listener()
        xid = uuid.uuid4().hex
        self._wave_queues[xid] = events
        await self.engine.run_op(
            "kv_stream_begin",
            {"xfer_id": xid, "request_id": request_id,
             "hashes": list(seq_hashes)})
        self._transfers[xid] = _Transfer(
            seq_hashes=list(seq_hashes),
            deadline=time.monotonic() + self.ttl_s)
        return {"xfer_id": xid, "block_hashes": list(seq_hashes),
                "shards": shards}

    async def finish_streaming(self, xid: str) -> int:
        """Prefill finished: close the stream at its staged count. Returns
        the covered (pullable) block count; 0 releases the transfer
        entirely (nothing for the decode side to pull)."""
        self._wave_queues.pop(xid, None)
        covered = await self.engine.run_op("kv_stream_end", {"xfer_id": xid})
        covered = int(covered or 0)
        xfer = self._transfers.get(xid)
        if covered and xfer is not None:
            xfer.seq_hashes = xfer.seq_hashes[:covered]
            xfer.deadline = time.monotonic() + self.ttl_s
        else:
            await self._release(xid)
        return covered

    async def abort_streaming(self, xid: str) -> None:
        """Mid-stream abort (cancelled request, errored prefill): release
        pins for shipped AND not-yet-staged waves."""
        self._wave_queues.pop(xid, None)
        await self._release(xid)

    async def release(self, xfer_id: str) -> None:
        """Decode-side ack: the pull completed (or was abandoned) — unpin
        and drop staging."""
        await self._release(xfer_id)

    async def _release(self, xid: str) -> None:
        self._wave_queues.pop(xid, None)
        if self._transfers.pop(xid, None) is not None:
            await self.engine.run_op("kv_release", {"xfer_id": xid})

    async def _gc_loop(self) -> None:
        while True:
            await asyncio.sleep(self.ttl_s / 4)
            now = time.monotonic()
            for xid, xfer in list(self._transfers.items()):
                if xfer.deadline <= now:
                    log.warning("kv transfer %s expired unpulled; releasing", xid)
                    await self._release(xid)
