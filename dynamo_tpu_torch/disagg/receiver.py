"""Decode-side KV transfer receiver: pull shard slices, inject, release —
copy of ``dynamo_tpu/disagg/receiver.py``.

The pull is two core ops: ``kv_prefetch`` starts fetching the box slices
the decode engine owns from the shard servers listed in the params on a
thread beside the engine's steps, and ``kv_import`` joins it and injects
the blocks into the cache as matchable prefix entries
(``EngineCore.prefetch_remote`` / ``import_remote``). Data never transits
the coordinator.

``StreamedKvConsumer`` is the pipelined form: availability events from the
prefill side trigger per-wave prefetches whose network fetch overlaps both
the remote prefill still computing AND the injection of the previous wave.
Mixed ``kv_dtype`` conversion stays at the wave boundary (stage
dequantizes, inject requantizes).
"""

from __future__ import annotations

import asyncio
import time

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("disagg")


async def _send_release_ack(params: dict) -> None:
    """Done-ack to the owner (shards[0], the prefill engine's server): it
    unpins and unstages. Fire-and-forget — TTL expiry covers a lost ack."""
    from dynamo_tpu_torch.disagg.sharded import send_release

    try:
        await asyncio.get_running_loop().run_in_executor(
            None, send_release, params["shards"][0]["addr"], params["xfer_id"])
    except Exception as exc:  # noqa: BLE001
        log.warning("kv release ack failed (TTL will reclaim): %s", exc)


async def pull_and_import(engine: AsyncTorchEngine, params: dict) -> int:
    """Pull the transfer described by ``params`` into ``engine``'s prefix
    cache and ack completion to the transfer's owner. Returns blocks
    injected.

    params: {"xfer_id", "block_hashes": [...],
             "shards": [{"addr": "host:port", "box": [ls, le, hs, he]}]}

    Raises on a failed pull (import_remote's -1) so the caller's
    conditional-disagg fallback fires; a 0 return is a SUCCESSFUL pull
    whose blocks were all already device-resident.
    """
    # Chaos: an error here surfaces exactly like a failed pull — the
    # caller's conditional-disagg fallback (local prefill) must fire.
    await chaos.ainject("disagg.import", xfer_id=params["xfer_id"])
    # Two ops: the prefetch starts the network fetch on a background
    # thread (engine steps keep running while bytes move); the import
    # joins it and injects.
    await engine.run_op("kv_prefetch", {"params": params})
    n = await engine.run_op("kv_import", {"params": params})
    if n < 0:
        raise RuntimeError(f"kv pull {params['xfer_id']} failed")
    log.info("pulled %s KV blocks from %d shard(s)", n, len(params["shards"]))
    await _send_release_ack(params)
    return n


class StreamedKvConsumer:
    """Pipelined consumer of a streamed KV handoff.

    Built from the prefill side's announce event (xfer_id + shard list +
    full expected hash chain). Each availability event ``advance(ready)``
    issues a ``kv_prefetch_wave`` for the new window immediately (its
    network fetch starts on a background thread) and then imports the
    PREVIOUS window — so at steady state the fetch of wave w overlaps the
    injection of wave w-1 and whatever prefill chunks are still computing
    remotely. ``finish(final_params)`` drains the pipeline, records the
    overlap ratio, and acks the release.
    """

    def __init__(self, engine: AsyncTorchEngine, announce: dict):
        self.engine = engine
        self.xfer_id = announce["xfer_id"]
        self.params = {"xfer_id": self.xfer_id,
                       "shards": announce["shards"],
                       "block_hashes": list(announce["block_hashes"])}
        self.expected = len(self.params["block_hashes"])
        self.issued = 0              # blocks with a prefetch in flight/done
        self.injected = 0
        self.pending: list[tuple[int, int]] = []  # prefetched, not imported
        self.failed = False
        self.waves = 0
        self.tail_waves = 0          # waves first seen after prefill ended
        self.t_first: float | None = None
        self.t_prefill_done: float | None = None

    async def advance(self, ready: int, tail: bool = False) -> None:
        """A wave availability event: blocks [0, ready) are pullable."""
        ready = min(int(ready), self.expected)
        if self.failed or ready <= self.issued:
            return
        if self.t_first is None:
            self.t_first = time.monotonic()
        start, stop = self.issued, ready
        await self.engine.run_op(
            "kv_prefetch_wave",
            {"params": self.params, "start": start, "stop": stop,
             "tail": tail})
        self.pending.append((start, stop))
        self.issued = stop
        self.waves += 1
        if tail:
            self.tail_waves += 1
        # Keep exactly one wave in the network stage: import everything
        # older — its bytes are already host-side, so this is the device-
        # injection half of the pipeline.
        while len(self.pending) > 1:
            await self._import_next(final=False)

    async def _import_next(self, final: bool) -> None:
        start, stop = self.pending.pop(0)
        n = await self.engine.run_op(
            "kv_import_wave",
            {"params": self.params, "start": start, "stop": stop,
             "final": final})
        if n < 0:
            self.failed = True
            raise RuntimeError(
                f"kv wave pull {self.xfer_id}[{start}:{stop}) failed")
        self.injected += n

    async def finish(self, final_params: dict | None) -> int:
        """Prefill is done: pull any not-yet-issued tail (the final covered
        count can exceed the last announced wave), drain pending imports,
        record metrics, ack release. Returns blocks injected."""
        self.t_prefill_done = time.monotonic()
        covered = (len(final_params.get("block_hashes", []))
                   if final_params else self.issued)
        if covered > self.issued:
            await self.advance(covered, tail=True)
        while self.pending:
            await self._import_next(final=len(self.pending) == 1)
        self._record_overlap()
        log.info("streamed pull %s: %d blocks over %d wave(s), %d after "
                 "prefill end", self.xfer_id, self.injected, self.waves,
                 self.tail_waves)
        await _send_release_ack(self.params)
        return self.injected

    async def abort(self) -> None:
        """Tear down mid-stream: close the pull state and ask the prefill
        side to release shipped and unshipped waves alike."""
        self.failed = True
        try:
            await self.engine.run_op("kv_pull_abort",
                                     {"xfer_id": self.xfer_id})
        except Exception as exc:  # noqa: BLE001 — best-effort teardown
            log.warning("kv pull abort failed: %s", exc)
        await _send_release_ack(self.params)

    def overlap_ratio(self) -> float:
        """Fraction of the pull window [first prefetch, last import] that
        ran while the remote prefill was still computing. 1.0 when every
        wave was issued before prefill ended and nothing remained to drain
        afterwards; 0.0 for the serialized handoff shape."""
        if self.t_first is None or self.t_prefill_done is None:
            return 0.0
        t_end = time.monotonic()
        total = t_end - self.t_first
        if total <= 0:
            return 1.0
        overlapped = min(self.t_prefill_done, t_end) - self.t_first
        return max(0.0, min(1.0, overlapped / total))

    def _record_overlap(self) -> None:
        from dynamo_tpu_torch.disagg.metrics import get_kv_metrics

        if self.waves:
            get_kv_metrics().overlap_ratio.set(self.overlap_ratio())
