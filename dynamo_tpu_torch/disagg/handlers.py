"""Disaggregated request handlers: decode-first flow + prefill wrapper —
copy of ``dynamo_tpu/disagg/handlers.py``.

The decode worker decides per request whether remote prefill is worthwhile
(``_can_disagg``), calls the prefill pool, then generates locally with the
handed-off KV; the prefill worker generates exactly one token and returns
transfer metadata (the decode-first pattern).

The streamed handoff (default) turns the prefill response into an event
stream: one announce event up front (transfer id + shard endpoints + full
expected hash chain), one availability event per staged wave while the
prefill is still computing, then the final message with the
``kv_transfer_params``. A decode worker that understands the events pulls
waves as they land (StreamedKvConsumer); one that doesn't can ignore them
and use the final params as for a one-shot staged transfer — a
single-wave transfer is byte-identical to the one-shot staged pull.
"""

from __future__ import annotations

import asyncio
import copy
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.disagg.receiver import StreamedKvConsumer, pull_and_import
from dynamo_tpu_torch.disagg.source import KvTransferSource
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.tokens import compute_block_hashes_for_tokens
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("disagg")


class PrefillHandler:
    """Wraps an engine as a prefill-only worker: compute prompt KV, discard
    the sampled token, pin + advertise the blocks for pulling — streaming
    wave availability to the caller while the prefill is still running."""

    def __init__(self, engine: AsyncTorchEngine, source: KvTransferSource,
                 block_size: int, stream: bool = True):
        self.engine = engine
        self.source = source
        self.block_size = block_size
        self.stream = stream

    async def generate(self, payload: dict, ctx) -> AsyncIterator[dict]:
        req = PreprocessedRequest.from_dict(payload)
        # Prefill-only: one step past the prompt, sampling result discarded
        # (the decode side samples its own first token from the handed-off KV).
        req.stop_conditions = StopConditions(max_tokens=1, ignore_eos=True)
        # The decode scheduler can match at most (prompt_len-1)//block_size
        # blocks (it must recompute ≥1 token for last-position state), so a
        # final exactly-full block would be transferred but never matched —
        # don't ship it.
        cap = (len(req.token_ids) - 1) // self.block_size
        hashes = compute_block_hashes_for_tokens(req.token_ids, self.block_size)[:cap]
        if self.stream and hashes:
            async for out in self._generate_streamed(req, hashes, ctx):
                yield out
            return
        async for out in self.engine.generate(req):
            if ctx.is_cancelled():
                return
            if out.finish_reason is not None and out.error:
                yield out.to_dict()
                return
        params = await self.source.register(hashes)
        result: dict[str, Any] = {"token_ids": [], "finish_reason": "stop"}
        if params is not None:
            result["kv_transfer_params"] = params
        yield result

    async def _generate_streamed(self, req: PreprocessedRequest,
                                 hashes: list[int],
                                 ctx) -> AsyncIterator[dict]:
        """Register the transfer up front, run the prefill concurrently, and
        relay wave availability events as they land. The engine pump and
        the wave listener share one queue so a single await drives both."""
        events: asyncio.Queue = asyncio.Queue()
        reg = await self.source.register_streaming(req.request_id, hashes,
                                                   events)
        xid = reg["xfer_id"]

        async def pump() -> None:
            try:
                async for out in self.engine.generate(req):
                    if out.finish_reason is not None and out.error:
                        await events.put(("error", out))
                        return
            finally:
                await events.put(("done", None))

        task = asyncio.create_task(pump())
        announced = 0
        error_out = None
        handed_off = False
        try:
            yield {"kv_transfer_stream": {
                "xfer_id": xid, "shards": reg["shards"],
                "block_hashes": hashes, "ready": 0}}
            while True:
                kind, val = await events.get()
                if ctx.is_cancelled():
                    return
                if kind == "wave":
                    val = min(int(val), len(hashes))
                    if val > announced:
                        announced = val
                        yield {"kv_transfer_stream": {"xfer_id": xid,
                                                      "ready": val}}
                elif kind == "error":
                    error_out = val
                elif kind == "done":
                    break
            if error_out is not None:
                yield error_out.to_dict()
                return
            # The final wave may have been staged without its event being
            # consumed yet — the covered count at stream end is authoritative.
            covered = await self.source.finish_streaming(xid)
            handed_off = True  # TTL owns the transfer from here
            result: dict[str, Any] = {"token_ids": [], "finish_reason": "stop"}
            if covered:
                result["kv_transfer_params"] = {
                    "xfer_id": xid, "block_hashes": hashes[:covered],
                    "shards": reg["shards"], "streamed": True}
            yield result
        finally:
            task.cancel()
            if not handed_off:
                # Cancelled, errored, or the caller dropped the stream:
                # release pins for shipped and not-yet-staged waves alike.
                asyncio.get_running_loop().create_task(
                    self.source.abort_streaming(xid))


class DisaggDecodeHandler:
    """Decode worker handler with conditional remote prefill.

    ``prefill_call(payload, request_id)`` is any async-iterator factory that
    reaches the prefill pool (a PushRouter/KvPushRouter generate) — injected
    so the handler is transport-agnostic and unit-testable.
    """

    def __init__(
        self,
        engine: AsyncTorchEngine,
        prefill_call: Callable[[dict, str], AsyncIterator[dict]],
        block_size: int,
        min_prefill_blocks: int = 2,
    ):
        self.engine = engine
        self.prefill_call = prefill_call
        self.block_size = block_size
        self.min_prefill_blocks = min_prefill_blocks
        self.remote_prefills = 0
        self.local_fallbacks = 0

    def _can_disagg(self, req: PreprocessedRequest) -> bool:
        return len(req.token_ids) // self.block_size >= self.min_prefill_blocks

    async def _remote_prefill(self, req: PreprocessedRequest) -> None:
        pre = copy.deepcopy(req)
        pre.request_id = f"{req.request_id}-prefill"
        pre.annotations["disagg"] = "prefill"
        consumer: StreamedKvConsumer | None = None
        params = None
        try:
            async for out in self.prefill_call(pre.to_dict(), pre.request_id):
                if not isinstance(out, dict):
                    continue
                ev = out.get("kv_transfer_stream")
                if ev is not None:
                    if consumer is None and ev.get("shards"):
                        consumer = StreamedKvConsumer(self.engine, ev)
                    elif consumer is not None and ev.get("ready"):
                        await consumer.advance(int(ev["ready"]))
                if out.get("kv_transfer_params"):
                    params = out["kv_transfer_params"]
        except Exception:
            if consumer is not None:
                await consumer.abort()
            raise
        if consumer is not None:
            try:
                n = await consumer.finish(params)
            except Exception:
                await consumer.abort()
                raise
            if n == 0 and params is None:
                # The prefill stream ended without handing anything off
                # (e.g. its engine errored before the first wave).
                raise RuntimeError(
                    "prefill worker returned no kv_transfer_params")
            return
        if params is None:
            raise RuntimeError("prefill worker returned no kv_transfer_params")
        await pull_and_import(self.engine, params)

    async def generate(self, payload: dict, ctx) -> AsyncIterator[dict]:
        req = PreprocessedRequest.from_dict(payload)
        if self._can_disagg(req):
            try:
                await self._remote_prefill(req)
                self.remote_prefills += 1
            except Exception as exc:
                # Conditional disagg: fall back to local prefill rather than
                # failing the request.
                self.local_fallbacks += 1
                log.warning("remote prefill failed (%s); prefilling locally", exc)
        async for out in self.engine.generate(req):
            if ctx.is_cancelled():
                return
            yield out.to_dict()
