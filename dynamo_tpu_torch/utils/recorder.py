"""Stream recorder: capture coordinator subjects (KV events, load metrics)
or request streams to JSONL for replay and analysis.

Copy of ``dynamo_tpu/utils/recorder.py`` over the port's coordinator
client (``transports/client.py``) and MessagePack codec
(``utils/msgpack.py``), in place of the ``msgpack`` package, which the
card's machine lacks.

CLI: ``python -m dynamo_tpu_torch.utils.recorder --coordinator tcp://... \
      --subject 'kv_events.dynamo.backend' --out events.jsonl``

Replay: :func:`load_router_events` turns a recorded KV-event file back
into RouterEvent objects, so recorded workloads can drive a RadixIndexer
offline (router evaluation / regression analysis).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import time
from typing import Iterator

from dynamo_tpu_torch.utils import msgpack
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("recorder")


class _SharedWriter:
    """One file handle + asyncio lock per output path: recorders for
    multiple subjects appending to the same file cannot interleave lines."""

    def __init__(self, path: str):
        self._f = open(path, "a")
        self._lock = asyncio.Lock()

    async def write_line(self, line: str) -> None:
        loop = asyncio.get_running_loop()
        async with self._lock:
            await loop.run_in_executor(
                None, lambda: (self._f.write(line), self._f.flush()))

    def close(self) -> None:
        self._f.close()


class StreamRecorder:
    """Subscribes to one coordinator pub/sub subject; writes one JSON line
    per message: {"t": ..., "subject": ..., "payload": ...}."""

    def __init__(self, coord, subject: str, path: str,
                 writer: "_SharedWriter | None" = None):
        self.coord = coord
        self.subject = subject
        self.path = path
        self._writer = writer or _SharedWriter(path)
        self._owns_writer = writer is None
        self.count = 0
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        sub = await self.coord.subscribe(self.subject)
        self._task = asyncio.ensure_future(self._loop(sub))

    async def _loop(self, sub) -> None:
        async for subject, payload in sub:
            try:
                obj = msgpack.unpackb(payload)
            except Exception:
                obj = {"_raw_hex": payload.hex()}
            line = json.dumps({
                "t": time.time(), "subject": subject, "payload": obj,
            }, default=str) + "\n"
            # Off-loop + per-file locked: recording must neither stall the
            # event loop nor interleave lines across subjects.
            await self._writer.write_line(line)
            self.count += 1

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._owns_writer:
            self._writer.close()


def iter_records(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_router_events(path: str) -> list:
    """Recorded kv_events file → RouterEvent list (replayable into a
    RadixIndexer for offline router evaluation)."""
    from dynamo_tpu_torch.router.events import RouterEvent

    out = []
    for rec in iter_records(path):
        payload = rec.get("payload")
        if isinstance(payload, list):
            for d in payload:
                try:
                    out.append(RouterEvent.from_dict(d))
                except Exception:
                    log.warning("skipping malformed event record")
    return out


async def amain(ns: argparse.Namespace) -> None:
    from dynamo_tpu_torch.transports.client import CoordinatorClient

    coord = await CoordinatorClient.connect(ns.coordinator)
    writer = _SharedWriter(ns.out)
    recorders = [StreamRecorder(coord, s, ns.out, writer=writer)
                 for s in ns.subject]
    for r in recorders:
        await r.start()
    log.info("recording %s -> %s", ns.subject, ns.out)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    for r in recorders:
        await r.stop()
    writer.close()
    await coord.close()
    log.info("recorded %d messages", sum(r.count for r in recorders))


def main() -> None:
    configure_logging()
    p = argparse.ArgumentParser("dynamo-recorder")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--subject", action="append", required=True,
                   help="pub/sub subject (repeatable), e.g. kv_events.dynamo.backend")
    p.add_argument("--out", required=True, help="JSONL output path")
    asyncio.run(amain(p.parse_args()))


if __name__ == "__main__":
    main()
