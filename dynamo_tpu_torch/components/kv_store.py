"""Standalone G4 remote KV block store process.

Fills the role of the reference's remote cache level backend
(reference: lib/llm/src/block_manager.rs:63-75 ``CacheLevel::G4``; the
object-store flavor of block_manager/storage/). Run one per pod (or per
cell) and point engines at it with ``--remote-kv-addr`` — or let them
discover it through the coordinator, where the store registers itself
lease-bound (a dead store vanishes and engines degrade to local tiers).

    python -m dynamo_tpu_torch.components.kv_store --port 9301 \
        --coordinator tcp://127.0.0.1:4222 --capacity-gib 8

Copy of ``dynamo_tpu/components/kv_store.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.kvbm.remote import RemoteBlockServer, register_store
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("kv_store")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo-kv-store")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--advertise-host", default="127.0.0.1",
                   help="address engines should dial (the bind host may be 0.0.0.0)")
    p.add_argument("--capacity-gib", type=float, default=4.0)
    p.add_argument("--coordinator", default=None,
                   help="register in this coordination service for discovery")
    return p.parse_args(argv)


async def amain(ns: argparse.Namespace) -> None:
    server = RemoteBlockServer(capacity_bytes=int(ns.capacity_gib * (1 << 30)))
    port = await server.start(ns.host, ns.port)

    rt = None
    if ns.coordinator:
        from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
        from dynamo_tpu_torch.utils.config import RuntimeConfig

        rt = await DistributedRuntime.create(
            RuntimeConfig.from_settings(coordinator_url=ns.coordinator))
        assert rt.client is not None and rt.primary_lease is not None
        await register_store(rt.client, rt.instance_id,
                             f"{ns.advertise_host}:{port}",
                             lease_id=rt.primary_lease.id)
    print(f"KV_STORE_READY port={port}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()
    if rt is not None:
        await rt.shutdown()


def main() -> None:
    configure_logging()
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
