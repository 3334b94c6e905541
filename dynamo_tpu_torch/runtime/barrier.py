"""Leader-worker barrier: multi-process rendezvous over the coordinator —
copy of ``dynamo_tpu/runtime/barrier.py`` over the port's coordinator
client (transports/client.py: ``put``, ``get``, ``delete``,
``watch_prefix``).

Fills the role of the reference's etcd leader-worker barrier
(reference: lib/runtime/src/utils/leader_worker_barrier.rs:14-50 — the
leader posts data under a barrier id and waits for N workers to check in;
workers post themselves and wait for the leader's ``complete`` key).

Used wherever N processes must meet before proceeding (multi-host engine
bring-up, KVBM leader/worker handshakes). Keys live under
``barrier/{id}/...`` and are lease-bound when a lease id is given, so a
crashed participant's state evaporates with its lease.

Re-run safety: each leader run stamps a fresh generation token into the
data key, check-ins carry the token of the data they saw, and the leader
counts only current-generation check-ins — so stale check-ins can never
satisfy a new leader early, and a leader restart mid-rendezvous makes
workers re-check-in against the new generation. The leader also deletes
leftover data/complete keys from a finished prior run before starting.
One window remains open by construction: a worker that registers its
watch while a COMPLETED prior run's keys still exist (leader of the new
run not yet started) sees a self-consistent stale data+complete pair and
returns the old payload — bind keys to leases (``lease_id``) so a dead
run's keys evaporate, or use a fresh ``barrier_id`` per rendezvous, to
close it. Waits are watch-driven (the coordinator replays current state
into a new watch, then pushes events), not polled.
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import Any

from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("barrier")

ROOT = "barrier"


class BarrierTimeout(TimeoutError):
    pass


async def leader_barrier(client, barrier_id: str, num_workers: int,
                         data: Any = None, timeout: float = 120.0,
                         lease_id: int = 0) -> list[str]:
    """Leader side: publish ``data``, wait for ``num_workers`` check-ins,
    then post the completion marker. Returns the worker names seen."""
    gen = uuid.uuid4().hex
    # Clear a finished prior run's markers so late-registering workers
    # can't be released by them once this run's data key lands.
    await client.delete(f"{ROOT}/{barrier_id}/complete")
    await client.put(f"{ROOT}/{barrier_id}/data",
                     json.dumps({"gen": gen, "payload": data}).encode(),
                     lease_id)
    prefix = f"{ROOT}/{barrier_id}/workers/"
    watch = await client.watch_prefix(prefix)
    seen: set[str] = set()

    async def wait_for_workers() -> None:
        if len(seen) >= num_workers:  # trivially complete (num_workers == 0)
            return
        async for ev in watch:
            if ev.op == "put" and ev.value == gen.encode():
                seen.add(ev.key[len(prefix):])
                if len(seen) >= num_workers:
                    return
        raise ConnectionError("coordinator watch ended during barrier")

    try:
        await asyncio.wait_for(wait_for_workers(), timeout)
    except asyncio.TimeoutError:
        raise BarrierTimeout(
            f"barrier {barrier_id!r}: {len(seen)}/{num_workers} workers "
            f"within {timeout}s ({sorted(seen)})") from None
    finally:
        await watch.cancel()
    await client.put(f"{ROOT}/{barrier_id}/complete", gen.encode(), lease_id)
    return sorted(seen)


async def worker_barrier(client, barrier_id: str, worker_name: str,
                         timeout: float = 120.0, lease_id: int = 0) -> Any:
    """Worker side: wait for the leader's data, check in against its
    generation, wait for the matching completion marker, and return the
    leader's published payload. A leader restart mid-wait (new generation
    appearing on the data key) triggers a re-check-in, so the rendezvous
    survives the race instead of deadlocking until timeout."""
    prefix = f"{ROOT}/{barrier_id}/"
    watch = await client.watch_prefix(prefix)
    payload: Any = None
    gen: str | None = None
    complete: str | None = None

    async def participate() -> None:
        nonlocal payload, gen, complete
        async for ev in watch:
            if ev.op == "delete":
                if ev.key == f"{prefix}complete":
                    complete = None  # a new leader run is resetting
                continue
            if ev.value is None:
                continue
            if ev.key == f"{prefix}data":
                blob = json.loads(ev.value.decode())
                payload, new_gen = blob["payload"], blob["gen"]
                if new_gen != gen:
                    gen = new_gen
                    await client.put(f"{prefix}workers/{worker_name}",
                                     gen.encode(), lease_id)
            elif ev.key == f"{prefix}complete":
                complete = ev.value.decode()
            if gen is not None and complete == gen:
                return
        # watch ended: the coordinator connection died mid-rendezvous —
        # fail loudly (mirrors the leader side) instead of returning a
        # half-formed payload as success.
        raise ConnectionError("coordinator watch ended during barrier")

    try:
        await asyncio.wait_for(participate(), timeout)
    except asyncio.TimeoutError:
        stage = "leader data" if gen is None else "completion marker"
        raise BarrierTimeout(
            f"barrier {barrier_id!r}: no {stage} within {timeout}s") from None
    finally:
        await watch.cancel()
    return payload
