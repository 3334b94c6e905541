"""Planner connectors: apply replica decisions to the world.

Reference: components/src/dynamo/planner/ — KubernetesConnector patches
DynamoGraphDeployment replicas; VirtualConnector writes decisions to etcd
for an external orchestrator (virtual_connector.py). Here:

- :class:`VirtualConnector` writes the decision JSON to the coordinator KV
  (``planner/decisions/{namespace}``) with a monotonically increasing
  revision; any orchestrator can watch that prefix.
- :class:`ProcessConnector` applies decisions directly by spawning/stopping
  local worker processes — the no-K8s path used by tests and single-host
  deployments (each "replica" is one ``python -m
  dynamo_tpu_torch.components.worker`` process).

Copy of ``dynamo_tpu/planner/connector.py``.
"""

from __future__ import annotations

import asyncio
import json
import re
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.runtime.drain import DrainRequest, drain_key
from dynamo_tpu_torch.transports.client import CoordinatorClient
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

log = get_logger("planner")

DECISIONS_PREFIX = "planner/decisions"


class ConnectorMetrics:
    """The dynamo_connector_* family (the JAX package's names, which its
    tools/lint_metrics.py CONNECTOR_METRICS cross-checks)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.replicas_spawned = registry.counter(
            "connector_replicas_spawned",
            "Worker processes the planner connector started")
        self.replicas_retired = registry.counter(
            "connector_replicas_retired",
            "Worker processes the planner connector retired (drained "
            "or force-stopped)")
        self.sigkill_escalations = registry.counter(
            "connector_sigkill_escalations",
            "Retirements that escalated to SIGKILL after the drain AND "
            "the abort signal both timed out (last resort)")
        self.drain_seconds = registry.histogram(
            "connector_drain_seconds",
            "Seconds from drain initiation to worker process exit",
            buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0))


_metrics: ConnectorMetrics | None = None


def get_connector_metrics() -> ConnectorMetrics:
    global _metrics
    if _metrics is None:
        _metrics = ConnectorMetrics()
    return _metrics


def install_connector_metrics(registry: MetricsRegistry) -> ConnectorMetrics:
    """Re-home the singleton into a runtime registry (planner /metrics)."""
    m = get_connector_metrics()
    m.bind(registry)
    return m


class VirtualConnector:
    def __init__(self, client: CoordinatorClient, namespace: str = "dynamo"):
        self.client = client
        self.namespace = namespace
        self.revision = 0
        self._seeded = False

    @property
    def key(self) -> str:
        return f"{DECISIONS_PREFIX}/{self.namespace}"

    async def _seed_revision(self) -> None:
        """Resume the revision counter from the stored decision so a planner
        restart never regresses it (an orchestrator deduplicating by revision
        would ignore fresh decisions otherwise)."""
        existing = await self.read()
        if existing and isinstance(existing.get("revision"), int):
            self.revision = max(self.revision, existing["revision"])
        self._seeded = True

    async def apply(self, prefill_replicas: int, decode_replicas: int,
                    reason: str = "") -> None:
        if not self._seeded:
            await self._seed_revision()
        self.revision += 1
        await self.client.put(self.key, json.dumps({
            "revision": self.revision,
            "prefill_replicas": prefill_replicas,
            "decode_replicas": decode_replicas,
            "reason": reason,
            "ts": time.time(),
        }).encode())

    async def read(self) -> dict | None:
        value = await self.client.get(self.key)
        return json.loads(value) if value else None


_READY_RE = re.compile(r"WORKER_READY instance=([0-9a-f]{16})")


@dataclass
class Replica:
    """One worker process the connector owns. The stdout reader thread
    tees the child's lines through (so harnesses can still wait on
    WORKER_READY/WORKER_DRAINED) while capturing the instance id the
    drain handshake needs."""

    proc: subprocess.Popen
    instance_id: int | None = None
    _reader: threading.Thread | None = field(default=None, repr=False)

    def start_reader(self) -> None:
        if self.proc.stdout is None:
            return

        def pump() -> None:
            for line in self.proc.stdout:
                m = _READY_RE.search(line)
                if m:
                    self.instance_id = int(m.group(1), 16)
                sys.stdout.write(line)
                sys.stdout.flush()

        self._reader = threading.Thread(target=pump, daemon=True)
        self._reader.start()

    def alive(self) -> bool:
        return self.proc.poll() is None


class ProcessConnector:
    """Scale worker fleets by (de)spawning local processes.

    ``prefill_args``/``decode_args`` are full argv tails for
    ``python -m dynamo_tpu_torch.components.worker``; scale-down retires the
    most-recently started replicas, CONCURRENTLY (a 4→1 decision costs
    one drain window, not three).

    Retirement ladder (runtime/drain.py protocol on the worker side):

    1. **initiate** — write the coordinator drain key (carries the
       decision's reason + this connector's deadline) when a client and
       the replica's instance id are known; otherwise SIGTERM. Both start
       the same graceful drain.
    2. **abort** — past ``drain_deadline`` + margin, send SIGTERM: the
       worker treats a signal during an active drain as "abort" (skip
       waiting + evacuation, bounded fast exit).
    3. **SIGKILL** — logged last resort, counted in
       ``dynamo_connector_sigkill_escalations_total``.
    """

    def __init__(self, prefill_args: list[str] | None, decode_args: list[str],
                 client: CoordinatorClient | None = None,
                 namespace: str = "dynamo", drain_deadline: float = 30.0,
                 abort_grace: float = 5.0):
        self.prefill_args = prefill_args
        self.decode_args = decode_args
        self.client = client
        self.namespace = namespace
        self.drain_deadline = drain_deadline
        self.abort_grace = abort_grace
        self.prefill_procs: list[Replica] = []
        self.decode_procs: list[Replica] = []

    def _spawn(self, args: list[str]) -> Replica:
        cmd = [sys.executable, "-u", "-m", "dynamo_tpu_torch.components.worker", *args]
        log.info("spawning worker: %s", " ".join(args))
        rep = Replica(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, text=True, bufsize=1))
        rep.start_reader()
        get_connector_metrics().replicas_spawned.inc()
        return rep

    async def _wait(self, rep: Replica, timeout: float) -> bool:
        """Await process exit off-loop; True when it exited in time."""
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, rep.proc.wait, timeout)
            return True
        except subprocess.TimeoutExpired:
            return False

    async def _retire(self, rep: Replica, reason: str) -> None:
        """Drain one replica to exit (see the class-level ladder)."""
        m = get_connector_metrics()
        t0 = time.monotonic()
        if not rep.alive():
            m.replicas_retired.inc()
            return
        initiated = False
        if self.client is not None and rep.instance_id is not None:
            # Planner-initiated handshake: the worker's drain-key watcher
            # picks this up within its poll interval. Do NOT also signal —
            # a signal landing after the key would read as "abort".
            try:
                req = DrainRequest(reason=reason,
                                   deadline_s=self.drain_deadline,
                                   ts=time.time())
                await asyncio.wait_for(self.client.put(
                    drain_key(self.namespace, rep.instance_id),
                    req.to_bytes()), 3.0)
                initiated = True
            except Exception:
                log.warning("drain key write failed; falling back to SIGTERM")
        if not initiated:
            try:
                rep.proc.send_signal(signal.SIGTERM)
            except ProcessLookupError:
                pass
        if not await self._wait(rep, self.drain_deadline + 10.0):
            log.warning("replica pid=%d ignored the drain window; sending "
                        "the abort signal", rep.proc.pid)
            try:
                rep.proc.send_signal(signal.SIGTERM)
            except ProcessLookupError:
                pass
            if not await self._wait(rep, self.abort_grace):
                log.error("replica pid=%d survived drain AND abort; "
                          "SIGKILL as last resort", rep.proc.pid)
                m.sigkill_escalations.inc()
                rep.proc.kill()
                await self._wait(rep, 5.0)
        m.replicas_retired.inc()
        m.drain_seconds.observe(time.monotonic() - t0)
        log.info("replica pid=%d instance=%s exited rc=%s after %.2fs", rep.proc.pid,
                 f"{rep.instance_id:016x}" if rep.instance_id is not None else "?",
                 rep.proc.returncode, time.monotonic() - t0)

    def _reap(self, procs: list[Replica]) -> int:
        """Drop exited replicas (crashes); returns how many were reaped."""
        dead = [r for r in procs if not r.alive()]
        for r in dead:
            log.warning("replica pid=%d exited on its own (rc=%s); reaping",
                        r.proc.pid, r.proc.returncode)
        procs[:] = [r for r in procs if r.alive()]
        return len(dead)

    async def apply(self, prefill_replicas: int, decode_replicas: int,
                    reason: str = "") -> None:
        retiring: list = []
        for procs, args, target in (
            (self.prefill_procs, self.prefill_args, prefill_replicas),
            (self.decode_procs, self.decode_args, decode_replicas),
        ):
            if args is None:
                continue
            self._reap(procs)
            while len(procs) < target:
                procs.append(self._spawn(args))
            while len(procs) > target:
                retiring.append(self._retire(procs.pop(), reason))
        if retiring:
            await asyncio.gather(*retiring)

    async def shutdown(self, reason: str = "planner shutdown") -> None:
        retiring = []
        for procs in (self.prefill_procs, self.decode_procs):
            while procs:
                retiring.append(self._retire(procs.pop(), reason))
        if retiring:
            await asyncio.gather(*retiring)
