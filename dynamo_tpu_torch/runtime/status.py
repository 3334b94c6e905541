"""Per-process system status server: /health, /live, /metrics.

Fills the role of the reference's system status server
(reference: lib/runtime/src/system_status_server.rs:1-811 + system_health.rs
— an env-gated (DYN_SYSTEM_ENABLED / DYN_SYSTEM_PORT) HTTP endpoint every
process can expose, independent of any model-serving frontend, giving
k8s probes and Prometheus a uniform per-process surface).

Workers previously published metrics only over the coordinator; with this,
every DistributedRuntime process can also be scraped/probed directly.
Status providers (e.g. the worker's engine stats fn) plug in at runtime.

Copy of ``dynamo_tpu/runtime/status.py`` over the port's stdlib HTTP server
(``frontend/http.py``) instead of aiohttp.
"""

from __future__ import annotations

import time
from typing import Callable

from dynamo_tpu_torch.frontend import http as web
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

log = get_logger("status")


class SystemStatusServer:
    def __init__(self, metrics: MetricsRegistry, port: int = 0):
        self.metrics = metrics
        self.port = port
        self._providers: dict[str, Callable[[], dict]] = {}
        self._t0 = time.monotonic()
        self._server: web.HttpServer | None = None
        # Readiness: a static flag AND an optional dynamic probe (e.g. the
        # worker's health-canary state); /health is 503 when either is off.
        self.ready = True
        self._ready_fn: Callable[[], bool] | None = None

    def set_ready_fn(self, fn: Callable[[], bool]) -> None:
        self._ready_fn = fn

    def _is_ready(self) -> bool:
        try:
            dynamic = self._ready_fn() if self._ready_fn is not None else True
        except Exception:
            dynamic = False
        return self.ready and dynamic

    def add_provider(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a status section (e.g. the engine's stats fn)."""
        self._providers[name] = fn

    async def start(self, host: str = "0.0.0.0") -> int:
        srv = web.HttpServer()
        srv.add_get("/health", self._health)
        srv.add_get("/live", self._live)
        srv.add_get("/metrics", self._metrics)
        srv.add_get("/debug/sched", self._debug_sched)
        srv.add_get("/debug/mem", self._debug_mem)
        self.port = await srv.start(host, self.port)
        self._server = srv
        log.info("system status server on port %d", self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None

    async def _health(self, request: web.Request) -> web.Response:
        ready = self._is_ready()
        body = {
            "status": "ready" if ready else "notready",
            "uptime_s": round(time.monotonic() - self._t0, 1),
        }
        for name, fn in self._providers.items():
            try:
                body[name] = fn()
            except Exception as exc:  # noqa: BLE001 - a broken provider
                body[name] = {"error": str(exc)}  # must not break the probe
        return web.json_response(body, status=200 if ready else 503)

    async def _live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def _debug_sched(self, request: web.Request) -> web.Response:
        """Worker-local scheduling ledger (obs/sched_ledger.py): the
        recent-step ring, goodput trend, and top HOL culprits of THIS
        process's engine — span-level victim detail lives in the worker's
        own FlightRecorder, so merge it in."""
        from dynamo_tpu_torch.obs.sched_ledger import get_sched_ledger
        from dynamo_tpu_torch.obs.tracer import get_tracer

        return web.json_response(get_sched_ledger().debug_info(
            recorder=get_tracer().recorder))

    async def _debug_mem(self, request: web.Request) -> web.Response:
        """Worker-local memory ledger (obs/mem_ledger.py): the tier
        occupancy waterfall, top pin owners, churn trend, consumption
        rates, TTX forecast, and the last pin-leak audit report."""
        from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger

        return web.json_response(get_mem_ledger().debug_info())

    async def _metrics(self, request: web.Request) -> web.Response:
        text = self.metrics.expose()
        # Status-provider numeric leaves export as gauges too, so engine
        # stats (kv_usage, num_running, ...) are scrapeable without the
        # coordinator in the path.
        lines = [text] if text else []
        for name, fn in self._providers.items():
            try:
                stats = fn()
            except Exception:
                continue
            for k, v in stats.items():
                if isinstance(v, bool):
                    v = int(v)
                if isinstance(v, (int, float)):
                    lines.append(f"dynamo_{name}_{k} {v}")
        return web.Response(text="\n".join(lines) + "\n",
                            content_type="text/plain")
