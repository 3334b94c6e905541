"""Fleet aggregator process: discover, scrape, roll up, serve.

Fills the role of the reference's metrics-aggregation component plus the
Prometheus instance its SLA planner queries (reference: deploy/metrics):
``python -m dynamo_tpu_torch.components.aggregator`` discovers every live
frontend/router/worker via the coordinator's ``dyn/metrics`` prefix,
scrapes them on ``--scrape-interval``, and serves

* ``/metrics``     — per-target series (instance/role labels), fleet
  rollups (``instance="_fleet"``), plus ``dynamo_fleet_*`` and
  ``dynamo_slo_*`` families;
* ``/debug/fleet`` — the JSON dashboard (freshness, burn contributors,
  EWMA anomaly flags);
* ``/health`` / ``/live`` — probes.

Point the planner's ``--fleet-url`` at this port.

Copy of ``dynamo_tpu/components/aggregator.py`` over the port's stdlib HTTP
server (``frontend/http.py``) instead of aiohttp; every GET route answers
HEAD too.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.frontend import http as web
from dynamo_tpu_torch.obs.fleet import (
    DEFAULT_SLO_SPECS,
    FleetAggregator,
    parse_slo_specs,
)
from dynamo_tpu_torch.transports.client import CoordinatorClient
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("aggregator.main")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo-aggregator")
    p.add_argument("--coordinator", default="tcp://127.0.0.1:6650")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0,
                   help="HTTP port for /metrics and /debug/fleet (0 = pick)")
    p.add_argument("--scrape-interval", type=float, default=2.0,
                   help="seconds between scrape sweeps")
    p.add_argument("--scrape-timeout", type=float, default=2.0,
                   help="per-target scrape timeout in seconds")
    p.add_argument("--staleness-ttl", type=float, default=10.0,
                   help="seconds without a successful scrape before a "
                        "target's data is labeled stale (and, once also "
                        "deregistered, dropped)")
    p.add_argument("--slo-spec", default=None,
                   help="path to a JSON SLO spec document ({'slos': [...]}); "
                        "default: built-in TTFT/ITL p95 + availability")
    return p.parse_args(argv)


def make_app(agg: FleetAggregator) -> web.HttpServer:
    async def metrics(_req: web.Request) -> web.Response:
        return web.Response(text=agg.expose(), content_type="text/plain")

    async def debug_fleet(_req: web.Request) -> web.Response:
        return web.json_response(agg.debug_info())

    async def health(_req: web.Request) -> web.Response:
        return web.json_response({"status": "ready",
                                  "targets": len(agg.targets)})

    async def live(_req: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    app = web.HttpServer()
    app.add_get("/metrics", metrics)
    app.add_get("/debug/fleet", debug_fleet)
    app.add_get("/health", health)
    app.add_get("/live", live)
    return app


async def amain(ns: argparse.Namespace) -> None:
    specs = DEFAULT_SLO_SPECS
    if ns.slo_spec is not None:
        with open(ns.slo_spec) as f:
            specs = parse_slo_specs(f.read())
    client = await CoordinatorClient.connect(ns.coordinator,
                                             auto_reconnect=True)
    agg = FleetAggregator(
        client, namespace=ns.namespace,
        scrape_interval_s=ns.scrape_interval,
        scrape_timeout_s=ns.scrape_timeout,
        staleness_ttl_s=ns.staleness_ttl,
        specs=specs)

    app = make_app(agg)
    port = await app.start(ns.host, ns.port)
    log.info("fleet aggregator on :%d (interval=%.1fs ttl=%.1fs slos=%s)",
             port, ns.scrape_interval, ns.staleness_ttl,
             ",".join(s.name for s in specs))
    print(f"AGGREGATOR_READY port={port}", flush=True)

    loop_task = asyncio.create_task(agg.run())
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        loop_task.cancel()
        await app.stop()
        await client.close()


def main() -> None:
    configure_logging()
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
