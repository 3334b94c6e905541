"""Planner process: scrape frontend metrics, plan, apply.

Fills the role of ``python -m dynamo.planner`` (reference:
components/src/dynamo/planner/planner_sla.py): an SLA-driven loop sizing
the prefill/decode fleets. ``python -m dynamo_tpu_torch.components.planner``.

Copy of ``dynamo_tpu/components/planner.py``: ``--profile-data`` is an npz
of the port's profiler (``planner/profiler.py``), process mode spawns the
port's workers, and each decision is logged with the reason it applies.
"""

from __future__ import annotations

import argparse
import asyncio
import shlex
import signal

import numpy as np

from dynamo_tpu_torch.planner.connector import ProcessConnector, VirtualConnector
from dynamo_tpu_torch.planner.interpolator import (
    DecodeInterpolator, PrefillInterpolator, synthetic_profile)
from dynamo_tpu_torch.planner.planner_core import Planner, PlannerConfig
from dynamo_tpu_torch.planner.scrape import AggregatorScraper, FrontendScraper
from dynamo_tpu_torch.transports.client import CoordinatorClient
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("planner.main")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo-planner")
    p.add_argument("--frontend-url", default="http://127.0.0.1:8080")
    p.add_argument("--fleet-url", default=None,
                   help="fleet aggregator base URL; when set the planner "
                        "consumes fleet-wide rollup rates (every frontend) "
                        "instead of one frontend, and decisions carry the "
                        "aggregator's SLO snapshot in their reason")
    p.add_argument("--model", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--coordinator", default="tcp://127.0.0.1:6650")
    p.add_argument("--mode", choices=["virtual", "process", "dryrun"], default="virtual")
    p.add_argument("--adjustment-interval", type=float, default=30.0)
    p.add_argument("--ttft-sla", type=float, default=0.5, help="seconds")
    p.add_argument("--itl-sla", type=float, default=0.05, help="seconds")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--chip-budget", type=int, default=0)
    p.add_argument("--chips-per-prefill-replica", type=int, default=1)
    p.add_argument("--chips-per-decode-replica", type=int, default=1)
    p.add_argument("--load-predictor", choices=["constant", "moving_average", "linear"],
                   default="moving_average")
    p.add_argument("--profile-data", default=None,
                   help="npz from the profiler; default: synthetic analytic profile")
    p.add_argument("--prefill-worker-args", default=None,
                   help="process mode: argv tail for prefill workers")
    p.add_argument("--decode-worker-args", default=None,
                   help="process mode: argv tail for decode workers")
    p.add_argument("--drain-deadline", type=float, default=30.0,
                   help="process mode: seconds a retiring worker gets to "
                        "drain before the connector escalates "
                        "(abort signal, then SIGKILL)")
    return p.parse_args(argv)


def load_profile(path: str | None) -> dict:
    if path is None:
        log.warning("no --profile-data; using the synthetic analytic profile")
        return synthetic_profile()
    return dict(np.load(path))


async def amain(ns: argparse.Namespace) -> None:
    data = load_profile(ns.profile_data)
    planner = Planner(
        PlannerConfig(
            ttft_sla_s=ns.ttft_sla, itl_sla_s=ns.itl_sla,
            adjustment_interval_s=ns.adjustment_interval,
            chips_per_prefill_replica=ns.chips_per_prefill_replica,
            chips_per_decode_replica=ns.chips_per_decode_replica,
            min_replicas=ns.min_replicas, max_replicas=ns.max_replicas,
            chip_budget=ns.chip_budget, load_predictor=ns.load_predictor,
        ),
        PrefillInterpolator.from_data(data),
        DecodeInterpolator.from_data(data),
    )
    if ns.fleet_url is not None:
        scraper = AggregatorScraper(ns.fleet_url, ns.model)
    else:
        scraper = FrontendScraper(ns.frontend_url.rstrip("/") + "/metrics",
                                  ns.model)

    connector = None
    coord = None
    if ns.mode == "virtual":
        coord = await CoordinatorClient.connect(ns.coordinator)
        connector = VirtualConnector(coord, ns.namespace)
    elif ns.mode == "process":
        if ns.decode_worker_args is None:
            raise SystemExit("--mode process requires --decode-worker-args")
        # A coordinator client upgrades scale-down from plain SIGTERM to
        # the drain-key handshake (reason + deadline travel with the
        # decision); without one the signal path still drains gracefully.
        try:
            coord = await asyncio.wait_for(
                CoordinatorClient.connect(ns.coordinator), 3.0)
        except Exception:
            log.warning("coordinator unreachable; process connector will "
                        "retire workers via signals only")
            coord = None
        connector = ProcessConnector(
            shlex.split(ns.prefill_worker_args) if ns.prefill_worker_args else None,
            shlex.split(ns.decode_worker_args),
            client=coord, namespace=ns.namespace,
            drain_deadline=ns.drain_deadline)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    log.info("planner ready: mode=%s interval=%.0fs", ns.mode, ns.adjustment_interval)
    print("PLANNER_READY", flush=True)

    try:
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=ns.adjustment_interval)
                break
            except asyncio.TimeoutError:
                pass
            try:
                m = await scraper.observe_interval()
            except Exception as exc:
                log.warning("metrics scrape failed: %s", exc)
                continue
            planner.observe(m)
            decision = planner.plan()
            reason = decision.reason
            if isinstance(scraper, AggregatorScraper):
                # The SLO state that justified this decision travels with
                # it (VirtualConnector persists reason to the coordinator).
                slo = scraper.slo_reason()
                if slo:
                    reason = f"{reason} | {slo}"
                # Likewise the capacity forecast: the worst worker's TTX
                # and posture (obs/mem_ledger.py) stamp every decision so
                # a scale-up justified by memory pressure says so.
                mem = scraper.mem_reason()
                if mem:
                    reason = f"{reason} | {mem}"
            log.info("decision prefill=%d decode=%d reason=%s",
                     decision.prefill_replicas, decision.decode_replicas, reason)
            if connector is not None:
                await connector.apply(decision.prefill_replicas,
                                      decision.decode_replicas, reason)
    finally:
        if isinstance(connector, ProcessConnector):
            await connector.shutdown()
        if coord is not None:
            await coord.close()


def main() -> None:
    configure_logging()
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
