"""Standalone KV-aware router component.

Fills the role of the reference's dynamo.router component
(reference: components/src/dynamo/router/__main__.py:30-120): a process
serving a ``generate`` endpoint that KV-routes each PreprocessedRequest
over a target worker pool via KvPushRouter — so any caller (above all the
disagg decode fleet dispatching remote prefills) gets prefix-aware
placement without embedding a router brain of its own. Multiple router
replicas can share load predictions with --sync-replicas
(SyncedActiveSequences; reference: sequence.rs ActiveSequencesMultiWorker).

``python -m dynamo_tpu_torch.components.router --target dyn://dynamo.prefill.generate``

Copy of ``dynamo_tpu/components/router.py``. ``--device-kind`` keeps the
JAX package's default (``"tpu v5"``); a fleet of H100 workers passes
``--device-kind "NVIDIA H100 80GB HBM3"`` so that ``--global-prefix-cache``
prices prefill at the card's row of ``obs/costmodel.HW_SPECS``.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.router.kv_router import KvPushRouter, KvRouterConfig
from dynamo_tpu_torch.runtime.client import EndpointClient
from dynamo_tpu_torch.runtime.protocols import EndpointId
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime, RequestContext
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("router.component")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo-router")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="router")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--target", default="dyn://dynamo.prefill.generate",
                   help="worker-pool endpoint to KV-route over")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--overlap-weight", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--snapshot-interval", type=float, default=5.0,
                   help="radix snapshot dump period (s); 0 disables")
    p.add_argument("--sync-replicas", action="store_true",
                   help="mirror ActiveSequences predictions across router replicas")
    p.add_argument("--use-approx", action="store_true",
                   help="ApproxKvIndexer for pools that publish no KV events")
    p.add_argument("--global-prefix-cache", action="store_true",
                   help="arbitrate route-vs-pull-vs-recompute against the "
                        "prefix-cache cost model (workers must publish with "
                        "--global-prefix-cache for pulls to hit)")
    p.add_argument("--model", default="tiny-llama",
                   help="model preset/path the cost model prices prefill for")
    p.add_argument("--device-kind", default="tpu v5",
                   help="worker accelerator kind for the cost model "
                        "(obs/costmodel.py HW_SPECS key, e.g. 'tpu v5')")
    p.add_argument("--kv-dtype", choices=["bfloat16", "int8", "int4"],
                   default="bfloat16",
                   help="workers' KV cache dtype — sets the wire bytes the "
                        "arbiter charges per pulled block")
    return p.parse_args(argv)


async def amain(ns: argparse.Namespace) -> None:
    cfg = RuntimeConfig.from_settings(coordinator_url=ns.coordinator)
    rt = await DistributedRuntime.create(cfg)
    assert rt.client is not None

    prefix_cost = None
    if ns.global_prefix_cache:
        from dynamo_tpu_torch.kvbm.metrics import install_prefix_cache_metrics
        from dynamo_tpu_torch.models.config import resolve_model_config
        from dynamo_tpu_torch.obs.costmodel import hw_spec_for, prefix_cache_cost

        install_prefix_cache_metrics(rt.metrics)  # route_decisions on /metrics
        prefix_cost = prefix_cache_cost(
            resolve_model_config(ns.model), hw_spec_for(ns.device_kind),
            block_size=ns.block_size, kv_dtype=ns.kv_dtype)
        log.info("prefix-cache arbitration on: break-even %.1f blocks "
                 "(%s, %s, kv %s)", prefix_cost.break_even_blocks(),
                 ns.model, ns.device_kind, ns.kv_dtype)

    target_client = await EndpointClient.create(rt, EndpointId.parse(ns.target))
    router = await KvPushRouter.create(target_client, KvRouterConfig(
        block_size=ns.block_size,
        overlap_weight=ns.overlap_weight,
        temperature=ns.temperature,
        sync_replicas=ns.sync_replicas,
        use_approx_indexer=ns.use_approx,
        snapshot_interval_s=ns.snapshot_interval,
        prefix_cost=prefix_cost,
    ))

    async def handler(payload: dict, ctx: RequestContext):
        if ctx.deadline_ts is None and isinstance(payload, dict):
            # QoS deadline from the request annotations: expired work is
            # dropped at the routing hop instead of being forwarded.
            from dynamo_tpu_torch.qos.deadline import deadline_of

            ctx.deadline_ts = deadline_of(payload.get("annotations"))
        if ctx.is_expired():
            yield {"token_ids": [], "finish_reason": "cancelled"}
            return
        async for item in router.generate(payload):
            if ctx.is_cancelled():
                return
            yield item

    ep = rt.namespace(ns.namespace).component(ns.component).endpoint(ns.endpoint)
    await ep.serve(handler)
    # Fleet aggregator discovery: the router's metrics (route_decisions etc.)
    # live on its status server when DYN_SYSTEM_ENABLED is set.
    await rt.advertise_metrics("router")
    log.info("router ready: %s -> %s", ns.endpoint, ns.target)
    print(f"ROUTER_READY target={ns.target}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    log.info("router draining")
    await router.close()
    await rt.shutdown()


def main() -> None:
    configure_logging()
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
