"""Frontend process: HTTP ingress + model discovery + routed pipeline.

Fills the role of the reference's ``python -m dynamo.frontend``
(reference: components/src/dynamo/frontend/main.py + the ModelWatcher flow,
lib/llm/src/discovery/watcher.rs:50 and build_routed_pipeline,
entrypoint/input/common.rs:259): watch the model registry; when a model
appears, build preprocessor → migration → (kv|round-robin) router pipeline
and expose it at /v1/*; when its last instance vanishes, remove it.

Copy of ``dynamo_tpu/components/frontend.py`` over the port's HTTP
service (the OpenAI and KServe v2 REST routes). ``--encoder-endpoint``
sends a chat's images to an encode-worker pool
(``components/encode.py``). The KServe gRPC endpoint (``--grpc-port``:
grpc is not on the card's machine) is refused by name.
``python -m dynamo_tpu_torch.components.frontend --router-mode kv``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal

from dynamo_tpu_torch.frontend.migration import Migration
from dynamo_tpu_torch.frontend.model_manager import ModelManager
from dynamo_tpu_torch.frontend.service import HttpService
from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults
from dynamo_tpu_torch.protocols.common import LLMEngineOutput
from dynamo_tpu_torch.router.kv_router import KvPushRouter, KvRouterConfig
from dynamo_tpu_torch.runtime.client import EndpointClient, PushRouter, RouterMode
from dynamo_tpu_torch.runtime.pipeline import MapOutput, link
from dynamo_tpu_torch.runtime.protocols import MODEL_PREFIX, EndpointId
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
from dynamo_tpu_torch.tokenizer import load_tokenizer
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("frontend.main")


def make_ckpt_lookup(rt: DistributedRuntime):
    """Async stream-checkpoint lookup for the Migration operator.

    Discovers the G4 remote store lazily on first use (the store may
    advertise after the frontend starts) and runs the blocking record
    fetch off-loop. Any failure degrades to None — Migration then falls
    back to the plain reprompt path, never blocking recovery on the
    checkpoint plane. The store client is imported here, not in the first
    lookup: it brings torch (seconds on a card's host), and that import
    would block the event loop, watches included, while streams migrate
    (``amain`` imports it before the runtime starts)."""
    from dynamo_tpu_torch.kvbm.remote import ckpt_client, discover_store

    state: dict = {"pool": None}

    async def lookup(request_id: str) -> dict | None:
        try:
            if state["pool"] is None:
                addr = await discover_store(rt.client)
                if addr is None:
                    return None
                state["pool"] = ckpt_client(addr)
            pool = state["pool"]
            return await asyncio.get_running_loop().run_in_executor(
                None, pool.get_stream_ckpt, request_id)
        except Exception:  # noqa: BLE001 - store down ≠ recovery down
            state["pool"] = None  # re-discover next time
            log.exception("stream-checkpoint store lookup failed")
            return None

    return lookup


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo-frontend")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--router-mode", choices=["kv", "round_robin", "random"], default="kv")
    p.add_argument("--kv-overlap-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    p.add_argument("--migration-limit", type=int, default=3)
    p.add_argument("--grpc-port", type=int, default=None,
                   help="KServe v2 gRPC (refused by the port: not queued, "
                        "grpc is not on the card's machine)")
    p.add_argument("--tls-cert", default=None,
                   help="PEM certificate chain; serves HTTPS")
    p.add_argument("--tls-key", default=None, help="PEM private key")
    p.add_argument("--encoder-endpoint", default=None,
                   help="encode-worker endpoint for chat images, e.g. "
                        "dyn://dynamo.encoder.encode")
    # QoS gateway (qos/): admission control + load shedding.
    p.add_argument("--no-qos", action="store_true",
                   help="disable the QoS gateway entirely")
    p.add_argument("--qos-default-priority", default="standard",
                   choices=["interactive", "standard", "batch"],
                   help="priority class when the request carries none")
    p.add_argument("--qos-rate-limit-rps", type=float, default=0.0,
                   help="per-client token-bucket refill rate (0 = off)")
    p.add_argument("--qos-rate-burst", type=float, default=10.0,
                   help="per-client token-bucket burst size")
    p.add_argument("--qos-degrade-queue-depth", type=int, default=16,
                   help="queue depth at which max_tokens is clamped and "
                        "speculative decode disabled")
    p.add_argument("--qos-shed-queue-depth", type=int, default=32,
                   help="queue depth at which batch-class requests get 429")
    p.add_argument("--qos-max-queue-depth", type=int, default=64,
                   help="queue depth above which only interactive admits")
    p.add_argument("--qos-clamp-max-tokens", type=int, default=256,
                   help="max_tokens ceiling applied under degradation")
    p.add_argument("--qos-default-deadline-ms", type=float, default=None,
                   help="deadline budget assigned to requests without one")
    return p.parse_args(argv)


def check_frontend_args(ns: argparse.Namespace) -> None:
    """Raise on a frontend setting the torch port does not carry, naming
    why."""
    later = {
        "--grpc-port (KServe gRPC: not queued, grpc is not on the card's machine)":
            ns.grpc_port is not None,
    }
    missing = [name for name, hit in later.items() if hit]
    if missing:
        raise SystemExit("not supported by the torch port's frontend yet: "
                         + "; ".join(missing))


def qos_config_from_args(ns: argparse.Namespace):
    """Build the gateway config from --qos-* flags (None when --no-qos)."""
    from dynamo_tpu_torch.qos import QosConfig

    if getattr(ns, "no_qos", False):
        return QosConfig(enabled=False)
    return QosConfig(
        default_priority=ns.qos_default_priority,
        rate_limit_rps=ns.qos_rate_limit_rps,
        rate_burst=ns.qos_rate_burst,
        degrade_queue_depth=ns.qos_degrade_queue_depth,
        shed_queue_depth=ns.qos_shed_queue_depth,
        max_queue_depth=ns.qos_max_queue_depth,
        full_queue_depth=2 * ns.qos_max_queue_depth,
        clamp_max_tokens=ns.qos_clamp_max_tokens,
        default_deadline_ms=ns.qos_default_deadline_ms,
    )


class ModelWatcher:
    """Watches dyn/models/ and (un)registers per-model pipelines.

    A model whose last instance goes away leaves the model list at once,
    but its pipeline (endpoint client, router, migration operator) stays
    open for ``PARK_S`` seconds: a stream that was migrating off the dead
    instance keeps waiting on that client, which still watches the
    endpoint, and lands on a replacement when one registers. A replacement
    within the window re-registers the model over the same pipeline. (The
    JAX copy closes the pipeline at once: such a stream then retries the
    dead instance until its migration limit, and fails.)"""

    #: seconds a model's pipeline outlives its last instance
    PARK_S = 60.0

    def __init__(self, rt: DistributedRuntime, models: ModelManager, ns: argparse.Namespace):
        self.rt = rt
        self.models = models
        self.args = ns
        self.lookup_ckpt = None    # set by amain (stream-ckpt warm resume)
        self.image_encoder = None  # set by amain when --encoder-endpoint
        self._instances: dict[str, set[str]] = {}   # model -> instance keys
        # model -> (client, router, generate, stats_fn)
        self._pipelines: dict[str, tuple] = {}
        self._parked: dict[str, tuple] = {}          # model -> (pipeline, close task)
        self._task: asyncio.Task | None = None
        self._sweep_task: asyncio.Task | None = None

    async def start(self) -> None:
        assert self.rt.client is not None
        watch = await self.rt.client.watch_prefix(MODEL_PREFIX + "/")
        self._task = asyncio.create_task(self._loop(watch))

    async def _loop(self, watch) -> None:
        async for ev in watch:
            log.debug("model watch event: %s %s", ev.op, ev.key)
            try:
                if ev.op == "reset":
                    # Coordinator reconnect: keep pipelines (they would only
                    # churn), but forget the instance bookkeeping — the
                    # replay re-populates it for live workers. Workers that
                    # died DURING the outage produce neither replay nor
                    # delete events (the restarted coordinator never knew
                    # them), so sweep still-empty models after workers have
                    # had time to re-register.
                    self._instances.clear()
                    if self._sweep_task is None or self._sweep_task.done():
                        self._sweep_task = asyncio.create_task(
                            self._sweep_stale_models())
                    continue
                # key: dyn/models/{name}/{instance}
                _, _, rest = ev.key.partition(MODEL_PREFIX + "/")
                # rpartition: a served name may hold "/" (a local path, a hub
                # id); the instance id is the last segment
                name, _, inst = rest.rpartition("/")
                if ev.op == "put":
                    card = json.loads(ev.value)
                    known = self._instances.setdefault(name, set())
                    known.add(inst)
                    if name not in self._pipelines:
                        await self._add_model(name, card)
                elif ev.op == "delete":
                    known = self._instances.get(name)
                    if known:
                        known.discard(inst)
                        if not known:
                            await self._remove_model(name)
            except Exception:
                log.exception("model watch event failed: %s", ev)

    @staticmethod
    def _validated_parsers(card: dict) -> tuple[str | None, str | None]:
        """Validate parser names from the card up front (before any client
        is created — a bad name must not leak an EndpointClient per watch
        event). Invalid names degrade to no-parser with an error log."""
        from dynamo_tpu_torch.parsers import get_reasoning_parser, get_tool_parser

        tool, reasoning = card.get("tool_call_parser"), card.get("reasoning_parser")
        try:
            if tool:
                get_tool_parser(tool)
        except ValueError:
            log.error("invalid tool_call_parser %r in model card; disabling", tool)
            tool = None
        try:
            if reasoning:
                get_reasoning_parser(reasoning)
        except ValueError:
            log.error("invalid reasoning_parser %r in model card; disabling", reasoning)
            reasoning = None
        return tool, reasoning

    async def _add_model(self, name: str, card: dict) -> None:
        tool_parser, reasoning_parser = self._validated_parsers(card)
        endpoint = EndpointId.parse("dyn://" + card["endpoint"])
        parked = self._parked.pop(name, None)
        if parked is not None:
            pipe, closer = parked
            closer.cancel()
            if pipe[0].endpoint == endpoint:
                self._register(name, card, pipe, tool_parser, reasoning_parser)
                log.info("model added: %s via %s (pipeline kept)", name, endpoint)
                return
            await self._close_pipeline(pipe)
        log.debug("add_model %s: creating endpoint client", name)
        client = await EndpointClient.create(self.rt, endpoint)
        log.debug("add_model %s: endpoint client ready", name)
        mode = self.args.router_mode
        if mode == "kv" and card.get("kv_events", True):
            log.debug("add_model %s: creating kv router", name)
            router = await KvPushRouter.create(client, KvRouterConfig(
                block_size=card.get("block_size", 16),
                overlap_weight=self.args.kv_overlap_weight,
                temperature=self.args.router_temperature,
            ))
            routed = router.generate
        else:
            push = PushRouter(client=client, mode=RouterMode(
                mode if mode != "kv" else "round_robin"))
            router = push

            async def routed(req):
                # Resolve the instance BEFORE streaming so a silently
                # truncated stream (no ERR frame) can still be attributed
                # to — and quarantine — the serving worker (Migration reads
                # ``last_instance_id`` off the request).
                iid = push.pick()
                req.last_instance_id = iid
                async for item in push.generate(req.to_dict(), req.request_id,
                                                instance_id=iid):
                    yield item

        # The routed model pipeline as a typed operator chain (reference:
        # build_routed_pipeline, entrypoint/input/common.rs:259). Stream
        # direction runs sink→left, so the decode stage is leftmost: the
        # migration operator retries over raw wire dicts, the consumer
        # receives LLMEngineOutput.
        pipeline = link(
            MapOutput(LLMEngineOutput.from_dict),
            Migration(migration_limit=self.args.migration_limit,
                      wait_ready=client.wait_for_instances,
                      on_instance_error=client.quarantine,
                      lookup_ckpt=self.lookup_ckpt),
            sink=routed,
        )
        generate = pipeline.generate

        def stats_fn(client=client, router=router) -> dict:
            # Worker-published engine stats (incl. KVBM tiers) relayed over
            # the load_metrics subject — the distributed view behind
            # /engine_stats (reference: ForwardPassMetrics over NATS).
            out: dict = {"instances": [f"{i:x}" for i in client.known_instance_ids()]}
            if isinstance(router, KvPushRouter):
                out["workers"] = {f"{wid:x}": m
                                  for wid, m in router.router.worker_metrics.items()}
                out["router"] = router.routing_stats()
            return out

        self._register(name, card, (client, router, generate, stats_fn), tool_parser,
                       reasoning_parser)
        log.info("model added: %s via %s (router=%s)", name, endpoint, mode)

    def _register(self, name: str, card: dict, pipe: tuple, tool_parser,
                  reasoning_parser) -> None:
        _, _, generate, stats_fn = pipe
        self.models.register(
            name, load_tokenizer(card.get("tokenizer")), generate,
            defaults=ModelDefaults(max_model_len=card.get("max_model_len", 8192)),
            stats=stats_fn,
            tool_parser=tool_parser,
            reasoning_parser=reasoning_parser,
            image_encoder=self.image_encoder,
        )
        self._pipelines[name] = pipe

    async def _sweep_stale_models(self, settle_s: float = 10.0) -> None:
        """Post-reset: models whose workers never re-registered within the
        settle window are gone for good — unregister them (no delete event
        will ever arrive for keys the restarted coordinator never held)."""
        await asyncio.sleep(settle_s)
        for name in list(self._pipelines):
            if not self._instances.get(name):
                log.warning("model %s has no instances after coordinator "
                            "reconnect settle; removing", name)
                await self._remove_model(name)

    async def _remove_model(self, name: str) -> None:
        self.models.unregister(name)
        pipe = self._pipelines.pop(name, None)
        if pipe:
            # parked, not closed: a migrating stream keeps a watching client
            self._parked[name] = (pipe, asyncio.create_task(self._close_parked(name)))
        log.info("model removed: %s", name)

    async def _close_parked(self, name: str) -> None:
        await asyncio.sleep(self.PARK_S)
        pipe, _ = self._parked.pop(name)
        await self._close_pipeline(pipe)

    @staticmethod
    async def _close_pipeline(pipe: tuple) -> None:
        client, router = pipe[:2]
        if hasattr(router, "close"):
            await router.close()
        await client.close()


async def amain(ns: argparse.Namespace) -> None:
    check_frontend_args(ns)
    # The checkpoint lookup's store client imports torch: import it before
    # the runtime grants the lease, whose keepalives the import would stall.
    import dynamo_tpu_torch.kvbm.remote  # noqa: F401
    cfg = RuntimeConfig.from_settings(coordinator_url=ns.coordinator)
    rt = await DistributedRuntime.create(cfg)
    models = ModelManager()
    watcher = ModelWatcher(rt, models, ns)
    if ns.encoder_endpoint:
        # Multimodal: images route to the encode worker pool; embedding
        # tensors come back over the data plane.
        import uuid as _uuid

        from dynamo_tpu_torch.protocols.common import tensor_from_wire

        enc_client = await EndpointClient.create(
            rt, EndpointId.parse(ns.encoder_endpoint))
        enc_push = PushRouter(client=enc_client, mode=RouterMode("round_robin"))

        async def image_encoder(imgs: list[bytes]):
            async for item in enc_push.generate(
                    {"images": list(imgs)}, _uuid.uuid4().hex):
                if item.get("error"):
                    # worker-side client error (bad image bytes) → the
                    # HTTP layer maps ValueError to 400, not 502
                    raise ValueError(item["error"])
                embs = item.get("embeddings")
                if embs is None:
                    raise RuntimeError(f"bad encoder response: {item}")
                try:
                    return [tensor_from_wire(e) for e in embs]
                except Exception as exc:  # noqa: BLE001 - replica bug/skew
                    # malformed tensor envelopes are an infrastructure
                    # fault (502), never the client's image
                    raise RuntimeError(
                        f"undecodable encoder payload: {exc}") from exc
            raise RuntimeError("encoder returned no response")

        watcher.image_encoder = image_encoder
    # Crash recovery: broken streams first try an exact warm resume from
    # the shared stream-checkpoint store (kvbm/stream_ckpt.py).
    watcher.lookup_ckpt = make_ckpt_lookup(rt)
    await watcher.start()
    svc = HttpService(models, qos=qos_config_from_args(ns))
    # Recovery counters live next to the request counters they balance
    # against (InvariantChecker reads both from one /metrics scrape).
    from dynamo_tpu_torch.frontend.migration import install_migration_metrics
    from dynamo_tpu_torch.kvbm.stream_ckpt import install_stream_ckpt_metrics

    install_migration_metrics(svc.metrics)
    # Frontend-side stream-ckpt counters (TTL-expired records surface on
    # the lookup path, next to the resume outcomes they explain).
    install_stream_ckpt_metrics(svc.metrics)
    from dynamo_tpu_torch import chaos

    if chaos.enabled():
        from dynamo_tpu_torch.chaos.metrics import install_chaos_metrics

        install_chaos_metrics(svc.metrics)
    port = await svc.start(ns.host, ns.port,
                           tls_cert=ns.tls_cert, tls_key=ns.tls_key)
    # Fleet aggregator discovery: the frontend's /metrics lives on its HTTP
    # service port, not a status server — advertise that (lease-bound).
    scheme = "https" if ns.tls_cert else "http"
    await rt.advertise_metrics(
        "frontend", f"{scheme}://{rt.advertise_address.split(':')[0]}:{port}")
    log.info("frontend ready on :%d (router=%s)", port, ns.router_mode)
    print(f"FRONTEND_READY port={port}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await svc.stop()
    await rt.shutdown()


def main() -> None:
    import faulthandler

    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks
    configure_logging()
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
