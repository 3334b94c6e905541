"""Worker process: serve an engine (torch | mocker) on the distributed runtime.

Fills the role of the reference's engine worker components
(reference: components/src/dynamo/vllm/main.py init flow + mocker/main.py):
connect runtime → build engine with KV-event publishing → register model
card → serve_endpoint → publish metrics.
``python -m dynamo_tpu_torch.components.worker --device cpu ...``; without
``--device`` the engine runs on the CUDA card and raises when there is none.

Copy of ``dynamo_tpu/components/worker.py``. ``--engine mocker`` serves the
mocker (mocker/engine.py: no tensor, no card, the torch engine's modules
never imported), which the chaos harness and the fleet tests run.
``--disagg prefill`` serves the prefill half of disaggregated serving (a
``KvTransferSource`` and a ``PrefillHandler``; no model card), ``--disagg
decode`` the decode half (a ``DisaggDecodeHandler`` over a KV-aware or
round-robin router of the prefill pool; disagg/), at any ``--tp`` or
``--pp`` (the leader hands off whole blocks). Multi-host engines and ``--disagg`` on the
mocker are refused by name (:func:`check_worker_args`); so is whatever the engine's
``check_supported`` refuses. The published stats carry the paged-attention
launches by route, the forward steps they ran in and the card's peak
allocated bytes (``"attention"``), which a process that cannot read this
one's counters checks launches against, and the KV handoff's bytes and
seconds by phase (``"kv_transfer"``).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import signal

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.runtime.protocols import MODEL_PREFIX
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime, RequestContext
from dynamo_tpu_torch.utils.config import EngineConfig, RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("worker")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo-worker")
    p.add_argument("--engine", choices=["torch", "mocker"], default="torch")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (cpu runs the "
                        "plain attention path, for tests)")
    p.add_argument("--model", default="tiny-llama")
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="serve the model at this dtype instead of its own "
                        "(float32: f32 weights over the f32 KV cache)")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--tool-call-parser", default=None)
    p.add_argument("--reasoning-parser", default=None)
    p.add_argument("--num-blocks", type=int, default=0)
    p.add_argument("--max-batch-size", type=int, default=32)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                   help="torch.distributed backend of --tp/--pp/--ep/--dp ranks: nccl takes one "
                        "card a rank; ranks that share a card need gloo")
    p.add_argument("--tp-devices", default=None,
                   help="comma-separated card index of each rank (default rank r on "
                        "cuda:r); ranks that share a card need --dist-backend gloo "
                        "and an explicit --num-blocks")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (layer blocks and their KV cache sharded over "
                        "'pipe', a rank a stage; composes with --dp only)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas within ONE engine ('data' axis)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel shards ('expert' axis; MoE models: the "
                        "experts split over ep ranks, the dropless dispatch)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel shards ('seq' axis; ring attention)")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="serve RANDOM weights when the model path has no "
                        "loadable safetensors (tests/benches only)")
    p.add_argument("--spec-ngram", type=int, default=0,
                   help="n-gram speculative decoding: propose continuations "
                        "of the trailing n-gram, verify in one pass "
                        "(greedy-exact; 0 = off)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="max proposed tokens per verify step")
    p.add_argument("--decode-window", type=int, default=1,
                   help="decode steps fused per device dispatch")
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="prefill chunk tokens per step; 0 = SLO-driven auto "
                        "sizing (largest per-QoS chunk keeping predicted "
                        "decode ITL inside --itl-slo-ms)")
    p.add_argument("--itl-slo-ms", type=float, default=50.0,
                   help="decode ITL SLO budget for --prefill-chunk 0 auto "
                        "sizing (interactive 1x, standard 2x, batch 4x)")
    p.add_argument("--no-unified-step", action="store_true",
                   help="dispatch decode and prefill chunks as the legacy "
                        "two XLA launches instead of one ragged mixed step")
    p.add_argument("--quantization", choices=["none", "int8"], default="none",
                   help="weight-only quantization (int8: per-channel scales, "
                        "bf16 compute; halves decode HBM traffic)")
    p.add_argument("--kv-dtype", choices=["bfloat16", "int8", "int4"],
                   default="bfloat16",
                   help="paged KV cache storage dtype (int8: per-block-per-"
                        "head scales, in-kernel dequant; halves KV bytes so "
                        "auto-sizing fits ~2x the blocks; int4: packed "
                        "nibbles, quarter bytes / ~4x blocks, even head_dim)")
    p.add_argument("--session-ttl", type=float, default=0.0,
                   help="session-sticky KV retention: seconds a finished "
                        "session's committed blocks stay pinned so the next "
                        "turn prefills only the suffix (0 = off)")
    p.add_argument("--no-session-tiers", action="store_true",
                   help="skip staging expired session KV down the KVBM tier "
                        "ladder before unpinning")
    p.add_argument("--ring-prefill-threshold", type=int, default=0,
                   help="sp>1 only: min prompt tokens for ring prefill "
                        "(0 = cost-model break-even, -1 = never); the port "
                        "refuses sp > 1 (ROADMAP item 14)")
    p.add_argument("--stream-ckpt-blocks", type=int, default=0,
                   help="crash-consistent stream checkpoints: every N "
                        "committed decode blocks (and once at prefill "
                        "completion) flush the stream's KV + a resumable "
                        "record to the G4 remote store so a worker kill "
                        "costs at most one interval of recompute; cadence "
                        "QoS-degrades (interactive 1x, standard 2x, batch "
                        "4x). 0 = off; needs --remote-kv-addr")
    p.add_argument("--warmup-mode", choices=["off", "lazy", "full"],
                   default="lazy",
                   help="compile ledger / CUDA-graph bucket warmup: off = "
                        "no ledger, lazy = capture on first use against the "
                        "enumerated lattice, full = capture the reachable "
                        "bucket lattice before the endpoint serves "
                        "(readiness waits for it)")
    p.add_argument("--warmup-deadline", type=float, default=120.0,
                   help="full-mode warmup wall-seconds budget; lattice "
                        "entries past the deadline stay cold and show as "
                        "warmup coverage < 1.0 (0 = unbounded)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--speedup-ratio", type=float, default=10.0, help="mocker only")
    p.add_argument("--vocab-size", type=int, default=32000,
                   help="mocker only: bound on synthesized token ids; values "
                        "<= 260 keep every id inside the ByteTokenizer's "
                        "byte range so completion text round-trips")
    p.add_argument("--no-kv-events", action="store_true")
    p.add_argument("--health-interval", type=float, default=5.0,
                   help="idle seconds before a health canary replays through "
                        "the handler (reference: health_check.rs); 0 disables")
    p.add_argument("--wedgeable", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--drain-deadline", type=float, default=30.0,
                   help="retirement: seconds in-flight streams get to finish "
                        "after SIGTERM / a planner drain request before "
                        "being force-stopped (runtime/drain.py)")
    p.add_argument("--drain-batch-grace", type=float, default=None,
                   help="retirement: seconds before batch-class streams are "
                        "early-stopped during a drain (default: half the "
                        "deadline)")
    p.add_argument("--chaos-plan", default=None,
                   help="enable deterministic fault injection: a ChaosPlan "
                        "JSON file path or inline JSON (docs/CHAOS.md); "
                        "equivalent to DYN_CHAOS_PLAN")
    p.add_argument("--chaos-seed", type=int, default=None,
                   help="override the chaos plan's seed (DYN_CHAOS_SEED)")
    p.add_argument("--host-kv-blocks", type=int, default=0, help="G2 host KV tier capacity")
    p.add_argument("--disk-kv-path", default=None, help="G3 disk KV tier directory")
    p.add_argument("--remote-kv-addr", default=None,
                   help="G4 remote block store host:port ('auto' = discover "
                        "via the coordinator)")
    p.add_argument("--global-prefix-cache", action="store_true",
                   help="fleet-wide prefix cache: publish committed prefix "
                        "blocks to the G4 remote store so cold workers can "
                        "import instead of recomputing (needs "
                        "--remote-kv-addr)")
    # Disaggregated serving (reference: vllm decode-first pattern).
    p.add_argument("--disagg", choices=["none", "prefill", "decode"], default="none")
    p.add_argument("--prefill-endpoint", default="dyn://dynamo.prefill.generate",
                   help="decode mode: where the prefill pool lives")
    p.add_argument("--prefill-router", choices=["kv", "round-robin"], default="kv",
                   help="decode mode: prefix-aware (KvPushRouter) or plain "
                        "round-robin dispatch over the prefill pool; use "
                        "round-robin when --prefill-endpoint points at a "
                        "standalone router, which is KV-aware itself")
    p.add_argument("--no-kv-stream", action="store_true",
                   help="disable chunk-streamed KV handoff on a prefill "
                        "worker (fall back to one staged transfer at end "
                        "of prefill)")
    p.add_argument("--kv-transfer-ttl", type=float, default=60.0,
                   help="seconds a KV transfer may sit without progress "
                        "(registration, wave, or pull) before its pins are "
                        "released")
    p.add_argument("--min-prefill-blocks", type=int, default=2,
                   help="decode mode: prompt blocks below which prefill stays local")
    # Multi-host engine (reference: lib/llm/src/engines.rs:29-44 MultiNodeConfig).
    p.add_argument("--multihost-group", default=None,
                   help="rendezvous group for multi-host ranks (default: "
                        "namespace.component; MUST differ across replicas "
                        "of one component)")
    p.add_argument("--num-nodes", type=int, default=1,
                   help="processes forming ONE SPMD engine (1 = single-host)")
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument("--leader-addr", default=None,
                   help="multi-host only (refused by the port)")
    return p.parse_args(argv)


def check_worker_args(ns: argparse.Namespace) -> None:
    """Raise on a worker setting the torch port does not carry yet, naming
    the ROADMAP item that brings it."""
    if ns.disagg != "none" and ns.engine != "torch":
        raise SystemExit("--disagg requires --engine torch (KV handoff needs a real cache)")
    later = {
        "--num-nodes > 1 (multi-host engines: ROADMAP item 14)": ns.num_nodes > 1,
    }
    missing = [name for name, hit in later.items() if hit]
    if missing:
        raise SystemExit("not supported by the torch port's worker yet: "
                         + "; ".join(missing))


def override_dtype(model: str, dtype: str) -> None:
    """Serve ``model`` (a preset or a checkpoint path) at ``dtype`` in this
    process: its config is registered as a preset under the same name, so
    the served name and the weights' source stay the model's own (random
    weights are drawn at ``dtype`` from the same seed)."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS, resolve_model_config

    MODEL_PRESETS[model] = dataclasses.replace(resolve_model_config(model), dtype=dtype)


def engine_config(ns: argparse.Namespace, remote_kv: str | None) -> EngineConfig:
    """The engine settings the worker's flags give."""
    return EngineConfig(
        model=ns.model,
        block_size=ns.block_size,
        num_blocks=ns.num_blocks,
        max_batch_size=ns.max_batch_size,
        max_model_len=ns.max_model_len,
        tp=ns.tp,
        dist_backend=ns.dist_backend,
        tp_devices=tuple(int(d) for d in ns.tp_devices.split(",")) if ns.tp_devices else (),
        pp=ns.pp,
        dp=ns.dp,
        ep=ns.ep,
        sp=ns.sp,
        decode_window=ns.decode_window,
        prefill_chunk=ns.prefill_chunk,
        itl_slo_ms=ns.itl_slo_ms,
        unified_step=not ns.no_unified_step,
        quantization=ns.quantization,
        kv_dtype=ns.kv_dtype,
        spec_ngram=ns.spec_ngram,
        spec_k=ns.spec_k,
        allow_random_weights=ns.allow_random_weights,
        host_kv_blocks=ns.host_kv_blocks,
        disk_kv_path=ns.disk_kv_path,
        remote_kv_addr=remote_kv,
        global_prefix_cache=ns.global_prefix_cache,
        session_ttl=ns.session_ttl,
        session_tiers=not ns.no_session_tiers,
        stream_ckpt_blocks=ns.stream_ckpt_blocks,
        warmup_mode=ns.warmup_mode,
        warmup_deadline=ns.warmup_deadline,
    )


def attention_stats(core) -> dict:
    """Paged-attention launches by route since the process started, the
    forward steps of every step program's calls (a fused window counts
    its steps; launches inside a program's capture are counted through its
    calls), the model's layers, and the card's peak allocated bytes (0 on
    the CPU, where no kernel launches)."""
    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa

    # list(): the engine thread may add a program while this runs
    steps = sum(p.calls * (p.shape[3] if len(p.shape) > 3 else 1)
                for p in list(core.runner.programs.values()))
    dev = core.runner.device
    return {
        "launches": dict(pa.paged_attention.launches_by_kernel),
        "forward_steps": int(steps),
        "layers": int(core.model_cfg.num_layers),
        "max_memory_allocated": int(torch.cuda.max_memory_allocated(dev))
        if dev.type == "cuda" else 0,
    }


def kv_transfer_stats(core) -> dict:
    """The KV handoff's phases on this worker: the block mover's extracts
    (the prefill side's stage: D2H) with the waits on a step in flight, and
    its injects (the decode side's import: H2D and scatter), the pulls'
    network half (fetch + assemble on the decode side), and the blocks the
    staging pins hold now."""
    return {**core.transfer.stats.snapshot(), "pull": dict(core.pull_stats),
            "staged_pins": sum(len(v) for v in list(core._staged_pins.values()))}


def model_card(ns: argparse.Namespace, name: str) -> dict:
    """ModelDeploymentCard-equivalent (reference: lib/llm/src/model_card.rs:91)."""
    return {
        "name": name,
        "endpoint": f"{ns.namespace}.{ns.component}.{ns.endpoint}",
        "tokenizer": ns.tokenizer or ns.model,
        "block_size": ns.block_size,
        "max_model_len": ns.max_model_len,
        "kv_events": not ns.no_kv_events,
        "tool_call_parser": ns.tool_call_parser,
        "reasoning_parser": ns.reasoning_parser,
    }


async def amain(ns: argparse.Namespace) -> None:
    check_worker_args(ns)
    if ns.served_model_name is None:
        ns.served_model_name = ns.model
    if ns.engine != "mocker":
        # Hub repo ids resolve to a local snapshot (a GGUF-only one to its
        # file) before anything else reads the model string (the card's
        # tokenizer, the engine's weights); the served name stays the
        # user-given id.
        from dynamo_tpu_torch.models.hub import resolve_model_path

        ns.model = resolve_model_path(ns.model)
    if ns.dtype is not None:
        override_dtype(ns.model, ns.dtype)
    if ns.chaos_plan is not None:
        # CLI mirror of DYN_CHAOS_PLAN/DYN_CHAOS_SEED (docs/CHAOS.md).
        chaos.configure(ns.chaos_plan, seed=ns.chaos_seed)
    # Import the engine's modules before the runtime grants the lease: an
    # import blocks the event loop (torch's takes seconds on a card's host),
    # and a lease whose keepalives stall past its TTL dies before the
    # endpoint registers (the mocker's store client brings torch too).
    if ns.engine == "mocker":
        from dynamo_tpu_torch.mocker.engine import MockEngine, MockEngineArgs

        if ns.remote_kv_addr:
            import dynamo_tpu_torch.kvbm.remote  # noqa: F401
    else:
        from dynamo_tpu_torch.engine.engine import build_engine
        from dynamo_tpu_torch.obs.profiler import install_perf_metrics
    cfg = RuntimeConfig.from_settings(coordinator_url=ns.coordinator)
    rt = await DistributedRuntime.create(cfg)
    assert rt.client is not None and rt.primary_lease is not None
    if chaos.enabled():
        from dynamo_tpu_torch.chaos.metrics import install_chaos_metrics

        install_chaos_metrics(rt.metrics)

    if rt.status_server is not None:
        # NotReady until the endpoint actually serves — model loading can
        # take minutes and a readiness probe must not pass before it.
        rt.status_server.ready = False

    publisher = None
    if not ns.no_kv_events:
        publisher = KvEventPublisher(
            rt.client, ns.namespace, ns.component, worker_id=rt.instance_id)
        publisher.start()
    sink = publisher.sink if publisher else None

    # Resolve the G4 remote store address once.
    remote_kv = ns.remote_kv_addr
    if remote_kv == "auto":
        from dynamo_tpu_torch.kvbm.remote import discover_store

        remote_kv = await discover_store(rt.client)
        if remote_kv is None:
            log.warning("--remote-kv-addr auto: no store advertised; "
                        "continuing without a G4 tier")
    if ns.host_kv_blocks or ns.disk_kv_path or remote_kv:
        from dynamo_tpu_torch.kvbm.metrics import install_prefix_cache_metrics

        # KVBM tiers feed dynamo_prefix_cache_* (kvbm/metrics.py); re-home
        # the singleton so /metrics exposes hit/import/publish counters.
        install_prefix_cache_metrics(rt.metrics)
    if ns.session_ttl > 0:
        from dynamo_tpu_torch.engine.session import install_session_metrics

        # Session retention feeds dynamo_session_* (engine/session.py).
        install_session_metrics(rt.metrics)
    if ns.stream_ckpt_blocks > 0:
        from dynamo_tpu_torch.kvbm.stream_ckpt import install_stream_ckpt_metrics

        # Crash checkpoints feed dynamo_stream_ckpt_* (kvbm/stream_ckpt.py).
        install_stream_ckpt_metrics(rt.metrics)
    if ns.warmup_mode != "off":
        from dynamo_tpu_torch.obs.compile_ledger import install_compile_metrics

        # Compile ledger feeds its dynamo_* family (obs/compile_ledger.py).
        install_compile_metrics(rt.metrics)
    from dynamo_tpu_torch.obs.sched_ledger import install_sched_metrics

    # Scheduling ledger feeds dynamo_sched_* (goodput, padding waste, HOL
    # stalls — obs/sched_ledger.py).
    install_sched_metrics(rt.metrics)
    from dynamo_tpu_torch.obs.mem_ledger import install_mem_metrics

    # Memory ledger feeds dynamo_mem_* (occupancy waterfall, pin-leak
    # audit, TTX forecast — obs/mem_ledger.py).
    install_mem_metrics(rt.metrics)

    if ns.engine == "mocker":
        engine = MockEngine(MockEngineArgs(
            num_blocks=ns.num_blocks or 512,
            block_size=ns.block_size,
            max_batch_size=ns.max_batch_size,
            max_model_len=ns.max_model_len,
            speedup_ratio=ns.speedup_ratio,
            vocab_size=ns.vocab_size,
            remote_kv_addr=remote_kv,
            global_prefix_cache=ns.global_prefix_cache,
            session_ttl=ns.session_ttl,
            stream_ckpt_blocks=ns.stream_ckpt_blocks,
            warmup_mode=ns.warmup_mode,
        ), event_sink=sink)
        # the mocker files the lattice in its compile ledger (no real
        # captures): full mode before the endpoint serves, as a real engine
        warm = engine.warmup() if ns.warmup_mode != "off" else None
    else:
        # The engine feeds the dynamo_engine_perf_* family (MFU, HBM-BW
        # utilization, roofline fraction — obs/profiler.py); re-home the
        # singleton into the runtime registry so /metrics exposes it.
        install_perf_metrics(rt.metrics)

        # Engine construction (weights, cache, graph warmup) blocks for
        # seconds — run off-loop so the lease keep-alive keeps ticking.
        loop = asyncio.get_running_loop()
        cfg_engine = engine_config(ns, remote_kv)
        engine = await loop.run_in_executor(None, lambda: build_engine(
            cfg_engine, device=ns.device, event_sink=sink))
        warm = engine.core.warmup_summary
    if warm:
        log.info("bucket warmup: %s", warm)

    kv_source = None            # --disagg prefill
    decode = None               # --disagg decode
    prefill_client = None
    kv_prefill_router = None

    def stats_fn() -> dict:
        if ns.engine == "mocker":
            return engine.stats()
        # the device prefix hits as a count (the engine's stats carry their
        # rate), beside the kernel launches
        out = {**engine.stats(), "attention": attention_stats(engine.core),
               "prefix_hit_blocks": engine.core.metrics.prefix_hit_blocks}
        if ns.disagg != "none":
            out["kv_transfer"] = kv_transfer_stats(engine.core)
        if decode is not None:
            out["disagg"] = {"remote_prefills": decode.remote_prefills,
                             "local_fallbacks": decode.local_fallbacks,
                             "prefill_instances": len(prefill_client.instance_ids())}
        return out

    async def handler(payload: dict, ctx: RequestContext):
        req = PreprocessedRequest.from_dict(payload)
        # QoS deadline rides the request annotations; stamping it on the
        # ctx makes every is_cancelled() poll double as deadline
        # enforcement, and an already-expired request short-circuits
        # before the engine sees it.
        from dynamo_tpu_torch.qos.deadline import deadline_of
        from dynamo_tpu_torch.obs.tracer import get_tracer, trace_context_of

        ctx.deadline_ts = ctx.deadline_ts or deadline_of(req.annotations)
        if ctx.is_expired():
            yield LLMEngineOutput(
                finish_reason=FinishReason.CANCELLED).to_dict()
            return
        # Tracing: open a dispatch span under the wire traceparent and,
        # on the FINAL delta, ship every span this process closed for
        # the trace back to the frontend (LLMEngineOutput.spans) so one
        # /debug/traces endpoint shows the cross-process timeline.
        tr = get_tracer("worker")
        tctx = trace_context_of(req.annotations)
        span = tr.start_span("worker.dispatch", ctx=tctx,
                             request_id=req.request_id,
                             model=req.model) if tctx else None
        async for out in engine.generate(req):
            if ctx.is_cancelled():
                if span is not None:
                    tr.end_span(span, status="cancelled")
                return
            d = out.to_dict()
            if out.finish_reason is not None and span is not None:
                tr.end_span(
                    span,
                    status="error" if out.error else "ok",
                    finish_reason=str(out.finish_reason))
                d["spans"] = [
                    s.to_dict()
                    for s in tr.recorder.spans_for(tctx.trace_id)]
            yield d

    if ns.disagg != "none":
        from dynamo_tpu_torch.disagg.metrics import install_kv_metrics

        install_kv_metrics(rt.metrics)
    if ns.disagg == "prefill":
        from dynamo_tpu_torch.disagg.handlers import PrefillHandler
        from dynamo_tpu_torch.disagg.source import KvTransferSource

        # shards[0] = this engine's shard server, started inside the source
        kv_source = KvTransferSource(
            engine, ttl_s=ns.kv_transfer_ttl,
            advertise_host=rt.advertise_address.rsplit(":", 1)[0])
        kv_source.start()
        prefill = PrefillHandler(engine, kv_source, block_size=ns.block_size,
                                 stream=not ns.no_kv_stream)
        handler = prefill.generate
    elif ns.disagg == "decode":
        from dynamo_tpu_torch.disagg.handlers import DisaggDecodeHandler
        from dynamo_tpu_torch.runtime.client import EndpointClient, PushRouter
        from dynamo_tpu_torch.runtime.protocols import EndpointId

        prefill_client = await EndpointClient.create(
            rt, EndpointId.parse(ns.prefill_endpoint))
        if ns.prefill_router == "kv":
            # Prefix-aware prefill dispatch: repeated prefixes land on the
            # prefill worker already holding their KV.
            from dynamo_tpu_torch.router.kv_router import KvPushRouter, KvRouterConfig

            # Each decode worker is one replica of the prefill-router fleet:
            # share load predictions (SyncedActiveSequences) so concurrent
            # decode workers don't make load-blind correlated placements,
            # and leave snapshot dumping to standalone routers.
            kv_prefill_router = await KvPushRouter.create(
                prefill_client, KvRouterConfig(
                    block_size=ns.block_size, sync_replicas=True,
                    snapshot_interval_s=0.0))

            async def prefill_call(payload, request_id):
                async for item in kv_prefill_router.generate(payload):
                    yield item
        else:
            prefill_router = PushRouter(prefill_client)

            async def prefill_call(payload, request_id):
                async for item in prefill_router.generate(payload, request_id):
                    yield item

        decode = DisaggDecodeHandler(
            engine, prefill_call, block_size=ns.block_size,
            min_prefill_blocks=ns.min_prefill_blocks)
        handler = decode.generate

    if ns.wedgeable and ns.engine == "mocker":
        # Test hook: a control payload wedges/unwedges the mock engine's
        # step loop so e2e tests can exercise canary-driven NotReady.
        inner_handler = handler

        async def handler(payload: dict, ctx: RequestContext):  # noqa: F811
            if isinstance(payload, dict) and "__wedge__" in payload:
                engine.wedged = bool(payload["__wedge__"])
                yield {"token_ids": [], "finish_reason": "stop"}
                return
            async for item in inner_handler(payload, ctx):
                yield item

    if chaos.enabled():
        # Fault point covering the dispatch path — wrapped here, under the
        # health monitor, so canaries exercise the same injected failures
        # real traffic does. Only built when a plan is active: the disabled
        # path adds no generator layer.
        chaos_inner = handler

        async def handler(payload: dict, ctx: RequestContext):  # noqa: F811
            await chaos.ainject(
                "worker.dispatch", endpoint=ns.endpoint,
                request_id=payload.get("request_id")
                if isinstance(payload, dict) else None)
            async for item in chaos_inner(payload, ctx):
                yield item

    # Health canaries (reference: lib/runtime/src/health_check.rs:20-36):
    # replay a tiny generate through the SAME handler when idle; a wedged
    # engine flips ready=False in the published metrics and the KV router
    # stops sending traffic until a canary succeeds again.
    monitor = None
    if ns.health_interval > 0:
        from dynamo_tpu_torch.runtime.health import (
            EndpointHealthMonitor,
            HealthCheckConfig,
            default_canary_payload,
            install_health_metrics,
        )

        install_health_metrics(rt.metrics)
        monitor = EndpointHealthMonitor(handler, HealthCheckConfig(
            payload=default_canary_payload(),
            idle_interval_s=ns.health_interval,
            timeout_s=max(ns.health_interval, 5.0),
        ))
        handler = monitor.handler
        base_stats = stats_fn

        def stats_fn():  # noqa: F811
            return {**base_stats(), "ready": monitor.ready}

    # While draining, published stats advertise NotReady so routers with a
    # stale membership view stop picking this worker even before the
    # instance-key DELETE propagates (kv_router health gating).
    drain_state = {"draining": False}
    inner_stats = stats_fn

    def stats_fn():  # noqa: F811
        s = dict(inner_stats())
        if drain_state["draining"]:
            s["ready"] = False
            s["draining"] = True
        return s

    ep = rt.namespace(ns.namespace).component(ns.component).endpoint(ns.endpoint)
    await ep.serve(handler)
    if monitor is not None:
        monitor.start()
    if rt.status_server is not None:
        rt.status_server.ready = True
        rt.status_server.add_provider("engine", stats_fn)
        if monitor is not None:
            # k8s readiness mirrors the canary state (reference: the system
            # status server consumes SystemHealth the same way).
            rt.status_server.set_ready_fn(lambda: monitor.ready)
        # Fleet aggregator discovery: publish this worker's status-server
        # /metrics under the coordinator's metrics prefix (lease-bound).
        await rt.advertise_metrics("worker")

    metrics_pub = WorkerMetricsPublisher(
        rt.client, ns.namespace, ns.component, rt.instance_id, stats_fn)
    metrics_pub.start()

    name = ns.served_model_name or ns.model
    if ns.disagg != "prefill":
        # Prefill workers are internal capacity — only decode/agg workers
        # publish a model card for the frontend to discover.
        async def put_card() -> None:
            await rt.client.put(
                f"{MODEL_PREFIX}/{name}/{rt.instance_id:016x}",
                json.dumps(model_card(ns, name)).encode(),
                lease_id=rt.primary_lease.id)

        await put_card()
        # A coordinator restart loses the card with the lease — re-declare
        # it whenever the runtime re-registers this worker.
        rt.on_reconnect(put_card)

    # -- retirement (runtime/drain.py) ---------------------------------
    # First SIGTERM/SIGINT starts a graceful drain: membership out, bounded
    # run-down, session-KV evacuation. A SECOND signal aborts the drain
    # (skip waiting + evacuation, bounded fast exit). A planner drain
    # request on the coordinator key starts the same protocol with its own
    # reason/deadline. The handlers are in place before the ready line: a
    # signal right after it (a planner or launcher retiring a replica it
    # just saw come up) must start the drain, not kill the process.
    from dynamo_tpu_torch.runtime.drain import (
        DrainRequest,
        WorkerDrainer,
        drain_key,
        drain_status_key,
        install_drain_metrics,
    )

    install_drain_metrics(rt.metrics)
    stop = asyncio.Event()
    abort = asyncio.Event()
    drain_req = DrainRequest(reason="signal")
    loop = asyncio.get_running_loop()

    def on_signal() -> None:
        if not stop.is_set():
            stop.set()
        else:
            log.warning("second signal: aborting drain, fast exit")
            abort.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, on_signal)

    log.info("worker ready: engine=%s model=%s disagg=%s instance=%x",
             ns.engine, name, ns.disagg, rt.instance_id)
    print(f"WORKER_READY instance={rt.instance_id:016x}", flush=True)

    async def watch_drain_key() -> None:
        key = drain_key(ns.namespace, rt.instance_id)
        while True:
            try:
                raw = await rt.client.get(key)
            except Exception:
                raw = None  # coordinator unreachable; signals still work
            if raw is not None:
                try:
                    req = DrainRequest.from_bytes(raw)
                except Exception:
                    req = DrainRequest(reason="planner")
                drain_req.reason = req.reason or "planner"
                drain_req.deadline_s = req.deadline_s
                stop.set()
                return
            await asyncio.sleep(0.5)

    watcher = asyncio.create_task(watch_drain_key())
    await stop.wait()
    watcher.cancel()

    async def deregister() -> None:
        drain_state["draining"] = True
        await rt.deregister()
        if ns.disagg != "prefill":
            try:
                await asyncio.wait_for(rt.client.delete(
                    f"{MODEL_PREFIX}/{name}/{rt.instance_id:016x}"), 3.0)
            except Exception:
                log.warning("model card delete failed; lease expiry will")

    drainer = WorkerDrainer(
        inflight=lambda: rt.inflight_streams,
        deregister=deregister,
        evacuate=engine.evacuate_sessions,
        abort_batch=lambda: engine.abort_class("batch"),
        abort_all=lambda: engine.abort_class(None),
        abort_event=abort,
        deadline_s=ns.drain_deadline,
        batch_grace_s=ns.drain_batch_grace,
    )
    report = await drainer.drain(reason=drain_req.reason,
                                 deadline_s=drain_req.deadline_s)
    if monitor is not None:
        await monitor.stop()
    # Final snapshot: the retired worker's LAST published stats show it
    # idle/NotReady (aggregate views would otherwise keep its stale busy
    # numbers forever), then the terminal drain report lands on the
    # non-lease-bound status key for the planner to read post-exit.
    await metrics_pub.publish_once()
    await metrics_pub.stop()
    # The terminal report carries the engine's exit-time occupancy: routers
    # forget deregistered workers, so this line (and the status key) is the
    # only place a leak in a RETIRED worker stays observable.
    terminal = report.to_dict()
    try:
        final = dict(stats_fn())
        terminal["final_kv_usage"] = float(final.get("kv_usage", 0.0) or 0.0)
        terminal["final_num_running"] = int(final.get("num_running", 0) or 0)
    except Exception:
        pass
    try:
        await asyncio.wait_for(rt.client.put(
            drain_status_key(ns.namespace, rt.instance_id),
            json.dumps(terminal).encode()), 3.0)
    except Exception:
        log.warning("drain status publish failed (coordinator unreachable?)")
    if kv_source is not None:
        await kv_source.stop()
    if kv_prefill_router is not None:
        await kv_prefill_router.close()
    if publisher:
        await publisher.stop()
    if ns.engine == "mocker":
        await engine.stop()
    else:
        await engine.shutdown()
    await rt.shutdown()
    print(f"WORKER_DRAINED {json.dumps(terminal)}", flush=True)


def main() -> None:
    configure_logging()
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
