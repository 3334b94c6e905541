"""Single-process launcher for the port:
``python -m dynamo_tpu_torch.launch.run in=<http|text|batch> out=torch``.

Port of ``dynamo_tpu/launch/run.py``: frontend → preprocessor → engine →
detokenizer, all in-process. ``in=http`` serves the OpenAI surface
(``frontend/service.py``) over the port's stdlib HTTP/1.1 server.

Examples:
    python -m dynamo_tpu_torch.launch.run in=http out=torch --model llama-3-8b-lite \
        --allow-random-weights --port 8080
    python -m dynamo_tpu_torch.launch.run in=http out=torch --model tests/data/tiny-real-llama \
        --device cpu --port 8077 --block-size 4 --num-blocks 128 --max-model-len 256
    python -m dynamo_tpu_torch.launch.run in=batch out=torch --model llama-3-8b-lite \
        --allow-random-weights --input-jsonl prompts.jsonl
    python -m dynamo_tpu_torch.launch.run in=text out=torch --model tests/data/tiny-real-llama
    python -m dynamo_tpu_torch.launch.run in=batch out=torch --model tests/data/tiny-real-llama \
        --device cpu --kv-dtype int8 --input-jsonl prompts.jsonl
    python -m dynamo_tpu_torch.launch.run in=batch out=torch --model tests/data/tiny-real-llama \
        --device cpu --quantization int8 --input-jsonl prompts.jsonl
    python -m dynamo_tpu_torch.launch.run in=batch out=torch --model tiny-moe \
        --device cpu --allow-random-weights --input-jsonl prompts.jsonl
    python -m dynamo_tpu_torch.launch.run in=batch out=torch --model llama-3-8b-lite \
        --allow-random-weights --decode-window 4 --warmup-mode full --input-jsonl prompts.jsonl
    python -m dynamo_tpu_torch.launch.run in=batch out=torch --model tests/data/tiny-real-llama \
        --device cpu --spec-ngram 2 --spec-k 4 --input-jsonl prompts.jsonl
    python -m dynamo_tpu_torch.launch.run in=http out=torch --model llama-3-8b-lite \
        --allow-random-weights --prefill-chunk 0 --itl-slo-ms 50 --max-model-len 2048
    python -m dynamo_tpu_torch.launch.run in=http out=torch --model llama-3-8b-lite \
        --allow-random-weights --tp 2 --dist-backend gloo --tp-devices 0,0 \
        --num-blocks 2048 --warmup-mode off
    python -m dynamo_tpu_torch.launch.run in=batch out=torch --model tiny-moe \
        --device cpu --tp 2 --ep 2 --dist-backend gloo --num-blocks 64 \
        --warmup-mode off --input-jsonl prompts.jsonl
    python -m dynamo_tpu_torch.launch.run in=batch out=torch --model tests/data/tiny-real-llama \
        --device cpu --pp 2 --dp 2 --dist-backend gloo --num-blocks 64 \
        --warmup-mode off --input-jsonl prompts.jsonl
    python -m dynamo_tpu_torch.kvbm.remote --port 7070 &
    python -m dynamo_tpu_torch.launch.run in=http out=torch --model tests/data/tiny-real-llama \
        --device cpu --num-blocks 64 --host-kv-blocks 256 --disk-kv-path /tmp/kv \
        --remote-kv-addr 127.0.0.1:7070 --session-ttl 300

``--warmup-mode`` and ``--warmup-deadline`` are the JAX worker's flags
(``dynamo_tpu/components/worker.py``); the launcher takes them until the
worker is ported.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from dynamo_tpu_torch.engine.engine import AsyncTorchEngine, build_engine
from dynamo_tpu_torch.frontend.model_manager import ModelManager
from dynamo_tpu_torch.frontend.service import HttpService
from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.tokenizer import DecodeStream, load_tokenizer
from dynamo_tpu_torch.utils.config import EngineConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("launch")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    in_mode, out_mode = "text", "torch"
    rest = []
    for a in argv:
        if a.startswith("in="):
            in_mode = a[3:]
        elif a.startswith("out="):
            out_mode = a[4:]
        else:
            rest.append(a)
    p = argparse.ArgumentParser("dynamo-run (torch)")
    p.add_argument("--model", default="tiny-llama")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (cpu runs the "
                        "plain PyTorch path)")
    p.add_argument("--max-batch-size", type=int, default=64)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=0)
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="prefill chunk tokens per step; 0 = SLO-driven auto "
                        "sizing (largest per-QoS chunk keeping predicted "
                        "decode ITL inside --itl-slo-ms). Its chunks reach "
                        "thousands of tokens (up to --max-model-len), and a mixed "
                        "step runs as a dense [rows, chunk] grid, so the graph of "
                        "the largest step holds the activations of "
                        "--max-batch-size x chunk token rows, which at an 8B "
                        "model's width takes a large share of the card's memory "
                        "from the KV cache (PERF.md section 5). Lower "
                        "--max-batch-size or --max-model-len to bound it")
    p.add_argument("--itl-slo-ms", type=float, default=50.0,
                   help="decode ITL SLO budget for --prefill-chunk 0 auto "
                        "sizing (interactive 1x, standard 2x, batch 4x)")
    p.add_argument("--kv-dtype", default="bfloat16", choices=["bfloat16", "int8", "int4"],
                   help="KV cache storage: model precision, or int8 / packed int4 "
                        "with per-(block, kv head) scales (2x / 4x the blocks)")
    p.add_argument("--quantization", choices=["none", "int8"], default="none",
                   help="weight-only quantization: int8 matrices with per-channel "
                        "scales (MoE expert stacks stay at the model dtype)")
    p.add_argument("--no-unified-step", action="store_true",
                   help="dispatch decode and prefill chunks as two steps "
                        "instead of one ragged mixed step")
    p.add_argument("--decode-window", type=int, default=1,
                   help="fuse N decode steps into one dispatch (one CUDA graph); "
                        "N > 1 implies the two-launch step path")
    p.add_argument("--warmup-mode", default="lazy", choices=["off", "lazy", "full"],
                   help="step-program warmup: off (no ledger), lazy (capture each "
                        "bucket's graph on first use), full (capture the whole "
                        "bucket lattice before serving)")
    p.add_argument("--warmup-deadline", type=float, default=120.0,
                   help="wall-seconds budget for --warmup-mode full (0 = unbounded)")
    p.add_argument("--spec-ngram", type=int, default=0,
                   help="n-gram speculative decoding (greedy-exact; 0 = off). It "
                        "currently lowers decode throughput on the card: verify "
                        "rows run as a second forward beside decode and a row "
                        "pauses a cycle before each verify (ROADMAP Queue 1)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="max proposed tokens per verify step")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks ('model' axis), one process each (this "
                        "process is rank 0); heads, kv heads and FFN width (a MoE "
                        "model's per-expert and shared widths) must divide by it. "
                        "The engine has dp x pp x ep x tp ranks; more than one runs "
                        "eager steps: it needs --warmup-mode off")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (JAX's 'pipe' axis): the layers and their KV "
                        "cache split over pp ranks, one process each, a step run as "
                        "microbatches through them; composes with --dp only; needs "
                        "--warmup-mode off")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas inside the engine (JAX's 'data' "
                        "axis): dp x ep x tp ranks, params and cache replicated "
                        "over data; needs --warmup-mode off when dp x ep x tp > 1")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel shards (JAX's 'expert' axis): a MoE model's "
                        "experts split over ep ranks (num_experts must divide by "
                        "it), served by the dropless dispatch; attention and cache "
                        "replicated over expert; needs --warmup-mode off when "
                        "dp x ep x tp > 1")
    p.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                   help="torch.distributed backend of --tp/--pp/--ep/--dp ranks: nccl "
                        "takes one card a rank; ranks that share a card need gloo")
    p.add_argument("--tp-devices", default=None,
                   help="comma-separated card index of each rank (default rank r on "
                        "cuda:r); ranks that share a card need --dist-backend gloo "
                        "and an explicit --num-blocks")
    p.add_argument("--host-kv-blocks", type=int, default=0, help="G2 host KV tier capacity")
    p.add_argument("--session-ttl", type=float, default=0.0,
                   help="session-sticky KV retention: seconds a finished "
                        "session's committed blocks stay pinned so the next "
                        "turn prefills only the suffix (0 = off)")
    p.add_argument("--no-session-tiers", action="store_true",
                   help="skip staging expired session KV down the KVBM tier "
                        "ladder before unpinning")
    p.add_argument("--disk-kv-path", default=None, help="G3 disk KV tier directory")
    p.add_argument("--remote-kv-addr", default=None,
                   help="G4 remote block store host:port "
                        "(python -m dynamo_tpu_torch.kvbm.remote)")
    p.add_argument("--max-tokens", type=int, default=256, help="default max output tokens")
    p.add_argument("--input-jsonl", default=None)
    p.add_argument("--allow-random-weights", action="store_true",
                   help="serve RANDOM weights when the model path has no "
                        "loadable safetensors (tests/benches only)")
    p.add_argument("--tool-call-parser", default=None,
                   help="tool-call parser name (hermes, mistral, llama3_json, ...)")
    p.add_argument("--reasoning-parser", default=None,
                   help="reasoning parser name (basic, deepseek_r1, ...)")
    p.add_argument("--mm-image-tokens", type=int, default=0,
                   help="enable multimodal chat: run an in-process vision "
                        "encoder producing this many embedding tokens per "
                        "image (0 = multimodal off)")
    ns = p.parse_args(rest)
    ns.in_mode, ns.out_mode = in_mode, out_mode
    return ns


def build_local_engine(ns: argparse.Namespace) -> tuple[AsyncTorchEngine, EngineConfig]:
    # Hub repo ids resolve to a local snapshot; the served model name
    # (ns.model, used for registration) keeps the user-given id.
    from dynamo_tpu_torch.models.hub import resolve_model_path

    resolved = resolve_model_path(ns.model)
    if ns.tokenizer is None and resolved != ns.model:
        ns.tokenizer = resolved
    cfg = EngineConfig(
        model=resolved,
        max_batch_size=ns.max_batch_size,
        max_model_len=ns.max_model_len,
        block_size=ns.block_size,
        num_blocks=ns.num_blocks,
        prefill_chunk=ns.prefill_chunk,
        itl_slo_ms=ns.itl_slo_ms,
        kv_dtype=ns.kv_dtype,
        quantization=ns.quantization,
        unified_step=not ns.no_unified_step,
        decode_window=ns.decode_window,
        spec_ngram=ns.spec_ngram,
        spec_k=ns.spec_k,
        warmup_mode=ns.warmup_mode,
        warmup_deadline=ns.warmup_deadline,
        allow_random_weights=ns.allow_random_weights,
        host_kv_blocks=ns.host_kv_blocks,
        disk_kv_path=ns.disk_kv_path,
        remote_kv_addr=ns.remote_kv_addr,
        session_ttl=ns.session_ttl,
        session_tiers=not ns.no_session_tiers,
        tp=ns.tp,
        pp=ns.pp,
        dp=ns.dp,
        ep=ns.ep,
        dist_backend=ns.dist_backend,
        tp_devices=tuple(int(d) for d in ns.tp_devices.split(",")) if ns.tp_devices else (),
    )
    return build_engine(cfg, device=ns.device), cfg


async def run_http(ns: argparse.Namespace) -> None:
    engine, cfg = build_local_engine(ns)
    tok = load_tokenizer(ns.tokenizer or ns.model)
    image_encoder = None
    if ns.mm_image_tokens > 0:
        from dynamo_tpu_torch.models.config import resolve_model_config
        from dynamo_tpu_torch.models.vision import VisionConfig, VisionEncoder

        venc = VisionEncoder(VisionConfig(
            num_image_tokens=ns.mm_image_tokens,
            lm_hidden_size=resolve_model_config(cfg.model).hidden_size), device=ns.device)
        loop = asyncio.get_running_loop()

        async def image_encoder(imgs: list[bytes]):
            out = await loop.run_in_executor(None, venc.encode, imgs)
            return [out[i] for i in range(len(imgs))]

    models = ModelManager()
    models.register(
        ns.model, tok, engine.generate,
        defaults=ModelDefaults(max_model_len=cfg.max_model_len, default_max_tokens=ns.max_tokens),
        stats=engine.stats,
        tool_parser=ns.tool_call_parser,
        reasoning_parser=ns.reasoning_parser,
        embed=engine.embed,
        image_encoder=image_encoder,
    )
    svc = HttpService(models)
    # Single-process launch: the engine lives here, so its perf-counter,
    # scheduling-ledger and memory-ledger families belong on this /metrics
    # (obs/profiler.py, obs/sched_ledger.py, obs/mem_ledger.py).
    from dynamo_tpu_torch.obs.mem_ledger import install_mem_metrics
    from dynamo_tpu_torch.obs.profiler import install_perf_metrics
    from dynamo_tpu_torch.obs.sched_ledger import install_sched_metrics

    install_perf_metrics(svc.metrics)
    install_sched_metrics(svc.metrics)
    install_mem_metrics(svc.metrics)
    if cfg.session_ttl > 0:
        from dynamo_tpu_torch.engine.session import install_session_metrics

        # Session retention feeds dynamo_session_* (engine/session.py).
        install_session_metrics(svc.metrics)
    if cfg.host_kv_blocks > 0 or cfg.disk_kv_path or cfg.remote_kv_addr:
        from dynamo_tpu_torch.kvbm.metrics import install_prefix_cache_metrics
        from dynamo_tpu_torch.kvbm.stream_ckpt import install_stream_ckpt_metrics

        # The KVBM tiers feed dynamo_prefix_cache_* (onboards, publishes)
        # and dynamo_stream_ckpt_* (kvbm/metrics.py, kvbm/stream_ckpt.py).
        install_prefix_cache_metrics(svc.metrics)
        install_stream_ckpt_metrics(svc.metrics)
    if cfg.warmup_mode != "off":
        from dynamo_tpu_torch.obs.compile_ledger import install_compile_metrics

        # Compile ledger feeds dynamo_xla_compile_* (obs/compile_ledger.py).
        install_compile_metrics(svc.metrics)
    await svc.start(ns.host, ns.port)
    log.info("serving %s on http://%s:%d/v1", ns.model, ns.host, svc.port)
    try:
        await asyncio.Event().wait()
    finally:
        await svc.stop()
        await engine.shutdown()


async def run_text(ns: argparse.Namespace) -> None:
    engine, _cfg = build_local_engine(ns)
    tok = load_tokenizer(ns.tokenizer or ns.model)
    print(f"dynamo_tpu_torch REPL — model={ns.model} (ctrl-d to exit)")
    loop = asyncio.get_running_loop()
    while True:
        try:
            line = await loop.run_in_executor(None, lambda: input("> "))
        except (EOFError, KeyboardInterrupt):
            break
        req = PreprocessedRequest(
            token_ids=tok.encode(tok.apply_chat_template([{"role": "user", "content": line}]),
                                 add_bos=True),
            stop_conditions=StopConditions(max_tokens=ns.max_tokens),
            sampling_options=SamplingOptions(temperature=0.7),
            eos_token_ids=[tok.eos_id],
        )
        stream = DecodeStream(tok)
        async for out in engine.generate(req):
            for t in out.token_ids:
                sys.stdout.write(stream.step(t))
                sys.stdout.flush()
        sys.stdout.write(stream.flush() + "\n")
    await engine.shutdown()


async def run_batch(ns: argparse.Namespace) -> None:
    """Batch mode: JSONL of {"prompt": ...} → JSONL of completions."""
    engine, _cfg = build_local_engine(ns)
    tok = load_tokenizer(ns.tokenizer or ns.model)

    async def one(line: str) -> dict:
        obj = json.loads(line)
        req = PreprocessedRequest(
            token_ids=tok.encode(obj["prompt"], add_bos=True),
            stop_conditions=StopConditions(max_tokens=obj.get("max_tokens", ns.max_tokens)),
            sampling_options=SamplingOptions(temperature=obj.get("temperature", 0.0)),
            eos_token_ids=[tok.eos_id],
        )
        toks: list[int] = []
        async for out in engine.generate(req):
            toks.extend(out.token_ids)
            if out.error:
                raise RuntimeError(f"request failed: {out.error}")
        return {"prompt": obj["prompt"], "text": tok.decode(toks), "tokens": len(toks)}

    if ns.input_jsonl:
        with open(ns.input_jsonl) as src:
            text = src.read()
    else:
        text = sys.stdin.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    try:
        results = await asyncio.gather(*(one(ln) for ln in lines))
    finally:
        await engine.shutdown()
    for r in results:
        print(json.dumps(r))


def main(argv: list[str] | None = None) -> None:
    configure_logging()
    ns = parse_args(argv)
    if ns.out_mode != "torch":
        raise SystemExit(f"unknown out={ns.out_mode} (supported: torch)")
    if ns.in_mode == "http":
        asyncio.run(run_http(ns))
    elif ns.in_mode == "text":
        asyncio.run(run_text(ns))
    elif ns.in_mode == "batch":
        asyncio.run(run_batch(ns))
    else:
        raise SystemExit(f"unknown in={ns.in_mode} (supported: http, text, batch)")


if __name__ == "__main__":
    main()
