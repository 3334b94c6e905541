"""End-to-end serving numbers of the port on the card, per kv dtype.

    python3 serve_timing.py [--label NAME] [--kv bfloat16,int8,int4]
                            [--windows 1,4] [--cprofile]

Runs the serving workload of ``chip_smoke.py`` phase (b): llama-3-8b-lite
at full width (8 layers, random weights from seed 0), 32 concurrent greedy
requests of 128 prompt tokens and 64 output tokens, through ``build_engine``
and ``AsyncTorchEngine.generate``. Per kv dtype (and per decode window,
``--windows``) it builds one engine and serves it several times, each run
with prompts of its own so that no run hits the prefix cache of another:

0. untimed: first-use costs (a kernel built at its first launch, CUDA and
   cuBLAS initialisation) land here in a tree that does not warm up;
1. timed: decode tok/s (output tokens after the first, over the time from
   the last first token to the last token), TTFT of all 32, wall, peak
   device memory;
2. under ``torch.profiler``: the device's busy share of the serving wall
   (the sum of kernel device time over the wall; kernels of one stream do
   not overlap). The profiler's own host cost slows the run it watches;
3. with ``--cprofile``: the same requests driven through the engine's
   pipelined step loop (``EngineCore.step_begin`` / ``step_finalize``, as
   the engine thread drives them) in this one thread under cProfile, which
   on Python 3.12 would mix every thread's calls into one profile. Prints
   the top cumulative functions and splits the loop's time between the
   step program's host side (``ModelRunner._step`` eagerly,
   ``StepProgram.__call__`` with graphs: PyTorch op dispatch, or input
   copies and a graph replay), waiting for the card
   (``StepOutputs.materialize``) and the rest of the engine's Python
   (scheduler, input packing, output assembly).

It uses only what every slice of the port has (``build_engine``,
``AsyncTorchEngine``, ``EngineConfig``) and imports the ``dynamo_tpu_torch``
beside it; it sets ``warmup_mode="full"`` only where the config has that
field, and reports the warmup where the engine did one. A copy placed at
the root of an older checkout therefore times that tree. To compare two
trees, run it in both on one machine, in the order old, new, new, old.

Prints the card's name and power limit (nvidia-smi), then one JSON line a
run (``label``, ``kv_dtype``, ``decode_window``, ``run``, the numbers);
``--out FILE`` appends the lines and the cProfile tables to FILE as well.
The cProfile run's own cost slows the loop it watches: its split is a
share, not a rate.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import dataclasses
import gc
import io
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BATCH, PROMPT, DECODE = 32, 128, 64


def serve_once(engine, vocab: int, run: int) -> dict:
    """One serving run of the workload; prompts differ per ``run``."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    first_at, done_at = {}, {}

    async def one(i: int):
        hi = vocab - 5
        req = PreprocessedRequest(
            token_ids=[(7 * i + 11 * j + 101 * run) % hi + 5 for j in range(PROMPT)],
            stop_conditions=StopConditions(max_tokens=DECODE, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
            request_id=f"timing-{run}-{i}")
        n = 0
        async for out in engine.generate(req):
            if out.error:
                raise RuntimeError(f"request {i} failed: {out.error}")
            if n == 0:
                first_at[i] = time.perf_counter()
            n += len(out.token_ids)
        if n != DECODE:
            raise AssertionError(f"request {i}: {n} tokens, expected {DECODE}")
        done_at[i] = time.perf_counter()

    async def go():
        t0 = time.perf_counter()
        try:
            await asyncio.gather(*(one(i) for i in range(BATCH)))
        finally:
            await engine.shutdown()
        return t0

    torch.cuda.reset_peak_memory_stats()
    t0 = asyncio.run(go())
    t_first, t_end = max(first_at.values()), max(done_at.values())
    return {"decode_tok_s": BATCH * (DECODE - 1) / (t_end - t_first),
            "ttft_all_s": t_first - t0, "wall_s": t_end - t0,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def busy_share(prof, wall_s: float) -> float:
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.self_device_time_total > 0)
    return busy_us / 1e6 / wall_s


#: engine functions whose cumulative time is one part of the loop's:
#: (file suffix, function name) -> part
PARTS = {("engine/engine.py", "_step"): "step_program",       # eager tree
         ("engine/engine.py", "__call__"): "step_program",    # StepProgram
         ("engine/engine.py", "materialize"): "wait_for_card"}


def profile_loop(core, vocab: int, run: int, top: int = 25) -> tuple[dict, str]:
    """Serve the workload through ``core``'s pipelined step loop in this
    thread under cProfile; returns the loop's time split and the top
    cumulative functions as pstats prints them."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    hi = vocab - 5
    for i in range(BATCH):
        core.add_request(PreprocessedRequest(
            token_ids=[(7 * i + 11 * j + 101 * run) % hi + 5 for j in range(PROMPT)],
            stop_conditions=StopConditions(max_tokens=DECODE, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
            request_id=f"timing-{run}-{i}"))
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    pending = None
    while core.has_work() or pending is not None:
        nxt = core.step_begin() if core.has_work() else None
        if pending is not None:
            core.step_finalize(pending)
        pending = nxt
    prof.disable()
    wall = time.perf_counter() - t0
    split = dict.fromkeys(("step_program", "wait_for_card"), 0.0)
    for (file, _line, name), (_cc, _nc, _tt, cumtime, _callers) in pstats.Stats(prof).stats.items():
        for (suffix, fn), part in PARTS.items():
            if file.endswith(suffix) and name == fn:
                split[part] += cumtime
    split["engine_python"] = wall - sum(split.values())
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(top)
    return {"loop_s": wall, "split_s": split,
            "split_share": {k: v / wall for k, v in split.items()}}, out.getvalue()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--label", default=ROOT.name, help="tag of every output line")
    ap.add_argument("--kv", default="bfloat16,int8,int4", help="comma-separated kv dtypes")
    ap.add_argument("--windows", default="1",
                    help="comma-separated decode windows (a tree without fused "
                         "windows takes 1 only)")
    ap.add_argument("--cprofile", action="store_true",
                    help="also profile the engine's step loop on the host (cProfile)")
    ap.add_argument("--out", default=None, help="also append the output to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_timing: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine, build_engine
    from dynamo_tpu_torch.utils.config import EngineConfig

    sink = open(args.out, "a") if args.out else None

    def emit(text: str) -> None:
        print(text, flush=True)
        if sink is not None:
            sink.write(text + "\n")
            sink.flush()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    emit(card)
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    for window in [int(w) for w in args.windows.split(",") if w]:
        for kv in [k for k in args.kv.split(",") if k]:
            extra = {"warmup_mode": "full"} if "warmup_mode" in fields else {}
            if window > 1:
                extra["decode_window"] = window
            t0 = time.perf_counter()
            engine = build_engine(EngineConfig(
                model="llama-3-8b-lite", block_size=16, max_batch_size=BATCH,
                max_model_len=PROMPT + DECODE + 16, prefill_chunk=PROMPT, kv_dtype=kv,
                allow_random_weights=True, **extra))
            torch.cuda.synchronize()
            core = engine.core
            base = {"label": args.label, "card": card, "kv_dtype": kv, "decode_window": window,
                    "build_s": time.perf_counter() - t0}
            warm = getattr(core, "warmup_summary", None)
            if warm is not None:
                base.update(warmup_s=warm.get("seconds"), graphs=len(core.runner.programs),
                            graph_pool_gib=warm.get("graph_pool_gib"),
                            warmup_failed=warm.get("failed"), coverage=warm.get("coverage"))
            vocab = core.model_cfg.vocab_size

            serve_once(engine, vocab, 0)
            engine = AsyncTorchEngine(core)
            emit(json.dumps({**base, "run": "timed", **serve_once(engine, vocab, 1)}))

            from torch.profiler import ProfilerActivity
            engine = AsyncTorchEngine(core)
            prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            with prof:
                res = serve_once(engine, vocab, 2)
                torch.cuda.synchronize()
            emit(json.dumps({**base, "run": "profiled",
                             "busy_share": busy_share(prof, res["wall_s"]), **res}))
            del prof

            if args.cprofile:
                res, table = profile_loop(core, vocab, 3)
                emit(json.dumps({**base, "run": "cprofile", **res}))
                emit(f"[cprofile] {args.label} kv={kv} W={window}\n{table}")
            del engine, core
            gc.collect()
            torch.cuda.empty_cache()
    if sink is not None:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
