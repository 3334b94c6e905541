"""Pre-deployment SLA profiler: sweep a live engine, fit the planner.

Reference: benchmarks/profiler/profile_sla.py:71-393 — the reference sweeps
TP configurations of vLLM engines with genai-perf and writes npz files the
planner's interpolators read (tests/planner/profiling_results/). Here the
sweep drives our own EngineCore in-process (no HTTP hop, no external load
generator) and produces exactly the data dict
``planner.interpolator.{Prefill,Decode}Interpolator.from_data`` consume:

    prefill_isl, prefill_ttft_s, prefill_thpt_per_chip,
    decode_concurrency, decode_context, decode_itl_s, decode_thpt_per_chip

Method notes:
- each grid point is measured after a warmup pass so XLA compiles (one per
  static bucket) never pollute timings;
- prefix caching is disabled so repeat sweeps measure real prefill;
- decode ITL is steady-state: ``steps`` all-decode engine steps over a
  full batch, timed after the first decode step compiled.

CLI: ``python -m dynamo_tpu_torch.planner.profiler --model llama-3-8b-lite
--output profile.npz`` (run on the target card; ``--device cpu`` sweeps on
the CPU); the planner component loads the npz via ``--profile-data``
instead of its synthetic default.

Copy of ``dynamo_tpu/planner/profiler.py`` over the port's ``EngineCore``:
``SlaProfiler(cfg, chips, device)`` passes ``device`` to the engine, which
runs on ``cuda`` when none is given (and raises without a card), as every
entry point of the port does; "XLA compiles" are step programs made (CUDA
graph captures) on the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from dynamo_tpu_torch.engine.engine import EngineCore
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.utils.config import EngineConfig
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("profiler")


def _request(ctx_len: int, max_tokens: int, rid: str, seed: int = 0) -> PreprocessedRequest:
    toks = [(7 * seed + 11 * j) % 31900 + 5 for j in range(ctx_len)]
    req = PreprocessedRequest(
        token_ids=toks,
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
    )
    req.request_id = rid
    return req


class SlaProfiler:
    """Sweep one engine configuration; the engine is shared across grid
    points so compiled buckets are reused (one compile per static shape)."""

    def __init__(self, engine_cfg: EngineConfig, chips: int = 1, device=None):
        self.core = EngineCore(engine_cfg, device=device)
        self.chips = max(chips, 1)
        self._uid = 0

    def _rid(self) -> str:
        self._uid += 1
        return f"prof-{self._uid}"

    def _drain(self) -> None:
        while self.core.has_work():
            self.core.step()

    # ------------------------------------------------------------------
    def measure_ttft(self, isl: int) -> float:
        """Seconds from enqueue to first sampled token (prefill all chunks)."""
        req = _request(isl, 1, self._rid(), seed=self._uid)
        t0 = time.perf_counter()
        self.core.add_request(req)
        got = False
        while not got and self.core.has_work():
            outs = self.core.step()
            got = any(o.token_ids for o in outs.values())
        ttft = time.perf_counter() - t0
        self._drain()
        return ttft

    def profile_prefill(self, isl_grid: list[int]) -> tuple[np.ndarray, np.ndarray]:
        ttfts, thpts = [], []
        for isl in isl_grid:
            self.measure_ttft(isl)            # warmup: compile this bucket
            ttft = self.measure_ttft(isl)
            ttfts.append(ttft)
            thpts.append(isl / ttft / self.chips)
            log.info("prefill isl=%d ttft=%.4fs thpt/chip=%.1f tok/s",
                     isl, ttft, thpts[-1])
        return np.asarray(ttfts), np.asarray(thpts)

    # ------------------------------------------------------------------
    def measure_itl(self, concurrency: int, context: int, steps: int) -> float:
        """Steady-state seconds per all-decode step at a (concurrency,
        context) operating point."""
        maxb = self.core.engine_cfg.max_batch_size
        if concurrency > maxb:
            # Admission is slot-gated: extra requests would just queue, the
            # warmup would run until most of the batch FINISHED, and the
            # timed window would measure a smaller tail cohort.
            log.warning("capping ITL concurrency %d to max_batch_size %d",
                        concurrency, maxb)
            concurrency = maxb
        # Token budget: the wait-for-steady-state warmup below runs mixed
        # prefill+decode steps in which early-admitted requests already
        # decode, so give each request enough headroom that `steps` decode
        # tokens are still left once the whole batch reaches steady state.
        warmup_steps = max(
            -(-concurrency * context // self.core.engine_cfg.max_tokens_per_step),
            concurrency // max(self.core.engine_cfg.max_batch_size, 1) + 1,
        )
        for _ in range(concurrency):
            self.core.add_request(
                _request(context, steps + 2 + warmup_steps, self._rid(), seed=self._uid))
        # Run until EVERY request has finished prefill (the scheduler mixes
        # prefill chunks into decode steps, so "first decode token seen" is
        # NOT steady state — at high concurrency most of the batch would
        # still be prefilling and the timed window would fold prefill-chunk
        # compute into the ITL). Steady state = num_prefill_tokens stops
        # growing and at least one decode token has landed.
        entered = self.core.metrics.num_decode_tokens
        while self.core.has_work():
            pre = self.core.metrics.num_prefill_tokens
            self.core.step()
            if (self.core.metrics.num_prefill_tokens == pre
                    and self.core.sched.num_waiting == 0
                    and self.core.metrics.num_decode_tokens > entered):
                # No prefill progressed this step AND nothing is queued
                # waiting for a batch slot — a decode-only step with waiting
                # requests would still see their prefills land inside the
                # timed window once slots free up.
                break
        base = self.core.metrics.num_decode_tokens
        t0 = time.perf_counter()
        while (self.core.metrics.num_decode_tokens - base < concurrency * steps
               and self.core.has_work()):
            self.core.step()
        dt = time.perf_counter() - t0
        measured = self.core.metrics.num_decode_tokens - base
        self._drain()
        if measured == 0:
            raise RuntimeError(
                f"ITL window measured zero decode tokens at concurrency="
                f"{concurrency}, context={context} — warmup consumed the "
                "whole workload; raise steps or lower context")
        return dt / max(measured // max(concurrency, 1), 1)

    def profile_decode(
        self, conc_grid: list[int], ctx_grid: list[int], steps: int = 16
    ) -> tuple[np.ndarray, np.ndarray]:
        itl = np.zeros((len(conc_grid), len(ctx_grid)))
        thpt = np.zeros_like(itl)
        for i, c in enumerate(conc_grid):
            # measure_itl caps at max_batch_size; throughput must use the
            # EFFECTIVE concurrency or points above the cap report inflated
            # capacity to the planner.
            c_eff = min(c, self.core.engine_cfg.max_batch_size)
            for j, ctx in enumerate(ctx_grid):
                self.measure_itl(c, ctx, 2)   # warmup buckets
                itl[i, j] = self.measure_itl(c, ctx, steps)
                thpt[i, j] = c_eff / itl[i, j] / self.chips
                log.info("decode conc=%d ctx=%d itl=%.4fs thpt/chip=%.1f",
                         c, ctx, itl[i, j], thpt[i, j])
        return itl, thpt

    # ------------------------------------------------------------------
    def run(self, isl_grid: list[int], conc_grid: list[int],
            ctx_grid: list[int], decode_steps: int = 16) -> dict:
        ttft, p_thpt = self.profile_prefill(isl_grid)
        itl, d_thpt = self.profile_decode(conc_grid, ctx_grid, decode_steps)
        return {
            "prefill_isl": np.asarray(isl_grid, np.float64),
            "prefill_ttft_s": ttft,
            "prefill_thpt_per_chip": p_thpt,
            "decode_concurrency": np.asarray(conc_grid, np.float64),
            "decode_context": np.asarray(ctx_grid, np.float64),
            "decode_itl_s": itl,
            "decode_thpt_per_chip": d_thpt,
        }


def save_profile(path: str, data: dict) -> None:
    np.savez(path, **data)


def load_profile(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def engine_config_for_sweep(model: str, isl_grid: list[int],
                            conc_grid: list[int], ctx_grid: list[int],
                            decode_steps: int, block_size: int = 16,
                            tp: int = 1) -> EngineConfig:
    """Size the engine to the sweep's largest operating point."""
    max_len = max(max(isl_grid) + 8, max(ctx_grid) + decode_steps + 8)
    max_conc = max(conc_grid)
    blocks_per_seq = -(-max_len // block_size) + 1
    return EngineConfig(
        # Profiling sweeps measure latency/throughput, not output quality —
        # random weights on a weights-less dir are fine here.
        allow_random_weights=True,
        model=model, block_size=block_size,
        num_blocks=max_conc * blocks_per_seq + 1,
        max_batch_size=max_conc, max_model_len=max_len,
        decode_bucket=tuple(sorted(set(conc_grid))),
        enable_prefix_caching=False, tp=tp,
    )


def main() -> None:
    p = argparse.ArgumentParser("sla-profiler")
    p.add_argument("--model", default="llama-3-8b-lite")
    p.add_argument("--output", default="profile.npz")
    p.add_argument("--isl-grid", type=int, nargs="+", default=[128, 512, 2048])
    p.add_argument("--conc-grid", type=int, nargs="+", default=[1, 8, 32])
    p.add_argument("--ctx-grid", type=int, nargs="+", default=[256, 1024, 4096])
    p.add_argument("--decode-steps", type=int, default=32)
    p.add_argument("--chips", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device of the engine (default cuda; cpu to sweep "
                        "without a card)")
    ns = p.parse_args()
    cfg = engine_config_for_sweep(ns.model, ns.isl_grid, ns.conc_grid,
                                  ns.ctx_grid, ns.decode_steps, tp=ns.tp)
    prof = SlaProfiler(cfg, chips=max(ns.chips, ns.tp), device=ns.device)
    try:
        data = prof.run(ns.isl_grid, ns.conc_grid, ns.ctx_grid, ns.decode_steps)
    finally:
        prof.core.close()  # a tp engine's followers stop with it
    save_profile(ns.output, data)
    print(f"profile written to {ns.output}")


if __name__ == "__main__":
    main()
