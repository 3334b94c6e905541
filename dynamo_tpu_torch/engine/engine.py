"""The port's engine: model runner + engine core + async facade.

Port of ``dynamo_tpu/engine/engine.py`` for the dense Llama serving path
on one device:

- ``ModelRunner``: owns params, the paged KV cache and per-slot sampling
  state on the device; runs one bucketed ragged step per dispatch, a
  fused window of decode steps, a speculative verify step (every
  position's argmax, engine/spec.py), or an embedding call on a cache of
  its own.
- ``StepProgram``: one bucket's step program, the counterpart of a jitted
  step of the JAX runner. On the card it is a CUDA graph captured once
  (lazily at first use, or at warmup) and replayed every step; on the CPU
  the same object runs its body eagerly. Its variants take a guided
  step's logits mask and a multimodal step's embedding override;
  ``VerifyProgram`` is the verify step's.
- ``EngineCore``: synchronous scheduler + step loop (directly testable),
  pipelined one step deep through ``step_begin`` / ``step_finalize``.
- ``AsyncTorchEngine``: thread-hosted step loop bridging to asyncio
  streams.

Where JAX donates the cache and the sampling state to a jitted step and
gets new arrays back, the runner updates them in place. Host/device
overlap: JAX gets it from async dispatch. Here a dispatch stages its
inputs in fresh pinned host memory and copies them with
``non_blocking=True`` into the bucket's static input buffers (a copy from
pageable memory would synchronise the stream), replays the bucket's graph,
and copies the sampled tokens back into pinned memory behind a CUDA event,
so finalizing step N waits for step N only while step N+1 already runs on
the card.

Observability, as the JAX engine wires it: ``prefill_chunk=0`` resolves to
per-QoS chunks through the cost model (obs/costmodel.py) at construction;
each finalized step files a step record (obs/recorder.py) with the step
profiler's analytic counters (obs/profiler.py), a scheduling-ledger record
(goodput, padding, HOL stalls; obs/sched_ledger.py) and a memory-ledger
observation (occupancy, TTX, leak audit; obs/mem_ledger.py); a request
carrying a traceparent gets ``engine.queue`` → ``engine.prefill`` →
``engine.decode`` spans.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import hashlib
import os
import queue as thread_queue
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable

import numpy as np
import torch

from dynamo_tpu_torch.engine.cache import KVCacheSpec, allocate_cache, register_device_tier
from dynamo_tpu_torch.engine.prefix_pool import PrefixPool
from dynamo_tpu_torch.engine.sampling import (
    NEG_INF,
    SamplingState,
    greedy_sample,
    record_tokens,
    sample,
)
from dynamo_tpu_torch.engine.guided import TokenMasker
from dynamo_tpu_torch.engine.scheduler import Phase, Scheduler, Seq, StepPlan
from dynamo_tpu_torch.engine.spec import accept, propose, spec_eligible
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig, resolve_model_config
from dynamo_tpu_torch.obs import costmodel as cm
from dynamo_tpu_torch.obs.compile_ledger import (
    WARMUP_MODES,
    BucketSig,
    enumerate_buckets,
    get_compile_ledger,
)
from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger, live_ids_of
from dynamo_tpu_torch.obs.profiler import StepPerfProfiler
from dynamo_tpu_torch.obs.profiler import phase as _perf_phase
from dynamo_tpu_torch.obs.sched_ledger import HolStall, get_sched_ledger, step_geometry
from dynamo_tpu_torch.obs.tracer import get_tracer, trace_context_of
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    tensor_from_wire,
)
from dynamo_tpu_torch.qos.deadline import deadline_of, expired
from dynamo_tpu_torch.utils.config import EngineConfig
from dynamo_tpu_torch.utils.device import device_name, resolve_device
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("engine")

#: the share of the card's memory over which the warmup's graph pool is
#: logged as a warning (PERF.md's limit for it)
GRAPH_POOL_SHARE = 0.10


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


def _derived_seed(request_id: str) -> int:
    """Stable per-request sampler seed for requests that set none: every
    stream's noise is then a pure function of (request, draws)."""
    return int.from_bytes(hashlib.sha256(request_id.encode()).digest()[:4], "big")


def _weak_source(method: Callable[[], dict]) -> Callable[[], dict]:
    """A memory-ledger live-id source that does not keep its engine alive:
    the process-global ledger would otherwise hold every engine ever made
    (its weights and KV cache) through the bound method. A collected
    engine's source reports nothing, as an unregistered one does."""
    ref = weakref.WeakMethod(method)

    def source() -> dict:
        live = ref()
        return live() if live is not None else {}

    return source


def check_supported(ec: EngineConfig) -> None:
    """Raise on settings this slice of the port does not carry, naming the
    slice that brings them (ROADMAP), and on invalid ones."""
    if ec.spec_ngram > 0 and ec.decode_window > 1:
        raise ValueError(
            "spec_ngram and decode_window>1 are mutually exclusive "
            "(both amortize dispatches over future tokens; pick one)")
    later = {
        "tp/pp/dp/ep/sp > 1 (parallelism slice)":
            any(v != 1 for v in ec.mesh_shape().values()),
        "quantization=int8 (weight-only int8 slice)": ec.quantization == "int8",
        "host/disk/remote KV tiers (KVBM slice)": bool(
            ec.host_kv_blocks > 0 or ec.disk_kv_path or ec.remote_kv_addr
            or ec.global_prefix_cache or ec.stream_ckpt_blocks > 0),
        "session_ttl > 0 (session retention slice)": ec.session_ttl > 0,
    }
    missing = [name for name, hit in later.items() if hit]
    if missing:
        raise ValueError("not supported by the torch port yet: " + "; ".join(missing))
    if ec.quantization not in ("none", ""):
        raise ValueError(f"unknown quantization {ec.quantization!r} (supported: none)")
    if ec.kv_dtype not in ("bfloat16", "", "int8", "int4"):
        raise ValueError(f"unknown kv_dtype {ec.kv_dtype!r} (supported: bfloat16 "
                         "[model-precision cache], int8, int4)")
    if ec.attn_num_splits < 0:
        raise ValueError(f"attn_num_splits must be >= 0 (0 = auto), got {ec.attn_num_splits}")
    if ec.warmup_mode not in WARMUP_MODES:
        raise ValueError(f"unknown warmup_mode {ec.warmup_mode!r} "
                         f"(supported: {', '.join(WARMUP_MODES)})")
    if ec.warmup_deadline < 0:
        raise ValueError(f"warmup_deadline must be >= 0 (0 = unbounded), "
                         f"got {ec.warmup_deadline}")


@dataclass
class EngineMetrics:
    """Engine-side stats (the JAX engine's EngineMetrics, minus the
    counters of features not ported yet)."""

    num_steps: int = 0
    num_prefill_tokens: int = 0
    num_decode_tokens: int = 0
    num_requests_finished: int = 0
    num_preemptions: int = 0
    prefix_hit_blocks: int = 0
    prefix_lookup_blocks: int = 0
    deadline_cancelled: int = 0
    kv_cache_bytes: int = 0
    kv_quant_enabled: bool = False

    spec_proposed: int = 0
    spec_accepted: int = 0
    # host seconds step_begin spent building guided logits masks, and the
    # steps that built any
    guided_mask_seconds: float = 0.0
    guided_mask_steps: int = 0

    def snapshot(self, sched: Scheduler, pool: PrefixPool) -> dict:
        return {
            "kv_cache_bytes": self.kv_cache_bytes,
            "kv_quant_enabled": self.kv_quant_enabled,
            "num_waiting": sched.num_waiting,
            "num_running": sched.num_running,
            "kv_usage": pool.usage,
            "kv_total_blocks": pool.num_blocks,
            "num_steps": self.num_steps,
            "prefill_tokens": self.num_prefill_tokens,
            "decode_tokens": self.num_decode_tokens,
            "requests_finished": self.num_requests_finished,
            "preemptions": self.num_preemptions,
            "prefix_hit_rate": self.prefix_hit_blocks / max(self.prefix_lookup_blocks, 1),
            "deadline_cancelled": self.deadline_cancelled,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
        }


@dataclass
class StepOutputs:
    """A dispatched step's sampled tokens and logprobs. On the card they are
    being copied into pinned host memory behind ``event``;
    :meth:`materialize` waits for that copy only. ``started`` is recorded
    on the stream before the program's input copies, so the two events
    bound the program's device time."""

    tokens: torch.Tensor
    logprobs: torch.Tensor
    event: torch.cuda.Event | None = None
    started: torch.cuda.Event | None = None

    def materialize(self) -> tuple[np.ndarray, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return self.tokens.numpy(), self.logprobs.numpy()

    def device_seconds(self) -> float | None:
        """The program's device time, input copies to output copies, once
        materialized; None off the card."""
        if self.started is None or self.event is None:
            return None
        return self.started.elapsed_time(self.event) / 1e3


@dataclass
class PendingStep:
    """A dispatched-but-unmaterialized engine step: per batch,
    (kind, rows, sample_rows, outputs); a "verify" batch carries its
    chunks (current token + proposals) where the others carry
    sample_rows."""

    batches: list[tuple[str, list, list[bool], StepOutputs]] = field(default_factory=list)
    # Scheduling-ledger context captured at plan time (decode_window,
    # token-budget utilization, HOL victim list) — consumed by
    # _record_step at finalize. None when DYN_SCHED_LEDGER=0.
    sched: Any = None
    # Unified steps: the leading decode-row count of the "mixed" batch,
    # captured at plan time (prefill_target() moves as finalize appends).
    mixed_dec_rows: int = 0


class ModelRunner:
    """Device-state owner + bucketed step dispatch through one
    :class:`StepProgram` per bucket."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig, params=None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.device = resolve_device(device)
        if params is not None:
            self.params = params
        else:
            from dynamo_tpu_torch.models.config import MODEL_PRESETS
            from dynamo_tpu_torch.models.loader import has_weights, load_params

            if has_weights(engine_cfg.model):
                self.params = load_params(cfg, engine_cfg.model, device=self.device)
            else:
                if engine_cfg.model not in MODEL_PRESETS:
                    # A real model PATH without safetensors: serving random
                    # weights would look like a working server producing
                    # garbage. Fail fast unless explicitly allowed.
                    if not engine_cfg.allow_random_weights:
                        raise ValueError(
                            f"{engine_cfg.model!r} has no *.safetensors "
                            "weights to load; convert the checkpoint, fix "
                            "the path, or pass --allow-random-weights to "
                            "serve RANDOM weights (tests/benches only)")
                    log.warning("%s has no *.safetensors weights: engine will "
                                "serve RANDOM weights", engine_cfg.model)
                self.params = llama.init_params(cfg, seed=engine_cfg.seed,
                                                device=self.device)
        num_blocks = engine_cfg.num_blocks or self._auto_num_blocks()
        self.spec = KVCacheSpec.for_model(cfg, num_blocks, engine_cfg.block_size,
                                          kv_dtype=engine_cfg.kv_dtype)
        self.cache_k, self.cache_v = allocate_cache(self.spec, self.device)
        maxb = engine_cfg.max_batch_size
        dev = self.device
        # Row maxb is the trash row: padding/non-sampling rows write their
        # sampling-state updates there, so real slots are never clobbered
        # by duplicate scatter indices and draw counters only advance on
        # real samples.
        self.counts = torch.zeros((maxb + 1, cfg.vocab_size), dtype=torch.int32, device=dev)
        self.seeds = torch.zeros((maxb + 1,), dtype=torch.int64, device=dev)
        self.draws = torch.zeros((maxb + 1,), dtype=torch.int64, device=dev)
        # Per-slot latest sampled token, ON DEVICE: lets the next decode step
        # consume this step's token without a host round-trip — the core of
        # the pipelined step loop. Row maxb = trash.
        self.slot_toks = torch.zeros((maxb + 1,), dtype=torch.int32, device=dev)
        self.max_nblk = -(-engine_cfg.max_model_len // engine_cfg.block_size)
        # The bucket programs made so far (step_fn, verify_fn), and on the
        # card the pool their graphs share and the side stream they are
        # captured on.
        self.programs: dict[tuple, StepProgram] = {}
        self._ledger = get_compile_ledger()
        # Static inputs the program variants share (variant_inputs): the
        # guided programs' bool logits mask [max rows, V], made at the first
        # guided step; the multimodal programs' f32 embedding override and
        # its bool mask, sized to the largest mm bucket so far.
        self._logit_mask: torch.Tensor | None = None
        self._mm_override: torch.Tensor | None = None
        self._mm_mask: torch.Tensor | None = None
        # embed buckets (b, t) run so far (ledger: first use of each)
        self._embed_buckets: set[tuple[int, int]] = set()
        if dev.type == "cuda":
            self.graph_pool = torch.cuda.graph_pool_handle()
            self.capture_stream = torch.cuda.Stream(dev)

    def _auto_num_blocks(self) -> int:
        """Size the device KV pool from free card memory, or a small default
        on the CPU."""
        ec = self.engine_cfg
        budget = 0
        if self.device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(self.device)
            budget = int(free * 0.85)
        spec = KVCacheSpec.for_model(self.cfg, 1, ec.block_size, kv_dtype=ec.kv_dtype)
        n = max(budget // spec.bytes_per_block(), 16) if budget > 0 else 512
        cap = (ec.max_model_len // ec.block_size) * ec.max_batch_size + 1
        return int(min(n, cap))

    def reset_slot(self, slot: int, seed: int) -> None:
        """Initialize a seq's persistent sampling state: fresh penalty
        counts, its seed, and a draw counter at 0."""
        self.counts[slot] = 0
        self.seeds[slot] = seed
        self.draws[slot] = 0

    @staticmethod
    def step_key(b: int, t: int, nblk: int, window: int = 1, fast_greedy: bool = False,
                 mm: bool = False, masked: bool = False) -> tuple:
        """A step program's key: ``(b, t, nblk, window, fast_greedy)``, and
        "mm" / "masked" after it for those variants."""
        return ((b, t, nblk, window, fast_greedy) + (("mm",) if mm else ())
                + (("masked",) if masked else ()))

    def step_fn(self, b: int, t: int, nblk: int, window: int = 1,
                fast_greedy: bool = False, mm: bool = False,
                masked: bool = False) -> "StepProgram":
        """The bucket's program, made (warmed and captured) on first use —
        the counterpart of the JAX runner's ``step_fn`` cache, keyed by
        :meth:`step_key`."""
        key = self.step_key(b, t, nblk, window, fast_greedy, mm, masked)
        prog = self.programs.get(key)
        if prog is None:
            log.info("capturing step program B=%d T=%d NBLK=%d W=%d greedy=%s mm=%s "
                     "masked=%s", b, t, nblk, window, fast_greedy, mm, masked)
            prog = self.programs[key] = StepProgram(self, b, t, nblk, window, fast_greedy,
                                                    mm=mm, masked=masked)
        return prog

    def verify_fn(self, b: int, t: int, nblk: int) -> "VerifyProgram":
        """The verify bucket's program, keyed ``("verify", b, t, nblk)``."""
        key = ("verify", b, t, nblk)
        prog = self.programs.get(key)
        if prog is None:
            log.info("capturing verify program B=%d T=%d NBLK=%d", b, t, nblk)
            prog = self.programs[key] = VerifyProgram(self, b, t, nblk)
        return prog

    def variant_inputs(self, b: int, t: int, mm: bool, masked: bool) -> list[torch.Tensor]:
        """The variant programs' static inputs, views of the runner-wide
        buffers: with ``mm`` the override [b, t, H] f32 and its mask [b, t];
        with ``masked`` the logits mask [b, V]. The mm buffer grows to a
        larger bucket by being made anew: the programs captured on the old
        one are dropped then (the card first finishes their work), to be
        captured again at their next use."""
        dev = self.device
        out: list[torch.Tensor] = []
        if mm:
            h = self.cfg.hidden_size
            if self._mm_mask is None or self._mm_mask.numel() < b * t:
                stale = [k for k in self.programs if "mm" in k[5:]]
                if stale:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    for k in stale:
                        del self.programs[k]
                    log.info("mm buffer grows to B=%d T=%d: %d programs dropped",
                             b, t, len(stale))
                self._mm_override = self._mm_mask = None  # freed before the new one
                self._mm_override = torch.zeros(b * t * h, dtype=torch.float32, device=dev)
                self._mm_mask = torch.zeros(b * t, dtype=torch.bool, device=dev)
            out += [self._mm_override[: b * t * h].view(b, t, h),
                    self._mm_mask[: b * t].view(b, t)]
        if masked:
            if self._logit_mask is None:
                # rows never outnumber max_batch_size; a count past a
                # ladder is its own bucket
                n, ladder = self.engine_cfg.max_batch_size, self.engine_cfg.decode_bucket
                rows = max(_bucket(n, ladder), _bucket(n, (1, 2, 4, 8)))
                self._logit_mask = torch.ones((rows, self.cfg.vocab_size),
                                              dtype=torch.bool, device=dev)
            out.append(self._logit_mask[:b])
        return out

    def dispatch(self, rows: list[tuple[Seq, int, int]], sample_rows: list[bool],
                 window: int = 1, masks: list | None = None,
                 mixed: bool = False) -> StepOutputs:
        """Enqueue one bucketed step on the device without waiting for it;
        returns its outputs (tokens [B], or [B, window] for a fused decode
        window), to be materialized later. ``window > 1`` (decode rows
        only) fuses that many decode steps into the dispatch — the caller
        must have grown each seq's block table to cover ``window`` more
        tokens. ``masks``: per-row bool[V] allow-masks (guided rows) or
        None. ``mixed`` marks a unified ragged step (decode rows packed
        with prefill-chunk rows): the batch buckets over the decode row
        ladder while t takes the prefill chunk ladder. A chunk that meets a
        multimodal span carries its embedding rows (the "mm" variant)."""
        ec = self.engine_cfg
        n = len(rows)
        t_max = max(length for _, _, length in rows)
        if t_max == 1:
            # Degenerate mixed batches (every live row is one token) ARE
            # the decode step.
            b, t = _bucket(n, ec.decode_bucket), 1
        elif mixed:
            window = 1
            b, t = _bucket(n, ec.decode_bucket), _pow2_bucket(t_max, 16, ec.prefill_chunk)
        else:
            window = 1  # windows are a decode-dispatch concept
            b, t = _bucket(n, (1, 2, 4, 8)), _pow2_bucket(t_max, 16, ec.prefill_chunk)
        # Block-table width from the batch's max KV coverage — blocks past
        # start + length (+ window - 1 for a fused window) are never read.
        # Pow2-bucketed like the JAX runner.
        bsz = ec.block_size
        nblk_need = max(min(len(s.block_ids), -(-(start + length + window - 1) // bsz))
                        for s, start, length in rows)
        nblk = min(_pow2_bucket(max(nblk_need, 1), 4, self.max_nblk), self.max_nblk)

        # One int32 and one float32 host buffer carry every step input, so
        # the step costs two host→device copies.
        ints = np.zeros(b * t + b * nblk + 6 * b, np.int32)
        tokens = ints[: b * t].reshape(b, t)
        bt = ints[b * t: b * t + b * nblk].reshape(b, nblk)
        q_start, q_len, slots, top_k, do_sample, from_slot = (
            ints[b * (t + nblk):].reshape(6, b))
        floats = np.zeros((5, b), np.float32)
        temp, top_p, fp, pp, rp = floats
        top_p[:] = 1.0
        rp[:] = 1.0
        fast_greedy = True  # padding rows (temp 0, rp 1) are greedy-compatible

        for i, (seq, start, length) in enumerate(rows):
            # Decode rows only (start at/after the prefill target): a
            # length-1 resume-prefill chunk must read its host token, not
            # the in-flight sampled one.
            if (seq.inflight_samples > 0 and length == 1
                    and start >= seq.prefill_target()):
                # The input token was sampled by a still-in-flight step;
                # the step reads it from slot_toks on the device.
                from_slot[i] = 1
            else:
                chunk = seq.tokens[start: start + length]
                tokens[i, : len(chunk)] = chunk
            q_start[i] = start
            q_len[i] = length
            ids = seq.block_ids[:nblk]  # beyond-coverage blocks never read
            bt[i, : len(ids)] = ids
            slots[i] = max(seq.slot, 0)
            so = seq.req.sampling_options
            temp[i] = so.temperature if so.temperature is not None else 1.0
            top_k[i] = so.top_k or 0
            top_p[i] = so.top_p if so.top_p is not None else 1.0
            fp[i] = so.frequency_penalty or 0.0
            pp[i] = so.presence_penalty or 0.0
            rp[i] = so.repetition_penalty or 1.0
            do_sample[i] = sample_rows[i]
            if temp[i] > 0.0 or fp[i] != 0.0 or pp[i] != 0.0 or rp[i] != 1.0:
                fast_greedy = False

        extra: list[np.ndarray] = []
        # Multimodal: chunks meeting an embedding span carry the encoder
        # outputs for those positions. NOT gated on t > 1 — a length-1
        # prefill tail (chunk budget, prefix-cache hit leaving one token)
        # can land inside a span, and serving the placeholder embedding
        # there would poison the prefix cache. Decode rows start at/after
        # the prompt end, so they never meet a span.
        for i, (seq, start, length) in enumerate(rows):
            if not seq.mm_spans or start >= seq.mm_end:
                continue  # decode rows skip the span scan with one compare
            for pos, emb in seq.mm_spans:
                lo, hi = max(pos, start), min(pos + emb.shape[0], start + length)
                if lo >= hi:
                    continue
                if not extra:
                    extra = [np.zeros((b, t, self.cfg.hidden_size), np.float32),
                             np.zeros((b, t), bool)]
                extra[0][i, lo - start: hi - start] = emb[lo - pos: hi - pos]
                extra[1][i, lo - start: hi - start] = True
        mm = bool(extra)
        masked = masks is not None and any(m is not None for m in masks)
        if masked:
            fast_greedy = False
            logit_mask = np.ones((b, self.cfg.vocab_size), bool)
            for i, m in enumerate(masks):
                if m is not None:
                    logit_mask[i] = m
            extra.append(logit_mask)

        led = self._ledger
        cold = led.enabled and self.step_key(
            b, t, nblk, window, fast_greedy, mm, masked) not in self.programs
        if cold:
            # Making a program blocks this thread for its warm run, its
            # capture and the graph's instantiation.
            led.mark_inflight(True)
            t_capture = time.perf_counter()
        prog = self.step_fn(b, t, nblk, window, fast_greedy, mm, masked)
        if cold:
            led.mark_inflight(False)
            kind = ("window" if window > 1 else "decode" if t == 1
                    else "mixed" if mixed else "prefill")
            led.record(BucketSig(kind, b, t, nblk, fast_greedy, ec.kv_dtype or "bfloat16"),
                       time.perf_counter() - t_capture,
                       trace_ctx=next((s.trace_ctx for s, _, _ in rows
                                       if s.trace_ctx is not None), None))
        return prog(ints, floats, *extra)

    def _body(self, ints: torch.Tensor, floats: torch.Tensor, b: int, t: int,
              nblk: int, window: int, fast_greedy: bool,
              emb_override: torch.Tensor | None = None, emb_mask: torch.Tensor | None = None,
              logit_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The step program on its static inputs (JAX: ``_build_step_fn``;
        with ``window > 1``, ``_build_window_fn``: W decode steps unrolled,
        step j at ``q_start + j`` on step j-1's tokens). Returns tokens and
        logprobs, [B] or [B, W]. ``emb_override``/``emb_mask`` replace the
        embeddings of the masked positions; ``logit_mask`` (guided rows)
        sets disallowed logits to -1e30 — the bits of JAX's additive
        0 / -1e30 mask for every finite logit below ~3.8e22."""
        cfg = self.cfg
        trash_row = self.engine_cfg.max_batch_size
        tokens = ints[: b * t].view(b, t)
        bt = ints[b * t: b * t + b * nblk].view(b, nblk)
        q_start, q_len, slots, top_k, do_sample, from_slot = ints[b * (t + nblk):].view(6, b)
        slots_l = slots.long()
        do_sample = do_sample.bool()
        # Only sampling rows persist state; others write to the trash row.
        write_slots = torch.where(do_sample, slots_l, torch.full_like(slots_l, trash_row))
        # Device-fed decode input: rows whose previous token was sampled by
        # an in-flight step read it from slot_toks (stream order guarantees
        # the producing step has run).
        tokens[:, 0] = torch.where(from_slot.bool(), self.slot_toks[slots_l], tokens[:, 0])
        toks_w, lps_w = [], []
        for j in range(window):
            hidden = llama.forward(self.params, cfg, tokens if j == 0 else toks_w[-1][:, None],
                                   q_start if j == 0 else q_start + j, q_len, bt,
                                   self.cache_k, self.cache_v,
                                   attn_num_splits=self.engine_cfg.attn_num_splits,
                                   embed_override=emb_override, embed_mask=emb_mask)
            logits = llama.logits_from_hidden(self.params, cfg, hidden).float()
            if logit_mask is not None:
                logits = logits.masked_fill(~logit_mask, NEG_INF)
            with _perf_phase("sampling"):
                if fast_greedy:
                    # Whole batch greedy + penalty-free: argmax over raw
                    # logits is identical to the general path and skips its
                    # sort and noise.
                    toks, lps = greedy_sample(logits)
                else:
                    temp, top_p, fp, pp, rp = floats
                    st = SamplingState(
                        temperature=temp, top_k=top_k, top_p=top_p,
                        frequency_penalty=fp, presence_penalty=pp, repetition_penalty=rp,
                        seeds=self.seeds[slots_l], draws=self.draws[slots_l],
                        token_counts=self.counts[slots_l])
                    toks, lps = sample(logits, st)
                    self.counts[write_slots] = record_tokens(st.token_counts, toks, do_sample)
                    self.draws[write_slots] = st.draws + 1
            self.slot_toks[write_slots] = toks
            toks_w.append(toks)
            lps_w.append(lps)
        if window == 1:
            return toks_w[0], lps_w[0]
        return torch.stack(toks_w, dim=1), torch.stack(lps_w, dim=1)

    def run(self, rows: list[tuple[Seq, int, int]],
            sample_rows: list[bool]) -> tuple[np.ndarray, np.ndarray]:
        """Dispatch one step and block for host results (tokens, logprobs)."""
        toks, lps = self.dispatch(rows, sample_rows).materialize()
        n = len(rows)
        return toks[:n], lps[:n]

    # -- speculative verify ----------------------------------------------
    def dispatch_verify(self, rows: list[tuple[Seq, int, int]],
                        chunks: list[list[int]]) -> StepOutputs:
        """Enqueue one verify step (engine/spec.py); the chunk tokens are
        explicit (the proposals are not in seq.tokens yet). Returns
        ([B, t] argmax tokens, their logprobs)."""
        ec = self.engine_cfg
        n = len(rows)
        t_max = max(len(c) for c in chunks)
        b = _bucket(n, ec.decode_bucket)
        # clamp: _pow2_bucket's hi stops further doubling but does not cap
        # the result — a 5-token chunk must not make (and pay for) T=8
        t = min(_pow2_bucket(t_max, 2, ec.spec_k + 1), ec.spec_k + 1)
        # Same coverage-based table width as dispatch(): the verify chunk
        # reads nothing past start + len(chunk).
        bsz = ec.block_size
        nblk_need = max(min(len(seq.block_ids), -(-(start + len(c)) // bsz))
                        for (seq, start, _), c in zip(rows, chunks))
        nblk = min(_pow2_bucket(max(nblk_need, 1), 4, self.max_nblk), self.max_nblk)

        ints = np.zeros(b * t + b * nblk + 2 * b, np.int32)
        tokens = ints[: b * t].reshape(b, t)
        bt = ints[b * t: b * t + b * nblk].reshape(b, nblk)
        q_start, q_len = ints[b * (t + nblk):].reshape(2, b)
        for i, (seq, start, _length) in enumerate(rows):
            tokens[i, : len(chunks[i])] = chunks[i]
            q_start[i] = start
            q_len[i] = len(chunks[i])
            ids = seq.block_ids[:nblk]
            bt[i, : len(ids)] = ids

        led = self._ledger
        cold = led.enabled and ("verify", b, t, nblk) not in self.programs
        if cold:
            led.mark_inflight(True)
            t_capture = time.perf_counter()
        prog = self.verify_fn(b, t, nblk)
        if cold:
            led.mark_inflight(False)
            led.record(BucketSig("verify", b, t, nblk, True, ec.kv_dtype or "bfloat16"),
                       time.perf_counter() - t_capture,
                       trace_ctx=next((s.trace_ctx for s, _, _ in rows
                                       if s.trace_ctx is not None), None))
        return prog(ints)

    def _verify_body(self, ints: torch.Tensor, b: int, t: int,
                     nblk: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The verify program (JAX: ``_build_verify_fn``): one forward over
        a [B, t] chunk of (current token + proposed continuation),
        returning the argmax token and its logprob at every position.
        Greedy-only by contract (the planner verifies greedy, penalty-free
        rows only), so no sampling state is read or written; KV for all
        positions is written (rejected positions are overwritten by later
        true tokens)."""
        tokens = ints[: b * t].view(b, t)
        bt = ints[b * t: b * t + b * nblk].view(b, nblk)
        q_start, q_len = ints[b * (t + nblk):].view(2, b)
        hidden = llama.forward(self.params, self.cfg, tokens, q_start, q_len, bt,
                               self.cache_k, self.cache_v,
                               attn_num_splits=self.engine_cfg.attn_num_splits,
                               return_all_hidden=True)
        logits = llama.logits_from_hidden(self.params, self.cfg, hidden).float()  # [B, t, V]
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        lps = torch.log_softmax(logits, dim=-1).gather(-1, toks.long()[..., None])[..., 0]
        return toks, lps

    # -- embeddings ------------------------------------------------------
    def embed(self, token_lists: list[list[int]]) -> np.ndarray:
        """Embed a batch of token sequences → [N, H] float32: the
        final-norm hidden state at each input's last token (JAX:
        ``ModelRunner.embed``). A prefill-only forward on a cache of its
        own, in the model dtype, made for the call: embedding calls never
        touch the serving pool. Each row owns its blocks of that cache
        (the JAX runner gives every row the same table, so a batch of
        more than one input writes its rows' K and V over each other)."""
        ec, cfg = self.engine_cfg, self.cfg
        n = len(token_lists)
        t_max = max(len(ts) for ts in token_lists)
        if t_max > ec.max_model_len:
            raise ValueError(f"embedding input of {t_max} tokens exceeds max_model_len="
                             f"{ec.max_model_len}")
        t = _pow2_bucket(t_max, 16, ec.max_model_len)
        # Bounded bucket ladder, as the JAX runner's: client batch sizes
        # do not make unbounded bucket shapes.
        b = _bucket(n, (1, 2, 4, 8, 16, 32, 64))
        nblk = -(-t // ec.block_size)
        cold = self._ledger.enabled and (b, t) not in self._embed_buckets
        t0 = time.perf_counter()
        tokens = np.zeros((b, t), np.int32)
        q_len = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):
            tokens[i, : len(ts)] = ts
            q_len[i] = len(ts)
        dev = self.device
        # block 0 is the padding tokens' trash block; row i owns blocks
        # 1 + i*nblk .. (i+1)*nblk
        shape = (cfg.num_layers, b * nblk + 1, ec.block_size, cfg.num_kv_heads, cfg.head_dim)
        ck = torch.zeros(shape, dtype=llama.torch_dtype(cfg.dtype), device=dev)
        cv = torch.zeros_like(ck)
        bt = torch.arange(1, b * nblk + 1, dtype=torch.int32, device=dev).view(b, nblk)
        hidden = llama.forward(self.params, cfg, torch.from_numpy(tokens).to(dev),
                               torch.zeros((b,), dtype=torch.int32, device=dev),
                               torch.from_numpy(q_len).to(dev), bt, ck, cv,
                               attn_num_splits=ec.attn_num_splits)
        out = hidden[:n].float().cpu().numpy()
        self._embed_buckets.add((b, t))
        if cold:
            self._ledger.record(BucketSig("embed", b, t, 0, True, ec.kv_dtype or "bfloat16"),
                                time.perf_counter() - t0)
        return out

    # -- bucket warmup ---------------------------------------------------
    def warmup(self, sigs: list[BucketSig], deadline_s: float = 0.0) -> dict:
        """Make (warm and capture) the program of each enumerated bucket
        (obs/compile_ledger.py) before serving, so no serving dispatch pays
        a capture. The warm runs use padding inputs — q_len=0 rows,
        do_sample=False (sampling-state writes land on the trash row), KV
        writes to pool block 0, which no sequence reads. ``deadline_s``
        bounds the total wall (0 = unbounded); lattice entries past the
        deadline stay cold and count against coverage. On the card the
        summary also has ``graph_pool_gib``: the growth of the allocator's
        reserved memory over the warmup, which is the graphs' shared pool
        (every capture empties the allocator's other cached blocks), and
        ``graph_pool_top``: the buckets whose warm run and capture grew it
        most, in GiB. A pool over ``GRAPH_POOL_SHARE`` of the card is
        logged as a warning: that memory is no longer free for KV blocks."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        captured = cached = failed = skipped = 0
        growth: list[tuple[float, BucketSig]] = []
        for sig in sigs:
            if deadline_s > 0 and time.perf_counter() - t0 >= deadline_s:
                skipped += 1
                continue
            before = torch.cuda.memory_reserved(self.device) if cuda else 0
            try:
                hit = self._warm_one(sig)
            except Exception:
                log.warning("warmup capture failed for %s", sig, exc_info=True)
                failed += 1
                continue
            cached += 1 if hit else 0
            captured += 0 if hit else 1
            if cuda:
                growth.append(((torch.cuda.memory_reserved(self.device) - before) / 2**30, sig))
        summary = {"captured": captured, "cached": cached, "failed": failed,
                   "deadline_skipped": skipped,
                   "seconds": round(time.perf_counter() - t0, 3),
                   "coverage": round(self._ledger.coverage(), 4)}
        if cuda:
            torch.cuda.empty_cache()
            pool = (torch.cuda.memory_reserved(self.device) - reserved0) / 2**30
            summary["graph_pool_gib"] = pool
            growth.sort(key=lambda gs: -gs[0])
            summary["graph_pool_top"] = [
                {"kind": sig.kind, "b": sig.b, "t": sig.t, "nblk": sig.nblk,
                 "greedy": sig.greedy, "gib": gib} for gib, sig in growth[:8] if gib > 0]
            card = torch.cuda.get_device_properties(self.device).total_memory / 2**30
            if pool > GRAPH_POOL_SHARE * card:
                log.warning(
                    "the graph pool holds %.1f GiB, %.0f%% of the card, memory no KV block "
                    "can use; most of it went to the buckets %s (b x t token rows of the "
                    "largest: %d). Lower max_batch_size, max_tokens_per_step or the "
                    "prefill chunk to keep it smaller.",
                    pool, 100 * pool / card,
                    [(s.kind, s.b, s.t) for _, s in growth[:4]],
                    max(s.b * s.t for _, s in growth) if growth else 0)
        log.info("bucket warmup: %s", summary)
        return summary

    def _warm_one(self, sig: BucketSig) -> bool:
        """Make one bucket's program. Returns True when it already
        existed (nothing captured)."""
        if sig.kind == "verify":
            key: tuple = ("verify", sig.b, sig.t, sig.nblk)
        else:
            window = self.engine_cfg.decode_window if sig.kind == "window" else 1
            key = self.step_key(sig.b, sig.t, sig.nblk, window, sig.greedy)
        if key in self.programs:
            return True
        t0 = time.perf_counter()
        if sig.kind == "verify":
            self.verify_fn(*key[1:])
        else:
            self.step_fn(*key)
        self._ledger.record(sig, time.perf_counter() - t0, source="warmup")
        return False


class StepProgram:
    """One bucket's step program: the counterpart of a jitted step of the
    JAX runner.

    It owns the bucket's static inputs — one int32 and one float32 buffer
    laid out as ``ModelRunner.dispatch`` packs them, holding padding until
    a step fills them; the "mm" and "masked" variants also take views of
    the runner's shared buffers (``ModelRunner.variant_inputs``). Making it
    runs the body once on those padding inputs (the warm run: first
    launches build the kernels and size cuBLAS's workspaces, off the
    capture); on the card it then captures the body into a CUDA graph in
    the runner's shared graph pool, on the runner's side stream. A capture
    failure raises; nothing falls back to eager. A call copies the step's
    host inputs into the static buffers, replays the graph, and right after
    the replay, on the same stream, copies its static outputs (``toks``,
    ``lps``) into fresh pinned host tensors behind an event — before any
    other graph of the pool can reuse their memory. On the CPU nothing is
    captured: a call runs the body eagerly on the same static buffers.

    Kernel launches: the warm run's are not counted, the capture's are
    recorded (``launches``, by kernel) and every call counts them once
    (``ops.paged_attention.count_launches``); ``calls`` counts the calls."""

    def __init__(self, runner: ModelRunner, b: int, t: int, nblk: int, window: int,
                 fast_greedy: bool, mm: bool = False, masked: bool = False):
        self.runner = runner
        self.shape = (b, t, nblk, window, fast_greedy)
        self.mm, self.masked = mm, masked
        dev = runner.device
        ints = torch.zeros(b * t + b * nblk + 6 * b, dtype=torch.int32, device=dev)
        # padding sampling params: temp 0, top_p 1, penalties 0, rep 1
        floats = torch.tensor([0.0, 1.0, 0.0, 0.0, 1.0], device=dev)[:, None].repeat(1, b)
        self.inputs = [ints, floats, *runner.variant_inputs(b, t, mm, masked)]
        self._make()

    @property
    def ints(self) -> torch.Tensor:
        return self.inputs[0]

    def _make(self) -> None:
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple[torch.Tensor, torch.Tensor] | None = None
        with pa.launches_made():
            self._warm()
        with pa.launches_made() as made:
            self._capture()
        self.launches: dict[str, int] = made
        self.calls = 0

    def _run(self) -> tuple[torch.Tensor, torch.Tensor]:
        ints, floats, *rest = self.inputs
        emb, emb_mask = rest[:2] if self.mm else (None, None)
        logit_mask = rest[-1] if self.masked else None
        return self.runner._body(ints, floats, *self.shape, emb, emb_mask, logit_mask)

    def _warm(self) -> None:
        if self.runner.device.type != "cuda":
            self._run()
            return
        side = self.runner.capture_stream
        side.wait_stream(torch.cuda.current_stream(self.runner.device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(self.runner.device).wait_stream(side)

    def _capture(self) -> None:
        if self.runner.device.type != "cuda":
            return
        self.graph = torch.cuda.CUDAGraph()
        # No garbage collection while capturing: a collected program of an
        # engine gone out of use (a cycle through its runner) destroys its
        # CUDA graph, which a capturing stream does not permit, and that
        # voids this capture.
        gc_on = gc.isenabled()
        gc.disable()
        try:
            # thread_local: an unsafe CUDA call made meanwhile by another
            # thread (the asyncio side of AsyncTorchEngine) does not void
            # the capture.
            with torch.cuda.graph(self.graph, pool=self.runner.graph_pool,
                                  stream=self.runner.capture_stream,
                                  capture_error_mode="thread_local"):
                self.outputs = self._run()
        finally:
            if gc_on:
                gc.enable()

    def _replay(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.graph is None:
            return self._run()
        self.graph.replay()
        return self.outputs

    def __call__(self, *host_inputs: np.ndarray) -> StepOutputs:
        """Run the program on ``host_inputs``, one array for each static
        input, in order."""
        cuda = self.runner.device.type == "cuda"
        started = None
        if cuda:
            started = torch.cuda.Event(enable_timing=True)
            started.record()
        for static, arr in zip(self.inputs, host_inputs, strict=True):
            host = torch.from_numpy(arr)
            # A fresh pinned tensor per step: the previous step's
            # non-blocking copy may not have run yet.
            static.copy_(host.pin_memory() if cuda else host, non_blocking=cuda)
        toks, lps = self._replay()
        pa.count_launches(self.launches)
        self.calls += 1
        if not cuda:
            return StepOutputs(toks, lps)
        toks_h = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        lps_h = torch.empty(lps.shape, dtype=lps.dtype, pin_memory=True)
        toks_h.copy_(toks, non_blocking=True)
        lps_h.copy_(lps, non_blocking=True)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return StepOutputs(toks_h, lps_h, event, started)


class VerifyProgram(StepProgram):
    """A verify bucket's program (``ModelRunner._verify_body``): one int32
    static input laid out as ``ModelRunner.dispatch_verify`` packs it
    (tokens [B, t], block tables, q_start, q_len); outputs [B, t]."""

    def __init__(self, runner: ModelRunner, b: int, t: int, nblk: int):
        self.runner = runner
        self.shape = (b, t, nblk)
        self.inputs = [torch.zeros(b * t + b * nblk + 2 * b, dtype=torch.int32,
                                   device=runner.device)]
        self._make()

    def _run(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.runner._verify_body(self.inputs[0], *self.shape)


class EngineCore:
    """Synchronous engine: scheduler + runner + output assembly."""

    def __init__(self, engine_cfg: EngineConfig, params=None,
                 device: str | torch.device | None = None):
        check_supported(engine_cfg)
        self.engine_cfg = engine_cfg
        self.model_cfg = resolve_model_config(engine_cfg.model)
        if self.model_cfg.is_moe:
            raise ValueError(f"{engine_cfg.model!r} is a MoE model: not supported "
                             "by the torch port yet (MoE slice)")
        device = resolve_device(device)
        # Unified ragged mixed-phase steps: one launch per iteration when
        # prefill work rides along. Fused decode windows keep the legacy
        # path (a window is decode-only).
        self._unified = engine_cfg.unified_step and engine_cfg.decode_window == 1
        # Compile ledger gate (obs/compile_ledger.py): configured before the
        # runner exists so every program this engine makes is governed by
        # the same mode; the enumerated lattice is the coverage denominator
        # in lazy mode and the capture worklist in full mode (warmup()).
        get_compile_ledger().configure(engine_cfg.warmup_mode)
        # Scheduling ledger gate (obs/sched_ledger.py): re-read the
        # DYN_SCHED_LEDGER env at engine construction so tests flipping
        # the env see the gate they set.
        self.sched_led = get_sched_ledger()
        self.sched_led.configure()
        # The device's roofline row (obs/costmodel.py): the CPU row on the
        # CPU, the card's row by its name. A card the table lacks prices
        # nothing (None) and refuses prefill_chunk=0, whose chunks would
        # otherwise be sized at another device's rates.
        self.device_name = device_name(device)
        self._hw: cm.HardwareSpec | None = None
        try:
            self._hw = cm.hw_spec_for(self.device_name)
        except LookupError as exc:
            if engine_cfg.prefill_chunk <= 0:
                raise ValueError(f"prefill_chunk=0 sizes prefill chunks from the "
                                 f"device's roofline: {exc}") from None
        # SLO-driven chunk sizing (prefill_chunk=0 = auto): resolve to
        # concrete per-QoS chunks BEFORE bucket enumeration and the
        # scheduler read the config — the prefill t ladder, warmup plan
        # and per-step token budget all key off ec.prefill_chunk, so auto
        # must not leave a 0 behind. The cap is the batch class's chunk
        # (largest SLO budget); interactive/standard refine downward
        # per-seq inside the scheduler.
        if engine_cfg.prefill_chunk <= 0:
            ladder_cap = min(engine_cfg.max_model_len, engine_cfg.max_tokens_per_step)
            self.chunk_by_qos = {
                qos: cm.auto_prefill_chunk(
                    self.model_cfg, self._hw,
                    itl_slo_s=engine_cfg.itl_slo_ms / 1e3,
                    decode_rows=engine_cfg.max_batch_size,
                    decode_kv_len=max(engine_cfg.max_model_len // 2, engine_cfg.block_size),
                    block_size=engine_cfg.block_size,
                    max_chunk=ladder_cap,
                    kv_dtype=engine_cfg.kv_dtype or "bfloat16",
                    quantization=engine_cfg.quantization or "none",
                    qos_class=qos)
                for qos in cm.QOS_ITL_SLO_SCALE}
            resolved = max(self.chunk_by_qos.values())
            log.info("auto prefill chunk (itl_slo=%.1fms, %s): %s -> cap %d",
                     engine_cfg.itl_slo_ms, self._hw.name, self.chunk_by_qos, resolved)
            engine_cfg = dataclasses.replace(engine_cfg, prefill_chunk=resolved)
            self.engine_cfg = engine_cfg
        else:
            self.chunk_by_qos = {qos: engine_cfg.prefill_chunk
                                 for qos in cm.QOS_ITL_SLO_SCALE}
        self.sched_led.set_prefill_chunks(self.chunk_by_qos)
        self.runner = ModelRunner(self.model_cfg, engine_cfg, params=params,
                                  device=device)
        if engine_cfg.warmup_mode != "off":
            get_compile_ledger().set_plan(enumerate_buckets(engine_cfg))
        self.pool = PrefixPool(self.runner.spec.num_blocks, engine_cfg.block_size,
                               enable_prefix_caching=engine_cfg.enable_prefix_caching)
        self.sched = Scheduler(
            pool=self.pool,
            max_batch_size=engine_cfg.max_batch_size,
            prefill_chunk=engine_cfg.prefill_chunk,
            max_model_len=engine_cfg.max_model_len,
            max_tokens_per_step=engine_cfg.max_tokens_per_step,
            decode_window=engine_cfg.decode_window,
            spec_lookahead=engine_cfg.spec_k if engine_cfg.spec_ngram > 0 else 0,
            chunk_by_qos=self.chunk_by_qos,
        )
        self.metrics = EngineMetrics(
            kv_cache_bytes=self.runner.spec.bytes_per_block() * self.runner.spec.num_blocks,
            kv_quant_enabled=self.runner.spec.quantized)
        # Hardware counters: analytic FLOPs/bytes + MFU/BW-util per step
        # (obs/profiler.py). DYN_PERF_PROFILE=0 turns the whole thing into
        # a no-op per step.
        self.perf = StepPerfProfiler(self.model_cfg, engine_cfg, self.device_name)
        self._seqs: dict[str, Seq] = {}
        self.default_eos: list[int] = []
        # Tracing: decode spans rotate every N generated tokens — one span
        # (one allocation) per N steps, never per token (obs/tracer.py).
        self._trace_stride = max(int(os.environ.get("DYN_TRACE_DECODE_STRIDE", "32")), 1)
        self._trace_last_preempt = 0
        # Deadline clock for the current step window.
        self._step_now: float | None = None
        # The last warmup()'s summary.
        self.warmup_summary: dict | None = None
        # Structured output: token-id → text table + tokenizer EOS, built
        # lazily on the first guided request (engine/guided.py).
        self._guided_vocab: tuple[list[str], list[int]] | None = None
        # Memory & capacity ledger (obs/mem_ledger.py): re-read the
        # DYN_MEM_LEDGER env at construction (same contract as the sched
        # ledger above), publish this engine's device pool as the tier row,
        # and hand the audit a live-id source so orphaned pins reconcile
        # against what this engine actually holds. Both are pulled only at
        # snapshot/audit time, never on the step path.
        self.mem_led = get_mem_ledger()
        self.mem_led.configure()
        register_device_tier(self.pool, self.runner.spec)
        self._mem_source_key = f"engine:{id(self):x}"
        self.mem_led.register_live_source(self._mem_source_key,
                                          _weak_source(self._mem_live_ids))

    def _mem_live_ids(self) -> dict:
        """Per-owner-class live ids for the mem-ledger leak audit. A pin
        tagged under any class but absent from the matching set here is an
        orphan — a reference the engine no longer knows about. The port's
        engine holds stream pins only: the other classes' owners (sessions,
        KVBM queues, disagg staging) are not ported yet and report empty."""
        return live_ids_of(streams=self._seqs.keys())

    def _guided_pieces(self) -> tuple[list[str], list[int]]:
        if self._guided_vocab is None:
            from dynamo_tpu_torch.tokenizer import guided_vocab, load_tokenizer

            tok = load_tokenizer(self.engine_cfg.model)
            pieces = guided_vocab(tok, self.runner.cfg.vocab_size)
            eos = getattr(tok, "eos_id", None)
            self._guided_vocab = (pieces, [eos] if eos is not None else [])
        return self._guided_vocab

    def warmup(self) -> dict:
        """Bucket warmup (obs/compile_ledger.py), run before the engine
        serves (``build_engine`` calls it before the step loop starts, so
        device state has one owner throughout). ``off``/``lazy`` return at
        once; ``full`` makes the program of every enumerated bucket under
        ``warmup_deadline``."""
        ec = self.engine_cfg
        led = get_compile_ledger()
        out: dict = {"mode": ec.warmup_mode, "coverage": round(led.coverage(), 4)}
        if ec.warmup_mode != "off" and led.plan is not None:
            out["buckets"] = len(led.plan)
        if ec.warmup_mode == "full":
            out.update(self.runner.warmup(
                sorted(led.plan or enumerate_buckets(ec),
                       key=lambda s: (s.kind, s.b, s.t, s.nblk, s.greedy)),
                deadline_s=ec.warmup_deadline))
        self.warmup_summary = out
        return out

    # ------------------------------------------------------------------
    def add_request(self, req: PreprocessedRequest,
                    now: float | None = None) -> LLMEngineOutput | None:
        """Queue a request; returns an immediate error output if rejected."""
        if not req.token_ids:
            return LLMEngineOutput(
                finish_reason=FinishReason.ERROR, error="empty prompt (no token_ids)")
        if expired(deadline_of(req.annotations), now):
            # Already past deadline: never enters the scheduler.
            self.metrics.deadline_cancelled += 1
            return LLMEngineOutput(finish_reason=FinishReason.CANCELLED)
        seq = Seq(req=req, block_size=self.engine_cfg.block_size)
        if req.sampling_options.guided_json is not None:
            pieces, tok_eos = self._guided_pieces()
            eos_ids = list(req.eos_token_ids or self.default_eos or tok_eos)
            seq.guided = TokenMasker(pieces, eos_ids, req.sampling_options.guided_json)
        if req.mm_embeddings:
            try:
                seq.mm_spans = [(int(s["pos"]), tensor_from_wire(s))
                                for s in req.mm_embeddings]
            except Exception as exc:  # noqa: BLE001 - malformed client input
                return LLMEngineOutput(
                    finish_reason=FinishReason.ERROR,
                    error=f"bad mm_embeddings payload: {exc}")
            H = self.model_cfg.hidden_size
            for pos, emb in seq.mm_spans:
                if (emb.ndim != 2 or emb.shape[1] != H or pos < 0
                        or pos + emb.shape[0] > len(req.token_ids)):
                    return LLMEngineOutput(
                        finish_reason=FinishReason.ERROR,
                        error=f"mm span (pos={pos}, shape={emb.shape}) out of "
                              f"range for prompt len {len(req.token_ids)} / "
                              f"hidden {H}")
            seq.mm_end = max(pos + emb.shape[0] for pos, emb in seq.mm_spans)
        self.sched.add(seq)
        if seq.phase is Phase.FINISHED:  # rejected (too long for model or pool)
            return LLMEngineOutput(
                finish_reason=FinishReason.ERROR,
                error=f"prompt of {seq.prompt_len} tokens exceeds capacity "
                      f"(max_model_len={self.engine_cfg.max_model_len}, "
                      f"usable_kv_blocks={self.pool.num_blocks - 1})",
            )
        self._seqs[req.request_id] = seq
        seq.trace_ctx = trace_context_of(getattr(req, "annotations", None))
        if seq.trace_ctx is not None:
            # Admission wait starts now; step_begin ends it when the first
            # prefill chunk is planned (engine.queue → engine.prefill).
            seq.trace_span = get_tracer().start_span(
                "engine.queue", ctx=seq.trace_ctx,
                request_id=req.request_id, model=req.model,
                prompt_tokens=seq.prompt_len, priority=seq.qos_priority)
        self.metrics.prefix_lookup_blocks += max(len(seq.tokens) // seq.block_size, 1)
        return None

    def abort(self, request_id: str) -> None:
        seq = self._seqs.get(request_id)
        if seq is None or seq.phase is Phase.FINISHED:
            return
        self._trace_finish(seq, FinishReason.CANCELLED)
        self.sched.finish(seq, FinishReason.CANCELLED)

    def has_work(self) -> bool:
        return self.sched.has_work()

    # ------------------------------------------------------------------
    def _check_stop(self, seq: Seq, token: int) -> FinishReason | None:
        sc = seq.req.stop_conditions
        n_out = seq.num_output_tokens
        if expired(seq.deadline_ts, self._step_now):
            # Mid-decode deadline: nobody is waiting for the rest.
            self.metrics.deadline_cancelled += 1
            return FinishReason.CANCELLED
        eos_ids = set(seq.req.eos_token_ids or self.default_eos)
        if token in (sc.stop_token_ids or []):
            return FinishReason.STOP
        if token in eos_ids and not sc.ignore_eos and (sc.min_tokens or 0) <= n_out:
            return FinishReason.STOP
        if sc.max_tokens is not None and n_out >= sc.max_tokens:
            return FinishReason.LENGTH
        if len(seq.tokens) >= self.engine_cfg.max_model_len:
            return FinishReason.LENGTH
        return None

    def _init_slot(self, seq: Seq) -> None:
        """Reset a seq's sampling slot: every stream gets a concrete seed
        (explicit or request-derived)."""
        so = seq.req.sampling_options
        seed = so.seed if so.seed is not None else _derived_seed(seq.request_id)
        self.runner.reset_slot(seq.slot, seed)

    def step_begin(self) -> PendingStep | None:
        """Plan one engine step and dispatch it to the device without
        waiting for results. Host-side state is advanced speculatively
        (positions — everything value-independent), so the caller may plan
        and dispatch the NEXT step while this one computes: the sampled
        tokens stay on the device (slot_toks) and feed the next decode step
        directly. Value-dependent effects (token append, hash commit, stop
        conditions) happen in :meth:`step_finalize`."""
        plan = self.sched.plan()
        self.metrics.num_preemptions = self.sched.preemption_count
        if plan.empty:
            return None
        self.metrics.num_steps += 1
        self._trace_plan(plan)
        for seq in [w.seq for w in plan.prefill] + plan.decode:
            if not seq.slot_initialized and seq.slot >= 0:
                self._init_slot(seq)
                seq.slot_initialized = True

        # Unified mode: decode rows, guided decode rows and the step's
        # prefill-chunk rows pack into ONE ragged "mixed" step. Legacy mode
        # (unified_step=False, or decode_window > 1) runs them as separate
        # bucketed steps, decode first.
        pending = PendingStep()
        batches: list[tuple[str, list, list[bool], int, list | None]] = []
        decode_seqs = plan.decode
        guided_rows: list = []
        if any(s.guided is not None for s in decode_seqs):
            rest = []
            for s in decode_seqs:
                if s.guided is None:
                    rest.append(s)
                elif s.inflight_samples == 0:
                    # Unpipelined by design: the mask for token t needs
                    # token t-1 on the host.
                    guided_rows.append((s, s.num_computed, 1))
                # else: pause this cycle until the in-flight token lands
            decode_seqs = rest
        if self.engine_cfg.spec_ngram > 0 and decode_seqs:
            verify_rows, verify_chunks, decode_seqs = self._plan_verify(decode_seqs)
            if verify_rows:
                out = self.runner.dispatch_verify(verify_rows, verify_chunks)
                for seq, start, length in verify_rows:
                    seq.num_computed = start + length
                    seq.inflight_samples += 1
                    seq.verify_inflight = True
                pending.batches.append(("verify", verify_rows, verify_chunks, out))
        t_mask = time.perf_counter()
        pf_rows = [(w.seq, w.start, w.length) for w in plan.prefill]
        # Sample only on the chunk completing a *fresh* prompt; a
        # preempt-resumed seq already holds its next token (the resume
        # prefill just rebuilds KV), so sampling would duplicate output.
        pf_sample_rows = [
            w.start + w.length >= w.seq.prefill_target()
            and len(w.seq.tokens) == w.seq.prompt_len
            for w in plan.prefill
        ]
        pf_masks = None
        if any(w.seq.guided is not None and smp
               for w, smp in zip(plan.prefill, pf_sample_rows)):
            # The FIRST sampled token must already obey the grammar.
            pf_masks = [w.seq.guided.mask() if (w.seq.guided is not None and smp) else None
                        for w, smp in zip(plan.prefill, pf_sample_rows)]
        guided_masks = [s.guided.mask() for s, _, _ in guided_rows]
        if guided_rows or pf_masks is not None:
            self.metrics.guided_mask_seconds += time.perf_counter() - t_mask
            self.metrics.guided_mask_steps += 1
        dec_rows = [(s, s.num_computed, 1) for s in decode_seqs]
        if self._unified and pf_rows:
            # One ragged step: decode rows, guided decode rows (their masks
            # join per row), then the prefill chunks. dispatch() classifies
            # a degenerate all-length-1 batch back to "decode".
            pending.mixed_dec_rows = len(dec_rows) + len(guided_rows)
            masks = None
            if guided_rows or pf_masks is not None:
                masks = ([None] * len(dec_rows) + guided_masks
                         + (pf_masks if pf_masks is not None else [None] * len(pf_rows)))
            batches.append(("mixed", dec_rows + guided_rows + pf_rows,
                            [True] * pending.mixed_dec_rows + pf_sample_rows, 1, masks))
        else:
            if dec_rows:
                batches.append(("decode", dec_rows, [True] * len(dec_rows),
                                plan.decode_window, None))
            if guided_rows:
                batches.append(("decode", guided_rows, [True] * len(guided_rows), 1,
                                guided_masks))
            if pf_rows:
                batches.append(("prefill", pf_rows, pf_sample_rows, 1, pf_masks))

        for kind, rows, sample_rows, window, masks in batches:
            out = self.runner.dispatch(rows, sample_rows, window=window, masks=masks,
                                       mixed=(kind == "mixed"))
            # Value-independent bookkeeping, done at dispatch so the next
            # plan() sees advanced positions: a decode batch advances each
            # row by its window.
            advance = window if kind == "decode" else None
            for i, (seq, start, length) in enumerate(rows):
                seq.num_computed = start + (advance or length)
                if sample_rows[i]:
                    seq.inflight_samples += 1
            pending.batches.append((kind, rows, sample_rows, out))
        if self.sched_led.enabled:
            pending.sched = self._sched_info(plan)
        return pending

    def _sched_info(self, plan: StepPlan) -> dict:
        """The scheduling ledger's plan-time context of a step: decode
        window, token-budget utilization and the HOL stall of its prefill
        work on its decode rows."""
        used = (len(plan.decode) * plan.decode_window
                + sum(w.length for w in plan.prefill))
        hol = None
        if plan.prefill and plan.decode:
            # Every decode-ready stream in this step waits out the prefill
            # work before its token materializes; the culprit is the
            # request contributing the largest chunk. Under the unified step
            # the stall is NOT a whole separate launch — only the chunk's
            # marginal share of the mixed step's wall (priced by the cost
            # model) is charged to the victims.
            culprit = max(plan.prefill, key=lambda w: w.length)
            stall_share = None
            if self._unified and self._hw is not None:
                kw = dict(
                    decode_rows=len(plan.decode),
                    decode_kv_len=max(s.num_computed for s in plan.decode),
                    chunk_kv_len=max(w.start + w.length for w in plan.prefill),
                    block_size=self.engine_cfg.block_size,
                    kv_dtype=self.engine_cfg.kv_dtype or "bfloat16",
                    quantization=self.engine_cfg.quantization or "none")
                mixed_s = cm.mixed_step_seconds(
                    self.model_cfg, self._hw,
                    chunk=sum(w.length for w in plan.prefill), **kw)
                pure_s = cm.mixed_step_seconds(self.model_cfg, self._hw, chunk=0, **kw)
                if mixed_s > 0:
                    stall_share = max(mixed_s - pure_s, 0.0) / mixed_s
            hol = HolStall(
                culprit=culprit.seq.request_id,
                culprit_tokens=sum(w.length for w in plan.prefill),
                victims=[(s.trace_ctx, s.request_id, s.qos_priority)
                         for s in plan.decode],
                stall_share=stall_share)
        return {"decode_window": plan.decode_window,
                "budget_util": used / max(self.sched.max_tokens_per_step, 1),
                "hol": hol}

    def _trace_plan(self, plan: StepPlan) -> None:
        """Advance per-seq phase spans from the step plan. Untraced seqs
        (no obs.traceparent annotation) cost one None check here."""
        tr = None
        for w in plan.prefill:
            s = w.seq
            sp = s.trace_span
            if s.trace_ctx is None or (sp is not None and sp.name == "engine.prefill"):
                continue  # untraced, or a later chunk of the same prefill
            tr = tr or get_tracer()
            if sp is not None:
                # queue→prefill admit, or a preempt-resume out of decode.
                extra = ({"tokens": s.trace_tokens}
                         if sp.name == "engine.decode" and s.trace_tokens else {})
                tr.end_span(sp, prefix_hit_blocks=s.prefix_hit_blocks, **extra)
            s.trace_span = tr.start_span(
                "engine.prefill", ctx=s.trace_ctx, request_id=s.request_id,
                prompt_tokens=s.prompt_len, prefix_hit_blocks=s.prefix_hit_blocks)
            s.trace_tokens = 0
        for s in plan.decode:
            if s.trace_ctx is None:
                continue
            sp = s.trace_span
            if sp is not None and sp.name == "engine.decode":
                s.trace_tokens += plan.decode_window
                if s.trace_tokens >= self._trace_stride:
                    tr = tr or get_tracer()
                    tr.end_span(sp, tokens=s.trace_tokens, batch=len(plan.decode))
                    s.trace_span = tr.start_span(
                        "engine.decode", ctx=s.trace_ctx, request_id=s.request_id)
                    s.trace_tokens = 0
                continue
            tr = tr or get_tracer()
            if sp is not None:  # prefill complete: decode begins
                tr.end_span(sp)
            s.trace_span = tr.start_span(
                "engine.decode", ctx=s.trace_ctx, request_id=s.request_id,
                batch=len(plan.decode))
            s.trace_tokens = plan.decode_window

    def _trace_finish(self, seq: Seq, reason: FinishReason | None) -> None:
        sp = seq.trace_span
        if sp is None:
            return
        seq.trace_span = None
        status = "ok"
        if reason is FinishReason.CANCELLED:
            status = "cancelled"
        elif reason is FinishReason.ERROR:
            status = "error"
        attrs: dict = {"finish_reason": str(reason) if reason else "",
                       "output_tokens": seq.num_output_tokens}
        if sp.name == "engine.decode" and seq.trace_tokens:
            attrs["tokens"] = seq.trace_tokens
        get_tracer().end_span(sp, status=status, **attrs)

    def _record_step(self, t0: float, pending: PendingStep) -> None:
        """Step profile, one ring append per engine step; then the
        scheduling ledger's record and the memory ledger's observation."""
        n_pf = n_dec = 0
        for kind, rows, *_ in pending.batches:
            if kind == "prefill":
                n_pf += len(rows)
            elif kind == "mixed":
                n_dec += pending.mixed_dec_rows
                n_pf += len(rows) - pending.mixed_dec_rows
            else:
                n_dec += len(rows)
        pc = self.sched.preemption_count
        wall = time.perf_counter() - t0
        # The step profiler's time: on the card the device time of the
        # step's programs (CUDA events around each), since under the
        # pipelined loop the finalize's wall covers only the tail of a
        # step already running; on the CPU the finalize's wall, as JAX's.
        dev = [out.device_seconds() for *_, out in pending.batches] if self.perf.enabled else []
        perf_s = wall if not dev or None in dev else sum(dev)
        get_tracer().recorder.steps.record(
            time.time(), wall,
            num_prefill=n_pf, num_decode=n_dec,
            num_waiting=self.sched.num_waiting,
            num_preempted=pc - self._trace_last_preempt,
            occupancy=self.sched.num_running / max(self.engine_cfg.max_batch_size, 1),
            **self.perf.measure(pending.batches, perf_s))
        self._trace_last_preempt = pc
        if self.sched_led.enabled:
            info = pending.sched or {}
            self.sched_led.record_step(
                wall_s=wall,
                decode_window=info.get("decode_window", 1),
                budget_util=info.get("budget_util", 0.0),
                queue_depths=self.sched.waiting.depths(),
                hol=info.get("hol"),
                **step_geometry(self.model_cfg, self.engine_cfg, pending.batches,
                                mixed_dec_rows=pending.mixed_dec_rows))
        if self.mem_led.enabled:
            # Capacity forecast + leak audit cadence ride the step clock:
            # free-pool observations feed the per-QoS EWMA consumption
            # rates behind dynamo_mem_ttx_seconds, and maybe_audit is a
            # no-op until audit_interval_s has elapsed.
            self.mem_led.observe_device(
                free=self.pool.num_free_raw,
                cached=self.pool.num_inactive,
                total=self.pool.num_blocks - 1)
            self.mem_led.observe_free(self.pool.num_free, now=time.time())
            self.mem_led.maybe_audit(time.time())

    def _plan_verify(self, decode_seqs: list[Seq]
                     ) -> tuple[list[tuple[Seq, int, int]], list[list[int]], list[Seq]]:
        """Partition decode seqs into speculative-verify rows and plain
        decode. A seq verifies when it passes ``spec_eligible`` (the rule
        the scheduler reserved lookahead blocks by), its last token is on
        the host (no in-flight device-fed sample), and the n-gram proposer
        finds a continuation (engine/spec.py). Proposals are capped to the
        positions the seq's blocks cover: a chunk position past them would
        write its K/V through the table's padding into the trash block.

        Pipelined entry: under the overlapped step loop a decode seq's last
        token is always still in flight at plan time — so when the known
        prefix already shows a repetition signal (a proposal exists even
        without the pending token), the seq pauses one plan cycle (dropped
        from this step) so its token lands and the next plan can verify.
        The bubble costs one cycle; an accepted run repays it with up to
        spec_k+1 tokens. No signal → plain pipelined decode, no bubble."""
        ec = self.engine_cfg
        verify_rows, verify_chunks, plain = [], [], []
        for seq in decode_seqs:
            if not spec_eligible(seq):
                plain.append(seq)
                continue
            # cap proposals to stay inside the model context and the blocks
            k = min(ec.spec_k, ec.max_model_len - 1 - seq.num_computed,
                    len(seq.block_ids) * ec.block_size - 1 - seq.num_computed)
            proposal = propose(seq.tokens, ec.spec_ngram, k) if k > 0 else []
            if seq.inflight_samples > 0:
                if not proposal:
                    plain.append(seq)   # no signal: stay fully pipelined
                # else: pause this cycle (dispatch nothing for this seq)
                continue
            if not proposal:
                plain.append(seq)
                continue
            start = seq.num_computed
            chunk = [seq.tokens[start], *proposal]
            verify_rows.append((seq, start, len(chunk)))
            verify_chunks.append(chunk)
            self.metrics.spec_proposed += len(proposal)
        return verify_rows, verify_chunks, plain

    def _emit_and_finish(self, seq: Seq, candidates: list[int], lps_row: np.ndarray,
                         outputs: dict[str, LLMEngineOutput],
                         count_decode: bool) -> int:
        """The finalize tail, shared by decode/window and verify batches so
        the greedy-equivalence guarantee cannot drift between them: append
        candidate tokens (one, a fused window's, or a verify step's
        accepted run) until a stop fires — the rest is discarded, its KV in
        blocks this seq owns — then commit blocks, assemble the output and
        run finish bookkeeping. Returns the number of tokens emitted."""
        emitted: list[int] = []
        reason = None
        for token in candidates:
            seq.tokens.append(token)
            seq.block_seq.append(token)
            emitted.append(token)
            if seq.guided is not None:
                seq.guided.advance(token)
            reason = self._check_stop(seq, token)
            if reason is not None:
                break
        if count_decode:
            self.metrics.num_decode_tokens += len(emitted)
        self.sched.commit_computed_blocks(seq)
        if seq.prefix_hit_blocks:
            self.metrics.prefix_hit_blocks += seq.prefix_hit_blocks
            seq.prefix_hit_blocks = 0
        per_tok = [float(x) for x in lps_row[: len(emitted)]]
        out = LLMEngineOutput(token_ids=emitted, cum_log_probs=sum(per_tok),
                              log_probs=per_tok)
        if reason is not None:
            out.finish_reason = reason
            self._trace_finish(seq, reason)
            self.sched.finish(seq, reason)
            self.metrics.num_requests_finished += 1
            del self._seqs[seq.request_id]
        outputs[seq.request_id] = out
        return len(emitted)

    def step_finalize(self, pending: PendingStep) -> dict[str, LLMEngineOutput]:
        """Materialize a dispatched step's tokens and apply value-dependent
        effects: append tokens, commit full blocks (hash chain), evaluate
        stop conditions, assemble per-request outputs."""
        t0 = time.perf_counter()
        outputs: dict[str, LLMEngineOutput] = {}
        for kind, rows, sample_rows, out in pending.batches:
            toks, lps = out.materialize()
            if kind == "verify":
                self._finalize_verify(rows, sample_rows, toks, lps, outputs)
                continue
            # Normalize to [n, W]: single steps return [B], fused decode
            # windows [B, W] — one finalize path serves both.
            n = len(rows)
            toks, lps = toks[:n].reshape(n, -1), lps[:n].reshape(n, -1)
            for i, (seq, start, length) in enumerate(rows):
                if seq.phase is Phase.FINISHED:
                    # Finished (stop/abort) while this step was in flight:
                    # its speculative row is discarded.
                    continue
                decode_row = (kind == "decode"
                              or (kind == "mixed" and i < pending.mixed_dec_rows))
                if not decode_row:
                    self.metrics.num_prefill_tokens += length
                if not sample_rows[i]:
                    # Intermediate prefill chunk: no token emitted. (A seq
                    # preempted while in flight is WAITING with num_computed
                    # reset to 0 — commit is then a no-op.)
                    self.sched.commit_computed_blocks(seq)
                    continue
                seq.inflight_samples -= 1
                self._emit_and_finish(seq, [int(x) for x in toks[i]], lps[i], outputs,
                                      count_decode=decode_row)
        self._record_step(t0, pending)
        return outputs

    def _finalize_verify(self, rows: list[tuple[Seq, int, int]], chunks: list[list[int]],
                         toks: np.ndarray, lps: np.ndarray,
                         outputs: dict[str, LLMEngineOutput]) -> None:
        """Accept/roll back a speculative verify step (engine/spec.py).

        Position j's argmax is on the true greedy path iff every earlier
        proposal matched; accepted tokens append exactly as decode tokens
        would have, the rest of the chunk rolls back (its KV is stale but
        unreachable — later true tokens overwrite those positions)."""
        for i, (seq, start, length) in enumerate(rows):
            seq.verify_inflight = False
            if seq.phase is Phase.FINISHED:
                continue  # finished (abort) while in flight: discard
            seq.inflight_samples -= 1
            emitted_all = accept(chunks[i], [int(x) for x in toks[i, :length]])
            # A preemption while in flight reset num_computed: leave its
            # bookkeeping alone and discard the step.
            if seq.num_computed == start + length:
                # Roll back to the KV-valid bound BEFORE the commit inside
                # _emit_and_finish: KV at position start+j was computed from
                # input chunk[j], which is a true token only for
                # j < len(emitted_all). With the optimistic start+length
                # still in place, a rejection landing on a block boundary
                # would commit a block whose last slot holds KV from the
                # rejected proposal token — poisoning the shared prefix pool
                # for every later request with that chain. (A stop firing
                # mid-candidates finishes the seq inside _emit_and_finish, so
                # a live seq always emits all of emitted_all.)
                seq.num_computed = start + len(emitted_all)
            n_emitted = self._emit_and_finish(seq, emitted_all, lps[i], outputs,
                                              count_decode=True)
            self.metrics.spec_accepted += max(n_emitted - 1, 0)

    def set_step_time(self, now: float | None) -> None:
        self._step_now = now

    def has_expired_waiting(self, now: float | None = None) -> bool:
        return any(expired(s.deadline_ts, now) for s in self.sched.waiting)

    def reap_expired(self, now: float | None = None) -> dict[str, LLMEngineOutput]:
        """Cancel WAITING seqs whose deadline passed and emit their terminal
        outputs."""
        outs: dict[str, LLMEngineOutput] = {}
        for seq in self.sched.expire_waiting(now):
            self._seqs.pop(seq.request_id, None)
            self.metrics.deadline_cancelled += 1
            outs[seq.request_id] = LLMEngineOutput(finish_reason=FinishReason.CANCELLED)
        return outs

    def step(self) -> dict[str, LLMEngineOutput]:
        """Run one engine step synchronously; returns per-request deltas."""
        now = time.time()
        self.set_step_time(now)
        outs = self.reap_expired(now)
        pending = self.step_begin()
        if pending is not None:
            outs.update(self.step_finalize(pending))
        return outs

    def embed(self, token_lists: list[list[int]]) -> np.ndarray:
        """Last-token-pooled embeddings [N, H] f32 (engine-core thread only;
        ``ModelRunner.embed``)."""
        return self.runner.embed(token_lists)

    def fail_all(self, error: str) -> list[str]:
        """Abort every in-flight request (engine-fatal path). Returns the
        request ids that were failed."""
        rids = list(self._seqs)
        for rid in rids:
            self.abort(rid)
        self._seqs.clear()
        return rids


class AsyncTorchEngine:
    """Async facade: background step-loop thread + asyncio output streams
    (the JAX package's AsyncJaxEngine for one process)."""

    def __init__(self, core: EngineCore):
        self.core = core
        self._loop: asyncio.AbstractEventLoop | None = None
        self._inbox: thread_queue.Queue = thread_queue.Queue()
        self._streams: dict[str, asyncio.Queue] = {}
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, name="engine-core", daemon=True)
        self._started = False

    def start(self) -> None:
        if not self._started:
            self._loop = asyncio.get_running_loop()
            self._thread.start()
            self._started = True

    async def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        if self._started:
            await asyncio.get_running_loop().run_in_executor(None, self._thread.join, 5.0)
        # A dead engine must not keep vouching for its pins: drop its
        # live-id source so anything it leaked surfaces in the next audit.
        self.core.mem_led.unregister_live_source(self.core._mem_source_key)

    def _run(self) -> None:
        # Pipelined step loop: keep ONE step in flight. Each iteration plans
        # and dispatches step N+1 BEFORE waiting on step N's tokens, so host
        # work (scheduling, input packing, output assembly) runs while the
        # card computes.
        pending: PendingStep | None = None
        while not self._stop:
            moved = False
            while True:
                try:
                    kind, payload = self._inbox.get_nowait()
                except thread_queue.Empty:
                    break
                moved = True
                if kind == "add":
                    err = self.core.add_request(payload, now=time.time())
                    if err is not None:
                        self._post(payload.request_id, err)
                elif kind == "abort":
                    self.core.abort(payload)
                    self._post(payload, LLMEngineOutput(finish_reason=FinishReason.CANCELLED))
                elif kind == "exec":
                    # Core access (embeddings) marshaled onto this thread, the
                    # only one that touches device state. The future resolves
                    # on the loop it was made on, which may not be self._loop.
                    fn, fut, fut_loop = payload
                    try:
                        result, exc = fn(self.core), None
                    except Exception as e:  # noqa: BLE001 - handed to the caller
                        result, exc = None, e
                    try:
                        fut_loop.call_soon_threadsafe(self._resolve, fut, result, exc)
                    except RuntimeError:
                        pass  # the caller's loop closed before the result came
            if not self.core.has_work() and pending is None:
                if not moved:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            try:
                t_step = time.time()
                if self.core.has_expired_waiting(t_step):
                    for rid, out in self.core.reap_expired(t_step).items():
                        self._post(rid, out)
                self.core.set_step_time(t_step)
                nxt = self.core.step_begin() if self.core.has_work() else None
                if pending is not None:
                    for rid, out in self.core.step_finalize(pending).items():
                        self._post(rid, out)
                pending = nxt
            except Exception as exc:
                # Engine-fatal: fail + drain all in-flight state so the loop
                # doesn't spin hot retrying the same failing step.
                log.exception("engine step failed; failing all in-flight requests")
                pending = None
                self.core.fail_all(str(exc))
                for rid in list(self._streams):
                    self._post(rid, LLMEngineOutput(finish_reason=FinishReason.ERROR,
                                                    error=str(exc)))

    @staticmethod
    def _resolve(fut: asyncio.Future, result, exc: Exception | None) -> None:
        if fut.cancelled():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    async def run_in_core(self, fn: Callable[[EngineCore], Any]) -> Any:
        """Run ``fn(core)`` on the engine-core thread and await its result."""
        self.start()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inbox.put(("exec", (fn, fut, loop)))
        self._wake.set()
        return await fut

    def _post(self, rid: str, out: LLMEngineOutput) -> None:
        loop, q = self._loop, self._streams.get(rid)
        if loop is None or q is None:
            return
        loop.call_soon_threadsafe(q.put_nowait, out)

    async def generate(self, req: PreprocessedRequest) -> AsyncIterator[LLMEngineOutput]:
        self.start()
        q: asyncio.Queue = asyncio.Queue()
        self._streams[req.request_id] = q
        self._inbox.put(("add", req))
        self._wake.set()
        out: LLMEngineOutput | None = None
        try:
            while True:
                out = await q.get()
                yield out
                if out.finish_reason is not None:
                    break
        finally:
            self._streams.pop(req.request_id, None)
            if out is None or out.finish_reason is None:  # client bailed early
                self._inbox.put(("abort", req.request_id))
                self._wake.set()

    async def embed(self, token_lists: list[list[int]]) -> np.ndarray:
        """Embeddings via the engine-core thread (serialized with steps:
        device state has one owner)."""
        return await self.run_in_core(lambda core: core.embed(token_lists))

    def stats(self) -> dict[str, Any]:
        out = self.core.metrics.snapshot(self.core.sched, self.core.pool)
        led = get_compile_ledger()
        if led.enabled:
            # Warmup coverage + capture stalls ride the published stats.
            out["compile"] = led.snapshot()
        sled = get_sched_ledger()
        if sled.enabled:
            # Goodput, padding waste, and stall attribution.
            out["sched"] = sled.snapshot()
        mled = get_mem_ledger()
        if mled.enabled:
            # Tier occupancy, pin-owner totals, TTX posture, and the last
            # leak-audit verdict.
            out["mem"] = mled.snapshot()
        return out


def build_engine(engine_cfg: EngineConfig, params=None,
                 device: str | torch.device | None = None) -> AsyncTorchEngine:
    """The port's engine for ``engine_cfg`` on ``device`` (default: the
    CUDA card; raises when there is none), warmed up as
    ``engine_cfg.warmup_mode`` asks before its step loop starts (the
    summary is ``engine.core.warmup_summary``)."""
    core = EngineCore(engine_cfg, params=params, device=device)
    core.warmup()
    return AsyncTorchEngine(core)
