"""The port's engine: model runner + engine core + async facade.

Port of ``dynamo_tpu/engine/engine.py`` for the Llama serving path, dense
or MoE (the dense dispatch JAX runs at ep = 1), with weights at the model
dtype or weight-only int8 (``quantization="int8"``: quantized after init
or load, before the KV pool is sized, as in the JAX engine):

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

Tensor parallelism (``tp > 1``, the JAX engine's "model" mesh axis),
expert parallelism (``ep > 1``, its "expert" axis), sequence parallelism
(``sp > 1``, its "seq" axis: a step of fresh whole prompts past
``ring_prefill_threshold`` rings, its positions split over the seq ranks
(models/llama.forward_ring); every other step runs on each seq rank as on
one), pipeline parallelism (``pp > 1``, its "pipe" axis: each rank a
stage of its replica, holding its layers and their cache; composed with
dp only, as in JAX) and data parallelism inside the engine (``dp > 1``,
its "data" axis): the process that builds the ``EngineCore`` is rank 0,
the leader, and starts the other ranks (engine/tp.py); every rank's
``ModelRunner`` holds its shard of the params and of the cache
(replicated over data, seq and expert), the leader
posts each program's key and broadcasts its inputs, and the ranks'
forwards meet in the collectives of models/llama.py. A MoE model runs the
dense dispatch at ep = 1 (its width split over tp) and the dropless one
(models/moe.py) at ep > 1, as JAX's engine picks. Steps run eagerly.
The leader presents whole blocks (every kv head) to the KVBM tiers, the
store, the handoff and ``export_blocks``, as JAX's engine at one process
does (kvbm/transfer.TPTransferEngine): a follower gathers or writes its
heads of them when the leader posts ``extract`` or ``inject``.

Over several nodes (``num_nodes > 1``, parallel/multihost.py: the
leader's process builds the ``EngineCore`` with its op channel, the other
nodes' processes host their ranks) every rank keeps its own box of each
block instead, as JAX's processes do (kvbm/distributed.py): its own tiers
and, on a prefill engine, its own staged transfers and shard server; the
leader's offload manager decides and posts each rank's half. Named core
ops run on the leader and vote with the ranks where an outcome may differ
between them (``multihost.vote_min``); ``run_in_core`` is refused, as on
JAX's multi-host leader, and a lost node stops the engine
(``OpChannelDown``) with every open stream failed.

Memory beyond the card's KV pool, as the JAX engine has it: the KVBM tiers
(host, disk, remote; kvbm/) write evicted blocks back and onboard cached
prefixes at admission, session retention (engine/session.py) keeps a
finished turn's blocks for the next, stream checkpoints
(kvbm/stream_ckpt.py) park a live stream's blocks and a resumable record
in the remote store, and ``export_blocks`` / ``import_blocks`` move blocks
between engines. Blocks come back into the cache by in-place writes, so
the step graphs captured before them read them.

Disaggregated prefill/decode (disagg/): the named core ops of ``CORE_OPS``
(``AsyncTorchEngine.run_op``) pin and stage a chain to host memory in one
shot or wave by wave while its prefill runs (``stage_export``,
``stream_begin`` / ``stage_wave`` / ``stream_end``; the step loop stages a
wave after each finalize that commits blocks), serve it from a shard
server (disagg/sharded.py), and on the decode side fetch it on a thread
beside the steps and inject it as prefix entries (``prefetch_remote``,
``import_remote``). On one node the leader holds every block whole (a
tensor-parallel engine's through its transfer engine), so the JAX
package's rank vote is the identity and the shard server serves one
shard; over several nodes each rank of replica 0 stages and serves its box.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
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

from dynamo_tpu_torch import chaos
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
from dynamo_tpu_torch.engine.session import SessionStore, get_session_metrics
from dynamo_tpu_torch.engine.spec import accept, propose, spec_eligible
from dynamo_tpu_torch.engine.tp import wait_event
from dynamo_tpu_torch.kvbm.transfer import tp_gather, tp_scatter
from dynamo_tpu_torch.kvbm.stream_ckpt import (
    CKPT_DRAWS_KEY,
    CKPT_GENERATED_KEY,
    build_ckpt_record,
    get_stream_ckpt_metrics,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig, resolve_model_config
from dynamo_tpu_torch.models.quant import QUANTIZATIONS, leaf_shape, param_bytes
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
from dynamo_tpu_torch.parallel.collectives import TPFailure, TPGroup
from dynamo_tpu_torch.parallel.mesh import check_pp, stage_layers
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    tensor_from_wire,
)
from dynamo_tpu_torch.qos.deadline import deadline_of, expired
from dynamo_tpu_torch.router.events import KvCacheEvent
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


def _weak_source(method: Callable[[], Any], empty: Callable[[], Any] = dict
                 ) -> Callable[[], Any]:
    """A memory-ledger callback (live-id source, tier occupancy) that does
    not keep its owner alive: the process-global ledger would otherwise
    hold every engine ever made (its weights and KV cache) through the
    bound method. A collected owner's callback reports ``empty()``:
    nothing, as an unregistered one does."""
    ref = weakref.WeakMethod(method)

    def source():
        live = ref()
        return live() if live is not None else empty()

    return source


def step_graphs(ec: EngineConfig, device_type: str) -> tuple[bool, str]:
    """Whether the step programs of an engine of ``ec`` on a device of
    ``device_type`` are CUDA graphs, and the reason when they are not (""
    when they are). A function of the configuration alone, so every rank,
    a remote node's from the hello too, reaches the same answer.

    Graphs on the card at one rank; eager at more than one rank, each
    case with its reason. A graph can hold nccl's collectives (one card a
    rank), and the rest of a capture at tp x dp is in place (communicators
    formed eagerly, a replay's collectives counted, graphs dropped before
    a rank leaves its group), but it is not taken until it has passed its
    two-card check (ROADMAP item 14f)."""
    if device_type != "cuda":
        return False, "on the CPU, step programs run eagerly (CUDA graphs need a card)"
    if ec.dp * ec.pp * ec.sp * ec.ep * ec.tp == 1:
        return True, ""
    if ec.dist_backend != "nccl":
        return False, (f"{ec.dist_backend} reduces through host memory, which a CUDA graph "
                       "cannot hold: steps run eagerly (graphs need nccl, one card a rank)")
    if ec.pp > 1:
        return False, ("pp > 1: forward_pp counts its microbatches on the host and its stage "
                       "hops are point-to-point ops untried in a graph: steps run eagerly "
                       "(ROADMAP item 14g)")
    if ec.sp > 1:
        return False, ("sp > 1: a ring step picks its live rows with torch.nonzero, a host "
                       "read: steps run eagerly (ROADMAP item 14h)")
    if ec.ep > 1:
        return False, ("ep > 1: the dropless dispatch reads its group sizes on the host: "
                       "steps run eagerly (ROADMAP item 16c)")
    return False, ("tp x dp over nccl: a graph holding the ranks' collectives has not yet "
                   "served and shut down on two cards: steps run eagerly (ROADMAP item 14f, "
                   "its two-card check)")


def check_supported(ec: EngineConfig, cfg: ModelConfig) -> None:
    """Raise on settings this slice of the port does not carry for the
    model ``cfg``, naming the slice that brings them (ROADMAP), and on
    invalid ones."""
    if ec.spec_ngram > 0 and ec.decode_window > 1:
        raise ValueError(
            "spec_ngram and decode_window>1 are mutually exclusive "
            "(both amortize dispatches over future tokens; pick one)")
    # JAX's engine's words for what pipeline parallelism does not serve
    if ec.spec_ngram > 0 and ec.pp > 1:
        raise ValueError("spec_ngram requires pp=1 (forward_pp has "
                         "no all-positions output)")
    if ec.pp > 1 and (ec.tp > 1 or ec.ep > 1 or ec.sp > 1):
        raise ValueError(
            "pp>1 currently composes only with dp; tp/ep/sp must be 1 "
            "(the PP stage block is not head/expert/sequence-sharded — "
            "see models/llama.forward_pp)")
    # warmup_mode lazy and full serve at every mesh, as in JAX: each rank
    # makes the same programs in the same order, CUDA graphs where
    # step_graphs says so (ROADMAP item 14f)
    ranks = ec.tp * ec.ep * ec.sp * ec.pp * ec.dp
    for axis in ("tp", "dp", "ep", "pp", "sp", "num_nodes"):
        if getattr(ec, axis) < 1:
            raise ValueError(f"{axis} must be >= 1, got {getattr(ec, axis)}")
    if ranks % ec.num_nodes:
        raise ValueError(f"an engine of {ranks} ranks (dp x pp x sp x ep x tp) cannot be "
                         f"spread over {ec.num_nodes} nodes: the nodes must divide the ranks")
    if ec.pp_microbatches < 0:
        raise ValueError(f"pp_microbatches must be >= 0 (0 = auto), got {ec.pp_microbatches}")
    check_pp(cfg, ec.pp)
    if (ec.quantization == "int8" and ec.ep > 1 and cfg.is_moe
            and cfg.num_shared_experts):
        raise ValueError(
            "int8 weights at ep > 1 for a model with a shared expert: the JAX engine "
            "cannot serve them (its dropless shard_map's spec of the quantized shared "
            "expert is a bare matrix's; ROADMAP, gaps in the reference)")
    if ec.dist_backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown dist_backend {ec.dist_backend!r} (supported: gloo, nccl)")
    if ec.tp_devices and len(ec.tp_devices) != ranks // ec.num_nodes:
        raise ValueError(f"tp_devices {ec.tp_devices} must name one card for each of "
                         f"the dp x ep x tp = {ec.dp} x {ec.ep} x {ec.tp} ranks"
                         + (f" of each of the pp = {ec.pp} stages" if ec.pp > 1 else "")
                         + (f" of each of the sp = {ec.sp} seq ranks" if ec.sp > 1 else "")
                         + (f" on this node (1 of {ec.num_nodes})" if ec.num_nodes > 1 else ""))
    if len(set(ec.tp_devices)) < len(ec.tp_devices):
        # nccl refuses two ranks on one card; each rank would size its KV
        # pool from free memory while the other is still allocating
        if ec.dist_backend != "gloo":
            raise ValueError(f"tp_devices {ec.tp_devices}: ranks that share a card need "
                             f"dist_backend='gloo' (nccl takes one card a rank), got "
                             f"{ec.dist_backend!r}")
        if ec.num_blocks <= 0:
            raise ValueError(f"tp_devices {ec.tp_devices}: ranks that share a card need an "
                             "explicit num_blocks (sizing the pool from free memory would "
                             "race between them)")
    if ec.quantization not in QUANTIZATIONS:
        raise ValueError(f"unknown quantization {ec.quantization!r} (supported: none, int8)")
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
    # Session turns resumed from a remote session record (pull-to-warm).
    session_remote_resumes: int = 0
    # Streams resumed warm from a checkpoint (kvbm/stream_ckpt.py).
    stream_ckpt_resumes: int = 0
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
            "session_remote_resumes": self.session_remote_resumes,
            "stream_ckpt_resumes": self.stream_ckpt_resumes,
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
    #: how to wait for ``event`` instead of blocking on it: the leader's
    #: bounded wait over nccl (engine/tp.wait_event), None elsewhere
    wait: Callable[[torch.cuda.Event], None] | None = None

    def materialize(self) -> tuple[np.ndarray, np.ndarray]:
        if self.event is not None:
            if self.wait is not None:
                self.wait(self.event)
            else:
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
    :class:`StepProgram` per bucket.

    Under tensor parallelism (``tp``, a rank's group) every rank has a
    runner over its shard of the params and of the cache (its kv heads);
    ``params``, when given, is that shard. The leader's dispatch posts
    the step program's key to the followers and broadcasts the program's
    inputs; each follower runs the same program in :meth:`follow`.
    Sampling stays on the leader: a step's input tokens, the in-flight
    ones read from ``slot_toks`` included, reach the followers by a
    broadcast at the top of the step, and a fused window's sampled tokens
    by one after each of its inner steps. Every rank makes the same
    programs in the same order (a new program's warm run and capture are
    collective), CUDA graphs with their collectives inside or eager as
    :func:`step_graphs` decides (``graphs``, ``graph_reason``).
    Under data and sequence parallelism only the leader's replica and seq
    rank compute logits; the leader alone decides whether a prefill step
    rings (``ring_threshold``) and posts the flag in the step's key.
    Under pipeline parallelism a rank is one stage of its replica: it
    holds the stage's layers and their cache (``spec`` is the stage's),
    only stage 0 holds the embeddings, the final norm and the lm head, and
    the last stage's hidden comes back to stage 0 (models/llama.forward_pp)."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig, params=None,
                 device: str | torch.device | None = None, tp: TPGroup | None = None):
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.device = resolve_device(device)
        self.tp = tp
        rank, size = (tp.rank, tp.size) if tp is not None else (0, 1)
        expert, ep = (tp.expert_rank, tp.ep) if tp is not None else (0, 1)
        stage, pp = (tp.stage, tp.pp) if tp is not None else (0, 1)
        #: the layers [lo, hi) this rank holds (a pipeline stage's)
        self.layers = stage_layers(cfg, stage, pp)
        #: False on a follower: it runs each step's forward, not its sampling
        self.samples = tp is None or tp.leader
        #: False on a data replica, an expert shard, a seq rank or a pipeline
        #: stage past the first: its logits go unread (the leader's model
        #: group gathers them; a later stage has no lm head)
        self.logits = tp is None or (tp.data_rank == 0 and tp.expert_rank == 0
                                     and tp.seq_rank == 0 and tp.stage == 0)
        #: a MoE model's FFN, as JAX's engine picks it: the dropless
        #: dispatch once the experts are split, else the dense one
        self.moe_impl = "ep" if engine_cfg.ep > 1 else "dense"
        #: step programs are CUDA graphs, or eager for ``graph_reason``
        self.graphs, self.graph_reason = step_graphs(engine_cfg, self.device.type)
        #: the leader's wait for a step over nccl, whose collectives run on
        #: the card asynchronously: bounded, and failed by a lost follower
        self.wait = (functools.partial(wait_event, group=tp)
                     if tp is not None and tp.leader and tp.backend == "nccl" else None)
        if params is not None:
            self.params = params
        else:
            from dynamo_tpu_torch.models.config import MODEL_PRESETS
            from dynamo_tpu_torch.models.loader import has_weights, load_params

            if engine_cfg.model.endswith(".gguf"):
                from dynamo_tpu_torch.models.gguf import load_params_gguf

                _, self.params = load_params_gguf(engine_cfg.model, device=self.device,
                                                  rank=rank, tp=size, dtype=cfg.dtype,
                                                  stage=stage, pp=pp)
            elif has_weights(engine_cfg.model):
                self.params = load_params(cfg, engine_cfg.model, device=self.device,
                                          rank=rank, tp=size, expert=expert, ep=ep,
                                          stage=stage, pp=pp)
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
                # every rank makes the full tree's draws from the seed and
                # keeps only its shard of each (never the whole tree)
                self.params = llama.init_params(cfg, seed=engine_cfg.seed, device=self.device,
                                                rank=rank, tp=size, expert=expert, ep=ep,
                                                stage=stage, pp=pp)
                if size * ep * pp > 1 and self.device.type == "cuda":
                    torch.cuda.empty_cache()
        if engine_cfg.quantization == "int8":
            # After init or load and before the cache is sized, as in the
            # JAX engine; under TP each rank quantizes its shard, the
            # row-parallel scales taken over the group (models/quant.py).
            from dynamo_tpu_torch.models.quant import quantize_params_int8

            self.params = quantize_params_int8(self.params, cfg, tp=tp)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        num_blocks = engine_cfg.num_blocks or self._auto_num_blocks()
        if tp is not None:
            num_blocks = tp.agree_min(num_blocks)   # JAX's multihost hello does the same
        self.spec = KVCacheSpec.for_model(cfg, num_blocks, engine_cfg.block_size,
                                          kv_dtype=engine_cfg.kv_dtype, tp=size, pp=pp)
        #: the cache of whole blocks (every kv head, every layer): what the
        #: leader's tiers, exports and handoffs hold; ``spec`` at tp = pp = 1
        self.block_spec = (self.spec if size * pp == 1 else KVCacheSpec.for_model(
            cfg, num_blocks, engine_cfg.block_size, kv_dtype=engine_cfg.kv_dtype))
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
        #: bytes the card's reserve grew by while the warmup made programs
        self.warmup_reserved = 0
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
        if self.graphs:
            self.graph_pool = torch.cuda.graph_pool_handle()
            self.capture_stream = torch.cuda.Stream(dev)
        self.ring_threshold = self._ring_threshold() if self.samples else None
        #: the tiers of this rank's box over several nodes (tp_stats)
        self.tiers: list = []
        #: a follower's half of the block moves over several nodes
        #: (kvbm/distributed.RankBlocks: its tiers, staging, pulls)
        self.blocks = None
        if tp is not None and not tp.leader and engine_cfg.num_nodes > 1:
            from dynamo_tpu_torch.kvbm.distributed import RankBlocks

            self.blocks = RankBlocks(self)

    def _ring_threshold(self) -> int | None:
        """The least prompt tokens with which a step of fresh whole prompts
        rings (JAX's ``ModelRunner.__init__``): None at sp = 1 or with
        ``ring_prefill_threshold=-1``, the knob when it is > 0, and at 0 the
        cost model's ring-vs-chunked break-even for this model on this
        device's row (``obs/costmodel.py``). Sets the threshold gauge."""
        ec = self.engine_cfg
        if ec.sp <= 1 or ec.ring_prefill_threshold < 0:
            return None
        if ec.ring_prefill_threshold > 0:
            threshold = ec.ring_prefill_threshold
        else:
            try:
                hw = cm.hw_spec_for(device_name(self.device))
            except LookupError as exc:
                raise ValueError(f"ring_prefill_threshold=0 prices the ring on the device's "
                                 f"roofline: {exc}") from None
            threshold = cm.ring_prefill_break_even_tokens(
                self.cfg, hw, sp=ec.sp, chunk=ec.prefill_chunk, block_size=ec.block_size,
                kv_dtype=ec.kv_dtype, quantization=ec.quantization,
                max_tokens=ec.max_model_len)
        from dynamo_tpu_torch.obs.ring_prefill import get_ring_prefill_metrics

        get_ring_prefill_metrics().threshold_tokens.set(float(threshold))
        log.info("ring prefill engaged: sp=%d threshold=%d tokens%s", ec.sp, threshold,
                 "" if ec.ring_prefill_threshold else " (cost-model auto)")
        return threshold

    def _auto_num_blocks(self) -> int:
        """Size the device KV pool from free card memory, or a small default
        on the CPU."""
        ec = self.engine_cfg
        budget = 0
        if self.device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(self.device)
            budget = int(free * 0.85)
        spec = KVCacheSpec.for_model(self.cfg, 1, ec.block_size, kv_dtype=ec.kv_dtype,
                                     tp=ec.tp, pp=ec.pp)
        n = max(budget // spec.bytes_per_block(), 16) if budget > 0 else 512
        cap = (ec.max_model_len // ec.block_size) * ec.max_batch_size + 1
        return int(min(n, cap))

    def reset_slot(self, slot: int, seed: int, *, advance: int = 0,
                   resume_tokens: list[int] | None = None) -> None:
        """Initialize a seq's persistent sampling state: fresh penalty
        counts, its seed, and its draw counter at ``advance`` — a draw's
        noise is a pure function of (seed, draw), so a checkpoint-resumed
        stream's next draw is the one the unkilled run would have made.
        ``resume_tokens`` rebuilds the penalty counts from the generated
        tokens riding a resume prompt."""
        self.counts[slot] = 0
        if resume_tokens:
            toks = torch.tensor(resume_tokens, dtype=torch.long)
            if self.device.type == "cuda":  # a copy from pageable memory would wait
                toks = toks.pin_memory().to(self.device, non_blocking=True)
            self.counts[slot].index_add_(0, toks, torch.ones_like(toks, dtype=torch.int32))
        self.seeds[slot] = seed
        self.draws[slot] = advance

    @staticmethod
    def step_key(b: int, t: int, nblk: int, window: int = 1, fast_greedy: bool = False,
                 mm: bool = False, masked: bool = False, sp_prefill: bool = False) -> tuple:
        """A step program's key: ``(b, t, nblk, window, fast_greedy)``, and
        "mm" / "masked" / "sp" (a ring prefill step: JAX's ``sp_prefill``
        of its key) after it for those variants."""
        return ((b, t, nblk, window, fast_greedy) + (("mm",) if mm else ())
                + (("masked",) if masked else ()) + (("sp",) if sp_prefill else ()))

    def step_fn(self, b: int, t: int, nblk: int, window: int = 1,
                fast_greedy: bool = False, mm: bool = False,
                masked: bool = False, sp_prefill: bool = False) -> "StepProgram":
        """The bucket's program, made (warmed and captured) on first use —
        the counterpart of the JAX runner's ``step_fn`` cache, keyed by
        :meth:`step_key`."""
        key = self.step_key(b, t, nblk, window, fast_greedy, mm, masked, sp_prefill)
        prog = self.programs.get(key)
        if prog is None:
            log.info("capturing step program B=%d T=%d NBLK=%d W=%d greedy=%s mm=%s "
                     "masked=%s sp_prefill=%s", b, t, nblk, window, fast_greedy, mm, masked,
                     sp_prefill)
            prog = self.programs[key] = StepProgram(self, b, t, nblk, window, fast_greedy,
                                                    mm=mm, masked=masked,
                                                    sp_prefill=sp_prefill)
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
        # Sequence-parallel prefill (JAX's dispatch): a step of fresh whole
        # prompts (every row starts at 0) at sp > 1 rings, but only past the
        # threshold (__init__); shorter prompts, and steps with any other
        # row, take the chunked path on every seq rank, as at sp = 1.
        sp_prefill = (t > 1 and self.ring_threshold is not None
                      and all(start == 0 for _, start, _ in rows)
                      and t_max >= self.ring_threshold)
        if t > 1 and self.ring_threshold is not None:
            from dynamo_tpu_torch.obs.ring_prefill import get_ring_prefill_metrics

            rpm = get_ring_prefill_metrics()
            if sp_prefill:
                rpm.invocations.inc()
                rpm.tokens.inc(sum(length for _, _, length in rows))
            else:
                rpm.bypassed.inc()

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
            b, t, nblk, window, fast_greedy, mm, masked, sp_prefill) not in self.programs
        if cold:
            # Making a program blocks this thread for its warm run, its
            # capture and the graph's instantiation.
            led.mark_inflight(True)
            t_capture = time.perf_counter()
        if self.tp is not None:   # before step_fn: a new program's warm run is collective
            self.tp.post("step", (b, t, nblk, window, fast_greedy, mm, masked, sp_prefill))
        prog = self.step_fn(b, t, nblk, window, fast_greedy, mm, masked, sp_prefill)
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
              logit_mask: torch.Tensor | None = None,
              sp_prefill: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """The step program on its static inputs (JAX: ``_build_step_fn``;
        with ``window > 1``, ``_build_window_fn``: W decode steps unrolled,
        step j at ``q_start + j`` on step j-1's tokens). Returns tokens and
        logprobs, [B] or [B, W]. ``emb_override``/``emb_mask`` replace the
        embeddings of the masked positions; ``logit_mask`` (guided rows)
        sets disallowed logits to -1e30 — the bits of JAX's additive
        0 / -1e30 mask for every finite logit below ~3.8e22. ``sp_prefill``
        makes a prefill step a ring step (models/llama.forward_ring)."""
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
        if self.tp is not None:
            self.tp.broadcast(tokens)   # the leader's tokens, sampled ones included
        toks_w, lps_w = [], []
        for j in range(window):
            if j and self.tp is not None:
                # a window's next input: the leader's sampled tokens
                self.tp.broadcast(toks_w[-1])
            hidden = llama.forward(self.params, cfg, tokens if j == 0 else toks_w[-1][:, None],
                                   q_start if j == 0 else q_start + j, q_len, bt,
                                   self.cache_k, self.cache_v,
                                   attn_num_splits=self.engine_cfg.attn_num_splits,
                                   embed_override=emb_override, embed_mask=emb_mask,
                                   tp=self.tp, moe_impl=self.moe_impl,
                                   pp_microbatches=self.engine_cfg.pp_microbatches,
                                   sp_prefill=sp_prefill)
            if not self.samples:
                # a follower's outputs go unread; its next input comes by
                # the broadcast above (the leader's replica gathers logits)
                if self.logits:
                    llama.logits_from_hidden(self.params, cfg, hidden, self.tp)
                toks_w.append(torch.zeros_like(tokens[:, 0]))
                lps_w.append(torch.zeros(b, dtype=torch.float32, device=tokens.device))
                continue
            logits = llama.logits_from_hidden(self.params, cfg, hidden, self.tp).float()
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
        if self.tp is not None:
            self.tp.post("verify", (b, t, nblk))
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
                               return_all_hidden=True, tp=self.tp, moe_impl=self.moe_impl)
        if not self.logits:   # a data replica past the first: nothing read
            return tokens, torch.zeros(tokens.shape, device=tokens.device)
        logits = llama.logits_from_hidden(self.params, self.cfg, hidden,
                                          self.tp).float()  # [B, t, V]
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
        cold = self._ledger.enabled and (b, t) not in self._embed_buckets
        t0 = time.perf_counter()
        tokens = np.zeros((b, t), np.int32)
        q_len = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):
            tokens[i, : len(ts)] = ts
            q_len[i] = len(ts)
        dev = self.device
        if self.tp is not None:
            self.tp.post("embed", (b, t))
        hidden = self._embed_forward(torch.from_numpy(tokens).to(dev),
                                     torch.from_numpy(q_len).to(dev))
        out = hidden[:n].float().cpu().numpy()
        self._embed_buckets.add((b, t))
        if cold:
            self._ledger.record(BucketSig("embed", b, t, 0, True, ec.kv_dtype or "bfloat16"),
                                time.perf_counter() - t0)
        return out

    def _embed_forward(self, tokens: torch.Tensor, q_len: torch.Tensor) -> torch.Tensor:
        """The embedding call's forward over [b, t] tokens on a zeroed cache
        made for it (this rank's kv heads and layers); under tensor
        parallelism the leader's tokens and lengths are broadcast first. At
        pp > 1 the schedule takes its automatic microbatch count, as JAX's
        embedding program does."""
        ec, cfg = self.engine_cfg, self.cfg
        b, t = tokens.shape
        if self.tp is not None:
            self.tp.broadcast(tokens)
            self.tp.broadcast(q_len)
        nblk = -(-t // ec.block_size)
        dev = self.device
        # block 0 is the padding tokens' trash block; row i owns blocks
        # 1 + i*nblk .. (i+1)*nblk
        shape = (self.spec.num_layers, b * nblk + 1, ec.block_size, self.spec.num_kv_heads,
                 cfg.head_dim)
        ck = torch.zeros(shape, dtype=llama.torch_dtype(cfg.dtype), device=dev)
        cv = torch.zeros_like(ck)
        bt = torch.arange(1, b * nblk + 1, dtype=torch.int32, device=dev).view(b, nblk)
        return llama.forward(self.params, cfg, tokens,
                             torch.zeros((b,), dtype=torch.int32, device=dev),
                             q_len, bt, ck, cv, attn_num_splits=ec.attn_num_splits,
                             tp=self.tp, moe_impl=self.moe_impl)

    # -- tensor parallelism: a follower's loop ----------------------------
    def program(self, key: tuple) -> "StepProgram":
        """The program of ``key`` (:meth:`step_key`, or ``("verify", b,
        t, nblk)``), made if it does not exist yet."""
        if key[0] == "verify":
            return self.verify_fn(*key[1:])
        b, t, nblk, window, fast_greedy, *tags = key
        return self.step_fn(b, t, nblk, window, fast_greedy, mm="mm" in tags,
                            masked="masked" in tags, sp_prefill="sp" in tags)

    def release_graphs(self) -> None:
        """Before a rank leaves its group over nccl: once the card has run
        every replay, drop the step programs whose CUDA graphs hold the
        group's collectives. Destroying a communicator that a live graph
        still uses waits forever (each rank's leave hung after serving
        with graphs on two cards). Eager programs stay."""
        if self.graphs and self.tp is not None:
            torch.cuda.synchronize(self.device)
            self.programs.clear()

    def follow(self) -> None:
        """A follower's loop: run the leader's programs on this rank's
        shard, one message of the leader's at a time, until ``stop``.
        Programs are made on first use, as the leader makes them, or on
        the leader's ``make`` (its warmup), so a new program's warm run
        and capture meet the leader's; its inputs arrive by broadcast
        (:meth:`StepProgram.follow`). ``extract`` and ``inject``
        move this rank's kv heads (and its stage's layers) of whole blocks
        to or from the leader (kvbm/transfer.tp_gather, tp_scatter), in
        step order; over several nodes the ``kv_*`` posts move this rank's
        own box (kvbm/distributed.RankBlocks)."""
        dev = self.device
        while True:
            op, *args = self.tp.recv()
            if op == "stop":
                self.release_graphs()
                return
            if op == "step":
                self.step_fn(*args[0]).follow()
            elif op == "verify":
                self.verify_fn(*args[0]).follow()
            elif op == "make":   # the leader's warmup: make the program, run nothing
                self._make(args[0])
            elif op == "embed":
                b, t = args[0]
                self._embed_forward(torch.zeros((b, t), dtype=torch.int32, device=dev),
                                    torch.zeros((b,), dtype=torch.int32, device=dev))
            elif op == "extract":
                ids, dequant = args
                # the leader's block group (replica 0, seq rank 0, expert
                # shard 0) gathers: the cache is replicated over the others
                if (self.tp.data_rank == 0 and self.tp.seq_rank == 0
                        and self.tp.expert_rank == 0):
                    tp_gather(self.tp, self.cache_k, self.cache_v, ids, dequant,
                              self.block_spec.num_kv_heads)
            elif op == "inject":
                ids, mode, shape, dtype = args
                tp_scatter(self.tp, self.cache_k, self.cache_v, ids, mode, shape,
                           getattr(torch, dtype.removeprefix("torch.")))
            elif op.startswith("kv_"):   # this rank's box (kvbm/distributed.py)
                self.blocks.handle(op, args)
            elif op == "stats":
                self.tp.reply("stats", self.tp_stats())
            elif op == "reset_stats":
                self.reset_tp_stats()
            else:
                raise ValueError(f"unknown tensor-parallel op {op!r}")

    def reset_tp_stats(self) -> None:
        """Set this rank's launch counts, program calls and collective
        counters to 0."""
        pa.reset_launches()
        self.tp.reset_stats()
        for prog in self.programs.values():
            prog.calls = 0

    def tp_stats(self) -> dict:
        """This rank's count of kernel launches by kernel, forward steps
        (program calls), collectives and block moves and their host
        seconds since the last ``reset_stats`` (and the collectives its
        graph replays ran), whether its programs are CUDA graphs and why
        not, its peak device memory,
        its local head counts, its stage and the layers it holds, the
        bytes of its weights (of its layers, and of its MoE expert stacks)
        and of one block of its cache."""
        layers = self.params["layers"]
        d = self.cfg.head_dim
        return {"rank": self.tp.world_rank, "data_rank": self.tp.data_rank,
                "seq_rank": self.tp.seq_rank,
                "expert_rank": self.tp.expert_rank, "model_rank": self.tp.rank,
                "stage": self.tp.stage, "layers": list(self.layers),
                "microbatches": self.tp.microbatches,
                # each program's key and calls since the last reset_stats
                "programs": [[list(k), p.calls] for k, p in self.programs.items()],
                "layer_bytes": param_bytes(layers),
                "cache_block_bytes": self.spec.bytes_per_block(),
                "launches_by_kernel": dict(pa.paged_attention.launches_by_kernel),
                # a fused window's call runs its W forward steps
                "forward_steps": sum(p.calls * (p.shape[3] if len(p.shape) > 3 else 1)
                                     for p in self.programs.values()),
                # the ring prefill steps among them (no paged-attention launch)
                "ring_steps": sum(p.calls for p in self.programs.values() if p.sp_prefill),
                "ring_hops": self.tp.ring_hops, "ring_bytes": self.tp.ring_bytes,
                "ring_s": self.tp.ring_s,
                "collectives": self.tp.collectives, "collective_s": self.tp.collective_s,
                "graph_collectives": self.tp.graph_collectives,
                "graphs": self.graphs, "graph_reason": self.graph_reason,
                "block_moves": self.tp.block_moves, "block_bytes": self.tp.block_bytes,
                "block_s": self.tp.block_s,
                # over several nodes: this rank's tiers, (blocks, bytes) each
                "tiers": {t.name: list(t.occupancy()) for t in self.tiers},
                "max_memory_allocated": (torch.cuda.max_memory_allocated(self.device)
                                         if self.device.type == "cuda" else 0),
                # the card's reserved bytes that making the warmup's programs
                # added (their graph pool on the card, 0 on the CPU)
                "warmup_reserved": self.warmup_reserved,
                "heads": leaf_shape(layers["wq"])[-1] // d,
                "kv_heads": leaf_shape(layers["wk"])[-1] // d,
                "cache_kv_heads": self.spec.num_kv_heads,
                "weight_bytes": param_bytes(self.params),
                # the MoE expert stacks this rank holds (0 for a dense model)
                "expert_bytes": (sum(param_bytes(layers[k]) for k in ("w_gate", "w_up", "w_down"))
                                 if self.cfg.is_moe else 0),
                "local_experts": layers["w_gate"].shape[1] if self.cfg.is_moe else 0}

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
        logged as a warning: that memory is no longer free for KV blocks.

        At more than one rank the leader posts each program to its
        followers before it makes it (``make``: the warm run and the
        capture are collective), and a bucket that fails on any rank stops
        the warmup with a ``TPFailure`` naming the bucket (and the rank:
        the leader's own failure, or a follower's traceback), where one
        rank counts it as failed and goes on: the ranks' programs must not
        differ (JAX counts and goes on at every mesh; ROADMAP, gaps in the
        reference)."""
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
            except Exception as exc:
                if self.tp is not None:
                    raise TPFailure(
                        f"the warmup of bucket {sig} failed"
                        + ("" if isinstance(exc, TPFailure) else " on rank 0 (the leader)")
                        + f": {exc}") from exc
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
        if self.tp is not None:
            self.tp.post("make", key)
        self._make(key)
        self._ledger.record(sig, time.perf_counter() - t0, source="warmup")
        return False

    def _make(self, key: tuple) -> None:
        """Make the program of ``key`` for the warmup (at more than one
        rank every rank does, on the leader's ``make``), adding the growth
        of the card's reserved bytes to ``warmup_reserved``."""
        cuda = self.device.type == "cuda"
        before = torch.cuda.memory_reserved(self.device) if cuda else 0
        self.program(key)
        if cuda:
            self.warmup_reserved += torch.cuda.memory_reserved(self.device) - before


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
    other graph of the pool can reuse their memory. At more than one rank
    every rank makes the program at the same point of the leader's posts,
    and a call first broadcasts the leader's static inputs, eagerly, on
    the stream the replay then runs on; a graph over nccl would hold the
    body's collectives. Where :func:`step_graphs` says eager (the CPU, and
    for now every engine of more than one rank) nothing is captured: a
    call runs the body eagerly on the same static buffers.

    Kernel launches: the warm run's are not counted, the capture's are
    recorded (``launches``, by kernel) and every call, a follower's too,
    counts them once (``ops.paged_attention.count_launches``); so are the
    capture's collectives (``collectives``: added to the group's
    ``graph_collectives`` at each replay; the warm run's and the
    capture's go uncounted). ``calls`` counts the calls."""

    #: a ring prefill step's program (models/llama.forward_ring)
    sp_prefill = False

    def __init__(self, runner: ModelRunner, b: int, t: int, nblk: int, window: int,
                 fast_greedy: bool, mm: bool = False, masked: bool = False,
                 sp_prefill: bool = False):
        self.runner = runner
        self.shape = (b, t, nblk, window, fast_greedy)
        self.mm, self.masked, self.sp_prefill = mm, masked, sp_prefill
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
        tp = self.runner.tp
        counts = tp.step_counts() if tp is not None else None
        with pa.launches_made():
            self._warm()
        if tp is not None:   # as its launches, the warm run's collectives go uncounted
            tp.restore_step_counts(counts)
        with pa.launches_made() as made:
            self._capture()
        self.launches: dict[str, int] = made
        #: the collectives the graph holds (each replay runs them)
        self.collectives = 0
        if tp is not None:
            self.collectives = tp.collectives - counts[0]
            tp.restore_step_counts(counts)
        self.calls = 0

    def _run(self) -> tuple[torch.Tensor, torch.Tensor]:
        ints, floats, *rest = self.inputs
        emb, emb_mask = rest[:2] if self.mm else (None, None)
        logit_mask = rest[-1] if self.masked else None
        return self.runner._body(ints, floats, *self.shape, emb, emb_mask, logit_mask,
                                 self.sp_prefill)

    def _warm(self) -> None:
        if not self.runner.graphs:
            self._run()
            return
        side = self.runner.capture_stream
        side.wait_stream(torch.cuda.current_stream(self.runner.device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(self.runner.device).wait_stream(side)

    def _capture(self) -> None:
        if not self.runner.graphs:
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
        if self.runner.tp is not None:
            for static in self.inputs:
                self.runner.tp.broadcast(static)
        toks, lps = self._replay()
        self._count()
        if not cuda:
            return StepOutputs(toks, lps)
        toks_h = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        lps_h = torch.empty(lps.shape, dtype=lps.dtype, pin_memory=True)
        toks_h.copy_(toks, non_blocking=True)
        lps_h.copy_(lps, non_blocking=True)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return StepOutputs(toks_h, lps_h, event, started, self.runner.wait)

    def _count(self) -> None:
        """One call's counts: the launches and collectives of a replay
        (an eager call's counted themselves as they ran) and the call."""
        pa.count_launches(self.launches)
        if self.collectives:
            self.runner.tp.graph_collectives += self.collectives
        self.calls += 1

    def follow(self) -> None:
        """A follower's call: the static inputs are the leader's, by
        broadcast; the outputs are the leader's to sample."""
        for static in self.inputs:
            self.runner.tp.broadcast(static)
        self._replay()
        self._count()


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
                 device: str | torch.device | None = None,
                 event_sink: Callable[[KvCacheEvent], None] | None = None,
                 channel=None):
        """``channel``: over several nodes (``num_nodes > 1``), the leader's
        op channel (parallel/multihost.LeaderOpChannel) with the other
        nodes accepted; the engine sends them the hello, forms the group
        with their ranks and waits for their ``ready``."""
        self.model_cfg = resolve_model_config(engine_cfg.model)
        check_supported(engine_cfg, self.model_cfg)
        if engine_cfg.num_nodes > 1 and channel is None:
            raise ValueError("an engine over several nodes (num_nodes > 1) is built by its "
                             "leader with its op channel (parallel/multihost.py)")
        if engine_cfg.sp > 1 and engine_cfg.ring_prefill_threshold >= 0 and (
                engine_cfg.prefill_chunk < engine_cfg.max_model_len
                or engine_cfg.max_tokens_per_step < engine_cfg.max_model_len):
            # A sequence-parallel engine prefills a whole prompt as ONE
            # seq-sharded chunk (the ring's context must be the whole
            # prompt); chunks cut by prefill_chunk or by the per-step token
            # budget would start past 0 and take the chunked path. As JAX's
            # engine, on a copy of the config, before prefill_chunk=0 would
            # resolve (so it never does at sp > 1).
            log.info("sp=%d: raising prefill_chunk %d and max_tokens_per_step %d -> "
                     "max_model_len %d", engine_cfg.sp, engine_cfg.prefill_chunk,
                     engine_cfg.max_tokens_per_step, engine_cfg.max_model_len)
            engine_cfg = dataclasses.replace(
                engine_cfg,
                prefill_chunk=max(engine_cfg.prefill_chunk, engine_cfg.max_model_len),
                max_tokens_per_step=max(engine_cfg.max_tokens_per_step,
                                        engine_cfg.max_model_len))
        self.engine_cfg = engine_cfg
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
        # Tensor and data parallelism: this process is rank 0, the leader;
        # the followers start here and hold their shards of params and cache.
        self._tp_followers = None
        self._channel = channel
        tp_group = None
        if engine_cfg.tp * engine_cfg.ep * engine_cfg.sp * engine_cfg.pp * engine_cfg.dp > 1:
            from dynamo_tpu_torch.engine.tp import start_tp

            tp_group, self._tp_followers, params = start_tp(
                engine_cfg, self.model_cfg, device, params, channel)
            device = tp_group.device
        try:
            self.runner = ModelRunner(self.model_cfg, engine_cfg, params=params,
                                      device=device, tp=tp_group)
            if channel is not None:
                channel.wait_ready()
        except BaseException:
            if tp_group is not None:
                self._tp_followers.stop(tp_group)
            raise
        if tp_group is not None:   # every rank decided the same from the config
            log.info("step programs of the %d ranks: %s", tp_group.world_size,
                     "CUDA graphs" if self.runner.graphs else self.runner.graph_reason)
        #: the engine's group over several nodes (None on one node): block
        #: moves are per rank and outcomes that may differ are voted
        self._mh = tp_group if engine_cfg.num_nodes > 1 else None
        #: the last close's seconds and the followers it had to kill
        self.shutdown_stats: dict | None = None
        if engine_cfg.warmup_mode != "off":
            get_compile_ledger().set_plan(enumerate_buckets(engine_cfg))
        self.pool = PrefixPool(self.runner.spec.num_blocks, engine_cfg.block_size,
                               event_sink=event_sink,
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
        # Session-sticky KV retention (engine/session.py): finished streams
        # carrying a session.id keep their committed blocks pinned so the
        # next turn prefills only the suffix. Needs prefix caching — the
        # retained chain is claimed through the normal admission-time
        # match_prefix, which is also how avoided tokens get measured.
        self.sessions: SessionStore | None = None
        if engine_cfg.session_ttl > 0 and engine_cfg.enable_prefix_caching:
            self.sessions = SessionStore(self.pool, ttl=engine_cfg.session_ttl)
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
        # the block mover of export/import when there are no tiers
        self._transfer = None
        # Disaggregated handoff (disagg/): the host staging store and the
        # pins of each staged transfer (xfer id → block ids), the streamed
        # exports by request and by transfer id, the decode side's pulls in
        # flight, the shard server and the wave listener; ``pull_stats``
        # counts the pulls' network half (fetch threads add to it).
        self._staging = None
        self._staged_pins: dict[str, list[int]] = {}
        self._stream_exports: dict[str, _StreamExport] = {}
        self._streams_by_xid: dict[str, _StreamExport] = {}
        self._pulls: dict[str, dict] = {}
        self._shard_server = None
        self._stream_listener: Callable[[str, int], None] | None = None
        self.pull_stats = {"pulls": 0, "blocks": 0, "bytes": 0, "seconds": 0.0}
        self.kvbm = self._make_kvbm(engine_cfg)
        # Memory & capacity ledger (obs/mem_ledger.py): re-read the
        # DYN_MEM_LEDGER env at construction (same contract as the sched
        # ledger above), publish this engine's device pool and every KVBM
        # tier as tier rows, and hand the audit a live-id source so orphaned
        # pins reconcile against what this engine actually holds. All are
        # pulled only at snapshot/audit time, never on the step path.
        self.mem_led = get_mem_ledger()
        self.mem_led.configure()
        register_device_tier(self.pool, self.runner.spec)
        if self.kvbm is not None:
            for tier in self.kvbm.tiers:
                self.mem_led.register_tier(tier.name,
                                           _weak_source(tier.occupancy, lambda: (0, 0)))
        self._mem_source_key = f"engine:{id(self):x}"
        self.mem_led.register_live_source(self._mem_source_key,
                                          _weak_source(self._mem_live_ids))

    def _make_kvbm(self, ec: EngineConfig):
        """The KVBM tier cascade host → disk → remote (each tier spills
        its LRU victims to the next, lookups walk the chain top-down) and
        its offload manager, or None when no tier is configured."""
        if not (ec.host_kv_blocks > 0 or ec.disk_kv_path or ec.remote_kv_addr):
            return None
        from dynamo_tpu_torch.kvbm.offload import OffloadManager

        from dynamo_tpu_torch.kvbm import distributed as kd

        if self._mh is None:
            # whole blocks, fingerprinted by the model alone (JAX's engine
            # at one process): a tier's or the store's blocks serve engines
            # of any tp
            tiers, remote = kd.build_tiers(self.runner.block_spec, ec, ec.model,
                                           ec.disk_kv_path)
            return OffloadManager(
                self.runner, self.pool, tiers,
                # Fleet-wide prefix cache: committed blocks publish to the
                # shared remote store as they form, not only on eviction.
                publish_tier=remote if ec.global_prefix_cache else None,
                # Stream checkpoints park in the same shared store.
                ckpt_tier=remote if ec.stream_ckpt_blocks > 0 else None,
                transfer=self._new_transfer())
        # Over several nodes (JAX's engine at process_count > 1): each rank's
        # tiers hold its box (the leader's here, the others' in their
        # RankBlocks), fingerprinted by the shard, the disk tier under
        # rank{k}; the leader decides and posts each rank's half.
        _, shard_fp = kd.local_block_spec(self.runner.block_spec, self.my_box())
        tiers, remote = kd.build_tiers(self.runner.spec, ec, f"{ec.model}|{shard_fp}",
                                       kd.rank_disk_path(ec.disk_kv_path, 0))
        self.runner.tiers = tiers
        return OffloadManager(
            self.runner, self.pool, tiers,
            publish_tier=remote if ec.global_prefix_cache else None,
            # a rank's box in the shared store's checkpoint record would
            # corrupt cross-worker reads (JAX: single-host only)
            ckpt_tier=None,
            transfer=self._new_transfer(),
            # a tier that can answer differently on different ranks (the
            # shared store; a disk tier a restart purged) is voted
            vote_plans=bool(ec.remote_kv_addr or ec.disk_kv_path),
            ranks=kd.TierMirror(self._mh, tiers))

    def _mem_live_ids(self) -> dict:
        """Per-owner-class live ids for the mem-ledger leak audit. A pin
        tagged under any class but absent from the matching set here is an
        orphan — a reference the engine no longer knows about. A staging
        pin lives while its transfer is staged (until the decode side's
        release or the source's TTL)."""
        return live_ids_of(
            streams=self._seqs.keys(),
            sessions=self.sessions.session_ids() if self.sessions is not None else (),
            **(self.kvbm.queue_live_ids() if self.kvbm is not None else {}),
            staging=list(self._staged_pins))

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
        if self.runner.tp is not None:   # more than one rank: graphs, or eager and why
            out["graphs"], out["graph_reason"] = self.runner.graphs, self.runner.graph_reason
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
            if self.engine_cfg.sp > 1 or self.engine_cfg.pp > 1:
                return LLMEngineOutput(
                    finish_reason=FinishReason.ERROR,
                    error="multimodal requests require sp=1 and pp=1 "
                          "(the ring/pipeline prefill paths have no "
                          "embedding-override input yet)")
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
        if self.sessions is not None and seq.session_id is not None:
            # Turn N+1 of a retained session: release the store's pins so
            # the chain parks in the matchable inactive pool; this seq's
            # admission-time match_prefix re-references it an instant later
            # (single-threaded core — nothing allocates in between). The
            # avoided-token count is measured from that match in step_begin.
            sm = get_session_metrics()
            sm.lookups.inc()
            if self.sessions.claim(seq.session_id, self._step_now) is not None:
                sm.hits.inc()
            else:
                # No local turn retained: the session may have been parked
                # in the remote store (evacuate_sessions). A record hit
                # means the onboard below pulls the chain back warm.
                remote = self._remote_tier()
                if remote is not None and remote.get_session(seq.session_id):
                    sm.hits.inc()
                    sm.remote_resumes.inc()
                    self.metrics.session_remote_resumes += 1
        if self.kvbm is not None:
            # Same matchable cap as the scheduler: leave ≥1 prompt token to
            # compute so decode has last-position state. Onboarding is an
            # optimization — a corrupt tier entry must not take down the
            # engine-core thread.
            cap = (seq.prefill_target() - 1) // seq.block_size
            try:
                self.kvbm.onboard(seq.block_seq.sequence_hashes()[:cap])
            except Exception:
                log.exception("kvbm onboard failed; continuing without reuse")
        self.metrics.prefix_lookup_blocks += max(len(seq.tokens) // seq.block_size, 1)
        return None

    def abort(self, request_id: str) -> None:
        seq = self._seqs.get(request_id)
        if seq is None or seq.phase is Phase.FINISHED:
            return
        self._reap_stream_ckpt(seq)
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

    # -- crash-consistent stream checkpoints (kvbm/stream_ckpt.py) -------
    def _init_slot(self, seq: Seq) -> None:
        """Reset a seq's sampling slot — restoring the draw counter and
        penalty counts when the request carries stream_ckpt.* resume
        annotations. Every stream gets a concrete seed (explicit or
        request-derived), so its noise after n draws is a pure function of
        the request: a sampled resume is bit-identical at decode_window=1."""
        so = seq.req.sampling_options
        seed = so.seed if so.seed is not None else _derived_seed(seq.request_id)
        ann = getattr(seq.req, "annotations", None) or {}
        gen = int(ann.get(CKPT_GENERATED_KEY) or 0)
        if gen <= 0:
            self.runner.reset_slot(seq.slot, seed)
            return
        gen = min(gen, seq.prompt_len)
        self.runner.reset_slot(
            seq.slot, seed, advance=int(ann.get(CKPT_DRAWS_KEY) or gen),
            # the resume prompt's trailing ledger: the penalty counts the
            # interrupted stream had accumulated
            resume_tokens=seq.tokens[seq.prompt_len - gen:seq.prompt_len])

    def _ckpt_interval(self, seq: Seq) -> int:
        """Committed-block cadence for this seq, QoS-degraded from the
        stream_ckpt_blocks base: interactive streams checkpoint at the
        configured interval, standard at 2x, batch at 4x. 0 = off."""
        base = self.engine_cfg.stream_ckpt_blocks
        if base <= 0:
            return 0
        if seq.qos_priority == "interactive":
            return base
        return base * (4 if seq.qos_priority == "batch" else 2)

    def _maybe_stream_ckpt(self, seq: Seq) -> None:
        """Enqueue a StreamCheckpoint when due: once at prefill completion
        (the first emit's commit), then every interval committed blocks."""
        k = self._ckpt_interval(seq)
        if (k <= 0 or self.kvbm is None or self.kvbm.ckpt_tier is None
                or seq.committed_blocks <= 0):
            return
        if 0 <= seq.ckpt_blocks and seq.committed_blocks - seq.ckpt_blocks < k:
            return
        start = max(seq.ckpt_blocks, 0)
        hashes = seq.block_seq.sequence_hashes()[: seq.committed_blocks]
        pairs = list(zip(seq.block_ids[start:seq.committed_blocks], hashes[start:]))
        generated = seq.tokens[seq.prompt_len:]
        so = seq.req.sampling_options
        seed = so.seed if so.seed is not None else _derived_seed(seq.request_id)
        # The seed's two 32-bit words: the JAX engine's key data for it, and
        # with the draw counter the port's whole sampler state.
        record = build_ckpt_record(
            seq.request_id, generated, hashes,
            key_data=[(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
            draws=len(generated), seed=seed, prompt_tokens=seq.prompt_len)
        span = None
        if seq.trace_ctx is not None:
            span = get_tracer().start_span(
                "engine.ckpt", ctx=seq.trace_ctx, request_id=seq.request_id,
                blocks=len(pairs), generated=len(generated))
        self.kvbm.enqueue_stream_ckpt(seq.request_id, record, pairs)
        if span is not None:
            get_tracer().end_span(span)
        seq.ckpt_blocks = seq.committed_blocks

    def _reap_stream_ckpt(self, seq: Seq) -> None:
        """Finish-time reap: a finished stream (any reason) must not be
        resumable. Only streams that ever checkpointed pay the round trip."""
        if self.kvbm is not None and seq.ckpt_blocks >= 0:
            self.kvbm.delete_stream_ckpt(seq.request_id)

    def ckpt_lag_blocks(self) -> int:
        """Committed blocks of live streams not yet covered by a
        checkpoint — the crash exposure, exported as
        dynamo_stream_ckpt_lag_blocks."""
        return sum(max(s.committed_blocks - max(s.ckpt_blocks, 0), 0)
                   for s in list(self._seqs.values()) if s.phase is not Phase.FINISHED)

    def step_begin(self) -> PendingStep | None:
        """Plan one engine step and dispatch it to the device without
        waiting for results. Host-side state is advanced speculatively
        (positions — everything value-independent), so the caller may plan
        and dispatch the NEXT step while this one computes: the sampled
        tokens stay on the device (slot_toks) and feed the next decode step
        directly. Value-dependent effects (token append, hash commit, stop
        conditions) happen in :meth:`step_finalize`."""
        if self.sessions is not None:
            self._session_sweep()
        plan = self.sched.plan()
        if self.kvbm is not None:
            # Write back blocks evicted during planning before their slots
            # are rewritten by this step's KV scatter (one transfer for all
            # of them, ordered on the stream after the step in flight).
            self.kvbm.flush_pending()
        self.metrics.num_preemptions = self.sched.preemption_count
        if plan.empty:
            return None
        self.metrics.num_steps += 1
        self._trace_plan(plan)
        if self.sessions is not None:
            # Avoided-token accounting: the blocks a session turn did NOT
            # recompute are exactly its admission-time prefix hit — counted
            # once per seq on its first planned chunk.
            for w in plan.prefill:
                seq = w.seq
                if seq.session_id is not None and not seq.session_counted:
                    seq.session_counted = True
                    if seq.prefix_hit_blocks:
                        get_session_metrics().avoided_tokens.inc(
                            seq.prefix_hit_blocks * seq.block_size)
        # Checkpoint-resume accounting mirrors the session pattern: the
        # recompute a crash actually cost is the resume prompt MINUS what the
        # admission onboard pulled back warm, measured once.
        for w in plan.prefill:
            seq = w.seq
            if seq.ckpt_counted:
                continue
            seq.ckpt_counted = True
            ann = getattr(seq.req, "annotations", None) or {}
            if int(ann.get(CKPT_GENERATED_KEY) or 0) > 0:
                self.metrics.stream_ckpt_resumes += 1
                sm = get_stream_ckpt_metrics()
                sm.resumes.inc(1)
                sm.resume_recomputed_tokens.inc(max(
                    seq.prefill_target() - seq.prefix_hit_blocks * seq.block_size, 0))
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
        if reason is None:
            # Checkpoint cadence rides the commit stream: first at prefill
            # completion (this seq's first emit), then every interval
            # committed blocks. Finishing streams skip straight to the reap.
            self._maybe_stream_ckpt(seq)
        if seq.prefix_hit_blocks:
            self.metrics.prefix_hit_blocks += seq.prefix_hit_blocks
            seq.prefix_hit_blocks = 0
        per_tok = [float(x) for x in lps_row[: len(emitted)]]
        out = LLMEngineOutput(token_ids=emitted, cum_log_probs=sum(per_tok),
                              log_probs=per_tok)
        if reason is not None:
            out.finish_reason = reason
            self._reap_stream_ckpt(seq)
            if (self.sessions is not None and seq.session_id is not None
                    and reason in (FinishReason.STOP, FinishReason.LENGTH)):
                # Retain BEFORE sched.finish releases the seq's refs: the
                # session pin increfs the committed chain while it is still
                # active. Cancelled/errored streams never retain.
                self._retain_session(seq)
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
        if self.kvbm is not None and not self.sched.has_work():
            # Going idle: this finalize's commits would otherwise sit in the
            # publish/checkpoint queues until the next step_begin.
            self.kvbm.drain_publish()
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

    # -- session-sticky KV retention (engine/session.py) ----------------
    def _retain_session(self, seq: Seq) -> None:
        """Pin a finishing stream's committed chain under its session id."""
        hashes = seq.block_seq.sequence_hashes()[: seq.committed_blocks]
        self.sessions.retain(seq.session_id, hashes, self._step_now)
        # Capacity cap: LRU sessions demote (not just drop) so a later turn
        # can still re-import from the KVBM ladder.
        while len(self.sessions) > self.sessions.max_sessions:
            self._demote_session(*self.sessions.pop_oldest())

    def _session_sweep(self) -> None:
        """TTL + pool-pressure valve, run before each plan(). While the
        head-of-line waiting seq cannot admit because session pins hold the
        pool, the oldest sessions are released first — retained turns must
        never starve live traffic."""
        for sid, entry in self.sessions.pop_expired(self._step_now):
            self._demote_session(sid, entry)
        sched = self.sched
        while len(self.sessions) and sched.waiting:
            head = sched.waiting[0]
            need = head.blocks_needed(len(head.tokens))
            if need + len(sched.running) <= self.pool.num_free:
                break
            if need + len(sched.running) > self.pool.num_free + self.sessions.pinned_blocks:
                break  # releasing every pin still wouldn't admit; keep them
            self._demote_session(*self.sessions.pop_oldest())

    def _demote_session(self, session_id: str, entry) -> None:
        """Release a retained entry's pins, first write-staging the chain
        down the KVBM tier ladder when session_tiers is on — so a turn after
        device eviction re-imports instead of recomputing."""
        sm = get_session_metrics()
        sm.expired.inc()
        if self.engine_cfg.session_tiers and self.kvbm is not None and entry.pinned:
            try:
                staged = self.kvbm.stage_blocks(list(zip(entry.pinned, entry.seq_hashes)))
                sm.demoted_blocks.inc(staged)
            except Exception:
                log.exception("session %s: tier demotion failed; releasing pins to LRU",
                              session_id)
        if self.mem_led.enabled and entry.pinned:
            self.mem_led.record_churn("device", "session_demote", len(entry.pinned))
        self.pool.release(entry.pinned)
        entry.pinned = []

    def _remote_tier(self):
        """The shared remote tier in the KVBM ladder, or None."""
        if self.kvbm is None:
            return None
        return next((t for t in self.kvbm.tiers if t.name == "remote"), None)

    def evacuate_sessions(self) -> dict:
        """Push every retained session's device chain plus a resumable
        record to the shared remote store, then release the pins: the next
        turn, on this engine or another on the same store, pulls the chain
        back warm instead of recomputing. Without a remote tier the chain is
        staged down the local ladder (no record); so it is over several
        nodes, where a rank's box in the SHARED store would corrupt
        cross-worker reads (JAX's rule). Engine-core thread only (the
        ``session_evacuate`` core op)."""
        out = {"sessions": 0, "blocks": 0, "bytes": 0}
        if self.sessions is None:
            return out
        remote = self._remote_tier() if self._mh is None else None
        while (popped := self.sessions.pop_oldest()) is not None:
            sid, entry = popped
            try:
                if remote is not None and entry.pinned:
                    blocks = self.transfer.extract(self.runner.cache_k,
                                                   self.runner.cache_v, entry.pinned)
                    for h, block in zip(entry.seq_hashes, blocks):
                        remote.put(h, block)
                        out["blocks"] += 1
                        out["bytes"] += int(block.nbytes)
                    if remote.put_session(sid, list(entry.seq_hashes), entry.tokens):
                        out["sessions"] += 1
                elif self.kvbm is not None and entry.pinned:
                    self.kvbm.stage_blocks(list(zip(entry.pinned, entry.seq_hashes)))
            except Exception:
                log.exception("session %s evacuation failed; its blocks fall to the LRU", sid)
            self.pool.release(entry.pinned)
            entry.pinned = []
        return out

    def abort_class(self, priority: str | None = None) -> list[str]:
        """Abort every live request of one QoS class (None = all) — the
        drain run-down's early-stop valve (runtime/drain.py abort_batch /
        abort_all). Returns the aborted request ids so the async wrapper
        can emit their terminal CANCELLED outputs."""
        rids = [rid for rid, seq in self._seqs.items()
                if seq.phase is not Phase.FINISHED
                and (priority is None or seq.qos_priority == priority)]
        for rid in rids:
            self.abort(rid)
        return rids

    def step(self) -> dict[str, LLMEngineOutput]:
        """Run one engine step synchronously; returns per-request deltas."""
        now = time.time()
        self.set_step_time(now)
        outs = self.reap_expired(now)
        pending = self.step_begin()
        if pending is not None:
            outs.update(self.step_finalize(pending))
        return outs

    # -- KV-transfer primitives of disaggregated serving (engine-core thread)
    def _new_transfer(self):
        """A block mover over this engine's cache: whole blocks from every
        rank's heads (and every stage's layers) under tensor (and pipeline)
        parallelism on one node, as JAX's engine at one process moves them;
        each rank's own box over several nodes (kvbm/distributed.py)."""
        from dynamo_tpu_torch.kvbm.transfer import BlockTransferEngine, TPTransferEngine

        tp = self.runner.tp
        if tp is None:
            return BlockTransferEngine()
        if self._mh is not None:
            from dynamo_tpu_torch.kvbm.distributed import ShardedBlockTransferEngine

            return ShardedBlockTransferEngine(tp)
        spec = self.runner.block_spec
        return TPTransferEngine(tp, spec.num_kv_heads, spec.num_layers)

    @property
    def transfer(self):
        """The block mover: the offload manager's, else one of its own."""
        if self.kvbm is not None:
            return self.kvbm.transfer
        if self._transfer is None:
            self._transfer = self._new_transfer()
        return self._transfer

    def export_blocks(self, seq_hashes: list[int]) -> list[tuple[int, int | None, np.ndarray]]:
        """Gather the device-resident prefix of a hash chain off the device
        as ``(seq_hash, parent_hash, host block)`` — the prefill side of
        disaggregated serving. Over several nodes: the leader's box of
        each block, as a JAX process's export."""
        ids, kept = [], []
        parent: int | None = None
        for h in seq_hashes:
            bid = self.pool.block_for_hash(h)
            if bid is None:
                break
            ids.append(bid)
            kept.append((h, parent))
            parent = h
        if not ids:
            return []
        blocks = self.transfer.extract(self.runner.cache_k, self.runner.cache_v, ids)
        return [(h, par, data) for (h, par), data in zip(kept, blocks)]

    def import_blocks(self, plan: list[tuple[int, int | None, np.ndarray]],
                      span_attrs: dict | None = None, pull: tuple | None = None) -> int:
        """Write externally received blocks into the cache as matchable
        entries — the decode side of disaggregated serving. Blocks of any
        format (either package's, any kv dtype) convert at the boundary;
        hashes already on the device are skipped (and MRU-protected). Over
        several nodes ``plan`` holds the leader's box of each block and
        ``pull`` names the pull (xfer id, start, stop) whose blocks each
        other rank writes (:meth:`import_remote`)."""
        from dynamo_tpu_torch.kvbm.offload import inject_and_commit, plan_onboard

        by_hash = {h: data for h, _, data in plan}
        filtered = plan_onboard(self.pool, [h for h, _, _ in plan], by_hash.get)
        if self._mh is not None:
            if pull is None:
                raise ValueError("import_blocks over several nodes takes blocks a pull "
                                 "brought to every rank (import_remote)")
            self._mh.post("kv_load_pull", list(pull), [h for h, _, _ in filtered])
        flush = self.kvbm.flush_pending if self.kvbm is not None else None
        return inject_and_commit(self.runner, self.pool, self.transfer, filtered,
                                 flush=flush, span_attrs=span_attrs)

    def pin_blocks(self, seq_hashes: list[int]) -> list[int]:
        """Incref the device-resident prefix of a chain so it survives until
        a pending transfer pulls it; pair with unpin_blocks."""
        return self.pool.match_prefix(seq_hashes)

    def unpin_blocks(self, block_ids: list[int]) -> None:
        self.pool.release(block_ids)

    # -- disaggregated handoff: staged and streamed (named ops, CORE_OPS) ---
    # The prefill side pins a chain's blocks and stages them to host memory
    # (one shot, or wave by wave while the prefill runs); the shard server
    # serves them; the decode side fetches them off the engine-core thread
    # and injects them as matchable prefix entries. The JAX package runs
    # these as replayed ops on every rank of a multi-host engine. On one
    # node the port's leader holds every block whole (a tensor-parallel
    # engine's through its transfer engine), so the rank vote is the
    # identity; over several nodes the leader posts each op's rank-local
    # half (``kv_*``: each rank of replica 0 stages its box, every rank
    # pulls and injects its own) and votes where an outcome may differ.

    @property
    def staging(self):
        if self._staging is None:
            from dynamo_tpu_torch.disagg.sharded import StagingStore

            self._staging = StagingStore()
        return self._staging

    def my_box(self) -> tuple[int, int, int, int]:
        """This engine's (layer, head) extents of the global cache: all of
        it, whole blocks on the leader; over several nodes the leader
        rank's own box (kvbm/distributed.local_box)."""
        spec = self.runner.block_spec
        if self._mh is not None:
            from dynamo_tpu_torch.kvbm.distributed import local_box

            return local_box(self._mh, spec.num_layers, spec.num_kv_heads)
        return (0, spec.num_layers, 0, spec.num_kv_heads)

    def follower_shards(self) -> list[dict]:
        """The other nodes' shard servers of a prefill engine, ``[{"addr",
        "box"}, ...]`` (their ``ready`` acks): the handoff lists them after
        this engine's own."""
        return self._channel.shards() if self._channel is not None else []

    def start_shard_server(self, advertise_host: str, on_release=None) -> str:
        """Start (once) the shard server serving staged KV; returns the
        address to advertise in kv_transfer_params. Safe to call off the
        engine-core thread: it only binds a socket and reads the
        (lock-guarded) staging store."""
        if self._shard_server is None:
            from dynamo_tpu_torch.disagg.sharded import ShardServer

            self._shard_server = ShardServer(self.staging, on_release=on_release)
        return f"{advertise_host}:{self._shard_server.port}"

    def stop_shard_server(self) -> None:
        """Close the shard server and its connections. Idempotent."""
        server, self._shard_server = self._shard_server, None
        if server is not None:
            server.close()

    def _vote(self, n: int, kind: str, arg) -> int:
        """The minimum of ``n`` over the engine's ranks
        (``multihost.vote_min``): the identity on one node; over several,
        each other rank votes its own count of ``kind`` (``out``: its last
        extract's blocks, ``arg`` of them asked; ``staged``: the staged
        prefix of transfer ``arg``, which it then closes; ``pulled``: 1 if
        pull ``arg`` fetched its box)."""
        from dynamo_tpu_torch.parallel.multihost import vote_min

        if self._mh is not None:
            self._mh.post("kv_vote", kind, arg)
        return vote_min(n, self._mh)

    def _stage_extract(self, ids: list[int], span_attrs: dict | None = None) -> np.ndarray:
        """Blocks ``ids`` off the device as one [n, 2, L, BS, KH, D] array:
        quantized caches stage dequantized (f32) blocks, as the JAX package
        does; the importer requantizes at its inject boundary. Over several
        nodes every serving rank extracts its box too."""
        kw = {"serve": True} if self._mh is not None else {}
        blocks = self.transfer.extract(self.runner.cache_k, self.runner.cache_v, ids,
                                       dequant=self.runner.spec.quantized,
                                       span_attrs=span_attrs, **kw)
        return np.stack(blocks)

    def stage_export(self, xfer_id: str, seq_hashes: list[int]) -> int:
        """Pin the device-resident prefix of a chain and stage it to host
        memory; returns hashes covered. The pin and the staging hold until
        release_export: pulls are served from host memory, never touching
        device state again."""
        block_ids = self.pool.match_prefix(seq_hashes)
        data = None
        try:
            if block_ids:
                data = self._stage_extract(block_ids)
        except Exception as exc:  # noqa: BLE001 — the vote handles it
            log.warning("stage_export extract failed: %s", exc)
            data = None
        n = self._vote(len(block_ids) if data is not None else 0, "out", len(block_ids))
        if n < len(block_ids):
            self.pool.release(block_ids[n:])
            block_ids = block_ids[:n]
        if n == 0:
            return 0
        covered = seq_hashes[:n]
        parents: list[int | None] = [None, *covered[:-1]]
        self.staging.fill(xfer_id, covered, parents, data[:n], self.my_box())
        if self._mh is not None:
            self._mh.post("kv_stage_fill", xfer_id, covered, parents, n)
        self._staged_pins[xfer_id] = block_ids
        if self.mem_led.enabled:
            self.mem_led.pin("staging", xfer_id, len(block_ids))
        return n

    def release_export(self, xfer_id: str) -> None:
        """Unpin + unstage one transfer — final ack AND mid-stream abort.
        For a still-streaming transfer this also tears down the stream
        state, so pins already shipped, staged-but-unpulled, and
        not-yet-staged waves all release together (later kv_stage_wave ops
        for this id become no-ops)."""
        st = self._streams_by_xid.pop(xfer_id, None)
        if st is not None:
            self._stream_exports.pop(st.request_id, None)
        self.staging.drop(xfer_id)
        if self._mh is not None:
            self._mh.post("kv_unstage", xfer_id)
        ids = self._staged_pins.pop(xfer_id, None)
        if ids is not None and self.mem_led.enabled:
            self.mem_led.unpin("staging", xfer_id)
        if ids:
            self.pool.release(ids)

    # -- streamed (wave-granular) export: kv_stream_begin declares the full
    # expected chain once, the step loop stages one kv_stage_wave after each
    # finalize that commits new blocks (AsyncTorchEngine._stage_stream_waves),
    # and kv_stream_end closes it at the staged count.

    def stream_begin(self, xfer_id: str, request_id: str,
                     seq_hashes: list[int]) -> int:
        """Open a streamed export for ``request_id``'s chain. No device
        work — the staging entry just declares the expected hashes so
        early pulls can wait on waves."""
        st = _StreamExport(xfer_id=xfer_id, request_id=request_id,
                           hashes=list(seq_hashes))
        self._stream_exports[request_id] = st
        self._streams_by_xid[xfer_id] = st
        self._staged_pins.setdefault(xfer_id, [])
        parents: list[int | None] = [None, *st.hashes[:-1]]
        self.staging.begin(xfer_id, st.hashes, parents, self.my_box(),
                           self.runner.spec.dtype)
        if self._mh is not None:
            self._mh.post("kv_stage_begin", xfer_id, st.hashes, parents)
        return len(st.hashes)

    def stream_wave_targets(self) -> list[tuple[str, int, int]]:
        """Wave detection (engine-core thread, after step_finalize): chains
        whose committed-block prefix grew past what has been staged. Also
        caches each stream's Seq while it is still registered, so the final
        wave (committed by the finalize that finishes the request) is still
        visible after _seqs drops it."""
        if not self._stream_exports:
            return []
        out: list[tuple[str, int, int]] = []
        for rid, st in list(self._stream_exports.items()):
            if st.seq is None:
                st.seq = self._seqs.get(rid)
            if st.seq is None:
                continue
            avail = min(st.seq.committed_blocks, len(st.hashes))
            if avail > st.requested:
                out.append((st.xfer_id, st.requested, avail))
                st.requested = avail
        return out

    def stage_wave(self, xfer_id: str, start: int, stop: int) -> int:
        """Stage blocks [start, stop) of a streamed chain: pin the new
        wave, extract it, append to staging. A failed extract freezes the
        stream's staged count, which stream_end closes it at. Returns the
        blocks staged so far."""
        st = self._streams_by_xid.get(xfer_id)
        if st is None:  # released/aborted while the op was in flight
            return 0
        stop = min(stop, len(st.hashes))
        if stop <= start:
            return st.staged
        # Pin [start, stop) without double-pinning earlier waves:
        # match_prefix increfs the whole resident prefix, so drop the refs
        # below start. The committed prefix can't shrink between the
        # finalize that committed it and this op (no allocate in between),
        # so len(ids) == stop in the healthy case.
        ids = self.pool.match_prefix(st.hashes[:stop])
        if start:
            self.pool.release(ids[:start])
        keep = ids[start:]
        self._staged_pins.setdefault(xfer_id, []).extend(keep)
        if keep and self.mem_led.enabled:
            self.mem_led.pin("staging", xfer_id, len(keep))
        if st.failed:
            return st.staged
        if len(ids) < stop:
            log.warning("stage_wave %s: only %d/%d blocks resident; "
                        "freezing stream", xfer_id, len(ids), stop)
            st.failed = True
            return st.staged
        try:
            data = self._stage_extract(keep, span_attrs={
                "phase": "stage", "xfer_id": xfer_id, "start": start, "stop": stop})
        except Exception as exc:  # noqa: BLE001 — stream_end closes at staged
            log.warning("stage_wave extract failed: %s", exc)
            st.failed = True
            return st.staged
        if st.staged != start or not self.staging.append(xfer_id, start, data):
            st.failed = True
            return st.staged
        if self._mh is not None:
            self._mh.post("kv_stage_append", xfer_id, start, stop)
        st.staged = stop
        from dynamo_tpu_torch.disagg.metrics import get_kv_metrics

        get_kv_metrics().record_wave("stage", int(data.nbytes))
        return st.staged

    def stream_end(self, xfer_id: str) -> int:
        """Close a streamed export at its staged count: trim pins beyond
        it, mark the staging entry complete. Returns the covered (pullable)
        block count."""
        st = self._streams_by_xid.pop(xfer_id, None)
        if st is None:
            return 0
        self._stream_exports.pop(st.request_id, None)
        covered = self._vote(st.staged, "staged", xfer_id)
        pins = self._staged_pins.get(xfer_id, [])
        if len(pins) > covered:
            if self.mem_led.enabled:
                self.mem_led.unpin("staging", xfer_id, len(pins) - covered)
            self.pool.release(pins[covered:])
            self._staged_pins[xfer_id] = pins[:covered]
        self.staging.finalize(xfer_id, covered)
        return covered

    def _fetch_local(self, params: dict, start: int | None = None,
                     stop: int | None = None, clients: dict | None = None):
        """The network half of a pull of this engine's box
        (disagg/sharded.fetch_box). Safe off the core thread."""
        from dynamo_tpu_torch.disagg.sharded import fetch_box

        spec = self.runner.spec if self._mh is not None else self.runner.block_spec
        return fetch_box(params, self.my_box(), spec.block_size, spec.head_dim, spec.dtype,
                         start, stop, clients)

    def _pull_state(self, xfer_id: str) -> dict:
        return self._pulls.setdefault(
            xfer_id, {"clients": {}, "waves": {}, "last": None})

    def prefetch_remote(self, params: dict, start: int | None = None,
                        stop: int | None = None, tail: bool = False) -> None:
        """Start the pull's network half on a background thread so engine
        steps keep running while bytes move; import_remote joins it. Wave
        pulls ([start, stop) windows) of one transfer chain on a single
        thread lineage so the per-shard connections are reused without
        cross-thread sharing."""
        state = self._pull_state(params["xfer_id"])
        prev = state["last"]
        slot: dict = {}
        stats = self.pull_stats
        if self._mh is not None:   # every rank fetches its own box
            self._mh.post("kv_pull", params, start, stop)

        def run() -> None:
            if prev is not None:
                prev["thread"].join()
            t0 = time.perf_counter()
            with get_tracer().span("kv.transfer", phase="pull",
                                   xfer_id=params["xfer_id"],
                                   start=start if start is not None else 0,
                                   stop=stop if stop is not None else -1,
                                   tail=tail) as sp:
                result = self._fetch_local(params, start, stop,
                                           state["clients"])
                if result is not None:
                    sp.attrs["bytes"] = int(result[2].nbytes)
                    sp.attrs["blocks"] = len(result[0])
                    stats["pulls"] += 1
                    stats["blocks"] += len(result[0])
                    stats["bytes"] += int(result[2].nbytes)
                    stats["seconds"] += time.perf_counter() - t0
            slot["result"] = result

        t = threading.Thread(target=run, name="kv-prefetch", daemon=True)
        slot["thread"] = t
        state["waves"][(start, stop)] = slot
        state["last"] = slot
        t.start()

    def import_remote(self, params: dict, start: int | None = None,
                      stop: int | None = None, final: bool = True) -> int:
        """Join the prefetch (or fetch inline) and inject one window of the
        chain. Returns blocks injected, or -1 when the pull failed (no
        state was mutated). ``final`` closes the transfer's pull state
        (shard connections) afterwards."""
        if self._mh is not None and (start, stop) not in self._pull_state(
                params["xfer_id"])["waves"]:
            self.prefetch_remote(params, start, stop)   # every rank fetches its box
        state = self._pull_state(params["xfer_id"])
        slot = state["waves"].pop((start, stop), None)
        if slot is not None:
            slot["thread"].join()
            fetched = slot["result"]
        else:
            fetched = self._fetch_local(params, start, stop, state["clients"])
        key = (params["xfer_id"], start, stop)
        if self._vote(1 if fetched is not None else 0, "pulled", key) == 0:
            self.close_pull(params["xfer_id"])
            return -1
        hashes, parents, local = fetched
        plan = [(h, par, local[i])
                for i, (h, par) in enumerate(zip(hashes, parents))]
        n = self.import_blocks(
            plan, span_attrs={"phase": "import", "xfer_id": params["xfer_id"],
                              "start": start if start is not None else 0,
                              "stop": stop if stop is not None else len(hashes)},
            pull=key if self._mh is not None else None)
        from dynamo_tpu_torch.disagg.metrics import get_kv_metrics

        get_kv_metrics().record_wave("pull", int(local.nbytes))
        log.info("pulled %d KV blocks for box %s (injected %d)",
                 len(plan), self.my_box(), n)
        if final:
            self.close_pull(params["xfer_id"])
        return n

    def close_pull(self, xfer_id: str) -> None:
        """Tear down a transfer's pull state: close per-shard connections
        and drop pending wave results. Closing the sockets first makes any
        in-flight fetch thread fail fast, so the join is bounded."""
        state = self._pulls.pop(xfer_id, None)
        if state is None:
            return
        if self._mh is not None:
            self._mh.post("kv_pull_close", xfer_id)
        for client in state["clients"].values():
            client.close()
        last = state["last"]
        if last is not None and last["thread"].is_alive():
            last["thread"].join(timeout=5.0)

    def run_op(self, name: str, args: dict):
        """Execute one named core op (``CORE_OPS``)."""
        return CORE_OPS[name](self, args)

    def embed(self, token_lists: list[list[int]]) -> np.ndarray:
        """Last-token-pooled embeddings [N, H] f32 (engine-core thread only;
        ``ModelRunner.embed``)."""
        return self.runner.embed(token_lists)

    # -- tensor parallelism ------------------------------------------------
    def tp_stats(self) -> list[dict]:
        """Every rank's ``ModelRunner.tp_stats``, in rank order (between
        steps: on the engine-core thread once it runs)."""
        tp = self.runner.tp
        if tp is None:
            raise ValueError("tp_stats: this engine is not tensor-parallel")
        tp.post("stats")
        return [self.runner.tp_stats(),
                *self._tp_followers.replies("stats", self.runner.tp.timeout)]

    def reset_tp_stats(self) -> None:
        """Set every rank's launch counts, program calls and collective
        counters to 0."""
        self.runner.tp.post("reset_stats")
        self.runner.reset_tp_stats()

    def close(self) -> None:
        """Stop a tensor-parallel engine's followers and leave its group
        (right after posting ``stop``: a rank's leave over nccl waits for
        its peers'), then tell the other nodes and close the op channel;
        nothing to do at tp=1. ``shutdown_stats`` keeps the seconds it took
        and the followers it had to kill. Idempotent."""
        followers, self._tp_followers = self._tp_followers, None
        if followers is not None:
            self.runner.release_graphs()
            followers.stop(self.runner.tp)
            self.shutdown_stats = dict(followers.shutdown)
        channel, self._channel = self._channel, None
        if channel is not None:
            channel.close()

    def abandon(self) -> None:
        """After a lost rank, on the way out of the process: kill this
        node's followers and close the op channel, without leaving the
        group (over nccl a rank's leave waits for peers that are gone)."""
        followers, self._tp_followers = self._tp_followers, None
        if followers is not None:
            followers.kill()
        channel, self._channel = self._channel, None
        if channel is not None:
            channel.close()

    def fail_all(self, error: str) -> list[str]:
        """Abort every in-flight request (engine-fatal path). Returns the
        request ids that were failed."""
        rids = list(self._seqs)
        for rid in rids:
            self.abort(rid)
        self._seqs.clear()
        if self.sessions is not None:
            # Retained pins must not outlive the requests that made them.
            self.sessions.release_all()
        return rids


@dataclass
class _StreamExport:
    """Per-request state of a streamed (wave-granular) KV export.

    ``requested`` is how far wave detection has emitted stage ops;
    ``staged`` the prefix staged so far. ``seq`` is cached by wave
    detection so the final wave — committed by the finalize that also
    finishes the request — is still observable after the seq leaves
    ``_seqs``."""

    xfer_id: str
    request_id: str
    hashes: list[int]
    seq: Seq | None = None
    requested: int = 0
    staged: int = 0
    failed: bool = False


#: The named core ops (the JAX package's registry of ops a multi-host
#: engine replays; here they run on the one engine-core thread, the only
#: core access a multi-host leader allows): the disagg handoff, session
#: evacuation, the QoS class abort, and the ranks' counters.
CORE_OPS: dict[str, Callable[[EngineCore, dict], Any]] = {
    "kv_stage": lambda core, a: core.stage_export(a["xfer_id"], a["hashes"]),
    "kv_release": lambda core, a: core.release_export(a["xfer_id"]),
    "kv_prefetch": lambda core, a: core.prefetch_remote(a["params"]),
    "kv_import": lambda core, a: core.import_remote(a["params"]),
    # Streamed (wave-granular) handoff — see EngineCore.stream_begin.
    "kv_stream_begin": lambda core, a: core.stream_begin(
        a["xfer_id"], a["request_id"], a["hashes"]),
    "kv_stage_wave": lambda core, a: core.stage_wave(
        a["xfer_id"], a["start"], a["stop"]),
    "kv_stream_end": lambda core, a: core.stream_end(a["xfer_id"]),
    "kv_prefetch_wave": lambda core, a: core.prefetch_remote(
        a["params"], a["start"], a["stop"], a.get("tail", False)),
    "kv_import_wave": lambda core, a: core.import_remote(
        a["params"], a["start"], a["stop"], a.get("final", False)),
    "kv_pull_abort": lambda core, a: core.close_pull(a["xfer_id"]),
    "session_evacuate": lambda core, a: core.evacuate_sessions(),
    "qos_abort_class": lambda core, a: core.abort_class(
        a.get("priority") if a else None),
    # The port's: every rank's counters, read or zeroed between steps (their
    # posts must not interleave with a step's).
    "tp_stats": lambda core, a: core.tp_stats(),
    "reset_tp_stats": lambda core, a: core.reset_tp_stats(),
}


class OpChannelDown(RuntimeError):
    """The multi-host op channel (or a rank on another node) failed — the
    engine cannot continue (a node's ranks would be missing from every
    collective)."""


#: seconds between two looks at a tensor-parallel engine's followers
RANK_WATCH_S = 0.1


class AsyncTorchEngine:
    """Async facade: background step-loop thread + asyncio output streams
    (the JAX package's AsyncJaxEngine).

    ``op_sink``: on the leader of an engine over several nodes, the op
    channel's broadcast (parallel/multihost.LeaderOpChannel): every
    state-changing op (``add``, ``abort``, ``reap``, ``step``, ``exec`` of a
    named core op, ``fail_all``) is broadcast before it is applied, as
    JAX's leader does. The port's other nodes replay none of it (their
    ranks follow the leader's posts), but a lost node makes a broadcast or
    a step's collective fail: the engine then stops with
    ``OpChannelDown`` and fails every open stream, and later requests at
    once, instead of hanging. ``run_in_core`` is refused there (a closure
    cannot be broadcast): only the named ``CORE_OPS`` run.

    At more than one rank a watcher thread (``_watch_ranks``) stops the
    engine the same way when a local follower process exits, even while
    the step loop waits on the card for a collective that cannot end."""

    def __init__(self, core: EngineCore, op_sink: Callable[[dict], None] | None = None):
        self.core = core
        self._op_sink = op_sink
        self._channel_down: str | None = None
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
            followers = self.core._tp_followers
            if followers is not None and followers.procs:
                threading.Thread(target=self._watch_ranks, args=(followers.procs,),
                                 name="rank-watch", daemon=True).start()
            self._started = True

    def _watch_ranks(self, procs: list) -> None:
        """Stop the engine and fail every open stream as soon as a local
        follower process exits, whatever the engine-core thread is doing:
        over nccl a step whose peer is gone never completes on the card,
        and a call that waits for the card (a pinned allocation, a copy to
        the host) holds that thread for good. Reads the processes' exit
        codes only; a remote node's loss shows at the op channel."""
        while not self._stop:
            time.sleep(RANK_WATCH_S)
            for rank, proc in enumerate(procs, 1):
                code = proc.exitcode
                if code is not None and not self._stop:
                    self._down(f"follower rank {rank} exited with exit code {code}")
                    self._fail_streams(self._channel_down)
                    self._wake.set()
                    return

    async def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        if self._started:
            await asyncio.get_running_loop().run_in_executor(None, self._thread.join, 5.0)
        # the handoff's sockets and fetch threads end with the engine
        self.core.stop_shard_server()
        for xid in list(self.core._pulls):
            self.core.close_pull(xid)
        # a tensor-parallel engine's followers stop once the loop is done;
        # over nccl one that lost a rank is abandoned instead (its
        # followers killed, its group left as it is): its card holds
        # collectives that wait for the lost rank, and so would the leave
        tp = self.core.runner.tp
        lost = self.down is not None and tp is not None and tp.backend == "nccl"
        await asyncio.get_running_loop().run_in_executor(
            None, self.core.abandon if lost else self.core.close)
        # A dead engine must not keep vouching for its pins: drop its
        # live-id source so anything it leaked surfaces in the next audit.
        self.core.mem_led.unregister_live_source(self.core._mem_source_key)

    def _emit_op(self, op: dict) -> None:
        """Broadcast one op to the other nodes; a failed broadcast is fatal
        for the whole engine, so stop the loop and raise OpChannelDown."""
        if self._op_sink is None:
            return
        try:
            self._op_sink(op)
        except Exception as exc:
            log.exception("op-channel broadcast failed; stopping engine loop")
            self._down(str(exc))
            raise OpChannelDown(str(exc)) from exc

    def _down(self, error: str) -> None:
        self._channel_down = (f"multi-host op channel down: {error}" if self._op_sink is not None
                              else f"a rank of the engine is lost: {error}")
        self._stop = True

    @property
    def down(self) -> str | None:
        """Why the engine stopped for good (a rank, a node or the op
        channel lost), or None while it serves."""
        return self._channel_down

    def _stage_stream_waves(self) -> None:
        """After each finalize: stage the newly committed prefill chunks of
        any open streamed export as kv_stage_wave ops, and tell the source's
        listener how far each stream is staged. The next step is already
        dispatched when this runs, so each wave's extract first waits for
        it (``TransferStats.waits``): committed blocks are no longer
        written, but the gather is queued behind the step in flight."""
        for xid, start, stop in self.core.stream_wave_targets():
            args = {"xfer_id": xid, "start": start, "stop": stop}
            self._emit_op({"op": "exec", "name": "kv_stage_wave", "args": args})
            staged = self.core.run_op("kv_stage_wave", args)
            listener = self.core._stream_listener
            if listener is not None and staged:
                try:
                    listener(xid, staged)
                except Exception:  # noqa: BLE001 — advisory only
                    log.exception("stream wave listener failed")

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
                try:
                    self._apply(kind, payload)
                except OpChannelDown:
                    break   # _stop is set; streams fail below
            if self._channel_down is not None:
                break   # a node is lost: every stream fails below
            if not self.core.has_work() and pending is None:
                if not moved:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            try:
                # Chaos: inside the try so an error-kind injection exercises
                # the engine-fatal path (fail_all + drain), and a delay is a
                # straggling device step. After the idle continue: only
                # iterations with work count against a rule's ``after``.
                chaos.inject("engine.step")
                t_step = time.time()
                if self.core.has_expired_waiting(t_step):
                    self._emit_op({"op": "reap", "now": t_step})
                    for rid, out in self.core.reap_expired(t_step).items():
                        self._post(rid, out)
                self._emit_op({"op": "step", "now": t_step})
                self.core.set_step_time(t_step)
                nxt = self.core.step_begin() if self.core.has_work() else None
                if pending is not None:
                    for rid, out in self.core.step_finalize(pending).items():
                        self._post(rid, out)
                pending = nxt
                self._stage_stream_waves()
            except Exception as exc:
                # Engine-fatal: fail + drain all in-flight state so the loop
                # doesn't spin hot retrying the same failing step.
                log.exception("engine step failed; failing all in-flight requests")
                pending = None
                self.core.fail_all(str(exc))
                if isinstance(exc, (OpChannelDown, TPFailure)):
                    # a rank is gone (a lost node or follower, a failed
                    # collective): the group cannot run another step
                    self._down(str(exc))
                    break
                if self._op_sink is not None:
                    with contextlib.suppress(OpChannelDown):
                        self._emit_op({"op": "fail_all", "error": str(exc)})
                self._fail_streams(str(exc))
        if self._channel_down is not None:
            # fail everything in flight, an idle engine's streams too
            self.core.fail_all(self._channel_down)
            self._fail_streams(self._channel_down)

    def _fail_streams(self, error: str) -> None:
        for rid in list(self._streams):
            self._post(rid, LLMEngineOutput(finish_reason=FinishReason.ERROR, error=error))

    def _apply(self, kind: str, payload) -> None:
        """One inbox item on the engine-core thread: broadcast (over several
        nodes), then apply."""
        if kind == "add":
            t_add = time.time()
            try:
                self._emit_op({"op": "add", "req": payload.to_dict(), "now": t_add})
            except OpChannelDown as exc:
                self._post(payload.request_id, LLMEngineOutput(
                    finish_reason=FinishReason.ERROR, error=str(exc)))
                raise
            err = self.core.add_request(payload, now=t_add)
            if err is not None:
                self._post(payload.request_id, err)
        elif kind == "abort":
            self._emit_op({"op": "abort", "rid": payload})
            self.core.abort(payload)
            self._post(payload, LLMEngineOutput(finish_reason=FinishReason.CANCELLED))
        elif kind in ("exec", "exec_op"):
            # Core access (a named CORE_OPS op, or a closure: embeddings)
            # marshaled onto this thread, the only one that touches device
            # state. The future resolves on the loop it was made on, which
            # may not be self._loop.
            if kind == "exec_op":
                name, args, fut, fut_loop = payload
                fn = functools.partial(EngineCore.run_op, name=name, args=args)
            else:
                fn, fut, fut_loop = payload
            result = exc = None
            if kind == "exec" and self._op_sink is not None:
                # A closure cannot ride the op stream: refuse it, as JAX's
                # multi-host leader does.
                exc = RuntimeError("run_in_core is not supported on a multi-host leader; "
                                   "use run_op with a registered named op")
            else:
                try:
                    if kind == "exec_op":
                        self._emit_op({"op": "exec", "name": name, "args": args})
                    result = fn(self.core)
                except OpChannelDown as e:
                    self._resolve_on(fut_loop, fut, None, e)
                    raise
                except Exception as e:  # noqa: BLE001 - handed to the caller
                    exc = e
            self._resolve_on(fut_loop, fut, result, exc)

    def _resolve_on(self, fut_loop, fut, result, exc) -> None:
        try:
            fut_loop.call_soon_threadsafe(self._resolve, fut, result, exc)
        except RuntimeError:
            pass  # the caller's loop closed before the result came

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
        if self._channel_down is not None:
            raise OpChannelDown(self._channel_down)
        self.start()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inbox.put(("exec", (fn, fut, loop)))
        self._wake.set()
        return await fut

    async def run_op(self, name: str, args: dict) -> Any:
        """Run a registered named core op (``CORE_OPS``) on the engine-core
        thread and await its result. On a multi-host leader the op is
        broadcast first — the multi-host-safe form of ``run_in_core``."""
        if self._channel_down is not None:
            raise OpChannelDown(self._channel_down)
        self.start()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inbox.put(("exec_op", (name, args, fut, loop)))
        self._wake.set()
        return await fut

    def _post(self, rid: str, out: LLMEngineOutput) -> None:
        loop, q = self._loop, self._streams.get(rid)
        if loop is None or q is None:
            return
        loop.call_soon_threadsafe(q.put_nowait, out)

    async def generate(self, req: PreprocessedRequest) -> AsyncIterator[LLMEngineOutput]:
        if self._channel_down is not None:
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR, error=self._channel_down)
            return
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

    async def evacuate_sessions(self) -> dict:
        """Push retained session KV + resumable records to the remote
        store (the ``session_evacuate`` core op: multi-host-safe)."""
        return await self.run_op("session_evacuate", {})

    async def abort_class(self, priority: str | None = None) -> int:
        """Early-stop every live stream of one QoS class (None = all),
        emitting their terminal CANCELLED outputs. Returns the count."""
        rids = await self.run_op("qos_abort_class", {"priority": priority})
        for rid in rids or []:
            self._post(rid, LLMEngineOutput(finish_reason=FinishReason.CANCELLED))
        return len(rids or [])

    @property
    def inflight(self) -> int:
        """Streams with a live output queue (drain run-down's gauge)."""
        return len(self._streams)

    def stats(self) -> dict[str, Any]:
        core = self.core
        out = core.metrics.snapshot(core.sched, core.pool)
        if core.kvbm is not None:
            out["kvbm"] = core.kvbm.snapshot()
            if core.kvbm.ckpt_tier is not None:
                # Crash exposure refreshes on the stats poll cadence.
                get_stream_ckpt_metrics().lag_blocks.set(float(core.ckpt_lag_blocks()))
        if core.sessions is not None:
            out["session"] = core.sessions.snapshot()
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


def abandon_build(core: EngineCore) -> None:
    """After a failed warmup: a warmup that fails at more than one rank
    leaves the followers inside a collective the leader never joins, so
    kill them (``EngineCore.abandon``). Over gloo also leave the group,
    which waits for no peer, so the process can form another; over nccl
    the group stays as it is, since its leave would wait for the peers
    just killed."""
    core.abandon()
    tp = core.runner.tp
    if tp is not None and tp.backend != "nccl":
        tp.close()


def build_engine(engine_cfg: EngineConfig, params=None,
                 device: str | torch.device | None = None,
                 event_sink: Callable[[KvCacheEvent], None] | None = None,
                 channel=None) -> AsyncTorchEngine:
    """The port's engine for ``engine_cfg`` on ``device`` (default: the
    CUDA card; raises when there is none), warmed up as
    ``engine_cfg.warmup_mode`` asks before its step loop starts (the
    summary is ``engine.core.warmup_summary``). ``event_sink`` receives the
    prefix pool's KV events (the router's publisher). ``channel``: the op
    channel of the leader of an engine over several nodes, whose broadcast
    becomes the engine's op sink."""
    core = EngineCore(engine_cfg, params=params, device=device, event_sink=event_sink,
                      channel=channel)
    try:
        core.warmup()
    except BaseException:
        abandon_build(core)
        raise
    return AsyncTorchEngine(core, op_sink=channel.broadcast if channel is not None else None)
