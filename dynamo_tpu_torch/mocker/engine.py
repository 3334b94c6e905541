"""Mocker engine: a timing-accurate engine simulator with zero accelerators.

Fills the role of the reference's mocker
(reference: lib/llm/src/mocker/{engine.rs,scheduler.rs,kv_manager.rs}):
simulates a paged-KV continuous-batching engine — real block accounting
(the SAME PrefixPool the torch engine uses, so it emits true KV events),
prefill token budgets, configurable timing (``speedup_ratio`` scales real
sleeps), deterministic fake tokens — so routers, frontends, planners, and
fault tolerance are testable on a laptop CPU exactly like the reference
tests against N mockers (tests/router/test_router_e2e_with_mockers.py).

Copy of ``dynamo_tpu/mocker/engine.py``. It allocates no tensor and does
not import the torch engine (``engine.engine``, the models, the kernels):
a mocker worker starts in well under a second. With ``remote_kv_addr`` it
imports the KVBM's store client, which brings torch for the cache spec.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Callable

from dynamo_tpu_torch import chaos
from dynamo_tpu_torch.engine.errors import NoFreeBlocks
from dynamo_tpu_torch.engine.prefix_pool import PrefixPool
from dynamo_tpu_torch.engine.session import SessionStore, get_session_metrics, session_id_of
from dynamo_tpu_torch.kvbm.stream_ckpt import (
    CKPT_GENERATED_KEY,
    build_ckpt_record,
    get_stream_ckpt_metrics,
)
from dynamo_tpu_torch.obs.compile_ledger import (
    enumerate_buckets,
    get_compile_ledger,
    sig_for_rows,
)
from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger, live_ids_of
from dynamo_tpu_torch.obs.sched_ledger import HolStall, get_sched_ledger
from dynamo_tpu_torch.obs.tracer import get_tracer, trace_context_of
from dynamo_tpu_torch.protocols.common import FinishReason, LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.qos.config import class_rank
from dynamo_tpu_torch.qos.deadline import deadline_of, expired, priority_of
from dynamo_tpu_torch.router.events import KvCacheEvent
from dynamo_tpu_torch.tokens import TokenBlockSequence
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("mocker")


@dataclass
class MockEngineArgs:
    """(reference: mocker/protocols.rs MockEngineArgs)"""

    num_blocks: int = 512
    block_size: int = 16
    max_batch_size: int = 32
    max_model_len: int = 8192
    vocab_size: int = 32000
    # timing model
    prefill_us_per_token: float = 300.0
    decode_itl_ms: float = 8.0
    speedup_ratio: float = 10.0     # divide all times by this
    enable_prefix_caching: bool = True
    watermark: float = 0.01
    # Fleet-wide prefix cache mirror (device-free): a real RemoteBlockPool
    # against the shared G4 store, carrying tiny stand-in payloads — block
    # ACCOUNTING and the publish/import policy are exercised exactly like
    # the engine's (publish-on-commit, admission-time import shrinking
    # simulated prefill), without any device transfer.
    remote_kv_addr: str | None = None
    global_prefix_cache: bool = False
    # Session-sticky KV retention mirror (engine/session.py): finished
    # streams with a session.id keep their committed blocks pinned for this
    # many seconds so the next turn's simulated prefill covers only the new
    # suffix. 0 = off. Same SessionStore the engine uses — block
    # accounting and the dynamo_session_* metrics are real.
    session_ttl: float = 0.0
    # Compile-ledger mirror (obs/compile_ledger.py): each simulated
    # dispatch derives the bucket signature the engine WOULD compile
    # (same _bucket/_pow2_bucket math, device-free) and a first-touch
    # bucket files a real ledger event — span, metrics — plus a simulated
    # step-loop stall, so coldstart benchmarks measure a cold-vs-warm TTFT
    # gap without a TPU. "off" disables the ledger; "full" pre-files the
    # whole lattice in warmup() so no serving stall is ever injected.
    warmup_mode: str = "lazy"
    # Simulated wall seconds one cold-bucket compile stalls the step loop
    # (divided by speedup_ratio like every other simulated time).
    compile_s: float = 0.5
    # Unified mixed-phase step mirror (engine/engine.py step_begin): the
    # prefill chunk and every decode row advance in ONE simulated step —
    # sig_for_rows("mixed", ...), a single sched-ledger record whose HOL
    # stall is the chunk's MARGINAL share of the step wall (decode rows no
    # longer lose a whole serialized iteration). False = legacy two-step
    # serialization, matching --no-unified-step.
    unified_step: bool = True
    # Crash-consistent stream checkpoints mirror (kvbm/stream_ckpt.py):
    # every this-many committed decode blocks (QoS-degraded like the
    # engine: interactive 1x, standard 2x, batch 4x) the stream's newly
    # committed blocks (stand-in payloads) plus a resumable record flush
    # to the shared store; a resume request carrying stream_ckpt.*
    # annotations continues the md5 token sequence exactly where the
    # killed stream stopped. 0 = off. Requires remote_kv_addr.
    stream_ckpt_blocks: int = 0


@dataclass
class _MockSeq:
    req: PreprocessedRequest
    block_seq: TokenBlockSequence
    block_ids: list[int] = field(default_factory=list)
    committed: int = 0
    generated: int = 0
    prefilled: bool = False
    cached_blocks: int = 0
    queue: asyncio.Queue = field(default_factory=asyncio.Queue)
    done: bool = False
    priority: str = "standard"
    deadline_ts: float | None = None
    session_id: str | None = None
    # Tracing mirrors the real engine (engine/engine.py _trace_plan):
    # one open phase span per seq, decode spans rotated every N tokens.
    trace_ctx: object | None = None
    trace_span: object | None = None
    trace_tokens: int = 0
    # Stream-checkpoint mirror: committed-block watermark of the last
    # checkpoint (-1 = none yet), emitted-token ledger, and the resume
    # offset (generated tokens already in the resume prompt, so the md5
    # token sequence continues instead of restarting).
    ckpt_blocks: int = -1
    out_tokens: list[int] = field(default_factory=list)
    ckpt_offset: int = 0

    def __post_init__(self) -> None:
        ann = getattr(self.req, "annotations", None)
        self.priority = priority_of(ann, self.priority)
        self.deadline_ts = deadline_of(ann)
        self.session_id = session_id_of(ann)
        self.trace_ctx = trace_context_of(ann)
        try:
            self.ckpt_offset = int((ann or {}).get(CKPT_GENERATED_KEY) or 0)
        except (TypeError, ValueError):
            self.ckpt_offset = 0


class MockEngine:
    wedged: bool = False  # test hook (see _loop)

    def __init__(self, args: MockEngineArgs | None = None,
                 event_sink: Callable[[KvCacheEvent], None] | None = None):
        import os

        self.args = args or MockEngineArgs()
        self._trace_stride = max(
            int(os.environ.get("DYN_TRACE_DECODE_STRIDE", "32")), 1)
        self.pool = PrefixPool(
            self.args.num_blocks, self.args.block_size,
            event_sink=event_sink,
            enable_prefix_caching=self.args.enable_prefix_caching)
        self.waiting: list[_MockSeq] = []
        self.running: list[_MockSeq] = []
        self._task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self.prefix_hits = 0
        self.prefix_lookups = 0
        self.steps = 0
        self.deadline_cancelled = 0
        self.session_hits = 0
        self.session_remote_resumes = 0
        self.stream_ckpt_writes = 0
        self.stream_ckpt_resumes = 0
        self.stream_ckpt_resume_recomputed = 0
        # Session retention mirror — the same store the engine wires up.
        self.sessions: SessionStore | None = None
        if self.args.session_ttl > 0 and self.args.enable_prefix_caching:
            self.sessions = SessionStore(self.pool,
                                         ttl=self.args.session_ttl)
        # Fleet-wide prefix cache mirror: a REAL RemoteBlockPool client (so
        # mocker fleets exercise the wire protocol, breaker, and chaos
        # points) over a deliberately tiny KV geometry — the payload is a
        # stand-in; only the hash-keyed accounting matters here.
        self.remote = None
        self._payload = None
        self._importing = False
        self.imported_blocks = 0
        self.published_blocks = 0
        if self.args.remote_kv_addr:
            import numpy as np

            from dynamo_tpu_torch.engine.cache import KVCacheSpec
            from dynamo_tpu_torch.kvbm.remote import RemoteBlockPool

            spec = KVCacheSpec(
                num_blocks=self.args.num_blocks,
                block_size=self.args.block_size,
                num_layers=1, num_kv_heads=1, head_dim=2,
                dtype="float32", kv_dtype="float32")
            self.remote = RemoteBlockPool(
                spec, self.args.remote_kv_addr, fingerprint="mocker")
            self._payload = np.ones(
                (2, 1, self.args.block_size, 1, 2), dtype=np.float32)
            if self.args.global_prefix_cache:
                self.pool.commit_hook = self._on_commit
        # Compile-ledger mirror: signatures come from a synthetic
        # EngineConfig carrying the mocker's geometry (everything else at
        # engine defaults — the lattice math reads geometry only).
        from dynamo_tpu_torch.utils.config import EngineConfig

        self._lattice_cfg = EngineConfig(
            block_size=self.args.block_size,
            max_batch_size=self.args.max_batch_size,
            max_model_len=self.args.max_model_len,
            warmup_mode=self.args.warmup_mode,
            unified_step=self.args.unified_step)
        self._ledger = get_compile_ledger()
        self._ledger.configure(self.args.warmup_mode)
        if self.args.warmup_mode != "off":
            self._ledger.set_plan(enumerate_buckets(self._lattice_cfg))
        # Scheduling-ledger mirror (obs/sched_ledger.py): each simulated
        # step files a device-free step record — token-ratio goodput at
        # the sig_for_rows bucket geometry, HOL victims (the running
        # decode streams a serialized prefill makes wait), admission-block
        # causes — so fleet/chaos scenarios exercise the dynamo_sched_*
        # family and the decode_stall SLI without a TPU.
        self._sled = get_sched_ledger()
        self._sled.configure()
        # Memory-ledger mirror (obs/mem_ledger.py): the same pin taxonomy,
        # TTX forecast, and leak audit as the engine, device-free —
        # the pool accounting is real, so occupancy/orphan semantics are
        # identical. Bytes are 0 (stand-in payloads carry no KV).
        self._mled = get_mem_ledger()
        self._mled.configure()
        self._mled.register_tier("device", lambda: (
            self.pool.num_blocks - 1 - self.pool.num_free_raw, 0))
        self._mem_source_key = f"mocker:{id(self):x}"
        self._mled.register_live_source(self._mem_source_key,
                                        self._mem_live_ids)

    def _mem_live_ids(self) -> dict:
        """Live owner ids for the mem-ledger leak audit. The mocker pins
        only stream (admitted requests) and session classes; the rest are
        reported empty — nothing in this process should hold them."""
        return live_ids_of(
            streams=(s.req.request_id for s in self.running),
            sessions=(self.sessions.session_ids()
                      if self.sessions is not None else ()),
        )

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        self._mled.unregister_live_source(self._mem_source_key)

    def warmup(self) -> dict:
        """Full-mode mirror of EngineCore.warmup: file a warmup-source
        ledger event for every lattice entry (no real compiles, no sleeps)
        so a freshly started mocker reports coverage 1.0 and the step loop
        never injects simulated compile stalls."""
        led = self._ledger
        if not led.enabled:
            return {"mode": self.args.warmup_mode, "coverage": led.coverage()}
        plan = sorted(led.plan or (),
                      key=lambda s: (s.kind, s.b, s.t, s.nblk, s.greedy))
        compiled = 0
        if self.args.warmup_mode == "full":
            for sig in plan:
                if sig not in led.inventory:
                    led.record(sig,
                               self.args.compile_s / self.args.speedup_ratio,
                               source="warmup")
                    compiled += 1
        return {"mode": self.args.warmup_mode, "buckets": len(plan),
                "compiled": compiled, "coverage": led.coverage()}

    def _mock_compile(self, kind: str, n_rows: int, t_max: int,
                      nblk_need: int, victim=None) -> float:
        """Cold-bucket mirror: derive the signature the engine's dispatch would
        hit (sig_for_rows) and, on first touch, file a serve-source ledger
        event — engine.compile span under the victim's trace and all — and
        return the simulated stall the caller must sleep."""
        led = self._ledger
        if not led.enabled:
            return 0.0
        sig = sig_for_rows(kind, n_rows, t_max, nblk_need, self._lattice_cfg)
        if sig in led.inventory:
            return 0.0
        stall = self.args.compile_s / self.args.speedup_ratio
        led.record(sig, stall, trace_ctx=victim, source="serve")
        return stall

    # ------------------------------------------------------------------
    def _trace_phase(self, seq: _MockSeq, name: str, **attrs) -> None:
        """Close the seq's open phase span (if any) and open the next."""
        if seq.trace_ctx is None:
            return
        tr = get_tracer()
        self._trace_close(seq)
        seq.trace_span = tr.start_span(
            name, ctx=seq.trace_ctx, request_id=seq.req.request_id, **attrs)
        seq.trace_tokens = 0

    def _trace_close(self, seq: _MockSeq, status: str = "ok",
                     **attrs) -> None:
        sp = seq.trace_span
        if sp is None:
            return
        seq.trace_span = None
        if sp.name == "engine.decode" and seq.trace_tokens:
            attrs.setdefault("tokens", seq.trace_tokens)
        get_tracer().end_span(sp, status=status, **attrs)

    def _on_commit(self, block_id: int, seq_hash: int,
                   parent_hash: int | None) -> None:
        """Publish-on-commit mirror (kvbm/offload.py _on_commit →
        flush_pending): every canonical first commit pushes its stand-in
        payload to the shared store, best-effort."""
        if self._importing:
            return  # imported blocks' content just came FROM the store
        self.remote.put(seq_hash, self._payload)
        self.published_blocks += 1
        from dynamo_tpu_torch.kvbm.metrics import get_prefix_cache_metrics

        get_prefix_cache_metrics().published_blocks.inc(1)

    def _import_remote(self, chain: list[int],
                       matched: list[int]) -> list[int]:
        """Admission-time mirror of OffloadManager.onboard: walk the prompt
        chain past the locally matched prefix, committing contiguous remote
        hits as matchable blocks (so ``cached_blocks`` grows and the
        simulated prefill shrinks — the mocker's recompute-avoided tokens).
        Returns the imported block ids, which join the request's matched
        set."""
        if self.remote is None or not chain:
            return []
        from dynamo_tpu_torch.kvbm.metrics import get_prefix_cache_metrics

        t0 = time.perf_counter()
        plan: list[tuple[int, "int | None"]] = []
        parent = chain[len(matched) - 1] if matched else None
        for h in chain[len(matched):]:
            if self.remote.get(h) is None:
                break  # contiguity gap: later blocks are unmatchable
            plan.append((h, parent))
            parent = h
        found = len(plan)
        ids: list[int] = []
        if plan:
            try:
                ids = self.pool.allocate(len(plan))
            except NoFreeBlocks:
                plan = []
        self._importing = True
        try:
            for bid, (h, par) in zip(ids, plan):
                self.pool.commit(bid, h, par)
        finally:
            self._importing = False
        self.imported_blocks += len(ids)
        get_prefix_cache_metrics().record_onboard(
            found_blocks=found, imported_blocks=len(ids),
            block_size=self.args.block_size,
            seconds=time.perf_counter() - t0)
        return ids

    def _token_for(self, rid: str, i: int) -> int:
        digest = hashlib.md5(f"{rid}:{i}".encode()).digest()
        return int.from_bytes(digest[:4], "little") % self.args.vocab_size

    def _queue_depths(self) -> dict[str, int]:
        """Waiting seqs per QoS class — the mocker's stand-in for the real
        scheduler's WdrrQueue.depths()."""
        depths: dict[str, int] = {}
        for s in self.waiting:
            depths[s.priority] = depths.get(s.priority, 0) + 1
        return depths

    async def generate(self, req: PreprocessedRequest) -> AsyncIterator[LLMEngineOutput]:
        self.start()
        if len(req.token_ids) >= self.args.max_model_len:
            yield LLMEngineOutput(finish_reason=FinishReason.ERROR,
                                  error="prompt exceeds max_model_len")
            return
        seq = _MockSeq(req=req, block_seq=TokenBlockSequence.from_tokens(
            req.token_ids, self.args.block_size))
        if seq.trace_ctx is not None:
            seq.trace_span = get_tracer().start_span(
                "engine.queue", ctx=seq.trace_ctx,
                request_id=req.request_id, model=req.model,
                prompt_tokens=len(req.token_ids), priority=seq.priority)
        self.waiting.append(seq)
        self._wake.set()
        try:
            while True:
                out = await seq.queue.get()
                yield out
                if out.finish_reason is not None:
                    return
        finally:
            if not seq.done:
                seq.done = True  # client walked away; loop reaps it

    # ------------------------------------------------------------------
    async def _loop(self) -> None:
        a = self.args
        while True:
            while self.wedged:
                # Test hook: a "stuck engine step loop" — requests queue but
                # never progress, exactly the failure health canaries catch.
                await asyncio.sleep(0.05)
            if not self.waiting and not self.running:
                self._wake.clear()
                await self._wake.wait()
                continue  # re-check wedged before serving the wake-up work
            # Chaos: a delay here is a slow engine step (stragglers); an
            # error kills the step loop — the wedged-engine failure canaries
            # are built to catch.
            await chaos.ainject("mocker.step", running=len(self.running))
            if self.sessions is not None:
                for _sid, entry in self.sessions.pop_expired(time.monotonic()):
                    get_session_metrics().expired.inc()
                    self.pool.release(entry.pinned)
                    entry.pinned = []
            # reap cancelled
            for seq in [s for s in self.running if s.done]:
                self._finish(seq, None)
            # admit — higher priority classes first (stable within a class,
            # mirroring the real scheduler's WDRR front; QoS deadlines are
            # enforced before any simulated prefill is spent)
            self.waiting.sort(key=lambda s: class_rank(s.priority))
            while self.waiting and len(self.running) < a.max_batch_size:
                seq = self.waiting[0]
                if seq.done:  # client walked away before admission
                    self.waiting.pop(0)
                    continue
                if expired(seq.deadline_ts):
                    self.waiting.pop(0)
                    seq.done = True
                    self.deadline_cancelled += 1
                    self._trace_close(seq, status="cancelled")
                    seq.queue.put_nowait(
                        LLMEngineOutput(finish_reason=FinishReason.CANCELLED))
                    continue
                hashes = seq.block_seq.sequence_hashes()
                matchable = max((len(seq.req.token_ids) - 1) // a.block_size, 0)
                claimed = False
                if self.sessions is not None and seq.session_id is not None:
                    # Turn N+1: release the retained pins so the chain is
                    # matchable; the match below re-references it (same
                    # claim-then-match protocol as the engine).
                    sm = get_session_metrics()
                    sm.lookups.inc()
                    if self.sessions.claim(seq.session_id,
                                           time.monotonic()) is not None:
                        claimed = True
                        self.session_hits += 1
                        sm.hits.inc()
                matched = self.pool.match_prefix(hashes[:matchable])
                imported = self._import_remote(hashes[:matchable], matched)
                matched += imported
                if (not claimed and imported and self.sessions is not None
                        and seq.session_id is not None
                        and self.remote is not None
                        and self.remote.get_session(seq.session_id)):
                    # The previous holder drained away and parked this
                    # session in the remote store: the chain just came back
                    # via the import — a warm resume, not a recompute.
                    sm = get_session_metrics()
                    sm.hits.inc()
                    sm.remote_resumes.inc()
                    self.session_hits += 1
                    self.session_remote_resumes += 1
                need = -(-len(seq.req.token_ids) // a.block_size) - len(matched)
                try:
                    fresh = self.pool.allocate(max(need, 0))
                except NoFreeBlocks:
                    self.pool.release(matched)
                    if self._sled.enabled:
                        self._sled.record_block("no_free_blocks")
                    if not self.running:
                        # Nothing running ⇒ no blocks will ever free up: the
                        # request is simply too large for the pool. Fail it
                        # rather than busy-spinning on admission forever.
                        self.waiting.pop(0)
                        seq.done = True
                        self._trace_close(seq, status="error")
                        seq.queue.put_nowait(LLMEngineOutput(
                            finish_reason=FinishReason.ERROR,
                            error="request needs more KV blocks than the pool holds"))
                        continue
                    break
                seq.block_ids = matched + fresh
                seq.cached_blocks = len(matched)
                seq.committed = len(matched)
                if self._mled.enabled:
                    self._mled.pin("stream", seq.req.request_id,
                                   len(seq.block_ids))
                    self._mled.record_alloc(seq.priority, len(fresh))
                self.prefix_lookups += max(len(hashes), 1)
                self.prefix_hits += len(matched)
                if seq.ckpt_offset > 0:
                    # Checkpoint warm resume: the suffix past the imported
                    # chain is the one-interval recompute the protocol
                    # bounds — account it for the chaos invariant.
                    self.stream_ckpt_resumes += 1
                    sm = get_stream_ckpt_metrics()
                    sm.resumes.inc(1)
                    recomputed = max(
                        len(seq.req.token_ids) - len(matched) * a.block_size, 0)
                    self.stream_ckpt_resume_recomputed += recomputed
                    sm.resume_recomputed_tokens.inc(recomputed)
                if (self.sessions is not None and seq.session_id is not None
                        and matched):
                    get_session_metrics().avoided_tokens.inc(
                        len(matched) * a.block_size)
                self.waiting.pop(0)
                self.running.append(seq)
                self._trace_phase(seq, "engine.prefill",
                                  prompt_tokens=len(seq.req.token_ids),
                                  prefix_hit_blocks=len(matched))

            if (self._sled.enabled and self.waiting
                    and len(self.running) >= a.max_batch_size):
                self._sled.record_block("batch_full")
            self.steps += 1
            if self._mled.enabled:
                # Same per-step record point as the engine: waterfall
                # rows, TTX forecast fold, and the periodic leak audit.
                self._mled.observe_device(
                    free=self.pool.num_free_raw,
                    cached=self.pool.num_inactive,
                    total=self.pool.num_blocks - 1)
                self._mled.observe_free(self.pool.num_free, now=time.time())
                self._mled.maybe_audit(time.time())
            prefills = [s for s in self.running if not s.prefilled and not s.done]
            decodes = [s for s in self.running if s.prefilled and not s.done]
            if prefills and a.unified_step:
                # Unified mixed-phase step: the chunk and every decode row
                # advance in ONE simulated launch. The decode rows still pay
                # the chunk's compute alongside their own ITL, but no longer
                # lose a whole serialized iteration — HOL stall is the
                # chunk's MARGINAL share of this step, not its full wall.
                seq = prefills[0]
                new_tokens = len(seq.req.token_ids) - seq.cached_blocks * a.block_size
                n_rows = 1 + len(decodes)
                t_max = max(new_tokens, 1)
                nblk = max(len(s.block_ids) for s in [seq] + decodes)
                # Degenerate mixed batches (every live row one token) ARE
                # the decode program — same rule as dispatch().
                kind = "mixed" if t_max > 1 else "decode"
                stall = self._mock_compile(kind, n_rows, t_max, nblk,
                                           victim=seq.trace_ctx)
                pf_wall = new_tokens * a.prefill_us_per_token / 1e6 / a.speedup_ratio
                dec_wall = (a.decode_itl_ms / 1e3 / a.speedup_ratio
                            if decodes else 0.0)
                # One launch prices at the roofline MAX of the two phases
                # (costmodel.mixed_step_seconds), not the serialized sum the
                # legacy two-launch path below pays.
                wall = stall + max(pf_wall, dec_wall)
                await asyncio.sleep(wall)
                if self._sled.enabled:
                    sig = sig_for_rows(kind, n_rows, t_max, nblk,
                                       self._lattice_cfg)
                    share = (pf_wall / (pf_wall + dec_wall)
                             if pf_wall + dec_wall > 0 else None)
                    self._sled.record_step(
                        wall_s=wall, kinds=(kind,), prefill_rows=1,
                        decode_rows=len(decodes),
                        live_tokens=new_tokens + len(decodes),
                        sched_tokens=sig.b * sig.t,
                        queue_depths=self._queue_depths(),
                        hol=HolStall(
                            culprit=seq.req.request_id,
                            culprit_tokens=new_tokens,
                            victims=[(v.trace_ctx, v.req.request_id,
                                      v.priority) for v in decodes],
                            stall_share=share)
                        if decodes else None)
                seq.prefilled = True
                self._trace_phase(seq, "engine.decode",
                                  batch=len(self.running))
                self._commit(seq, len(seq.req.token_ids))
                self._emit_token(seq)
                for dseq in decodes:
                    if dseq.done:
                        continue
                    total = len(dseq.req.token_ids) + dseq.generated + 1
                    need = -(-total // a.block_size)
                    grow = need - len(dseq.block_ids)
                    if grow > 0:
                        try:
                            dseq.block_ids.extend(self.pool.allocate(grow))
                        except NoFreeBlocks:
                            continue  # starved this step; retried next step
                        if self._mled.enabled:
                            self._mled.pin("stream", dseq.req.request_id,
                                           grow)
                            self._mled.record_alloc(dseq.priority, grow)
                    self._emit_token(dseq)
                    self._commit(dseq, total - 1)
                continue
            if prefills:
                seq = prefills[0]
                new_tokens = len(seq.req.token_ids) - seq.cached_blocks * a.block_size
                stall = self._mock_compile(
                    "prefill", 1, new_tokens, len(seq.block_ids),
                    victim=seq.trace_ctx)
                wall = (stall + new_tokens * a.prefill_us_per_token
                        / 1e6 / a.speedup_ratio)
                await asyncio.sleep(wall)
                if self._sled.enabled:
                    # The mocker serializes prefill ahead of decode, so
                    # every prefilled running stream literally waited this
                    # whole iteration — the cleanest HOL victim set.
                    victims = [s for s in self.running
                               if s.prefilled and not s.done and s is not seq]
                    sig = sig_for_rows("prefill", 1, max(new_tokens, 1),
                                       len(seq.block_ids), self._lattice_cfg)
                    self._sled.record_step(
                        wall_s=wall, kinds=("prefill",), prefill_rows=1,
                        live_tokens=new_tokens, sched_tokens=sig.b * sig.t,
                        queue_depths=self._queue_depths(),
                        hol=HolStall(
                            culprit=seq.req.request_id,
                            culprit_tokens=new_tokens,
                            victims=[(v.trace_ctx, v.req.request_id,
                                      v.priority) for v in victims])
                        if victims else None)
                seq.prefilled = True
                self._trace_phase(seq, "engine.decode",
                                  batch=len(self.running))
                self._commit(seq, len(seq.req.token_ids))
                self._emit_token(seq)
                continue

            if decodes:
                stall = self._mock_compile(
                    "decode", len(decodes), 1,
                    max(len(s.block_ids) for s in decodes),
                    victim=next((s.trace_ctx for s in decodes
                                 if s.trace_ctx is not None), None))
                wall = stall + a.decode_itl_ms / 1e3 / a.speedup_ratio
                await asyncio.sleep(wall)
                if self._sled.enabled:
                    sig = sig_for_rows(
                        "decode", len(decodes), 1,
                        max(len(s.block_ids) for s in decodes),
                        self._lattice_cfg)
                    self._sled.record_step(
                        wall_s=wall, kinds=("decode",),
                        decode_rows=len(decodes),
                        live_tokens=len(decodes), sched_tokens=sig.b,
                        queue_depths=self._queue_depths())
                for seq in decodes:
                    # grow blocks as generated tokens fill them
                    total = len(seq.req.token_ids) + seq.generated + 1
                    need = -(-total // a.block_size)
                    grow = need - len(seq.block_ids)
                    if grow > 0:
                        try:
                            seq.block_ids.extend(self.pool.allocate(grow))
                        except NoFreeBlocks:
                            continue  # starved this step; retried next step
                        if self._mled.enabled:
                            self._mled.pin("stream", seq.req.request_id,
                                           grow)
                            self._mled.record_alloc(seq.priority, grow)
                    self._emit_token(seq)
                    self._commit(seq, total - 1)
                continue
            # Neither prefills nor decodes ran: waiting requests are blocked
            # on KV blocks held by running-but-stalled sequences. Yield a real
            # tick so the loop doesn't spin hot.
            await asyncio.sleep(a.decode_itl_ms / 1e3 / a.speedup_ratio)

    def _emit_token(self, seq: _MockSeq) -> None:
        if expired(seq.deadline_ts):
            # Mid-decode deadline: stop the stream where it stands.
            self.deadline_cancelled += 1
            seq.queue.put_nowait(
                LLMEngineOutput(finish_reason=FinishReason.CANCELLED))
            self._finish(seq, FinishReason.CANCELLED)
            return
        tok = self._token_for(seq.req.request_id,
                              seq.ckpt_offset + seq.generated)
        seq.generated += 1
        seq.out_tokens.append(tok)
        seq.trace_tokens += 1
        if (seq.trace_span is not None and seq.trace_tokens >= self._trace_stride
                and seq.trace_span.name == "engine.decode"):
            # One span per N decode tokens, mirroring the real engine.
            self._trace_phase(seq, "engine.decode")
        seq.block_seq.append(tok)
        sc = seq.req.stop_conditions
        finish = None
        if sc.max_tokens is not None and seq.generated >= sc.max_tokens:
            finish = FinishReason.LENGTH
        elif len(seq.req.token_ids) + seq.generated >= self.args.max_model_len:
            finish = FinishReason.LENGTH
        out = LLMEngineOutput(token_ids=[tok], finish_reason=finish)
        seq.queue.put_nowait(out)
        if finish is not None:
            self._finish(seq, finish)

    def _commit(self, seq: _MockSeq, computed_tokens: int) -> None:
        hashes = seq.block_seq.sequence_hashes()
        n_full = computed_tokens // self.args.block_size
        while seq.committed < n_full and seq.committed < len(seq.block_ids):
            i = seq.committed
            self.pool.commit(seq.block_ids[i], hashes[i], hashes[i - 1] if i else None)
            seq.committed += 1
        self._maybe_stream_ckpt(seq, hashes)

    def _ckpt_interval(self, seq: _MockSeq) -> int:
        """QoS-degraded cadence, mirroring EngineCore._ckpt_interval:
        interactive checkpoints at the base interval, standard at 2x,
        batch at 4x."""
        base = self.args.stream_ckpt_blocks
        if base <= 0 or self.remote is None:
            return 0
        if seq.priority == "interactive":
            return base
        if seq.priority == "batch":
            return base * 4
        return base * 2

    def _maybe_stream_ckpt(self, seq: _MockSeq, hashes: list[int]) -> None:
        """Mirror of EngineCore._maybe_stream_ckpt, device-free: push the
        newly committed blocks (stand-in payloads, real hash keys) and the
        resumable record to the shared store. First checkpoint fires at
        prefill completion (``ckpt_blocks == -1``), then every interval."""
        k = self._ckpt_interval(seq)
        if k <= 0 or seq.committed <= 0:
            return
        if 0 <= seq.ckpt_blocks and seq.committed - seq.ckpt_blocks < k:
            return
        start = max(seq.ckpt_blocks, 0)
        for h in hashes[start:seq.committed]:
            self.remote.put(h, self._payload)
        rec = build_ckpt_record(
            seq.req.request_id, list(seq.out_tokens),
            list(hashes[:seq.committed]),
            draws=seq.ckpt_offset + seq.generated,
            prompt_tokens=len(seq.req.token_ids))
        if self.remote.put_stream_ckpt(seq.req.request_id, rec):
            self.stream_ckpt_writes += 1
            sm = get_stream_ckpt_metrics()
            sm.writes.inc(1)
            sm.bytes.inc((seq.committed - start) * self._payload.nbytes)
        seq.ckpt_blocks = seq.committed

    def _finish(self, seq: _MockSeq, reason) -> None:
        seq.done = True
        if self.remote is not None and seq.ckpt_blocks >= 0:
            # Clean finish (any reason, incl. client walk-away): the stream
            # no longer needs crash recovery — reap its checkpoint record
            # so the store holds records for IN-FLIGHT streams only.
            self.remote.del_stream_ckpt(seq.req.request_id)
        status = "ok"
        if reason is None or reason is FinishReason.CANCELLED:
            status = "cancelled"
        elif reason is FinishReason.ERROR:
            status = "error"
        self._trace_close(seq, status=status,
                          output_tokens=seq.generated,
                          finish_reason=str(reason) if reason else "")
        if seq in self.running:
            self.running.remove(seq)
        if (self.sessions is not None and seq.session_id is not None
                and reason is FinishReason.LENGTH and seq.committed):
            # Retain before the release below, mirroring the engine:
            # pins take their refs while the chain is still active.
            hashes = seq.block_seq.sequence_hashes()[: seq.committed]
            self.sessions.retain(seq.session_id, hashes, time.monotonic())
        if seq.block_ids:
            if self._mled.enabled:
                self._mled.unpin("stream", seq.req.request_id)
                self._mled.record_release(seq.priority, len(seq.block_ids))
            self.pool.release(seq.block_ids)
            seq.block_ids = []

    # ------------------------------------------------------------------
    def abort_class(self, priority: str | None = None) -> int:
        """Early-stop every stream (waiting + running) of one QoS class
        (``None`` = all classes) — the drain run-down's QoS valve
        (runtime/drain.py: batch-class work yields the drain window to
        interactive streams). Each stream gets a terminal CANCELLED, so
        nothing is lost — just cut short."""
        n = 0
        for seq in [s for s in self.waiting if not s.done
                    and (priority is None or s.priority == priority)]:
            self.waiting.remove(seq)
            seq.done = True
            self._trace_close(seq, status="cancelled")
            seq.queue.put_nowait(
                LLMEngineOutput(finish_reason=FinishReason.CANCELLED))
            n += 1
        for seq in [s for s in self.running if not s.done
                    and (priority is None or s.priority == priority)]:
            seq.queue.put_nowait(
                LLMEngineOutput(finish_reason=FinishReason.CANCELLED))
            self._finish(seq, FinishReason.CANCELLED)
            n += 1
        if n:
            log.info("early-stopped %d %s stream(s)", n, priority or "ALL")
        return n

    def evacuate_sessions(self) -> dict:
        """Drain step 4 (runtime/drain.py): push every retained session's
        committed chain — blocks AND the resumable record — to the shared
        remote store, then release the pins. The mocker's stand-in payloads
        carry real hash-keyed accounting, so a surviving mocker's
        admission-time import finds the evacuated chain exactly like a real
        engine would."""
        out = {"sessions": 0, "blocks": 0, "bytes": 0}
        if self.sessions is None:
            return out
        while True:
            popped = self.sessions.pop_oldest()
            if popped is None:
                break
            sid, entry = popped
            if self.remote is not None and entry.seq_hashes:
                for h in entry.seq_hashes:
                    self.remote.put(h, self._payload)
                    out["blocks"] += 1
                    out["bytes"] += self._payload.nbytes
                if self.remote.put_session(sid, list(entry.seq_hashes),
                                           entry.tokens):
                    out["sessions"] += 1
            self.pool.release(entry.pinned)
            entry.pinned = []
        return out

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """ForwardPassMetrics-shaped stats (reference: publisher.rs:686)."""
        return {
            "num_waiting": len(self.waiting),
            "num_running": len(self.running),
            "kv_usage": self.pool.usage,
            "kv_total_blocks": self.pool.num_blocks,
            "prefix_hit_rate": self.prefix_hits / max(self.prefix_lookups, 1),
            "num_steps": self.steps,
            "deadline_cancelled": self.deadline_cancelled,
            "prefix_cache_imported_blocks": self.imported_blocks,
            "prefix_cache_published_blocks": self.published_blocks,
            **({"stream_ckpt_writes": self.stream_ckpt_writes,
                "stream_ckpt_resumes": self.stream_ckpt_resumes,
                "stream_ckpt_resume_recomputed":
                    self.stream_ckpt_resume_recomputed}
               if self.args.stream_ckpt_blocks > 0 else {}),
            **({"session": self.sessions.snapshot(),
                "session_hits": self.session_hits,
                "session_remote_resumes": self.session_remote_resumes}
               if self.sessions is not None else {}),
            **({"compile": self._ledger.snapshot()}
               if self._ledger.enabled else {}),
            **({"sched": self._sled.snapshot()}
               if self._sled.enabled else {}),
            **({"mem": self._mled.snapshot()}
               if self._mled.enabled else {}),
        }

    async def clear_kv(self) -> None:
        if self.sessions is not None:
            self.sessions.release_all()
        self.pool.clear()
