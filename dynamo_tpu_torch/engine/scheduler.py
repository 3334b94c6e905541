"""Continuous-batching scheduler — copy of ``dynamo_tpu/engine/scheduler.py``.

Requests move WAITING → (chunked prefill) → RUNNING (decode) → FINISHED,
with block allocation against the PrefixPool, recompute-style preemption
under block pressure, and prefix-cache reuse.

One step = decode rows AND at most a token-budgeted set of prefill chunks
(decode first): decode streams advance every step, so a long prompt's
prefill can stall ITL by at most one chunk's compute. By default the
engine runs the whole plan as ONE ragged mixed-phase step;
``unified_step=False`` restores the legacy two-launch path. Fused decode
windows (``decode_window > 1``) are decode-only and keep it: each decode
row grows its blocks ``w`` tokens ahead and the engine runs ``w`` decode
steps in one program. With speculative decoding (``spec_lookahead > 0``)
each verify-eligible decode row grows ``1 + spec_lookahead`` tokens ahead,
and a row whose verify step is in flight is not planned again until the
engine has accepted or rolled it back.

Chunk size is cost-model-driven when the engine's ``prefill_chunk == 0``:
the engine resolves a per-QoS-class cap (costmodel.auto_prefill_chunk —
the largest chunk whose predicted mixed-step time keeps decode ITL inside
the SLO ladder) and passes it here as ``chunk_by_qos``; plan() caps each
seq's chunk by its own class. The scheduling ledger (admission-block
causes, preemption recompute) and the memory ledger (stream pins, per-QoS
block consumption) are fed from here, each hook gated on its ledger's
``enabled``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from dynamo_tpu_torch.engine.errors import NoFreeBlocks
from dynamo_tpu_torch.engine.prefix_pool import PrefixPool
from dynamo_tpu_torch.engine.session import session_id_of
from dynamo_tpu_torch.engine.spec import spec_eligible
from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
from dynamo_tpu_torch.obs.sched_ledger import get_sched_ledger
from dynamo_tpu_torch.protocols.common import FinishReason, PreprocessedRequest
from dynamo_tpu_torch.qos.deadline import deadline_of, expired, priority_of
from dynamo_tpu_torch.qos.wdrr import WdrrQueue
from dynamo_tpu_torch.tokens import TokenBlockSequence


class Phase(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"   # prompt partially/fully computed; decoding when fully
    FINISHED = "finished"


@dataclass
class Seq:
    req: PreprocessedRequest
    block_size: int
    tokens: list[int] = field(default_factory=list)   # prompt + generated
    prompt_len: int = 0
    num_computed: int = 0          # tokens whose KV is resident
    block_ids: list[int] = field(default_factory=list)
    committed_blocks: int = 0      # prefix of block_ids committed to the pool
    phase: Phase = Phase.WAITING
    finish_reason: FinishReason | None = None
    slot: int = -1                 # persistent sampling-state slot
    slot_initialized: bool = False  # sampling state (seed, counts) reset done
    block_seq: TokenBlockSequence = field(init=False)
    prefix_hit_blocks: int = 0     # engine-local prefix cache hits (stats)
    # Count of dispatched-but-unmaterialized sampled steps whose token for
    # this seq lives only on device (pipelined step loop). While > 0, the
    # next decode input reads slot_toks instead of seq.tokens — a bool is
    # not enough: with step N in flight, step N-1's finalize must not make
    # step N+1's dispatch read the (not yet appended) host token.
    inflight_samples: int = 0
    # A speculative verify step is in flight: the scheduler must not plan
    # this seq again until finalize accepts/rolls back (engine/spec.py).
    verify_inflight: bool = False
    # Structured output: a TokenMasker (engine/guided.py) constraining each
    # sampled token to the request's JSON grammar. Guided seqs decode
    # unpipelined in their own masked rows.
    guided: object | None = None
    # Multimodal embedding spans [(pos, np.ndarray[K, H])]: encoder outputs
    # injected at prompt positions during prefill (engine dispatch). Spans
    # are retained for the seq's whole life — preemption recomputes the
    # prefill from position 0 and needs them again. mm_end (max span end)
    # lets decode dispatches skip the span scan with one comparison.
    mm_spans: list = field(default_factory=list)
    mm_end: int = 0
    # QoS: priority class feeds the WDRR waiting queue; deadline_ts is an
    # absolute wall-clock deadline after which the seq is cancelled.
    qos_priority: str = "standard"
    deadline_ts: float | None = None
    # Session-sticky KV retention (engine/session.py): the session.id
    # annotation, and whether this seq's avoided-prefill tokens have been
    # counted (once, on its first planned chunk — preemption must not
    # double-count the re-admission match).
    session_id: str | None = None
    session_counted: bool = False
    # Crash-consistent stream checkpoints (kvbm/stream_ckpt.py): committed
    # blocks covered by the last enqueued checkpoint (-1 = none yet; the
    # first fires at prefill completion), and whether this seq's
    # warm-resume metrics were counted (once, on its first planned chunk).
    ckpt_blocks: int = -1
    ckpt_counted: bool = False
    # Tracing (obs/tracer.py): the wire TraceContext parsed off the
    # request annotations, the one currently-open phase span
    # (engine.queue → engine.prefill → engine.decode), and the token
    # count inside the open decode-window span. The engine owns all
    # transitions; the scheduler never touches these.
    trace_ctx: object | None = None
    trace_span: object | None = None
    trace_tokens: int = 0

    def __post_init__(self) -> None:
        self.tokens = list(self.req.token_ids)
        self.prompt_len = len(self.tokens)
        self.block_seq = TokenBlockSequence.from_tokens(self.tokens, self.block_size)
        ann = getattr(self.req, "annotations", None)
        self.qos_priority = priority_of(ann, self.qos_priority)
        self.deadline_ts = deadline_of(ann)
        self.session_id = session_id_of(ann)

    @property
    def request_id(self) -> str:
        return self.req.request_id

    @property
    def num_output_tokens(self) -> int:
        return len(self.tokens) - self.prompt_len

    def prefill_target(self) -> int:
        """Tokens that must be (re)computed before decode can proceed.

        Fresh request: the whole prompt (then sample the first token).
        Preempt-resumed request: everything except the final already-sampled
        token — that token is the next decode input; re-sampling mid-stream
        positions would duplicate output the client already saw.
        """
        return max(self.prompt_len, len(self.tokens) - 1)

    @property
    def in_decode(self) -> bool:
        return self.phase is Phase.RUNNING and self.num_computed >= self.prefill_target()

    def blocks_needed(self, upto_tokens: int) -> int:
        return -(-upto_tokens // self.block_size)  # ceil div


@dataclass
class PrefillWork:
    seq: Seq
    start: int    # first token index of this chunk (== seq.num_computed)
    length: int   # chunk length


@dataclass
class StepPlan:
    prefill: list[PrefillWork] = field(default_factory=list)
    decode: list[Seq] = field(default_factory=list)
    # Fused decode steps for the decode rows this plan; every decode seq
    # has blocks allocated for `decode_window` more tokens.
    decode_window: int = 1

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode


class Scheduler:
    def __init__(
        self,
        pool: PrefixPool,
        max_batch_size: int,
        prefill_chunk: int,
        max_model_len: int,
        max_tokens_per_step: int = 8192,
        qos_weights: dict[str, int] | None = None,
        decode_window: int = 1,
        spec_lookahead: int = 0,
        chunk_by_qos: dict[str, int] | None = None,
    ):
        self.pool = pool
        self.max_batch_size = max_batch_size
        self.prefill_chunk = prefill_chunk
        # Per-QoS chunk caps (SLO-driven auto mode): each seq's prefill
        # chunk is additionally capped by its own class. None/empty =
        # uniform prefill_chunk for everyone.
        self.chunk_by_qos = dict(chunk_by_qos) if chunk_by_qos else {}
        self.max_model_len = max_model_len
        self.max_tokens_per_step = max_tokens_per_step
        self.decode_window = max(decode_window, 1)
        # Speculative verify chunks write KV for up to spec_k proposed
        # positions ahead — block growth must cover them (engine/spec.py).
        self.spec_lookahead = spec_lookahead
        # Weighted deficit-round-robin over priority classes instead of a
        # plain FIFO: interactive traffic admits ahead of batch without
        # starving it (preempted seqs resume ahead of all lanes via
        # appendleft).
        self.waiting: WdrrQueue = WdrrQueue(
            key_fn=lambda s: s.qos_priority, weights=qos_weights)
        self.running: list[Seq] = []
        self._slot_free: list[int] = list(range(max_batch_size - 1, -1, -1))
        self.preemption_count = 0
        # Scheduling ledger (obs/sched_ledger.py): admission-block causes
        # and preemption recompute accounting. Every hook is gated on
        # .enabled so DYN_SCHED_LEDGER=0 adds no work to the plan path.
        self._sled = get_sched_ledger()
        # Memory ledger (obs/mem_ledger.py): stream-owned pin taxonomy and
        # per-QoS block consumption rates (TTX forecast), gated the same
        # way by DYN_MEM_LEDGER=0.
        self._mled = get_mem_ledger()

    # ------------------------------------------------------------------
    def add(self, seq: Seq) -> None:
        if seq.prompt_len >= self.max_model_len:
            seq.phase = Phase.FINISHED
            seq.finish_reason = FinishReason.ERROR
            return
        # A prompt that can't fit even into an *empty* pool would wait
        # forever — reject it up front (+1: decode needs room to grow).
        if seq.blocks_needed(seq.prompt_len + 1) > self.pool.num_blocks - 1:
            seq.phase = Phase.FINISHED
            seq.finish_reason = FinishReason.ERROR
            return
        self.waiting.append(seq)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    # ------------------------------------------------------------------
    def _try_admit(self, seq: Seq) -> bool:
        """Admit a waiting seq: match cached prefix, allocate prompt blocks,
        claim a sampling slot. Returns False under resource pressure."""
        if not self._slot_free:
            if self._sled.enabled:
                self._sled.record_block("batch_full")
            return False
        # Match at most prefill_target-1 tokens so at least one token is
        # computed (we need last-position state before decode can continue).
        matchable = (seq.prefill_target() - 1) // seq.block_size
        matched = self.pool.match_prefix(seq.block_seq.sequence_hashes()[:matchable])
        need = seq.blocks_needed(len(seq.tokens)) - len(matched)
        # Watermark: keep one free/evictable block per running seq so the
        # decode-growth loop doesn't immediately hit pressure and preempt the
        # seq we just admitted (admit→evict→re-admit thrash).
        if need + len(self.running) > self.pool.num_free:
            self.pool.release(matched)
            if self._sled.enabled:
                self._sled.record_block("no_free_blocks")
            return False
        try:
            fresh = self.pool.allocate(need)
        except NoFreeBlocks:
            self.pool.release(matched)
            if self._sled.enabled:
                self._sled.record_block("no_free_blocks")
            return False
        seq.block_ids = matched + fresh
        seq.committed_blocks = len(matched)
        seq.num_computed = len(matched) * seq.block_size
        seq.prefix_hit_blocks = len(matched)
        if self._mled.enabled:
            self._mled.pin("stream", seq.request_id, len(seq.block_ids))
            self._mled.record_alloc(seq.qos_priority, len(fresh))
        seq.slot = self._slot_free.pop()
        seq.slot_initialized = False
        seq.phase = Phase.RUNNING
        self.running.append(seq)
        return True

    def _grow_for_decode(self, seq: Seq, tokens_ahead: int = 1) -> bool:
        """Ensure block capacity for `tokens_ahead` more tokens; False if
        allocation failed."""
        need = seq.blocks_needed(seq.num_computed + tokens_ahead)
        if need > len(seq.block_ids):
            grow = need - len(seq.block_ids)
            try:
                seq.block_ids.extend(self.pool.allocate(grow))
            except NoFreeBlocks:
                return False
            if self._mled.enabled:
                self._mled.pin("stream", seq.request_id, grow)
                self._mled.record_alloc(seq.qos_priority, grow)
        return True

    def preempt(self, seq: Seq, cause: str = "blocks") -> None:
        """Recompute-style preemption: release blocks, requeue at the front."""
        if self._sled.enabled:
            # Every resident-KV token released here must be recomputed
            # through prefill from position 0 on re-admission.
            self._sled.record_preempt(seq.num_computed, cause)
        if self._mled.enabled:
            self._mled.unpin("stream", seq.request_id)
            self._mled.record_release(seq.qos_priority, len(seq.block_ids))
        self.pool.release(seq.block_ids)
        seq.block_ids = []
        seq.committed_blocks = 0
        seq.num_computed = 0
        seq.phase = Phase.WAITING
        if seq.slot >= 0:
            self._slot_free.append(seq.slot)
            seq.slot = -1
        self.running.remove(seq)
        self.waiting.appendleft(seq)
        self.preemption_count += 1

    def finish(self, seq: Seq, reason: FinishReason) -> None:
        seq.phase = Phase.FINISHED
        seq.finish_reason = reason
        if seq in self.running:
            self.running.remove(seq)
        elif seq in self.waiting:
            self.waiting.remove(seq)
        if self._mled.enabled and seq.block_ids:
            self._mled.unpin("stream", seq.request_id)
            self._mled.record_release(seq.qos_priority, len(seq.block_ids))
        self.pool.release(seq.block_ids)
        seq.block_ids = []
        if seq.slot >= 0:
            self._slot_free.append(seq.slot)
            seq.slot = -1

    def expire_waiting(self, now: float | None = None) -> list[Seq]:
        """Cancel waiting seqs whose deadline has passed — before any
        prefill compute is spent on them."""
        stale = [s for s in self.waiting if expired(s.deadline_ts, now)]
        for seq in stale:
            self.finish(seq, FinishReason.CANCELLED)
        return stale

    # ------------------------------------------------------------------
    def plan(self) -> StepPlan:
        plan = StepPlan()
        # Admit as many waiting seqs as resources allow.
        while self.waiting and len(self.running) < self.max_batch_size:
            if not self._try_admit(self.waiting[0]):
                if self._sled.enabled and sum(
                        1 for d in self.waiting.depths().values() if d) > 1:
                    # The blocked head also gates every other non-empty
                    # WDRR lane behind its lane commitment — seqs that
                    # might have admitted had the round-robin pointer sat
                    # elsewhere.
                    self._sled.record_block("wdrr_gate")
                break
            self.waiting.popleft()
        if (self._sled.enabled and self.waiting
                and len(self.running) >= self.max_batch_size):
            self._sled.record_block("batch_full")

        # Decode batch first (every decodable stream advances every step);
        # grow blocks, preempting from the back on pressure.
        # Window: fuse up to decode_window steps into one dispatch. Shrink to
        # (a) fit every seq under max_model_len (the block table must cover
        # every fused position) and (b) the useful horizon — past the point
        # every stream will have hit max_tokens, fused steps are pure waste
        # (their tokens are discarded at finalize).
        cands = [s for s in self.running
                 if s.in_decode and s.num_computed < self.max_model_len]
        w = self.decode_window
        if w > 1 and cands:
            cap = min(self.max_model_len - s.num_computed for s in cands)
            useful = 1
            for s in cands:
                mt = s.req.stop_conditions.max_tokens
                # decode positions already computed (incl. in-flight windows)
                out_est = max(s.num_computed - s.prefill_target(), 0)
                useful = max(useful, (mt - out_est) if mt is not None else cap)
            w = max(1, min(w, cap, useful))
            w = 1 << (w.bit_length() - 1)  # pow2 bucket bounds the program count
        decodable: list[Seq] = []
        for seq in list(self.running):
            if not seq.in_decode:
                continue
            if seq.verify_inflight:
                # A dispatched-but-unfinalized verify step owns this seq's
                # next positions; replanning it before the accept/rollback
                # lands would read garbage state.
                continue
            if self.spec_lookahead and spec_eligible(seq):
                # Only verify-eligible seqs reserve lookahead blocks —
                # sampled/penalized seqs never speculate, and over-reserving
                # for them would trigger preemptions for capacity nobody uses.
                grow_ahead = max(w, 1 + self.spec_lookahead)
            else:
                grow_ahead = w
            if seq.num_computed >= self.max_model_len:
                # At capacity: the finalize of an in-flight step will finish
                # this seq (pipelined stepping plans ahead of stop checks);
                # decoding past max_model_len would outgrow the block table.
                continue
            while not self._grow_for_decode(seq, grow_ahead):
                # preempt the most recently admitted other seq
                victims = [s for s in reversed(self.running) if s is not seq]
                if not victims:
                    break
                victim = victims[0]
                self.preempt(victim, cause=(
                    "qos" if victim.qos_priority != seq.qos_priority
                    else "blocks"))
                if victim in decodable:
                    decodable.remove(victim)
            else:
                decodable.append(seq)
                continue
            # could not grow even after preemption: preempt seq itself
            self.preempt(seq)
        plan.decode = decodable[: self.max_batch_size]
        plan.decode_window = w if plan.decode else 1

        # Prefill chunks for seqs short of their target, within what's left
        # of the step token budget after the decode rows (a fused window
        # computes window tokens per row).
        budget = self.max_tokens_per_step - len(plan.decode) * plan.decode_window
        for seq in self.running:
            target = seq.prefill_target()
            if seq.num_computed < target and budget > 0:
                cap = self.chunk_by_qos.get(seq.qos_priority, self.prefill_chunk)
                chunk = min(target - seq.num_computed, cap, budget)
                plan.prefill.append(PrefillWork(seq=seq, start=seq.num_computed, length=chunk))
                budget -= chunk
        return plan

    # ------------------------------------------------------------------
    def commit_computed_blocks(self, seq: Seq) -> None:
        """Commit every fully-computed block.

        Bounded by len(tokens) as well as num_computed: under pipelined
        stepping num_computed runs ahead of the appended tokens, and a block
        can only be committed once every token value in it is known (the
        hash chain needs the values)."""
        n_full = min(seq.num_computed, len(seq.tokens)) // seq.block_size
        hashes = seq.block_seq.sequence_hashes()
        while seq.committed_blocks < n_full:
            i = seq.committed_blocks
            parent = hashes[i - 1] if i > 0 else None
            self.pool.commit(seq.block_ids[i], hashes[i], parent)
            seq.committed_blocks += 1
