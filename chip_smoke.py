"""Chip smoke for the PyTorch/CUDA port (``dynamo_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``dynamo_tpu_torch/csrc`` (one
``nvcc`` per source, all started together: one source,
``csrc/paged_attention_mma.cu``), then runs, in order, and exits non-zero
if any phase fails:

(a) each kernel of ``ops.paged_attention.ROUTES`` against its plain
    PyTorch version on the card: every cache (bf16 or f32 for the
    model-precision cache, int8, packed int4) with bf16 queries
    (``mma_bf16``, ``mma_int8``, ``mma_int4``) and with f32 queries
    (``mma_f32`` over the f32 cache, ``mma_int8_f32q``, ``mma_int4_f32q``),
    all instantiations of the one tensor-core design, at the main path's
    shapes (llama-3-8b-lite attention: KH=8,
    H=32, D=128, block 16: decode, a 128-token prefill, ragged chunks, an
    8-token chunk whose 32 query rows make 2 row groups a CTA, split-K), at
    the long-context decode geometry of ``bench.py`` (B=16, kv 8192), at
    the two other head widths of the presets (D=16, KH=2, H=4:
    tiny-real-llama; D=64, KH=8, H=64: the D=64 presets) and at the widest
    head the kernel takes (D=256, KH=1, H=2, B=4: its largest shared-memory
    layout), and at the speculative verify shapes (B=32, T=2, 4 and 5
    query tokens a row from q_start 128-187, mid-block: at T=5 the second
    of a CTA's 2 row groups holds 4 live rows), and at the prefill shapes
    of (f)'s SLO-sized chunks (one 2048-token chunk of a fresh prompt, and
    a unified step of 64 rows: 32 decode rows at kv 128-192, one 512-token
    chunk, 31 empty rows; and (f)'s own [64, 2048] step: the same 32
    decode rows, 4 chunks of 1,536 from position 0, 28 empty rows, its
    plain version computed 4 rows at a time and its plain and SDPA times
    over 3 calls). q is drawn in f32; the f32 cache holds full-precision f32
    draws of K and V, the bf16 cache the same draws rounded to bf16. bf16-q
    routes are held to one bf16 rounding, f32-q routes to the f32 limit
    (with TF32 off for the plain version's f32 products). Each case checks
    it ran the kernel its route names; with kernel / plain / library
    (``scaled_dot_product_attention`` on the pre-gathered, dequantized
    context in q's dtype, a yardstick the port never calls) times and the
    least time the card could take for the same work. The quantized
    content is made on the card by the port's own ``_scatter_kv`` from the
    bf16 values, and must equal, byte for byte and scale for scale, the
    same scatter on the CPU; the quantized scatter of a prefill step is
    timed per cache dtype;
(b) the port's serving path at full llama-3-8b-lite width (8 layers,
    random weights from a seed) through ``build_engine`` and
    ``AsyncTorchEngine.generate``: 32 requests, prompt 128, 64 greedy
    output tokens, once for each KV cache dtype (bfloat16, int8, int4).
    ``build_engine`` first captures the CUDA graph of every bucket of the
    enumerated lattice (``warmup_mode="full"``): no capture may fail,
    coverage must be 1.0, and serving must make no new graph — every step
    is a replay. The kernel launch counts (counted through replays) are set
    to 0 just before each run and read just after, and each run must launch
    its own variant only, 8 per forward step, through its route's kernel;
(b') the same bf16 serving run with fused decode windows
    (``decode_window=4``, one graph of 4 decode steps): its greedy streams
    must equal (b)'s bf16 streams token for token, each window's graph must
    hold 8 x 4 launches, and the launches must be 8 per forward step. Its
    one serve-time capture is the legacy prefill step of all 32 rows, whose
    batch size lies past the legacy prefill ladder (1, 2, 4, 8) that the
    lattice enumerates, as the JAX package's does;
(b'') the serving path in f32: llama-3-8b-lite with f32 weights (random,
    from a seed) and the f32 model-precision KV cache, 32 requests, prompt
    128, 32 greedy output tokens, after a full warmup as in (b), through
    ``mma_f32`` only, 8 launches per forward step counted through replays;
    then, in every layer, ``mma_f32`` over the f32 cache as the run left it
    (the model's own f32 K and V, checked not to be bf16 values), with the
    tables of the run's last decode step, must keep the f32 limit against
    the plain version; prints decode tok/s beside the card's name and power
    limit;
(c) coherence: the trained checkpoint ``tests/data/tiny-real-llama``
    through the port's loader and tokenizer must continue "one two three
    four" with " five six seven eight" on the card, with a bf16 and with an
    int8 cache (the int4 continuation is printed); its f32 greedy tokens on
    the card must equal the plain path's on the CPU for every cache dtype,
    and each of those f32 runs must go through its route's kernel only;
    no step dispatch may wait for the card (the host/device overlap of the
    pipelined step loop), at every kv dtype. These engines capture each
    bucket's graph lazily, at its first step;
(d1) speculative verify at full width in f32 (llama-3-8b-lite with f32
    weights over the f32 cache): 32 greedy requests whose 128-token
    prompts repeat a 16-token pattern 8 times, 32 output tokens, through
    the pipelined ``AsyncTorchEngine`` with ``spec_ngram=2, spec_k=4`` and
    again with spec off, each after a full warmup. The verify graphs must
    come from the warmup (serving makes no graph), proposals and verify
    steps must run, ``mma_f32`` only, 8 launches per forward step counted
    through replays. Each spec stream must equal its spec-off twin, or
    first leave it at a near-tie (the two runs' log-probs of their chosen
    tokens within 1e-4; the count is printed). Prints acceptance and
    decode tok/s beside the card's name and power limit;
(d2) the same over the bf16 cache with bf16 weights: ``mma_bf16`` only,
    8 a forward step; prints tok/s and acceptance beside (b)'s bf16 tok/s,
    and the share of spec streams equal to the spec-off ones (bf16
    rounding may flip a near-tie, so the share is no pass condition);
(d3) guided decoding at full width over the bf16 cache: 8 json_object
    and 4 json_schema requests (required keys, an enum) beside 8 plain
    greedy ones in one unified engine, 48 tokens each: a guided output
    that stopped must be a document that conforms to its schema, one cut
    by its length a grammatical prefix; the masked programs must have
    replayed their graphs; prints the host ms a step spent building masks;
(d4) the multimodal embedding override at full width: four 128-token
    prompts with a 64-position span at pos 16 beside the same prompts
    without spans; spans of the embedding table's own rows (widened to
    f32) must give the plain streams exactly, spans of random rows must
    change them, through a replayed mm graph;
(d5) embeddings at full width: 8 prompts of 7-128 tokens in one
    ``AsyncTorchEngine.embed`` call, 8 ``mma_bf16`` launches for the call,
    the serving pool's blocks as they were; the same weights widened to
    f32 over an f32 cache, batched (8 ``mma_f32`` launches) and alone, must
    agree row by row within 1e-4*|ref| + 1e-4; the bf16 rows' distance
    from their single calls is printed (a bf16 forward is not batch
    invariant). (d3)-(d5) capture graphs lazily;
(e1) the OpenAI HTTP frontend (the port's ``HttpService`` over its stdlib
    HTTP/1.1 server on 127.0.0.1, driven by an asyncio-streams client) in
    f32: llama-3-8b-lite with f32 weights over the f32 cache, 32 concurrent
    streaming /v1/completions with 128-token id prompts, 32 greedy tokens,
    logprobs 0 and include_usage. A tap on the registered ``generate``
    records what the engine handed the frontend: each stream's ids must
    equal the same prompt's through ``engine.generate`` in-process (or
    first differ at a near-tie), usage must count them, token_logprobs
    must equal the tap's to 1e-6, every stream must end in [DONE], and the
    HTTP run must launch ``mma_f32`` only, 8 a forward step;
(e2) bf16 at (b)'s geometry over HTTP after a full warmup: 32 concurrent
    streams of 128 prompt ids and 64 greedy tokens, once from a client in
    this process and once from a client in a spawned process of its own;
    prints decode tok/s and TTFT (all 32) measured at the client beside
    (b)'s in-process tok/s, the CPU seconds of the event-loop, engine and
    client threads (or client process), and the p50/p99 of the frontend's
    own TTFT and ITL histograms; every stream must carry 64 tokens and a
    finish reason (no bound on speed);
(e3) the other routes on (e2)'s engine: 4 json_object and 2 json_schema
    chats (stopped documents conform, masked graphs replay),
    /v1/embeddings of 8 token lists equal to an in-process
    ``engine.embed`` of the same batch (8 ``mma_bf16`` launches), a chat
    with an image part through a stub encoder (rows of the model's own
    embedding table: 200, an mm graph replays, the same image twice gives
    the same answer; 501 without an encoder), /health, /v1/models,
    /metrics, and ``frontend_requests_total{status="200"}`` equal to the
    200s sent; /debug/sched and /debug/mem answer 200 with the JAX
    documents' keys and a non-empty step ring, /metrics carries the
    engine's ``dynamo_engine_perf_*``, ``dynamo_sched_*`` and
    ``dynamo_mem_*`` families, HEAD /health answers 200 with no body, and a
    chat sent with a traceparent shows the engine's ``engine.queue``,
    ``engine.prefill`` and ``engine.decode`` spans in /debug/traces;
(e4) a streaming request cut by the client after 4 chunks: within 1 s
    the engine holds no seq for it and the pool's free blocks are back.
    (e)'s engines run with prefix caching off, so that a request sent
    twice prefills alike;
(f) SLO-sized prefill chunks at full width: llama-3-8b-lite in bf16 with
    ``prefill_chunk=0`` (``itl_slo_ms=50``, ``max_model_len=2048``) after a
    full warmup, serving (b)'s 32 x (128 + 64 greedy) with 4 prompts of
    1,536 tokens (4 greedy tokens each) sent after the first decode step,
    so mixed steps form under the decoders: ``mma_bf16`` only, 8 a forward
    step through replays, no graph made while serving, every block back
    and the memory ledger's leak audit at 0 orphan pins. Prints the
    resolved ``chunk_by_qos`` and hardware row, warmup seconds and
    graph-pool growth with the buckets that grew it most, decode tok/s,
    the decode rows' ITL while the late prompts prefill against
    ``costmodel.mixed_step_seconds``, the scheduling and memory ledgers'
    snapshots and the step profiler's EWMA of the decode-only and mixed
    steps (shares of each step's device time; every step's within 1);
    then the same traffic on a fresh
    engine with ``DYN_SCHED_LEDGER=0 DYN_MEM_LEDGER=0 DYN_PERF_PROFILE=0``
    (decode tok/s beside the first run's).

Prints the card's name and power limit (nvidia-smi), one ``ptxas`` line
per kernel instantiation (registers, spills), one JSON ``kernels`` line
(an entry per kernel of ``ROUTES``, its launches counted in the run that
serves its route: (b) for bf16 q, (b'') for f32 q over the f32 cache,
(c)'s f32 runs for f32 q over int8 and int4; ``verify_ms`` is the T=5
verify case's time), and as its last line
``{"ok": true, "device": {...}}``.
Without a CUDA card it exits non-zero and prints no result.

``python3 chip_smoke.py --profile`` also runs phase (b) and (b') under
``torch.profiler`` and prints device time by kernel and the device's busy
share of the serving wall time, for each run.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import gc
import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 2e-2  # bf16 kernel vs plain, as tests/test_ops.py holds the TPU kernel
# Both versions accumulate in f32 from the same bf16 inputs, so an output
# element may differ only by one bf16 rounding of its value (2^-7 relative)
# plus f32 noise: each shape is also held to |err| <= ULP_REL*|ref| + ULP_ABS.
ULP_REL, ULP_ABS = 2.0**-7, 1e-4
# f32 q: both versions take f32 products and f32 sums, in other orders, so
# an f32-q route is held to |err| <= F32_REL*|ref| + F32_ABS, the tolerance
# at which tests/test_torch_kv_quant.py holds the plain f32 path against
# the Pallas kernel; q rounded to bf16 breaks it
# (tests/test_torch_paged_attention.py).
F32_REL, F32_ABS = 2e-5, 2e-5
# (d5)'s f32 witness: a batched f32 embedding row against the same input
# embedded alone, |err| <= tol*|ref| + tol — the tolerance the CPU twins
# hold f32 hidden states to after a whole forward.
EMBED_F32_TOL = 1e-4

# The card's memory rate (bytes/s) and dense bf16 tensor rate (FLOP/s) are
# the cost model's row for it (``obs.costmodel.HW_SPECS``, NVIDIA's data
# sheet for the H100 SXM): one table of card rates for the bounds here and
# the engine's roofline counters. float32 outside the tensor cores: 67
# TFLOP/s. The f32 products of an f32-q route are done at the lesser cost
# of that rate and the bf16 tensor rate over the MMAs an f32-exact product
# takes there (F32_MMAS).
CARD_PEAK_F32 = 67e12
#: bf16 MMAs an f32-exact product takes, by cache kind: three q (or p)
#: terms against an exact int8 / int4 value; six term products of two
#: three-way splits against an f32 cache
F32_MMAS = {"float": 6, "int8": 3, "int4": 3}

#: the kernel's cache variants (ops.paged_attention.CACHE_KINDS) and the
#: engine's kv_dtype that serves each with bf16 queries
KV_DTYPES = {"float": "bfloat16", "int8": "int8", "int4": "int4"}
#: the phase-(a) case whose numbers stand in the kernels line
MAIN_CASE = "decode B=32 T=1 kv 128-192"
#: the phase-(a) verify chunk lengths (1 + spec_k proposals at spec_k 1, 3,
#: 4: the verify ladder of spec_k=4), and the case name of each; the T=5
#: case's time is the kernels line's ``verify_ms``
VERIFY_TS = (2, 4, 5)


#: phase (a)'s shapes of the SLO-sized prefill chunks of phase (f)
CHUNK_CASE = "chunk B=1 T=2048 kv 2048"
MIXED_CASE = "mixed B=64 T=512: 32 decode rows kv 128-192 + one chunk T=512, 31 empty rows"
#: the [64, 2048] step phase (f) runs: 32 decode rows, the 4 late prompts'
#: chunks of 1,536 tokens from position 0, and 28 empty rows
MIXED_F_CASE = ("mixed B=64 T=2048: 32 decode rows kv 128-192 + 4 chunks T=1536, "
                "28 empty rows")

#: the largest score tensor (bytes, f32) the plain version builds in one
#: call; a case past it is computed a few rows at a time
PLAIN_SCORE_BYTES = 2 * 2**30


def verify_case(t: int) -> str:
    return f"verify B=32 T={t} kv {128 + t}-{187 + t}"
#: the query dtypes phase (a) runs every case with
Q_DTYPES = (torch.bfloat16, torch.float32)


def err_limit(q_dtype: torch.dtype) -> tuple[float, float]:
    """(rel, abs): a route of this q dtype must keep |err| <= rel*|ref| + abs."""
    return (ULP_REL, ULP_ABS) if q_dtype == torch.bfloat16 else (F32_REL, F32_ABS)


def log(*a) -> None:
    print(*a, flush=True)


def card_rates(name: str) -> tuple[float, float]:
    """(memory bytes/s, dense bf16 FLOP/s) of the card: its cost-model row;
    a card the table lacks raises, naming it."""
    from dynamo_tpu_torch.obs.costmodel import hw_spec_for

    hw = hw_spec_for(name)
    return hw.hbm_bw, hw.peak_flops


#: the source of every route's kernel
SOURCE = "dynamo_tpu_torch/csrc/paged_attention_mma.cu"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` with L2 flushed before each call (the main
    path streams ~400 MB of weights between two attention calls). A ~5 ms
    sleep kernel ahead of the first event keeps the card busy while the
    host enqueues ``fn``, so a call whose host side outlasts its kernels
    (the wrapper's checks and allocations) is timed by its kernels."""
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# ---------------------------------------------------------------------------
# (a) kernel vs plain
# ---------------------------------------------------------------------------

def attention_case(gen, b, t, nblk, q_start, q_len, h=32, kh=8, d=128, bs=16):
    """f32 q, K and V (every bit of their significands used: a route that
    rounded f32 q, or an f32 cache, to bf16 would show) and the tables of
    one shape. The bf16 cache and the quantized caches' source are K and V
    rounded to bf16."""
    nb = b * nblk + 1
    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    k = torch.randn((nb, bs, kh, d), generator=gen, device="cuda")
    v = torch.randn((nb, bs, kh, d), generator=gen, device="cuda")
    perm = torch.randperm(nb - 1, generator=gen, device="cuda")[: b * nblk] + 1
    bt = perm.reshape(b, nblk).to(torch.int32).contiguous()
    qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    kl = qs + torch.tensor(q_len, dtype=torch.int32, device="cuda")
    return q, k, v, bt, qs, kl


def quantize(x: torch.Tensor, kind: str, chunk_blocks: int = 128) -> dict:
    """A quantized cache holding ``x`` [NB, BS, KH, D], written through the
    port's own ``_scatter_kv`` on ``x``'s device, whole blocks at a time
    (``chunk_blocks`` per call bounds the requant's transient gather)."""
    from dynamo_tpu_torch.models.llama import _scatter_kv

    nb, bs, kh, d = x.shape
    cache = {"q": torch.zeros((nb, bs, kh, d // 2 if kind == "int4" else d),
                              dtype=torch.uint8 if kind == "int4" else torch.int8,
                              device=x.device),
             "s": torch.zeros((nb, kh), dtype=torch.float32, device=x.device)}
    flat = x.reshape(nb * bs, kh, d)
    step = chunk_blocks * bs
    for s0 in range(0, nb * bs, step):
        n = min(step, nb * bs - s0)
        slots = torch.arange(s0, s0 + n, dtype=torch.int32, device=x.device)[None]
        _scatter_kv(cache, flat[s0: s0 + n][None], slots)
    return cache


def scatter_mismatch(x: torch.Tensor, card: dict, kind: str, blocks: int = 128) -> tuple[int, int]:
    """Elements of the card's quantized cache (payload bytes, scales) that
    differ from the same scatter run on the CPU, over the first ``blocks``
    blocks (the chunks are independent, so this is the CPU's whole work
    for those blocks)."""
    cpu = quantize(x[:blocks].cpu(), kind)
    return (int((card["q"][:blocks].cpu() != cpu["q"]).sum()),
            int((card["s"][:blocks].cpu() != cpu["s"]).sum()))


def attention_work(q, k, bt, qs, kl) -> tuple[float, float]:
    """Bytes the function must move (q and out once; K/V of each row's
    kv_len context once, at the cache's bytes per element: the payload's
    for a quantized cache, half a byte for packed int4, plus the f32 K and
    V scales of each (block, kv head) read; tables) and the products'
    operations on this run's visible (query, context) pairs."""
    from dynamo_tpu_torch.engine.cache import cache_payload

    b, t, h, d = q.shape
    payload = cache_payload(k)
    bs, kh = payload.shape[1], payload.shape[2]
    elem = payload.element_size() * payload.shape[3] / d      # int4: 0.5
    kv_tok = int(kl.sum())
    kv_bytes = 2 * kv_tok * kh * d * elem
    if isinstance(k, dict):
        blocks_read = int(((kl.long() + bs - 1) // bs).clamp(max=bt.shape[1]).sum())
        kv_bytes += 2 * blocks_read * kh * k["s"].element_size()
    nbytes = (2 * q.numel() * q.element_size() + kv_bytes
              + 4 * (bt.numel() + qs.numel() + kl.numel()))
    pos = qs[:, None].long() + torch.arange(t, device=q.device)[None, :]
    vis = torch.minimum(pos + 1, kl[:, None].long()).clamp(min=0)
    ops = 4.0 * d * h * float(vis.sum())
    return float(nbytes), ops


def library_fn(q, k, v, bt, qs, kl, efficient: bool = False):
    """SDPA over the pre-gathered (dequantized), head-expanded context in
    q's dtype, with the kernel's mask; all built outside the timed call.
    ``efficient`` holds SDPA to its memory-efficient backend."""
    from dynamo_tpu_torch.models.llama import _gather_kv

    b, t, h, d = q.shape
    ck = _gather_kv(k, bt).to(q.dtype)
    cv = _gather_kv(v, bt).to(q.dtype)
    rep = h // ck.shape[2]
    ck = ck.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    cv = cv.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    s = ck.shape[2]
    ctx = torch.arange(s, device=q.device)
    pos = qs[:, None].long() + torch.arange(t, device=q.device)[None, :]
    mask = (ctx[None, None, :] <= pos[:, :, None]) & (ctx[None, None, :] < kl[:, None, None].long())
    mask = mask[:, None]                                      # [B, 1, T, S]
    qt = q.transpose(1, 2).contiguous()
    if not efficient:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, ck, cv, attn_mask=mask)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask)
    return call


def time_scatter(gen) -> dict:
    """Device time of one layer's K scatter for a prefill step of the
    serving phase (32 rows x 128 tokens into a 417-block cache), per cache
    dtype: bf16 ``index_copy_`` against the quantized scatter, whose
    requant gathers each token's whole block."""
    from dynamo_tpu_torch.models.llama import _scatter_kv

    nb, bs, kh, d, n = 417, 16, 8, 128, 32 * 128
    new = torch.randn((32, 128, kh, d), generator=gen, device="cuda").to(torch.bfloat16)
    slots = (torch.arange(n, dtype=torch.int32, device="cuda") + bs).reshape(32, 128)
    res = {}
    for kind in KV_DTYPES:
        if kind == "float":
            cache = torch.zeros((nb, bs, kh, d), dtype=torch.bfloat16, device="cuda")
        else:
            cache = quantize(torch.zeros((nb, bs, kh, d), dtype=torch.bfloat16,
                                         device="cuda"), kind)
        res[kind] = time_ms(lambda: _scatter_kv(cache, new, slots), iters=10)
    log(f"[a] one layer's K scatter, prefill 32x128 tokens, ms: "
        + " ".join(f"{KV_DTYPES[k]}={v}" for k, v in res.items()))
    return res


def plain_score_bytes(q, kc, bt) -> int:
    """Bytes of one row's dense f32 score tensor [T, H, S] in the plain
    version."""
    payload = kc["q"] if isinstance(kc, dict) else kc
    return q.shape[1] * q.shape[2] * bt.shape[1] * payload.shape[1] * 4


def plain_by_rows(pa, q, kc, vc, bt, qs, kl, num_splits: int) -> torch.Tensor:
    """``paged_attention_plain`` over rows in groups whose dense score
    tensor stays within ``PLAIN_SCORE_BYTES`` (rows are independent, so
    this is the same function); one call when it fits."""
    b = q.shape[0]
    step = max(1, min(b, PLAIN_SCORE_BYTES // plain_score_bytes(q, kc, bt)))
    if step == b:
        return pa.paged_attention_plain(q, kc, vc, bt, qs, kl, num_splits=num_splits)
    return torch.cat([pa.paged_attention_plain(q[i: i + step], kc, vc, bt[i: i + step],
                                               qs[i: i + step], kl[i: i + step],
                                               num_splits=num_splits)
                      for i in range(0, b, step)])


def check_case(pa, name, q, kc, vc, bt, qs, kl, ns, kind, mism, bw, peak) -> dict:
    """One route at one shape: it must launch its route's kernel once and
    agree with the plain version within its q dtype's limit; with times.
    A case whose plain version is computed in row groups (phase (f)'s
    [64, 2048] step: 16 groups) times it and SDPA over 3 calls, not 20,
    and runs SDPA on its memory-efficient backend, which takes the mask
    without building the [B, H, T, S] score tensor."""
    args = (q, kc, vc, bt, qs, kl)
    route = pa.ROUTES[(q.dtype, kind)]
    kv_heads = (kc if kind == "float" else kc["q"]).shape[2]
    ns_used = pa.num_splits_for(q, kv_heads, bt.shape[1], ns, kind)
    pa.reset_launches()
    out = pa.paged_attention(*args, num_splits=ns)
    torch.cuda.synchronize()
    if pa.paged_attention.launches_by_kernel != {
            k: int(k == route) for k in pa.ROUTE_KERNELS}:
        raise AssertionError(f"{name} ({kind}, q {q.dtype}): launches by kernel "
                             f"{pa.paged_attention.launches_by_kernel}, expected one of "
                             f"{route}")
    ref = plain_by_rows(pa, *args, num_splits=ns_used).float()
    rel, abs_ = err_limit(q.dtype)
    limit = rel * ref.abs() + abs_
    outs = [out] + ([pa.paged_attention(*args, num_splits=1)] if ns_used > 1 else [])
    diffs = [(o.float() - ref).abs() for o in outs]
    err = max(d.max().item() for d in diffs)
    ratio = max((d / limit).max().item() for d in diffs)
    finite = bool(torch.isfinite(out.float()).all())
    if name.startswith("ragged"):
        finite = finite and bool((out[4] == 0).all())  # all-masked row → 0
    nbytes, ops = attention_work(q, kc, bt, qs, kl)
    heavy = q.shape[0] * plain_score_bytes(q, kc, bt) > PLAIN_SCORE_BYTES
    few, warm = (3, 1) if heavy else (20, 3)
    if q.dtype == torch.bfloat16:
        ops_s = ops / peak
    else:
        ops_s = min(ops / CARD_PEAK_F32, ops * F32_MMAS[kind] / peak)
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops_s * 1e3
    row = {
        "route": route,
        "max_abs_err": err, "err_over_limit": ratio, "err_limit": [rel, abs_],
        "num_splits": ns_used,
        "ms": time_ms(lambda: pa.paged_attention(*args, num_splits=ns)),
        "plain_ms": time_ms(lambda: plain_by_rows(pa, *args, num_splits=ns_used),
                            iters=few, warmup=warm),
        "library_ms": time_ms(library_fn(*args, efficient=heavy), iters=few, warmup=warm),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "ops": ops,
    }
    if mism is not None:
        row["scatter_cpu_mismatch"] = {"payload": mism[0], "scales": mism[1]}
    log(f"[a] {route} {name}: max_abs_err={err:.3e} (tol {TOL}); "
        f"worst err / ({rel:g}*|ref| + {abs_:g}) = {ratio:.3f} (limit 1) "
        + " ".join(f"{key}={row[key]}" for key in (
            "route", "num_splits", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"))
        + ("" if mism is None else
           f" card-vs-cpu scatter: {mism[0]} payload bytes, {mism[1]} scales "
           "differ (first 128 blocks of K and V)"))
    if not (err <= TOL and ratio <= 1.0 and finite):
        raise AssertionError(f"{route} {name}: err {err} err/limit {ratio} finite {finite}")
    if mism is not None and any(mism):
        raise AssertionError(f"{route} {name}: the card's quantized scatter differs from "
                             f"the CPU's ({mism[0]} payload bytes, {mism[1]} scales)")
    return row


def phase_kernels(bw: float, peak: float) -> dict:
    """Rows by route, then by shape."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls run in TF32: the plain version's f32 products "
                             "would not be f32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lens = torch.randint(128, 193, (32,), generator=gen, device="cuda").tolist()
    ragged_start = [0, 37, 5, 100, 0, 64, 15, 0]
    ragged_len = [16, 1, 11, 1, 0, 16, 1, 9]                  # row 4: kv_len 0
    decode = dict(b=32, t=1, nblk=16, q_start=[n - 1 for n in lens], q_len=[1] * 32)
    # name: (case, num_splits); every case runs every cache kind with each q dtype
    cases = {
        MAIN_CASE: (attention_case(gen, **decode), 0),
        "prefill B=32 T=128 kv 128": (attention_case(
            gen, 32, 128, 8, [0] * 32, [128] * 32), 0),
        "ragged B=8 T=16 with a zero-length row": (attention_case(
            gen, 8, 16, 8, ragged_start, ragged_len), 0),
        "chunk B=8 T=8 kv 8-144 (2 row groups a CTA)": (attention_case(
            gen, 8, 8, 9, [0, 31, 64, 100, 127, 5, 77, 136], [8] * 8), 0),
        "split-K B=2 T=1 kv 2048 ns=4": (attention_case(
            gen, 2, 1, 128, [2047, 2047], [1, 1]), 4),
        "long-context B=16 T=1 kv 8192 auto splits": (attention_case(
            gen, 16, 1, 512, [8191] * 16, [1] * 16), 0),
        "decode D=16 KH=2 H=4 B=32 kv 128-192": (attention_case(
            gen, **decode, h=4, kh=2, d=16), 0),
        "decode D=64 KH=8 H=64 B=32 kv 128-192": (attention_case(
            gen, **decode, h=64, kh=8, d=64), 0),
        "decode D=256 KH=1 H=2 B=4 kv 128-192 auto splits": (attention_case(
            gen, 4, 1, 16, [n - 1 for n in lens[:4]], [1] * 4, h=2, kh=1, d=256), 0),
        # the prefill bucket that prefill_chunk=0 sizing reaches at
        # max_model_len=2048 (phase (f))
        CHUNK_CASE: (attention_case(gen, 1, 2048, 128, [0], [2048]), 0),
        # a unified step's geometry: 32 decode rows, one 512-token chunk of
        # a fresh prompt, the rest of the decode ladder's 64 rows empty
        MIXED_CASE: (attention_case(
            gen, 64, 512, 32, [n - 1 for n in lens] + [0] * 32, [1] * 32 + [512] + [0] * 31), 0),
        # the [64, 2048] step of phase (f): its 32 decoders and the 4 late
        # prompts' 1,536-token chunks in one grid
        MIXED_F_CASE: (attention_case(
            gen, 64, 2048, 128, [n - 1 for n in lens] + [0] * 32,
            [1] * 32 + [LATE_PROMPT] * LATE + [0] * (32 - LATE)), 0),
    }
    # speculative verify chunks at decode depth: T query tokens a row from
    # q_start 128-187 (mid-block), each with its own causal limit; at
    # H/KH = 4, T=5 makes 20 query rows a kv head, 2 row groups of which
    # the second holds 4 live rows
    vstart = torch.randint(128, 188, (32,), generator=gen, device="cuda").tolist()
    for t in VERIFY_TS:
        cases[verify_case(t)] = (attention_case(gen, 32, t, 12, vstart, [t] * 32), 0)
    results: dict[str, dict] = {route: {} for route in pa.ROUTE_KERNELS}
    for name, ((q32, k32, v32, bt, qs, kl), ns) in cases.items():
        k, v = k32.bfloat16(), v32.bfloat16()
        for kind in KV_DTYPES:
            if kind == "float":
                mism = None
            else:
                kq, vq = quantize(k, kind), quantize(v, kind)
                mism = [a + b for a, b in zip(scatter_mismatch(k, kq, kind),
                                              scatter_mismatch(v, vq, kind))]
            for q_dtype in Q_DTYPES:
                q = q32.to(q_dtype)
                # a model-precision cache holds q's dtype: the f32 cache full
                # f32 draws, the bf16 cache the same rounded
                kc, vc = (((k32, v32) if q_dtype == torch.float32 else (k, v))
                          if kind == "float" else (kq, vq))
                row = check_case(pa, name, q, kc, vc, bt, qs, kl, ns, kind, mism, bw, peak)
                results[row["route"]][name] = row
                del q, kc, vc
            if mism is not None:
                del kq, vq
        torch.cuda.empty_cache()
    time_scatter(gen)
    return results


# ---------------------------------------------------------------------------
# (b) serving at full width
# ---------------------------------------------------------------------------

def print_profile(prof, wall_s: float) -> None:
    """Device time by kernel over the whole serving run, and the device's
    busy share of its wall time (kernels of one stream do not overlap).
    The profiler's own host overhead slows the run it watches."""
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows)
    log(f"[profile] wall {wall_s * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / 1e4 / wall_s:.1f}%)")
    for e in rows[:20]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms "
            f"{100 * e.self_device_time_total / busy_us:5.1f}% x{e.count:<6d} {e.key[:90]}")


#: llama-3-8b-lite with f32 weights, the model of (b'')
F32_MODEL = "llama-3-8b-lite-f32"


def register_f32_model() -> str:
    """Register llama-3-8b-lite with f32 weights as a preset of its own
    (its random weights are drawn in f32 from the same seed); returns its
    name."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS

    MODEL_PRESETS[F32_MODEL] = dataclasses.replace(
        MODEL_PRESETS["llama-3-8b-lite"], dtype="float32", name=F32_MODEL)
    return F32_MODEL


def check_live_cache(runner, gen) -> dict:
    """(b''): the f32 cache as the serving run left it holds the model's own
    f32 K and V (post-RoPE, mostly not bf16 values). In every layer, one
    decode call of the f32 route over that cache, with the block tables,
    q_start and q_len of the run's last step in a decode bucket (its
    program's static inputs) and f32 q drawn from ``gen``, must agree with
    the plain version within the f32 limit."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = runner.cfg
    h, d = cfg.num_heads, cfg.head_dim
    key, prog = max(((k, p) for k, p in runner.programs.items()
                     if k[1] == 1 and k[3] == 1 and p.calls), key=lambda kp: kp[0][0])
    b, _, nblk = key[:3]
    bt = prog.ints[b: b + b * nblk].view(b, nblk)
    qs, q_len = prog.ints[b * (1 + nblk): b * (1 + nblk) + 2 * b].view(2, b)
    kl = qs + q_len
    used = torch.unique(bt[kl > 0])
    rel, abs_ = err_limit(torch.float32)
    worst, not_bf16 = 0.0, []
    for li in range(cfg.num_layers):
        kc, vc = runner.cache_k[li], runner.cache_v[li]
        held = torch.cat([kc[used].flatten(), vc[used].flatten()])
        held = held[held != 0]
        not_bf16.append((held != held.bfloat16().float()).float().mean().item())
        q = torch.randn((b, 1, h, d), generator=gen, device=gen.device)
        args = (q, kc, vc, bt, qs, kl)
        out = pa.paged_attention(*args)
        ref = pa.paged_attention_plain(*args, num_splits=1)
        ratio = ((out - ref).abs() / (rel * ref.abs() + abs_)).max().item()
        if not (ratio <= 1.0 and bool(torch.isfinite(out).all())):
            raise AssertionError(f"[b''] layer {li}: {pa.ROUTES[(torch.float32, 'float')]} "
                                 f"on the live f32 cache: err/limit {ratio}")
        worst = max(worst, ratio)
    if min(not_bf16) < 0.5:
        raise AssertionError(f"[b''] the f32 cache holds bf16 values: the share of its "
                             f"nonzero elements that are not bf16 values is {not_bf16}")
    res = {"bucket": list(key), "rows": int((kl > 0).sum()), "kv_len_max": int(kl.max()),
           "blocks": int(used.numel()), "layers": cfg.num_layers,
           "err_over_limit": worst, "not_bf16_share_min": min(not_bf16)}
    log(f"[b''] live f32 cache vs plain version, every layer: {json.dumps(res)}")
    return res


def check_engine_launches(tag: str, core, by_kernel: dict, route: str) -> int:
    """The run launched ``route`` only, once per layer and forward step of
    every program call (verify programs included); returns the forward
    steps."""
    layers = core.model_cfg.num_layers
    forward_steps = sum(p.calls * (p.shape[3] if len(p.shape) > 3 else 1)
                        for p in core.runner.programs.values())
    want = {k: (layers * forward_steps if k == route else 0) for k in by_kernel}
    if forward_steps <= 0 or by_kernel != want:
        raise AssertionError(f"{tag}: kernel launches {by_kernel}, expected {want} "
                             f"({layers} per forward step, {route} only; "
                             f"{forward_steps} forward steps)")
    return forward_steps


async def serve(engine, reqs: dict, after=None):
    """Send ``reqs`` ({key: PreprocessedRequest}) to ``engine`` at once and
    collect each stream; then await ``after(engine)`` if given, and shut
    the engine down. Returns (start, first-token times, end times,
    {key: (tokens, logprobs)}, {key: finish reason}, and ``after``'s
    result last)."""
    first_at, done_at, streams, finish = {}, {}, {}, {}

    async def one(key):
        toks, lps = [], []
        async for out in engine.generate(reqs[key]):
            if out.error:
                raise RuntimeError(f"request {key} failed: {out.error}")
            if not toks:
                first_at[key] = time.perf_counter()
            toks += out.token_ids
            lps += out.log_probs or []
            if out.finish_reason is not None:
                finish[key] = str(out.finish_reason)
        done_at[key] = time.perf_counter()
        streams[key] = (toks, lps)

    t_start = time.perf_counter()
    try:
        await asyncio.gather(*(one(k) for k in reqs))
        extra = await after(engine) if after is not None else None
    finally:
        await engine.shutdown()
    return t_start, first_at, done_at, streams, (finish, extra)


def phase_serve(kind: str, profile: bool = False, window: int = 1,
                f32: bool = False) -> tuple[dict, dict]:
    """One serving run with the KV cache of ``kind`` after a full warmup
    (bf16 weights, or with ``f32`` f32 weights over the f32 model-precision
    cache): it must launch its route's kernel only, once per layer and
    forward step, all through replays of graphs the warmup captured.
    Returns the run's numbers and its token streams."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.obs.compile_ledger import get_compile_ledger
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.utils.config import EngineConfig

    batch, prompt, decode = 32, 128, 32 if f32 else 64
    model = register_f32_model() if f32 else "llama-3-8b-lite"
    tag = ("[b''] f32" if f32 else f"[b] kv_dtype={KV_DTYPES[kind]}" if window == 1
           else f"[b'] decode_window={window}")
    t0 = time.perf_counter()
    engine = build_engine(EngineConfig(
        model=model, block_size=16, max_batch_size=batch,
        max_model_len=prompt + decode + 16, prefill_chunk=prompt,
        kv_dtype=KV_DTYPES[kind], allow_random_weights=True,
        decode_window=window, warmup_mode="full"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    core = engine.core
    vocab = core.model_cfg.vocab_size
    spec = core.runner.spec
    warm = core.warmup_summary
    log(f"{tag}: {model} engine built and warmed up in {setup_s:.2f}s; kv blocks "
        f"{spec.num_blocks}, {spec.bytes_per_block()} bytes per block; warmup {warm}")
    if warm["failed"] or warm["deadline_skipped"] or warm["coverage"] != 1.0:
        raise AssertionError(f"{tag}: warmup left buckets without a graph: {warm}")

    hi = vocab - 5
    reqs = {i: PreprocessedRequest(
        token_ids=[(7 * i + 11 * j) % hi + 5 for j in range(prompt)],
        stop_conditions=StopConditions(max_tokens=decode, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
        request_id=f"bench-{i}") for i in range(batch)}

    torch.cuda.reset_peak_memory_stats()
    steps0 = core.metrics.num_steps
    led = get_compile_ledger()
    warmed = dict(core.runner.programs)
    serve_events0 = sum(e.source == "serve" for e in led.events)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    pa.reset_launches()
    t_start, first_at, done_at, streams, _ = asyncio.run(serve(engine, reqs))
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    if prof is not None:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        print_profile(prof, max(done_at.values()) - t_start)
    steps = core.metrics.num_steps - steps0
    for i, (toks, lps) in streams.items():
        if len(toks) != decode or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"request {i}: {len(toks)} tokens, expected {decode}")
        if not all(lp <= 1e-3 and lp == lp for lp in lps):
            raise AssertionError(f"request {i}: bad logprobs {lps[:4]}")
    programs = core.runner.programs
    minted = sorted(set(programs) - set(warmed))
    serve_events = sum(e.source == "serve" for e in led.events) - serve_events0
    # (b, t, nblk, window, fast_greedy): the legacy prefill ladder is (1, 2, 4, 8)
    allowed = [k for k in minted if window > 1 and k[1] > 1 and k[0] > 8]
    if minted != allowed or serve_events != len(minted):
        raise AssertionError(f"{tag}: serving made graphs {minted} ({serve_events} serve "
                             "ledger events); every step must replay a warmed-up graph")
    layers = core.model_cfg.num_layers
    route = pa.ROUTES[(torch.float32 if f32 else torch.bfloat16, kind)]
    forward_steps = check_engine_launches(tag, core, by_kernel, route)
    launches = sum(by_kernel.values())
    if window == 1 and forward_steps != steps:
        raise AssertionError(f"{tag}: {forward_steps} forward steps in {steps} engine steps")
    for key, p in programs.items():
        if p.launches.get(route, 0) != layers * key[3]:
            raise AssertionError(f"{tag}: graph {key} holds {p.launches}, expected "
                                 f"{layers * key[3]} launches of {route}")
    windows_run = sum(p.calls for k, p in programs.items() if k[3] > 1)
    if window > 1 and windows_run == 0:
        raise AssertionError(f"{tag}: no fused window ran")
    live = None
    if f32:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        live = check_live_cache(core.runner, gen)
    t_first = max(first_at.values())
    t_end = max(done_at.values())
    res = {
        "model": model, "kv_dtype": KV_DTYPES[kind], "decode_window": window, "requests": batch,
        "tokens": batch * decode, "steps": steps, "forward_steps": forward_steps,
        "windows": windows_run, "launches": launches, "launches_by_kernel": by_kernel,
        "launches_per_forward_step": launches / max(forward_steps, 1),
        "ttft_all_s": t_first - t_start,
        "decode_tok_s": batch * (decode - 1) / (t_end - t_first),
        "wall_s": t_end - t_start,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kv_blocks": spec.num_blocks, "bytes_per_block": spec.bytes_per_block(),
        "warmup_s": warm["seconds"], "graphs_warmed": len(warmed),
        "graph_pool_gib": warm["graph_pool_gib"], "serve_captures": [list(k) for k in minted],
    }
    if live is not None:
        res["live_cache_check"] = live
    log(f"{tag} " + json.dumps(res))
    del engine, core, programs, warmed
    gc.collect()
    torch.cuda.empty_cache()
    return res, {i: toks for i, (toks, _) in streams.items()}


# ---------------------------------------------------------------------------
# (c) coherence on the trained checkpoint
# ---------------------------------------------------------------------------

def phase_coherence() -> dict:
    from dynamo_tpu_torch.engine.engine import EngineCore
    from dynamo_tpu_torch.models.config import MODEL_PRESETS, ModelConfig
    from dynamo_tpu_torch.models.loader import load_params
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.tokenizer import load_tokenizer
    from dynamo_tpu_torch.utils.config import EngineConfig

    ckpt = str(ROOT / "tests" / "data" / "tiny-real-llama")
    tok = load_tokenizer(ckpt)
    ids = tok.encode("one two three four", add_bos=True)

    def greedy(model: str, device: str, params=None, hold_stream: bool = False,
               kv_dtype: str = "bfloat16"):
        """Greedy tokens, and with ``hold_stream`` the count of held steps
        and of those whose dispatch waited for the card: from the third
        step on (first uses of the step shapes are past), the stream is held
        busy by a ~0.1 s sleep kernel before ``step_begin``; a dispatch
        that synchronises returns only after the sleep, with the stream
        idle."""
        core = EngineCore(EngineConfig(model=model, block_size=16, num_blocks=64,
                                       max_batch_size=4, max_model_len=256,
                                       kv_dtype=kv_dtype),
                          params=params, device=device)
        core.add_request(PreprocessedRequest(
            token_ids=ids, request_id="c",
            stop_conditions=StopConditions(max_tokens=8, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0)))
        out: list[int] = []
        held = waited = 0
        while core.has_work():
            if hold_stream and core.metrics.num_steps >= 2:
                torch.cuda._sleep(200_000_000)
                pending = core.step_begin()
                held += 1
                waited += torch.cuda.current_stream().query()
                outs = core.step_finalize(pending)
            else:
                outs = core.step()
            for o in outs.values():
                out += o.token_ids
        return out, held, waited

    res: dict = {}
    for kv_dtype in ("bfloat16", "int8", "int4"):
        toks, held, waited = greedy(ckpt, "cuda", hold_stream=True, kv_dtype=kv_dtype)
        text = tok.decode(toks)
        log(f"[c] tiny-real-llama bf16, kv_dtype={kv_dtype}, on the card: {text!r}")
        if kv_dtype != "int4" and " five six seven eight" not in text:
            raise AssertionError(f"incoherent continuation on the card with "
                                 f"kv_dtype={kv_dtype}: {text!r}")
        log(f"[c] kv_dtype={kv_dtype}: step dispatches that waited for a busy card: "
            f"{waited} of {held}")
        if held == 0 or waited:
            raise AssertionError(f"kv_dtype={kv_dtype}: {waited} of {held} step "
                                 "dispatches synchronised with the card: the "
                                 "pipelined loop would not overlap")
        res[kv_dtype] = {"text": text, "held_steps": held, "waited": waited}
    cfg32 = dataclasses.replace(ModelConfig.from_hf_config(ckpt), dtype="float32",
                                name="tiny-real-llama-f32")
    MODEL_PRESETS[cfg32.name] = cfg32
    p_gpu = load_params(cfg32, ckpt, device="cuda")
    p_cpu = load_params(cfg32, ckpt, device="cpu")
    for kind, kv_dtype in KV_DTYPES.items():
        pa.reset_launches()
        gpu32 = greedy(cfg32.name, "cuda", p_gpu, kv_dtype=kv_dtype)[0]
        by_kernel = dict(pa.paged_attention.launches_by_kernel)
        cpu32 = greedy(cfg32.name, "cpu", p_cpu, kv_dtype=kv_dtype)[0]
        log(f"[c] f32, kv_dtype={kv_dtype}: greedy tokens card {gpu32} cpu {cpu32}; "
            f"launches by kernel {by_kernel}")
        if gpu32 != cpu32:
            raise AssertionError(f"kv_dtype={kv_dtype}: f32 greedy tokens on the card "
                                 "differ from the CPU plain path")
        route = pa.ROUTES[(torch.float32, kind)]
        if by_kernel[route] <= 0 or any(n for k, n in by_kernel.items() if k != route):
            raise AssertionError(f"kv_dtype={kv_dtype}: the f32 run launched {by_kernel}, "
                                 f"expected {route} only")
        res[kv_dtype]["f32_tokens"] = gpu32
        res[kv_dtype]["f32_launches_by_kernel"] = by_kernel
    return res


# ---------------------------------------------------------------------------
# (d) speculative verify, guided masks, multimodal override, embeddings
# ---------------------------------------------------------------------------

#: (d1)/(d2): 32 greedy requests whose 128-token prompts repeat a 16-token
#: pattern 8 times, 32 output tokens, spec_ngram=2, spec_k=4
SPEC_BATCH, SPEC_PROMPT, SPEC_DECODE, SPEC_PATTERN = 32, 128, 32, 16
#: a stream of the f32 spec run may first leave its spec-off twin only
#: where the two runs' log-probs of their chosen tokens differ by less
#: than this (a near-tie of the argmax)
NEAR_TIE = 1e-4


def spec_run(f32: bool, spec: bool, prompts: list[list[int]]) -> tuple[dict, dict]:
    """One serving run of (d1) (``f32``) or (d2) over the pipelined
    AsyncTorchEngine after a full warmup, with speculative verify on or
    off. Serving must make no graph; with spec on the verify graphs come
    from the warmup and verify steps run. Returns the run's numbers and
    its streams {i: (tokens, logprobs)}."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.obs.compile_ledger import get_compile_ledger
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.utils.config import EngineConfig

    model = register_f32_model() if f32 else "llama-3-8b-lite"
    tag = f"[{'d1' if f32 else 'd2'}] spec {'on' if spec else 'off'}"
    t0 = time.perf_counter()
    engine = build_engine(EngineConfig(
        model=model, block_size=16, max_batch_size=SPEC_BATCH,
        max_model_len=SPEC_PROMPT + SPEC_DECODE + 16, prefill_chunk=SPEC_PROMPT,
        kv_dtype="bfloat16", allow_random_weights=True, warmup_mode="full",
        spec_ngram=2 if spec else 0, spec_k=4))
    torch.cuda.synchronize()
    core = engine.core
    warm = core.warmup_summary
    log(f"{tag}: {model} engine built and warmed up in {time.perf_counter() - t0:.2f}s; "
        f"warmup {warm}")
    if warm["failed"] or warm["deadline_skipped"] or warm["coverage"] != 1.0:
        raise AssertionError(f"{tag}: warmup left buckets without a graph: {warm}")
    warm_verify = sorted(k for k in core.runner.programs if k[0] == "verify")
    if spec and not warm_verify:
        raise AssertionError(f"{tag}: the full warmup captured no verify graph")
    reqs = {i: PreprocessedRequest(
        token_ids=p, request_id=f"spec-{i}",
        stop_conditions=StopConditions(max_tokens=SPEC_DECODE, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0)) for i, p in enumerate(prompts)}
    led = get_compile_ledger()
    warmed = set(core.runner.programs)
    events0 = len(led.events)
    steps0 = core.metrics.num_steps
    pa.reset_launches()
    t_start, first_at, done_at, streams, _ = asyncio.run(serve(engine, reqs))
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    minted = sorted(map(str, set(core.runner.programs) - warmed))
    serve_sigs = [e.sig.to_dict() for e in led.events[events0:] if e.source == "serve"]
    if minted or serve_sigs:
        raise AssertionError(f"{tag}: serving made graphs {minted} (serve-time ledger "
                             f"events {serve_sigs}); every step must replay a warmed-up graph")
    route = pa.ROUTES[(torch.float32 if f32 else torch.bfloat16, "float")]
    forward_steps = check_engine_launches(tag, core, by_kernel, route)
    verify_steps = sum(p.calls for k, p in core.runner.programs.items() if k[0] == "verify")
    m = core.metrics
    if spec and (m.spec_proposed <= 0 or verify_steps <= 0):
        raise AssertionError(f"{tag}: no speculation ran: proposed {m.spec_proposed}, "
                             f"verify steps {verify_steps}")
    for i, (toks, lps) in streams.items():
        if len(toks) != SPEC_DECODE or len(lps) != SPEC_DECODE:
            raise AssertionError(f"{tag}: request {i}: {len(toks)} tokens")
    t_first, t_end = max(first_at.values()), max(done_at.values())
    res = {
        "model": model, "spec": spec, "requests": len(prompts), "steps": m.num_steps - steps0,
        "forward_steps": forward_steps, "verify_steps": verify_steps,
        "verify_calls_by_bucket": {"x".join(map(str, k[1:])): p.calls
                                   for k, p in core.runner.programs.items()
                                   if k[0] == "verify" and p.calls},
        "verify_graphs_warmed": len(warm_verify),
        "spec_proposed": m.spec_proposed, "spec_accepted": m.spec_accepted,
        "acceptance": m.spec_accepted / m.spec_proposed if m.spec_proposed else None,
        "launches_by_kernel": by_kernel,
        "launches_per_forward_step": sum(by_kernel.values()) / forward_steps,
        "decode_tok_s": len(prompts) * (SPEC_DECODE - 1) / (t_end - t_first),
        "ttft_all_s": t_first - t_start, "wall_s": t_end - t_start,
        "warmup_s": warm["seconds"], "graphs_warmed": len(warmed),
    }
    log(f"{tag} " + json.dumps(res))
    del engine, core
    gc.collect()
    torch.cuda.empty_cache()
    return res, streams


def phase_spec(f32: bool, smi: str, b_tok_s: float | None = None) -> dict:
    """(d1) with ``f32`` (f32 weights over the f32 cache: every stream must
    equal its spec-off twin, or first leave it at a near-tie), else (d2)
    over the bf16 cache (the share of equal streams is printed)."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS

    hi = MODEL_PRESETS["llama-3-8b-lite"].vocab_size - 5
    prompts = [[(7 * i + 11 * j) % hi + 5 for j in range(SPEC_PATTERN)]
               * (SPEC_PROMPT // SPEC_PATTERN) for i in range(SPEC_BATCH)]
    on, s_on = spec_run(f32, True, prompts)
    off, s_off = spec_run(f32, False, prompts)
    tag = "[d1] f32" if f32 else "[d2] bf16"
    equal, ties, bad = 0, [], []
    for i, (toks, lps) in s_on.items():
        ref_toks, ref_lps = s_off[i]
        j = next((j for j, (a, b) in enumerate(zip(toks, ref_toks)) if a != b), None)
        if j is None:
            equal += 1
        elif abs(lps[j] - ref_lps[j]) < NEAR_TIE:
            ties.append((i, j, abs(lps[j] - ref_lps[j])))
        else:
            bad.append((i, j, toks[j], ref_toks[j], lps[j], ref_lps[j]))
    log(f"{tag}: spec streams equal to spec-off: {equal} of {len(s_on)}; first differing "
        f"at a near-tie (|dlp| < {NEAR_TIE}): {len(ties)} {ties}; otherwise: {len(bad)} "
        f"{bad[:4]}")
    log(f"{tag}: acceptance {on['acceptance']} ({on['spec_accepted']} of "
        f"{on['spec_proposed']} proposed), decode tok/s spec {on['decode_tok_s']} / "
        f"spec off {off['decode_tok_s']}"
        + ("" if b_tok_s is None else f" / (b) bf16 {b_tok_s}") + f" on {smi}")
    if f32 and bad:
        raise AssertionError(f"{tag}: {len(bad)} spec streams leave their spec-off twins "
                             f"at no near-tie: {bad[:4]}")
    return {"spec": on, "off": off, "equal": equal, "near_ties": len(ties),
            "differ_elsewhere": len(bad)}


#: (d3)'s json_schema: required keys and a string enum
GUIDED_SCHEMA = {"type": "object",
                 "properties": {"name": {"type": "string", "enum": ["ada", "bob", "cy"]},
                                "ok": {"type": "boolean"}, "n": {"type": "number"}},
                 "required": ["name", "ok"]}


def phase_guided() -> dict:
    """(d3): 8 json_object and 4 json_schema requests beside 8 plain greedy
    ones in one unified bf16-cache engine (graphs captured at first use),
    48 tokens each. A guided output that stopped must be a document that
    conforms to its schema; one cut by its length must be a grammatical
    prefix. The masked programs must have replayed their graphs."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.engine.guided import JsonMachine, validate_json_output
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.tokenizer import ByteTokenizer, guided_vocab
    from dynamo_tpu_torch.utils.config import EngineConfig

    prompt, decode = 64, 48
    engine = build_engine(EngineConfig(
        model="llama-3-8b-lite", block_size=16, max_batch_size=32,
        max_model_len=prompt + decode + 16, prefill_chunk=prompt, kv_dtype="bfloat16",
        allow_random_weights=True, warmup_mode="lazy"))
    core = engine.core
    vocab = core.model_cfg.vocab_size
    eos = ByteTokenizer.EOS
    schemas = {f"obj-{i}": {} for i in range(8)}
    schemas.update({f"sch-{i}": GUIDED_SCHEMA for i in range(4)})
    schemas.update({f"plain-{i}": None for i in range(8)})
    reqs = {rid: PreprocessedRequest(
        token_ids=[(13 * n + 7 * j) % (vocab - 5) + 5 for j in range(prompt)],
        request_id=rid, eos_token_ids=[eos],
        stop_conditions=StopConditions(max_tokens=decode),
        sampling_options=SamplingOptions(temperature=0.0, guided_json=schema))
        for n, (rid, schema) in enumerate(schemas.items())}
    pa.reset_launches()
    _t0, _f, _d, streams, (finish, _) = asyncio.run(serve(engine, reqs))
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    check_engine_launches("[d3]", core, by_kernel, pa.ROUTES[(torch.bfloat16, "float")])
    pieces = guided_vocab(ByteTokenizer(), vocab)
    counts = {"stop": 0, "length": 0}
    for rid, (toks, _lps) in streams.items():
        schema = schemas[rid]
        if schema is None:
            continue
        text = "".join(pieces[t] for t in toks if t != eos)
        if finish[rid] == "stop":
            validate_json_output(text, schema)
        elif finish[rid] == "length":
            JsonMachine(schema).feed_str(text)
        else:
            raise AssertionError(f"[d3] {rid} finished {finish[rid]}")
        counts[finish[rid]] += 1
    masked = {k: p for k, p in core.runner.programs.items() if "masked" in k[5:]}
    replayed = sum(p.calls for p in masked.values() if p.graph is not None)
    if not masked or replayed <= 0:
        raise AssertionError(f"[d3] masked programs {list(masked)} replayed {replayed} times")
    m = core.metrics
    res = {"guided": 12, "plain": 8, "finished_stop": counts["stop"],
           "finished_length": counts["length"], "masked_graphs": len(masked),
           "masked_replays": replayed, "mask_steps": m.guided_mask_steps,
           "mask_host_ms_per_step": 1e3 * m.guided_mask_seconds / max(m.guided_mask_steps, 1),
           "launches_by_kernel": by_kernel,
           "example": "".join(pieces[t] for t in streams["sch-0"][0] if t != eos)}
    log("[d3] guided " + json.dumps(res))
    del engine, core
    gc.collect()
    torch.cuda.empty_cache()
    return res


def embed_exact(runner, texts: list[list[int]]) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``runner.embed`` with the runner's weights widened to f32, over an
    f32 cache: each input alone (the values the bf16 forward rounds), then
    all inputs in one call, and the paged-attention launches of that
    batched call."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    params, cfg = runner.params, runner.cfg
    wide = {k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict) else v.float())
            for k, v in params.items()}
    runner.params, runner.cfg = wide, dataclasses.replace(cfg, dtype="float32")
    try:
        single = torch.from_numpy(np.concatenate([runner.embed([t]) for t in texts]))
        pa.reset_launches()
        batch = torch.from_numpy(runner.embed(texts))
        return single, batch, dict(pa.paged_attention.launches_by_kernel)
    finally:
        runner.params, runner.cfg = params, cfg
        del wide


def phase_mm_embed() -> dict:
    """(d4) and (d5) on one bf16-cache engine (prefix caching off, graphs
    captured at first use).

    (d4): four requests of 128 prompt tokens with one 64-position span at
    pos 16 beside the same four prompts without spans, 32 greedy tokens.
    Two spans carry the embedding table's own rows for their tokens,
    widened to f32: those streams must equal the plain ones token for
    token. Two carry random f32 rows from a seed: those must differ.

    (d5): 8 prompts of 7-128 tokens embedded in one call of
    AsyncTorchEngine.embed; the batched call must launch mma_bf16 8 times
    (once a layer) and leave the serving pool's blocks as they were. The
    batch's rows are held to the prompts embedded alone in f32: the same
    weights widened to f32 over an f32 cache (``embed_exact``), batched
    and alone, through mma_f32 8 times for the batched call, each batched
    row within |err| <= 1e-4*|ref| + 1e-4 (the twins' f32 hidden-state
    tolerance) of its single call. A row that took another row's K and V
    (the JAX runner's shared block table) is off by the size of the values
    themselves. In bf16 the forward is not batch invariant, so the bf16
    rows' distance from their single calls is printed beside the
    elementwise bf16 rule (|err| <= 2^-7*|ref| + 1e-4) and twice the single
    call's own distance from f32, and is no pass condition."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions, tensor_to_wire)
    from dynamo_tpu_torch.utils.config import EngineConfig

    prompt, decode, pos, span = 128, 32, 16, 64
    engine = build_engine(EngineConfig(
        model="llama-3-8b-lite", block_size=16, max_batch_size=32,
        max_model_len=prompt + decode + 16, prefill_chunk=prompt, kv_dtype="bfloat16",
        allow_random_weights=True, warmup_mode="lazy", enable_prefix_caching=False))
    core = engine.core
    cfg = core.model_cfg
    table = core.runner.params["embed"]
    dev = core.runner.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    prompts = [[(17 * i + 5 * j) % (cfg.vocab_size - 5) + 5 for j in range(prompt)]
               for i in range(4)]

    def req(rid, toks, emb=None):
        r = PreprocessedRequest(
            token_ids=toks, request_id=rid,
            stop_conditions=StopConditions(max_tokens=decode, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0))
        if emb is not None:
            r.mm_embeddings = [{"pos": pos, **tensor_to_wire(emb.cpu().numpy())}]
        return r

    reqs = {}
    for i, p in enumerate(prompts):
        ids = torch.tensor(p[pos: pos + span], device=dev)
        emb = (table[ids].float() if i < 2 else
               torch.randn((span, cfg.hidden_size), generator=gen, device=dev)
               * cfg.hidden_size ** -0.5)
        reqs[f"mm-{i}"] = req(f"mm-{i}", p, emb)
        reqs[f"plain-{i}"] = req(f"plain-{i}", p)
    lens = [7, 16, 23, 40, 64, 90, 111, 128]
    texts = [[(29 * n + 3 * j) % (cfg.vocab_size - 5) + 5 for j in range(k)]
             for n, k in enumerate(lens)]

    async def embed_calls(eng):
        free0, blocks0 = core.pool.num_free, core.pool.num_blocks
        pa.reset_launches()
        batch = await eng.embed(texts)
        launches = dict(pa.paged_attention.launches_by_kernel)
        alone = [await eng.embed([t]) for t in texts]
        return batch, launches, alone, (free0, blocks0, core.pool.num_free,
                                        core.pool.num_blocks)

    pa.reset_launches()
    _t0, _f, _d, streams, (_fin, emb_res) = asyncio.run(serve(engine, reqs, embed_calls))
    # (d4)
    same = [streams[f"mm-{i}"][0] == streams[f"plain-{i}"][0] for i in range(4)]
    mm_progs = {k: p for k, p in core.runner.programs.items() if "mm" in k[5:]}
    mm_replays = sum(p.calls for p in mm_progs.values() if p.graph is not None)
    d4 = {"identity_equal": same[:2], "random_equal": same[2:],
          "mm_graphs": [list(k) for k in mm_progs], "mm_replays": mm_replays,
          "mm_buffer_mib": core.runner._mm_override.numel() * 4 / 2**20}
    log("[d4] multimodal " + json.dumps(d4))
    if not all(same[:2]) or any(same[2:]) or mm_replays <= 0:
        raise AssertionError(f"[d4] identity-row streams must equal the plain ones and "
                             f"random-row streams must differ, through a replayed mm "
                             f"graph: {d4}")
    # (d5)
    batch, launches, alone, (free0, blocks0, free1, blocks1) = emb_res
    single = torch.from_numpy(np.concatenate(alone))
    got = torch.from_numpy(batch)
    exact, exact_batch, f32_launches = embed_exact(core.runner, texts)
    f32_err = ((exact_batch - exact).abs()
               / (EMBED_F32_TOL * exact.abs() + EMBED_F32_TOL)).max().item()
    ulp = ((got - single).abs() / (ULP_REL * single.abs() + ULP_ABS)).max().item()
    to_single = (got - single).abs().amax(dim=1)               # per row
    noise = (single - exact).abs().amax(dim=1)
    batch_noise = (got - exact).abs().amax(dim=1)
    envelope = (to_single / (2 * noise + ULP_ABS)).max().item()
    route = pa.ROUTES[(torch.bfloat16, "float")]
    f32_route = pa.ROUTES[(torch.float32, "float")]
    d5 = {"inputs": len(texts), "lens": lens, "shape": list(batch.shape),
          "f32_batched_vs_single_max_abs": (exact_batch - exact).abs().amax(dim=1).tolist(),
          "f32_batched_err_over_limit": f32_err, "f32_limit": [EMBED_F32_TOL, EMBED_F32_TOL],
          "f32_launches_by_kernel": f32_launches,
          "bf16_batched_vs_single_max_abs": to_single.tolist(),
          "bf16_single_vs_f32_max_abs": noise.tolist(),
          "bf16_batched_vs_f32_max_abs": batch_noise.tolist(),
          "bf16_over_twice_the_noise": envelope, "bf16_ulp_rule_err_over_limit": ulp,
          "max_abs_value": single.abs().max().item(),
          "launches_by_kernel": launches, "pool_free": [free0, free1],
          "pool_blocks": [blocks0, blocks1]}
    log("[d5] embeddings " + json.dumps(d5))
    want = {k: (cfg.num_layers if k == route else 0) for k in launches}
    want_f32 = {k: (cfg.num_layers if k == f32_route else 0) for k in f32_launches}
    if (tuple(batch.shape) != (len(texts), cfg.hidden_size) or not np.isfinite(batch).all()
            or tuple(exact_batch.shape) != tuple(batch.shape) or f32_err > 1.0
            or launches != want or f32_launches != want_f32
            or (free0, blocks0) != (free1, blocks1)):
        raise AssertionError(f"[d5] embeddings: {d5}; launches expected {want}, "
                             f"f32 {want_f32}")
    del engine, core, table
    gc.collect()
    torch.cuda.empty_cache()
    return {"d4": d4, "d5": d5}


# ---------------------------------------------------------------------------
# (e) the OpenAI HTTP frontend
# ---------------------------------------------------------------------------

#: (e2)/(e3)'s model name, and a second name on the same engine that has no
#: image encoder
HTTP_MODEL, HTTP_NOENC = "llama-3-8b-lite", "llama-3-8b-lite-noenc"
#: rows of an (e3) image: the embedding table's rows for these ids
IMAGE_IDS = list(range(1000, 1016))


def wide_tokenizer():
    """ByteTokenizer that also names the ids past the byte range (`` t<id>``),
    so each token of a random-weight model streams text: the SSE chunk a
    token that a trained model's vocabulary gives. Byte ids decode as the
    ByteTokenizer's (the guided grammar only emits those)."""
    from dynamo_tpu_torch.tokenizer import ByteTokenizer

    class WideByteTokenizer(ByteTokenizer):
        def decode(self, ids, skip_special: bool = True) -> str:
            out, run = [], []
            for i in ids:
                if self.OFFSET <= i < self.OFFSET + 256:
                    run.append(i - self.OFFSET)
                    continue
                if run:
                    out.append(bytes(run).decode("utf-8", errors="replace"))
                    run = []
                if i >= self.OFFSET + 256:
                    out.append(f" t{i}")
            if run:
                out.append(bytes(run).decode("utf-8", errors="replace"))
            return "".join(out)

    return WideByteTokenizer()


def tapped(generate, taps: dict):
    """``generate`` recording what the engine handed the frontend, by
    request id: ids, log-probs, finish reason (None if the stream was
    closed before it finished)."""
    async def gen(pre):
        rec = taps.setdefault(pre.request_id, {"ids": [], "lps": [], "finish": None})
        async for out in generate(pre):
            rec["ids"] += out.token_ids
            rec["lps"] += out.log_probs or []
            if out.finish_reason is not None:
                rec["finish"] = str(out.finish_reason)
            yield out
    return gen


class HttpServing:
    """The port's HttpService on 127.0.0.1 in an event loop of its own
    thread, with ``engine``'s step loop started on it (its streams live on
    that loop); clients run on the main thread's loop."""

    def __init__(self, models, engine):
        from dynamo_tpu_torch.frontend.service import HttpService
        from dynamo_tpu_torch.obs.mem_ledger import install_mem_metrics
        from dynamo_tpu_torch.obs.profiler import install_perf_metrics
        from dynamo_tpu_torch.obs.sched_ledger import install_sched_metrics

        self.engine = engine
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.svc = HttpService(models)
        # the engine's families on the service's /metrics, as the launcher
        # installs them for in=http
        for install in (install_perf_metrics, install_sched_metrics, install_mem_metrics):
            install(self.svc.metrics)
        self.port = self.run(self.svc.start("127.0.0.1", 0))
        self.run(self._start())

    async def _start(self) -> None:
        self.engine.start()

    def run(self, coro, timeout: float = 300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.run(self.svc.stop())
        self.run(self.engine.shutdown())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


async def http_call(port: int, method: str, path: str, body=None, headers=None,
                    cut_after: int | None = None) -> dict:
    """One HTTP/1.1 request over asyncio streams: status, headers, body,
    and for a chunked (SSE) answer each event with its arrival time.
    ``cut_after``: close the connection after that many events."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    head = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1", "Connection: close",
            "Content-Type: application/json", f"Content-Length: {len(data)}"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    t0 = time.perf_counter()
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
    try:
        raw = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
        status = int(raw[0].split(" ")[1])
        hdrs = {k.strip().lower(): v.strip() for k, _, v in
                (ln.partition(":") for ln in raw[1:] if ln)}
        out = {"status": status, "headers": hdrs, "body": b"", "events": [], "times": [],
               "t0": t0}
        if hdrs.get("transfer-encoding") == "chunked":
            buf = b""
            while True:
                size = int((await reader.readuntil(b"\r\n")).split(b";")[0], 16)
                if size == 0:
                    break
                buf += await reader.readexactly(size)
                await reader.readexactly(2)
                while b"\n\n" in buf:
                    ev, buf = buf.split(b"\n\n", 1)
                    out["events"].append(ev.decode().removeprefix("data: "))
                    out["times"].append(time.perf_counter())
                    if cut_after is not None and len(out["events"]) >= cut_after:
                        return out
        else:
            out["body"] = await reader.readexactly(int(hdrs.get("content-length", "0")))
        return out
    finally:
        writer.close()


def sse_summary(res: dict) -> dict:
    """Text, token log-probs, finish reason and usage of a streamed
    completion; the times of its first and last token chunks."""
    evs = res["events"]
    if not evs or evs[-1] != "[DONE]":
        raise AssertionError(f"[e] stream did not end in [DONE]: {evs[-2:]}")
    text, lps, finish, usage, tok_times = "", [], None, None, []
    for ev, t in zip(evs[:-1], res["times"]):
        d = json.loads(ev)
        if d.get("usage"):
            usage = d["usage"]
        for ch in d["choices"]:
            text += ch["text"]
            finish = ch.get("finish_reason") or finish
            lps += (ch.get("logprobs") or {}).get("token_logprobs", [])
            if ch["text"]:
                tok_times.append(t)
    return {"text": text, "lps": lps, "finish": finish, "usage": usage,
            "first": tok_times[0] if tok_times else None,
            "last": tok_times[-1] if tok_times else None}


def throughput_clients(port: int, bodies: dict) -> tuple[float, list, float]:
    """(e2)'s clients: every body of ``bodies`` ({request id: body}) sent at
    once to /v1/completions and streamed; returns the start time, each
    answer's (status, ``sse_summary``) and the CPU seconds this process
    spent."""
    async def go():
        return await asyncio.gather(*(http_call(
            port, "POST", "/v1/completions", body, headers={"x-request-id": rid})
            for rid, body in bodies.items()))

    cpu0 = time.process_time()
    t_start = time.perf_counter()
    results = asyncio.run(go())
    return (t_start, [(r["status"], sse_summary(r)) for r in results],
            time.process_time() - cpu0)


def _client_main(port: int, bodies: dict, conn) -> None:
    conn.send(throughput_clients(port, bodies))
    conn.close()


def client_in_own_process(port: int, bodies: dict) -> tuple[float, list, float]:
    """``throughput_clients`` in a spawned process of its own, as a user's
    client is, so that its parsing does not share this process's
    interpreter lock with the frontend and the engine (perf_counter is the
    system's monotonic clock, one timeline in both processes)."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_client_main, args=(port, bodies, send))
    proc.start()
    try:
        send.close()
        if not recv.poll(300):
            raise AssertionError("[e2] the client process sent no result in 300 s")
        return recv.recv()
    finally:
        proc.join(60)
        if proc.is_alive():
            proc.kill()
            proc.join(10)


def histogram_quantiles(text: str, name: str, qs=(0.5, 0.99)) -> dict:
    """Quantiles of a Prometheus histogram (summed over labels), each the
    upper bound of the bucket that holds it."""
    from dynamo_tpu_torch.utils.metrics import parse_prometheus

    buckets: dict[float, float] = {}
    for (n, labels), v in parse_prometheus(text).items():
        if n == f"{name}_bucket":
            le = float(dict(labels)["le"])
            buckets[le] = buckets.get(le, 0.0) + v
    les = sorted(buckets)
    total = buckets[les[-1]] if les else 0.0
    return {f"p{round(q * 100)}": next((le for le in les if buckets[le] >= q * total), None)
            for q in qs} | {"count": total}


def http_engine(model: str, decode: int, prompt: int = 128):
    """(e)'s engine after a full warmup, with prefix caching off: a request
    sent twice (an in-process reference, the same image) prefills alike
    instead of from the first one's cached blocks, whose shapes round
    otherwise in bf16."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.utils.config import EngineConfig

    t0 = time.perf_counter()
    engine = build_engine(EngineConfig(
        model=model, block_size=16, max_batch_size=32, max_model_len=prompt + decode + 16,
        prefill_chunk=prompt, kv_dtype="bfloat16", allow_random_weights=True,
        warmup_mode="full", enable_prefix_caching=False))
    torch.cuda.synchronize()
    warm = engine.core.warmup_summary
    if warm["failed"] or warm["deadline_skipped"] or warm["coverage"] != 1.0:
        raise AssertionError(f"[e] {model}: warmup left buckets without a graph: {warm}")
    return engine, time.perf_counter() - t0


def thread_cpu_s(threads: dict) -> dict:
    """CPU seconds each named thread has used so far."""
    return {name: time.clock_gettime(time.pthread_getcpuclockid(t.ident))
            for name, t in threads.items()}


def forward_steps_since(core, calls0: dict) -> int:
    return sum((p.calls - calls0.get(k, 0)) * (p.shape[3] if len(p.shape) > 3 else 1)
               for k, p in core.runner.programs.items())


def phase_http_f32() -> dict:
    """(e1): 32 concurrent streaming /v1/completions (128-token id prompts,
    32 greedy tokens, logprobs 0, include_usage) into llama-3-8b-lite with
    f32 weights over the f32 cache. Each stream's ids (the tap's) must
    equal the same prompt's through engine.generate in-process, or first
    differ at a near-tie; usage must count the ids; token_logprobs must
    equal the tap's to 1e-6; every stream ends in [DONE]; the HTTP run
    launches mma_f32 only, 8 a forward step."""
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    batch, prompt, decode = 32, 128, 32
    model = register_f32_model()
    engine, setup_s = http_engine(model, decode)
    core = engine.core
    taps: dict = {}
    models = ModelManager()
    models.register(model, wide_tokenizer(), tapped(engine.generate, taps),
                    defaults=ModelDefaults(max_model_len=prompt + decode + 16),
                    stats=engine.stats)
    srv = HttpServing(models, engine)
    hi = core.model_cfg.vocab_size - 5
    prompts = [[(7 * i + 11 * j) % hi + 5 for j in range(prompt)] for i in range(batch)]
    calls0 = {k: p.calls for k, p in core.runner.programs.items()}
    pa.reset_launches()

    async def clients():
        return await asyncio.gather(*(http_call(
            srv.port, "POST", "/v1/completions",
            {"model": model, "prompt": p, "max_tokens": decode, "temperature": 0,
             "logprobs": 0, "ignore_eos": True, "stream": True,
             "stream_options": {"include_usage": True}},
            headers={"x-request-id": f"e1-{i}"}) for i, p in enumerate(prompts)))

    results = asyncio.run(clients())
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    forward_steps = forward_steps_since(core, calls0)
    route = pa.ROUTES[(torch.float32, "float")]
    want = {k: (core.model_cfg.num_layers * forward_steps if k == route else 0)
            for k in by_kernel}
    if forward_steps <= 0 or by_kernel != want:
        raise AssertionError(f"[e1] HTTP run launches {by_kernel}, expected {want}")

    async def in_process():
        async def one(i):
            toks, lps = [], []
            async for out in engine.generate(PreprocessedRequest(
                    token_ids=prompts[i], request_id=f"e1-ref-{i}",
                    stop_conditions=StopConditions(max_tokens=decode, ignore_eos=True),
                    sampling_options=SamplingOptions(temperature=0.0))):
                toks += out.token_ids
                lps += out.log_probs or []
            return toks, lps
        return await asyncio.gather(*(one(i) for i in range(batch)))

    refs = srv.run(in_process())
    equal, ties, bad, lp_err = 0, [], [], 0.0
    for i, res in enumerate(results):
        s = sse_summary(res)
        tap = taps[f"e1-{i}"]
        if res["status"] != 200 or s["usage"]["completion_tokens"] != len(tap["ids"]):
            raise AssertionError(f"[e1] request {i}: status {res['status']}, usage "
                                 f"{s['usage']}, {len(tap['ids'])} ids")
        if len(tap["ids"]) != decode or len(s["lps"]) != len(tap["lps"]):
            raise AssertionError(f"[e1] request {i}: {len(tap['ids'])} ids, "
                                 f"{len(s['lps'])} token_logprobs")
        lp_err = max(lp_err, max(abs(a - b) for a, b in zip(s["lps"], tap["lps"])))
        ref_toks, ref_lps = refs[i]
        j = next((j for j, (a, b) in enumerate(zip(tap["ids"], ref_toks)) if a != b), None)
        if j is None:
            equal += 1
        elif abs(tap["lps"][j] - ref_lps[j]) < NEAR_TIE:
            ties.append((i, j))
        else:
            bad.append((i, j, tap["ids"][j], ref_toks[j], tap["lps"][j], ref_lps[j]))
    res = {"model": model, "requests": batch, "decode": decode, "setup_s": setup_s,
           "streams_equal_in_process": equal, "near_ties": ties, "differ": bad[:4],
           "token_logprobs_max_abs_err": lp_err, "forward_steps": forward_steps,
           "launches_by_kernel": by_kernel,
           "launches_per_forward_step": sum(by_kernel.values()) / forward_steps}
    log("[e1] f32 over HTTP " + json.dumps(res))
    srv.close()
    if bad or lp_err > 1e-6:
        raise AssertionError(f"[e1] HTTP streams leave the in-process ones at no near-tie "
                             f"({bad[:4]}) or token_logprobs off the tap's by {lp_err}")
    del engine, core
    gc.collect()
    torch.cuda.empty_cache()
    return res


def head_request(port: int, path: str) -> tuple[int, dict, bytes]:
    """HEAD ``path`` with ``Connection: close``: (status, headers, every byte
    the server sent after the head until it closed)."""
    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"HEAD {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     "Connection: close\r\n\r\n".encode())
        try:
            raw = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
            rest = await asyncio.wait_for(reader.read(), 10)
        finally:
            writer.close()
        hdrs = {k.strip().lower(): v.strip() for k, _, v in
                (ln.partition(":") for ln in raw[1:] if ln)}
        return int(raw[0].split(" ")[1]), hdrs, rest
    return asyncio.run(go())


def observability_routes(port: int, metrics_text: str) -> dict:
    """(e3)'s observability checks on a service whose engine has served:
    /debug/sched and /debug/mem answer 200 with the JAX documents' keys
    and a non-empty step ring / device tier; /metrics carries the engine's
    perf, sched and mem families; HEAD /health answers 200 with no body; a
    chat sent with a traceparent shows the engine's queue, prefill and
    decode spans under its trace id in /debug/traces."""
    sched_keys = {"enabled", "env", "totals", "recent_steps", "goodput_trend",
                  "top_culprits", "trace_culprits"}
    mem_keys = {"enabled", "env", "totals", "top_owners", "churn_trend", "rates", "ttx",
                "last_audit"}
    docs = {}
    for path, keys in (("/debug/sched", sched_keys), ("/debug/mem", mem_keys)):
        r = asyncio.run(http_call(port, "GET", path))
        doc = json.loads(r["body"]) if r["status"] == 200 else {}
        if r["status"] != 200 or set(doc) != keys:
            raise AssertionError(f"[e3] {path}: {r['status']} keys {sorted(doc)}")
        docs[path] = doc
    if not docs["/debug/sched"]["recent_steps"] or \
            docs["/debug/mem"]["totals"]["tiers"].get("device", {}).get("blocks") is None:
        raise AssertionError(f"[e3] empty ledger documents: {json.dumps(docs)[:600]}")
    families = {"dynamo_engine_perf_mfu", "dynamo_sched_goodput_fraction",
                "dynamo_mem_device_blocks"}
    missing = sorted(f for f in families if f not in metrics_text)
    if missing:
        raise AssertionError(f"[e3] /metrics lacks {missing}")
    head = head_request(port, "/health")
    if head[0] != 200 or head[2] != b"" or "content-length" not in head[1]:
        raise AssertionError(f"[e3] HEAD /health: {head}")
    trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
    r = asyncio.run(http_call(port, "POST", "/v1/chat/completions", {
        "model": HTTP_MODEL, "max_tokens": 8, "temperature": 0,
        "messages": [{"role": "user", "content": "trace me"}]},
        headers={"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"}))
    spans = asyncio.run(http_call(port, "GET",
                                  f"/debug/traces?format=jsonl&trace_id={trace_id}"))
    names = [json.loads(ln)["name"] for ln in spans["body"].decode().splitlines() if ln]
    if r["status"] != 200 or not {"engine.queue", "engine.prefill", "engine.decode"} <= set(names):
        raise AssertionError(f"[e3] traced chat {r['status']}: spans {names}")
    sched = docs["/debug/sched"]
    return {"sched_steps": sched["totals"]["steps_total"],
            "goodput_fraction": sched["totals"]["goodput_fraction"],
            "mem_device_tier": docs["/debug/mem"]["totals"]["tiers"]["device"],
            "head_health": [head[0], head[1].get("content-length"), len(head[2])],
            "trace_spans": names}


def phase_http_bf16(smi: str, b_tok_s: float) -> dict:
    """(e2)-(e4) on one bf16 llama-3-8b-lite engine behind the HTTP service.

    (e2): after a full warmup, 32 concurrent streaming /v1/completions (128
    prompt ids, 64 greedy tokens), from a client in this process and then
    from one in its own process: decode tok/s and TTFT (all 32) measured
    at the client as PERF.md §2 defines them, beside (b)'s in-process
    tok/s, each thread's CPU seconds and the frontend's own TTFT / ITL
    histograms (p50 / p99). Every stream must carry 64 tokens and a finish
    reason.

    (e3): 4 json_object and 2 json_schema chats (every stopped document
    conforms, one cut by length is a grammatical prefix; masked graphs
    replay); /v1/embeddings of 8 token lists (7-128) equal to an
    in-process ``engine.embed`` of the same batch within one bf16 rounding,
    8 mma_bf16 launches; a chat with an image part through a stub encoder
    (rows of the model's own embedding table) answers 200 through a
    replayed mm graph, twice the same; without an encoder 501; /health,
    /v1/models and /metrics answer, and frontend_requests_total{status=
    "200"} counts the 200s sent.

    (e4): a streaming request cut by the client after 4 chunks: within 1 s
    the engine holds no seq and the pool's free blocks are back."""
    from dynamo_tpu_torch.engine.guided import JsonMachine, validate_json_output
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults
    from dynamo_tpu_torch.utils.metrics import metric_sum, parse_prometheus

    batch, prompt, decode = 32, 128, 64
    engine, setup_s = http_engine(HTTP_MODEL, decode)
    core = engine.core
    table = core.runner.params["embed"]
    image_rows = table[torch.tensor(IMAGE_IDS, device=table.device)].float().cpu().numpy()

    async def image_encoder(images):
        return [image_rows for _ in images]

    taps: dict = {}
    models = ModelManager()
    defaults = dict(max_model_len=prompt + decode + 16, default_max_tokens=decode)
    models.register(HTTP_MODEL, wide_tokenizer(), tapped(engine.generate, taps),
                    defaults=ModelDefaults(**defaults), stats=engine.stats,
                    embed=engine.embed, image_encoder=image_encoder)
    models.register(HTTP_NOENC, wide_tokenizer(), engine.generate,
                    defaults=ModelDefaults(**defaults), stats=engine.stats)
    srv = HttpServing(models, engine)
    sent_200 = 0
    hi = core.model_cfg.vocab_size - 5

    # (e2)
    prompts = [[(7 * i + 11 * j) % hi + 5 for j in range(prompt)] for i in range(batch)]
    bodies = {f"e2-{i}": {"model": HTTP_MODEL, "prompt": p, "max_tokens": decode,
                          "temperature": 0, "ignore_eos": True, "stream": True,
                          "stream_options": {"include_usage": True}}
              for i, p in enumerate(prompts)}
    e2 = {"model": HTTP_MODEL, "requests": batch, "prompt": prompt, "decode": decode,
          "setup_s": setup_s, "in_process_b_decode_tok_s": b_tok_s}
    for where in ("client_in_process", "client_own_process"):
        own = where == "client_own_process"
        reqs = {f"{rid}-own" if own else rid: body for rid, body in bodies.items()}
        threads = {"event_loop": srv.thread, "engine": engine._thread}
        if not own:
            threads["client"] = threading.main_thread()
        cpu0 = thread_cpu_s(threads)
        if own:
            t_start, sums, client_cpu = client_in_own_process(srv.port, reqs)
        else:
            t_start, sums, client_cpu = throughput_clients(srv.port, reqs)
        cpu = {k: v - cpu0[k] for k, v in thread_cpu_s(threads).items()}
        if own:
            cpu["client_process"] = client_cpu
        for rid, (status, s) in zip(reqs, sums):
            if (status != 200 or s["usage"]["completion_tokens"] != decode
                    or s["finish"] is None or len(taps[rid]["ids"]) != decode):
                raise AssertionError(f"[e2] {rid}: status {status}, usage {s['usage']}, "
                                     f"finish {s['finish']}")
        sent_200 += batch
        t_first = max(s["first"] for _, s in sums)
        t_end = max(s["last"] for _, s in sums)
        e2[where] = {"decode_tok_s": batch * (decode - 1) / (t_end - t_first),
                     "ttft_all_s": t_first - t_start, "wall_s": t_end - t_start,
                     "cpu_s": cpu}
        if not own:
            text = asyncio.run(http_call(srv.port, "GET", "/metrics"))["body"].decode()
            e2["frontend_ttft_s"] = histogram_quantiles(
                text, "dynamo_frontend_time_to_first_token_seconds")
            e2["frontend_itl_s"] = histogram_quantiles(
                text, "dynamo_frontend_inter_token_latency_seconds")
    log("[e2] bf16 over HTTP " + json.dumps(e2))
    log(f"[e2] decode tok/s over HTTP {e2['client_in_process']['decode_tok_s']} (client in "
        f"this process), {e2['client_own_process']['decode_tok_s']} (client in its own "
        f"process) against (b) in-process {b_tok_s}; TTFT (all 32) "
        f"{e2['client_in_process']['ttft_all_s']} / {e2['client_own_process']['ttft_all_s']} s; "
        f"on {smi}")

    # (e3) guided chats
    schemas = [{}] * 4 + [GUIDED_SCHEMA] * 2
    masked0 = {k: p.calls for k, p in core.runner.programs.items() if "masked" in k[5:]}

    async def guided():
        return await asyncio.gather(*(http_call(srv.port, "POST", "/v1/chat/completions", {
            "model": HTTP_MODEL, "max_tokens": 48, "temperature": 0,
            "messages": [{"role": "user", "content": f"give me JSON number {i}"}],
            "response_format": ({"type": "json_object"} if not s else
                                {"type": "json_schema", "json_schema": {"schema": s}})})
            for i, s in enumerate(schemas)))

    counts = {"stop": 0, "length": 0}
    for s, r in zip(schemas, asyncio.run(guided())):
        if r["status"] != 200:
            raise AssertionError(f"[e3] guided chat: {r['status']} {r['body'][:300]}")
        ch = json.loads(r["body"])["choices"][0]
        text = ch["message"].get("content") or ""
        if ch["finish_reason"] == "stop":
            validate_json_output(text, s)
        elif ch["finish_reason"] == "length":
            JsonMachine(s).feed_str(text)
        else:
            raise AssertionError(f"[e3] guided chat finished {ch['finish_reason']}")
        counts[ch["finish_reason"]] += 1
    sent_200 += len(schemas)
    masked = {k: p for k, p in core.runner.programs.items() if "masked" in k[5:]}
    replayed = sum(p.calls - masked0.get(k, 0) for k, p in masked.items()
                   if p.graph is not None)
    if replayed <= 0:
        raise AssertionError(f"[e3] masked programs {list(masked)} replayed {replayed} times")

    # (e3) embeddings
    lens = [7, 16, 23, 40, 64, 90, 111, 128]
    texts = [[(29 * n + 3 * j) % hi + 5 for j in range(k)] for n, k in enumerate(lens)]
    pa.reset_launches()
    r = asyncio.run(http_call(srv.port, "POST", "/v1/embeddings",
                              {"model": HTTP_MODEL, "input": texts}))
    emb_launches = dict(pa.paged_attention.launches_by_kernel)
    if r["status"] != 200:
        raise AssertionError(f"[e3] embeddings: {r['status']} {r['body'][:300]}")
    sent_200 += 1
    got = torch.tensor([d["embedding"] for d in json.loads(r["body"])["data"]])
    ref = torch.from_numpy(srv.run(engine.embed(texts))).double()
    emb_err = ((got - ref).abs() / (ULP_REL * ref.abs() + ULP_ABS)).max().item()
    route = pa.ROUTES[(torch.bfloat16, "float")]
    want = {k: (core.model_cfg.num_layers if k == route else 0) for k in emb_launches}
    if tuple(got.shape) != (len(texts), core.model_cfg.hidden_size) or emb_err > 1.0 \
            or emb_launches != want:
        raise AssertionError(f"[e3] embeddings: shape {tuple(got.shape)}, err/limit "
                             f"{emb_err}, launches {emb_launches} (expected {want})")

    # (e3) image parts
    url = "data:image/png;base64," + base64.b64encode(b"one image's bytes").decode()
    chat = {"model": HTTP_MODEL, "max_tokens": 16, "temperature": 0, "messages": [
        {"role": "user", "content": [{"type": "text", "text": "what is in it?"},
                                     {"type": "image_url", "image_url": {"url": url}}]}]}
    mm0 = {k: p.calls for k, p in core.runner.programs.items() if "mm" in k[5:]}
    answers = []
    for n in range(2):
        r = asyncio.run(http_call(srv.port, "POST", "/v1/chat/completions", chat,
                                  headers={"x-request-id": f"e3-img-{n}"}))
        if r["status"] != 200:
            raise AssertionError(f"[e3] image chat: {r['status']} {r['body'][:300]}")
        answers.append((json.loads(r["body"])["choices"][0]["message"]["content"],
                        taps[f"e3-img-{n}"]["ids"]))
    sent_200 += 2
    mm_replays = sum(p.calls - mm0.get(k, 0) for k, p in core.runner.programs.items()
                     if "mm" in k[5:] and p.graph is not None)
    noenc = asyncio.run(http_call(srv.port, "POST", "/v1/chat/completions",
                                  {**chat, "model": HTTP_NOENC}))["status"]
    if answers[0] != answers[1] or mm_replays <= 0 or noenc != 501:
        raise AssertionError(f"[e3] image chats equal: {answers[0] == answers[1]}, mm "
                             f"replays {mm_replays}, without an encoder {noenc}")

    # (e3) the other routes
    routes = {p: asyncio.run(http_call(srv.port, "GET", p))
              for p in ("/health", "/v1/models", "/metrics")}
    if any(r["status"] != 200 for r in routes.values()) or \
            json.loads(routes["/v1/models"]["body"])["data"][0]["id"] != HTTP_MODEL:
        raise AssertionError(f"[e3] routes: {[(p, r['status']) for p, r in routes.items()]}")
    counted = metric_sum(parse_prometheus(routes["/metrics"]["body"].decode()),
                         "dynamo_frontend_requests_total", status="200")
    if counted != sent_200:
        raise AssertionError(f"[e3] frontend_requests_total{{status=200}} {counted}, "
                             f"sent {sent_200}")
    obs = observability_routes(srv.port, routes["/metrics"]["body"].decode())
    e3 = {"guided_finished": counts, "masked_replays": replayed,
          "embeddings_err_over_limit": emb_err, "embeddings_launches": emb_launches,
          "image_rows": len(IMAGE_IDS), "mm_replays": mm_replays, "image_answer": answers[0][0],
          "no_encoder_status": noenc, "requests_200": counted, "observability": obs}
    log("[e3] routes " + json.dumps(e3))

    # (e4) disconnect
    deadline = time.monotonic() + 30
    while core.sched.has_work() and time.monotonic() < deadline:
        time.sleep(0.01)
    free0 = core.pool.num_free
    max_tokens = decode + prompt - 16

    async def cut():
        return await http_call(srv.port, "POST", "/v1/completions", {
            "model": HTTP_MODEL, "prompt": prompts[0][:16], "max_tokens": max_tokens,
            "temperature": 0, "ignore_eos": True, "stream": True},
            headers={"x-request-id": "e4-cut"}, cut_after=4)

    asyncio.run(cut())
    t_cut = time.monotonic()
    while (core.sched.has_work() or core.pool.num_free != free0) and \
            time.monotonic() - t_cut < 1.0:
        time.sleep(0.002)
    freed_s = time.monotonic() - t_cut
    tap = taps["e4-cut"]
    e4 = {"freed_after_s": freed_s, "tokens_before_abort": len(tap["ids"]),
          "max_tokens": max_tokens, "finish": tap["finish"], "pool_free": [free0,
                                                                         core.pool.num_free]}
    log("[e4] disconnect " + json.dumps(e4))
    if core.sched.has_work() or core.pool.num_free != free0 or tap["finish"] is not None \
            or len(tap["ids"]) >= max_tokens:
        raise AssertionError(f"[e4] the cut request was not aborted within 1 s: {e4}")
    srv.close()
    del engine, core, table
    gc.collect()
    torch.cuda.empty_cache()
    return {"e2": e2, "e3": e3, "e4": e4}


# ---------------------------------------------------------------------------
# (f) SLO-sized prefill chunks at full width
# ---------------------------------------------------------------------------

#: (f)'s engine: llama-3-8b-lite in bf16 with prefill_chunk=0 sized against
#: a 50 ms ITL budget, max_model_len 2048 (the chunk ladder reaches 2048),
#: the default max_tokens_per_step (8192: (f)'s step of 32 decode rows and
#: 4 chunks of 1,536, 6,176 tokens, fits) and max_batch_size (64, so the
#: decode ladder's largest row bucket is 64, which its 36 rows need): its
#: largest step is [64, 2048], 131,072 token rows, whose graph holds most
#: of the graph pool, over PERF.md's limit (ROADMAP Queue 1, the padded
#: mixed step).
SLO_CFG = dict(model="llama-3-8b-lite", block_size=16, max_model_len=2048, prefill_chunk=0,
               itl_slo_ms=50.0, kv_dtype="bfloat16", allow_random_weights=True,
               warmup_mode="full")
#: the ledgers' own gates, all off for (f)'s second run
LEDGER_GATES = ("DYN_SCHED_LEDGER", "DYN_MEM_LEDGER", "DYN_PERF_PROFILE")
#: (f)'s late prompts: 4 of 1,536 tokens, 4 greedy tokens each
LATE, LATE_PROMPT, LATE_DECODE = 4, 1536, 4


async def serve_with_late(engine, reqs: dict, late: dict, after=None):
    """Send ``reqs`` at once; when every one of them has two tokens (its
    first decode step is done), send ``late``. Collect each stream's tokens
    and the arrival time of each token; then await ``after(engine)`` and
    shut the engine down. Returns (start, time the late ones were sent,
    {key: (tokens, times)}, ``after``'s result)."""
    streams: dict = {}
    started = asyncio.Event()
    need = set(reqs)

    async def one(key, req):
        toks, times = [], []
        async for out in engine.generate(req):
            if out.error:
                raise RuntimeError(f"request {key} failed: {out.error}")
            now = time.perf_counter()
            for t in out.token_ids:
                toks.append(t)
                times.append(now)
            if len(toks) >= 2 and key in need:
                need.discard(key)
                if not need:
                    started.set()
        streams[key] = (toks, times)

    t_start = time.perf_counter()
    try:
        first = [asyncio.ensure_future(one(k, r)) for k, r in reqs.items()]
        await started.wait()
        t_late = time.perf_counter()
        await asyncio.gather(*first, *(one(k, r) for k, r in late.items()))
        extra = await after(engine) if after is not None else None
    finally:
        await engine.shutdown()
    return t_start, t_late, streams, extra


def ewma(values: list[float]) -> float | None:
    """The step profiler's moving average over ``values``."""
    from dynamo_tpu_torch.obs.profiler import ewma_step

    out = None
    for v in values:
        out = ewma_step(out, v)
    return out


def slo_run(ledgers: bool) -> dict:
    """One (f) run: (b)'s 32 x (128 + 64 greedy), and after their first
    decode step 4 prompts of 1,536 tokens (4 greedy tokens each), on a
    fresh engine after a full warmup; with the ledgers' gates off when
    ``ledgers`` is False."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
    from dynamo_tpu_torch.obs.sched_ledger import get_sched_ledger
    from dynamo_tpu_torch.obs.tracer import get_tracer
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.utils.config import EngineConfig

    batch, prompt, decode = 32, 128, 64
    tag = "[f]" if ledgers else "[f] ledgers off"
    saved = {k: os.environ.get(k) for k in LEDGER_GATES}
    if not ledgers:
        os.environ.update({k: "0" for k in LEDGER_GATES})
    try:
        get_sched_ledger().reset()
        get_mem_ledger().reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = build_engine(EngineConfig(**SLO_CFG))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    core = engine.core
    warm = core.warmup_summary
    if warm["failed"] or warm["deadline_skipped"] or warm["coverage"] != 1.0:
        raise AssertionError(f"{tag}: warmup left buckets without a graph: {warm}")
    gates = (core.sched_led.enabled, core.mem_led.enabled, core.perf.enabled)
    if (not all(gates)) if ledgers else any(gates):
        raise AssertionError(f"{tag}: ledger gates sched={core.sched_led.enabled} "
                             f"mem={core.mem_led.enabled} perf={core.perf.enabled}")
    vocab = core.model_cfg.vocab_size
    hi = vocab - 5

    def req(rid, ids, n):
        return PreprocessedRequest(
            token_ids=ids, request_id=rid,
            stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0))

    reqs = {i: req(f"slo-{i}", [(7 * i + 11 * j) % hi + 5 for j in range(prompt)], decode)
            for i in range(batch)}
    late = {f"late-{i}": req(f"slo-late-{i}", [(13 * i + 3 * j) % hi + 5
                                               for j in range(LATE_PROMPT)], LATE_DECODE)
            for i in range(LATE)}

    async def after(engine):
        # every stream finished: the pool's blocks are back and the audit
        # finds no pin without a live owner (before shutdown drops the
        # engine's live-id source)
        pool, mled = engine.core.pool, engine.core.mem_led
        return {"pool_free": pool.num_free, "pool_usable": pool.num_blocks - 1,
                "stream_pins": mled.owner_blocks()["stream"] if mled.enabled else None,
                "audit": mled.audit() if mled.enabled else None}

    warmed = set(core.runner.programs)
    pa.reset_launches()
    epoch0 = time.time()
    t_start, t_late, streams, fin = asyncio.run(serve_with_late(engine, reqs, late, after))
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    minted = sorted(set(core.runner.programs) - warmed)
    if minted:
        raise AssertionError(f"{tag}: serving made graphs {minted}")
    route = pa.ROUTES[(torch.bfloat16, "float")]
    forward_steps = check_engine_launches(tag, core, by_kernel, route)
    for key, (toks, _) in streams.items():
        want = LATE_DECODE if str(key).startswith("late") else decode
        if len(toks) != want or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{tag} {key}: {len(toks)} tokens, expected {want}")
    if fin["pool_free"] != fin["pool_usable"]:
        raise AssertionError(f"{tag}: {fin['pool_usable'] - fin['pool_free']} blocks not back")
    if ledgers and (fin["stream_pins"] or fin["audit"]["orphan_pins"]):
        raise AssertionError(f"{tag}: stream pins {fin['stream_pins']}, audit {fin['audit']}")
    dec = [streams[i] for i in range(batch)]
    t_first = max(times[0] for _, times in dec)
    t_end = max(times[-1] for _, times in dec)
    t_late_first = max(streams[k][1][0] for k in late)
    # the decode rows' ITL: each decoder's gap between two tokens while the
    # late prompts prefilled (their send to their first token), against its
    # gaps in the decode-only steps before and after
    mixed_gaps, plain_gaps = [], []
    for _, times in dec:
        gaps = list(zip(times, times[1:]))
        mixed_gaps.append(max((b - a for a, b in gaps if b > t_late and a < t_late_first),
                              default=0.0))
        plain_gaps += [b - a for a, b in gaps if b <= t_late or a >= t_late_first]
    plain_gaps.sort()
    # decode tok/s of the decode-only steps after the mixed step(s)
    after = sum(sum(t > t_late_first for t in times) for _, times in dec)
    res = {
        "engine": {k: v for k, v in SLO_CFG.items() if k != "allow_random_weights"},
        "chunk_by_qos": core.chunk_by_qos, "hw": core._hw.name,
        "device_name": core.device_name, "resolved_prefill_chunk": core.engine_cfg.prefill_chunk,
        "setup_s": setup_s, "warmup_s": warm["seconds"], "graphs": len(warmed),
        "graph_pool_gib": warm["graph_pool_gib"],
        "graph_pool_share_of_card": warm["graph_pool_gib"] * 2**30
        / torch.cuda.get_device_properties(0).total_memory,
        "graph_pool_top": warm["graph_pool_top"],
        "forward_steps": forward_steps, "launches": by_kernel,
        "decode_tok_s": batch * (decode - 1) / (t_end - t_first),
        "decode_tok_s_after_mixed": after / (t_end - t_late_first),
        "itl_decode_only_median_s": plain_gaps[len(plain_gaps) // 2] if plain_gaps else None,
        "itl_during_late_prefill_s": {"median": sorted(mixed_gaps)[batch // 2],
                                      "max": max(mixed_gaps)},
        "late_ttft_all_s": t_late_first - t_late, "pool": fin,
    }
    if ledgers:
        from dynamo_tpu_torch.obs import costmodel as cm

        snap = core.sched_led.snapshot(steps=True)
        # the unified steps that carried prefill chunks under decode rows
        mixed_recs = [r for r in core.sched_led.steps
                      if "mixed" in r.kinds and r.decode_rows and r.prefill_rows]
        preds = []
        for r in mixed_recs:
            chunk = r.live_tokens - r.decode_rows
            kw = dict(decode_rows=r.decode_rows, decode_kv_len=prompt + decode,
                      chunk_kv_len=min(chunk, LATE_PROMPT), block_size=16)
            preds.append({
                "decode_rows": r.decode_rows, "prefill_rows": r.prefill_rows,
                "live_tokens": r.live_tokens, "sched_tokens": r.sched_tokens,
                "goodput": r.goodput, "wall_s": r.wall_s, "hol_stall_s": r.hol_stall_s,
                "predicted_mixed_step_s": cm.mixed_step_seconds(
                    core.model_cfg, core._hw, chunk=chunk, **kw),
                "predicted_pure_decode_s": cm.mixed_step_seconds(
                    core.model_cfg, core._hw, chunk=0, **kw),
                "padded_bound_s": r.sched_flops / core._hw.peak_flops})
        if not mixed_recs:
            raise AssertionError(f"{tag}: no mixed step formed: {snap['steps'][-8:]}")
        ring = [r for r in get_tracer().recorder.steps.snapshot() if r.ts >= epoch0]
        kinds = {"decode_only": [r for r in ring if r.decode_tokens and not r.prefill_tokens],
                 "mixed": [r for r in ring if r.decode_tokens and r.prefill_tokens]}
        res["perf_ewma"] = {k: {f: ewma([getattr(r, f) for r in rs])
                                for f in ("mfu", "bw_util", "roofline_frac", "tok_s")}
                            | {"steps": len(rs)} for k, rs in kinds.items()}
        # shares of the device's time for each step: none can pass 1
        shares = {f: max(getattr(r, f) for r in ring)
                  for f in ("mfu", "bw_util", "roofline_frac")}
        res["perf_step_max"] = shares
        if not all(0.0 < v <= 1.0 for v in shares.values()) or not all(kinds.values()):
            raise AssertionError(f"{tag}: step profiler shares out of (0, 1]: {shares}, "
                                 f"steps by kind {[len(v) for v in kinds.values()]}")
        res["sched"] = {k: snap[k] for k in (
            "steps_total", "goodput_fraction", "goodput_mean_recent", "live_tokens_total",
            "sched_tokens_total", "padding_flops_total", "padding_hbm_bytes_total",
            "hol_stall_seconds_total", "hol_victims_total", "top_culprits",
            "prefill_chunk_tokens", "admission_blocked")}
        res["mixed_steps"] = preds
        res["mem"] = core.mem_led.snapshot()
    log(f"{tag} " + json.dumps(res, default=str))
    del engine, core
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_slo(smi: str, b_tok_s: float) -> dict:
    """(f): llama-3-8b-lite in bf16 with ``prefill_chunk=0`` (SLO-sized
    chunks: ``itl_slo_ms=50``, ``max_model_len=2048``) after a full warmup,
    serving (b)'s 32 x (128 + 64 greedy) with 4 prompts of 1,536 tokens
    arriving after the first decode step, so mixed steps form under the
    decoders. It must launch ``mma_bf16`` only, 8 a forward step through
    replays, make no graph while serving, finish every stream with its
    tokens, give every block back, and leave the leak audit at 0 orphan
    pins. Prints the resolved ``chunk_by_qos`` and hardware row, warmup
    seconds and graph-pool growth, decode tok/s, the decode rows' ITL
    during the mixed steps against ``costmodel.mixed_step_seconds``, the
    scheduling ledger's goodput, padding and HOL culprits, the memory
    ledger's snapshot, and the step profiler's EWMA (MFU, HBM share,
    roofline fraction over each step's device time) of the decode-only and
    of the mixed steps; they must lie in [0, 1]. Then the same
    traffic on a fresh engine with the ledgers' gates off
    (``DYN_SCHED_LEDGER=0 DYN_MEM_LEDGER=0 DYN_PERF_PROFILE=0``): both
    decode tok/s."""
    from dynamo_tpu_torch.engine.engine import GRAPH_POOL_SHARE

    on = slo_run(True)
    off = slo_run(False)
    summary = {
        "chunk_by_qos": on["chunk_by_qos"], "hw": on["hw"],
        "decode_tok_s": {"ledgers_on": on["decode_tok_s"], "ledgers_off": off["decode_tok_s"],
                         "b_in_process": b_tok_s},
        "decode_tok_s_after_mixed": {"ledgers_on": on["decode_tok_s_after_mixed"],
                                     "ledgers_off": off["decode_tok_s_after_mixed"]},
        "itl_decode_only_median_s": {"ledgers_on": on["itl_decode_only_median_s"],
                                     "ledgers_off": off["itl_decode_only_median_s"]},
        "itl_during_late_prefill_s": on["itl_during_late_prefill_s"],
        "predicted_mixed_step_s": [m["predicted_mixed_step_s"] for m in on["mixed_steps"]],
        "warmup_s": [on["warmup_s"], off["warmup_s"]],
        "graph_pool_gib": [on["graph_pool_gib"], off["graph_pool_gib"]],
        "graph_pool_share_of_card": on["graph_pool_share_of_card"],
        "graph_pool_over_limit": on["graph_pool_share_of_card"] > GRAPH_POOL_SHARE,
        "graph_pool_top": on["graph_pool_top"][:4],
        "perf_ewma": on["perf_ewma"],
    }
    log(f"[f] summary {json.dumps(summary)} on {smi}")
    return {"on": on, "off": off}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dynamo_tpu_torch.ops import build
    from dynamo_tpu_torch.ops.paged_attention import ROUTES

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    bw, peak = card_rates(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"sms {torch.cuda.get_device_properties(0).multi_processor_count}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f}s")
    for kname in libs:
        for r in build.ptxas_report(kname):
            log(f"  ptxas {kname} {r['kernel']}: {r.get('registers')} registers, spill "
                f"stores {r.get('spill_stores')} B, loads {r.get('spill_loads')} B")

    kern = phase_kernels(bw, peak)
    profile = "--profile" in sys.argv[1:]
    serve, streams = {}, {}
    for kind in KV_DTYPES:
        serve[kind], streams[kind] = phase_serve(kind, profile=profile)
    _, win_streams = phase_serve("float", profile=profile, window=4)
    differ = [i for i in streams["float"] if win_streams[i] != streams["float"][i]]
    log(f"[b'] decode_window=4 greedy streams equal to (b)'s bf16 streams: "
        f"{len(streams['float']) - len(differ)} of {len(streams['float'])}")
    if differ:
        raise AssertionError(f"[b'] streams {differ} differ from decode_window=1's")
    serve_f32, _ = phase_serve("float", profile=profile, f32=True)
    log(f"[b''] f32 llama-3-8b-lite decode tok/s {serve_f32['decode_tok_s']} on {smi}, "
        f"{serve_f32['launches_per_forward_step']} launches of "
        f"{ROUTES[(torch.float32, 'float')]} a forward step")
    coherence = phase_coherence()
    phase_spec(True, smi)
    phase_spec(False, smi, serve["float"]["decode_tok_s"])
    phase_guided()
    phase_mm_embed()
    phase_http_f32()
    phase_http_bf16(smi, serve["float"]["decode_tok_s"])
    phase_slo(smi, serve["float"]["decode_tok_s"])
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")

    lines = []
    for (q_dtype, kind), route in ROUTES.items():
        rows = kern[route]
        main_shape = rows[MAIN_CASE]
        if q_dtype == torch.bfloat16:
            launches, run = serve[kind]["launches_by_kernel"][route], "(b) serving"
        elif kind == "float":
            launches, run = serve_f32["launches_by_kernel"][route], "(b'') f32 serving"
        else:
            launches = coherence[KV_DTYPES[kind]]["f32_launches_by_kernel"][route]
            run = "(c) f32 coherence"
        lines.append({
            "name": route, "route": "cuda",
            "source": SOURCE,
            "replaces": "dynamo_tpu/ops/paged_attention.py:314",
            "q_dtype": str(q_dtype).removeprefix("torch."),
            "cache": str(q_dtype).removeprefix("torch.") if kind == "float" else kind,
            "launches": launches, "launched_in": run,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "err_over_limit": max(r["err_over_limit"] for r in rows.values()),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "verify_ms": rows[verify_case(VERIFY_TS[-1])]["ms"], "tol": TOL,
            "err_limit": main_shape["err_limit"], "pass": True,
        })
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
