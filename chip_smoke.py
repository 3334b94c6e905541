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
    over 3 calls), and at the attention shapes of the MoE runs (j1) and
    (j2): gpt-oss's prefill step (B=16, T=128, H=64, KH=8, D=64) and
    deepseek-moe's GQA group of 16 (H=128, KH=8, D=128) at decode (B=8,
    kv 64-80) and at prefill (B=8, T=64). q is drawn in f32; the f32
    cache holds full-precision f32 draws of K and V, the bf16 cache the
    same draws rounded to bf16. bf16-q
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
    then the same traffic on the same engine and graphs with the ledgers'
    gates off, as ``DYN_SCHED_LEDGER=0 DYN_MEM_LEDGER=0
    DYN_PERF_PROFILE=0`` give, its prefix cache emptied (decode tok/s
    beside the first run's).

(g) the KVBM tiers, sessions, stream checkpoints and blocks across
    engines at llama-3-8b-lite width (8 layers, random weights from a
    seed; each serving run enters all its requests before its first step,
    and must launch its route's kernel only, 8 a forward step, counted
    through replays). First, at the model's block geometry on the card,
    ``extract`` of ``inject(x)`` must be ``x`` byte for byte at every kv
    dtype, written in place, and bf16 blocks the card quantizes into an
    int8 or int4 cache must equal the CPU's ``quantize_block``. (g1) per kv
    dtype: set A (16 greedy requests, 1024-token prompts, 32 tokens), set
    B of the same shape on a device pool of one working set, evicting A to
    a host tier (``host_kv_blocks``), then A again: it must onboard A's
    blocks, prefill only each prompt's last block, replay graphs captured
    before the first inject, keep the cache tensors where they were, and
    equal A's second run on an engine whose pool kept A; again in bf16 with
    a host tier of an eighth of a working set over a disk tier in a
    temporary directory (blocks must reach the disk and come back). Prints
    the transfers' D2H and H2D bytes/s and the flushes that waited for a
    step in flight, and their ms. (g2) a ``RemoteBlockServer`` on 127.0.0.1 in a thread of its own:
    a bf16 engine with ``global_prefix_cache`` publishes 8 prompts; an int8
    engine onboards them from the store, its blocks equal to the CPU's
    ``quantize_block`` of the stored bytes and its streams to int8 engines
    into which the same blocks were imported (quantized on the CPU, and as
    bf16 blocks the card quantizes, equal to the CPU's bytes too);
    ``export_blocks`` into another bf16 engine's ``import_blocks`` gives the
    exporting engine's continuation. (g3) 16 sessions: turn 2 prefills only
    its suffix and equals an engine without sessions, its TTFT printed
    beside a full recompute's; the memory ledger shows ``session`` pins;
    after the TTL they demote to the host tier (no pin, no orphan), and
    turn 3 re-imports them and equals the engine without sessions. (g4) in
    f32 over the remote store with ``stream_ckpt_blocks=1``: a greedy and a
    seeded sampled stream cut by shutting the engine down, resumed from
    their records on a fresh engine, must equal an uninterrupted run token
    for token; a finished stream's record is gone.

(i1) weight-only int8 at full width, after (c), with (i2) and (j) next:
    (b)'s bf16 run (llama-3-8b-lite,
    bf16 cache, full warmup, 32 x (128 prompt + 64 greedy)) with the
    weights quantized to int8 (``quantization="int8"``): ``mma_bf16`` only,
    8 a forward step through replays, no graph made while serving; prints
    decode tok/s, TTFT, weight bytes, memory (peak from the build on, peak
    while serving, allocated and reserved once built) and the KV blocks
    the engine's free-memory rule would size without its cap, beside (b)'s;
(i2) tiny-real-llama at f32 with int8 weights: its greedy tokens on the
    card must equal the plain path's on the CPU, through ``mma_f32`` only;
    the bf16 int8 continuation of "one two three four" is printed;
(j1) the MoE family at full layer width: gpt-oss-120b (128 experts, top
    4, H=2880, head dim 64) cut to 4 layers, random bf16 weights from a
    seed (the expert stacks drawn a slab at a time), the bf16 cache,
    lazily captured graphs, legacy steps whose prefill takes at most 2048
    token rows: 32 x (128 prompt + 32 greedy) through ``build_engine`` and
    ``AsyncTorchEngine.generate``, ``mma_bf16`` only, 4 a forward step;
    prints decode tok/s, TTFT and peak memory; (j2) deepseek-moe (256
    experts, top 8, a shared expert, H=7168) cut to 1 layer, 8 x (64 + 16)
    in steps of at most 512 rows, 1 launch a forward step; (j3) tiny-moe at
    f32, with and without int8 weights: greedy tokens on the card equal the
    CPU plain path's, through ``mma_f32`` only;

(a') tensor-parallel attention, right after (a): ``paged_attention_sharded``
    (one launch a rank on that rank's heads, the per-rank launch of the
    engine's ranks) at tp 2, 4 and 8 on all six routes, at the decode
    shape and the 128-token prefill of (a): at the unsharded launch's split
    count it must equal that launch bit for bit, with each rank's own split
    choice keep the route's limit against the plain version, and launch
    the route's kernel once a rank. Prints one rank's kernel time on its
    local heads (also at the unsharded split count where the rank chooses
    another), its bound, SDPA on the same heads and, at tp=2, the plain
    version;
(h) tensor parallelism at full width: llama-3-8b-lite cut to 4 layers at
    tp=2 as two processes on cuda:0 over gloo (``dist_backend="gloo"``,
    ``tp_devices=(0, 0)``, eager steps, an explicit KV pool), each rank
    building the full weights from the seed and keeping its shard, through
    ``build_engine`` and ``AsyncTorchEngine.generate``, 32 x (128 prompt +
    32 greedy). Every rank's counts are set to 0 just before each run and
    read just after: each rank must launch its route's kernel only, 4 a
    forward step, on 16 of the 32 heads and 4 of the 8 kv heads. (h1) f32
    weights over the f32 cache: every stream must equal a tp=1 engine's or
    first differ at a near-tie; with two cards or more, again over nccl,
    one card a rank (with one card a line says it was not run). (h2) bf16
    over the bf16 and int8 caches: decode tok/s and TTFT beside (b)'s (8
    layers), and each rank's milliseconds of collectives a step (no speed
    condition).
(i3) after (h): (h1)'s f32 model with int8 weights at tp=2 (each rank
    quantizing its shard, the row-parallel scales over the group) against
    tp=1 int8, by (h1)'s stream rule.
(k) the distributed deployment, last: the port's coordinator, frontend
    (``--router-mode kv`` on 127.0.0.1) and four llama-3-8b-lite workers
    on cuda:0 as processes (each ``--allow-random-weights --num-blocks N``,
    full warmup): two at f32 over the f32 cache (component ``f32``) and
    two at bf16 (component ``bf16``), spoken to over HTTP with the stdlib.
    A tokenizer whose every id is the text `` t<id>`` lets the client read
    the ids back. Each worker publishes its launches by route, forward
    steps and peak memory; each subphase reads them through the
    frontend's ``/engine_stats`` before and after. (k1) 32 x (128 + 32)
    f32 greedy streams must equal (b'')'s in-process streams or first
    differ at a near-tie, ``mma_f32`` only, 8 a forward step; (k2) bf16 at
    (b)'s traffic: decode tok/s and TTFT at the client beside (b)'s and
    (e2)'s, requests per worker, ``mma_bf16`` only, 8 a forward step on
    each worker, each worker's peak memory, the codec's microseconds a
    DATA frame; (k3) four groups of 8 requests sharing a 1024-token prefix
    each, one request at a time: at least 7 of a group's 8 on the worker
    that served its first (the router's decisions as the frontend reports
    them), that worker's device prefix hits rising, the router's ms a
    decision, a repeat's TTFT against the first's; (k4) 8 f32 streams of
    (128 + 64): the worker serving some of them is SIGKILLed after their
    first tokens; every stream finishes (the victim's through Migration on
    the other worker) equal to an unbroken run's or first differing at a
    near-tie, the dead instance leaves discovery within its lease, the
    next 4 requests succeed. Then each survivor gets SIGTERM and must
    drain (``WORKER_DRAINED``, state done) and exit 0; no process is left.
(l) disaggregated prefill/decode, after (k)'s processes are gone: a
    coordinator, the frontend (``--router-mode kv``) and four
    llama-3-8b-lite workers on cuda:0 with (k)'s settings, each with a
    status server whose /health carries its stats and /metrics its
    ``dynamo_kv_transfer_*`` counters: an f32 pair (``--disagg prefill``
    under component ``f32prefill``, ``--disagg decode`` at it, 512 blocks)
    and a bf16 pair (1280 blocks), streamed handoffs, a 4 s transfer TTL.
    (l1) (k1)'s 32 x (128 + 32) f32: streams equal (b'')'s or first differ
    at a near-tie; all 32 prefills remote, 7 blocks of 1 MiB a request
    staged by the prefill worker and pulled by the decode worker (the
    counters by phase), ``mma_f32`` only, 8 a forward step, on both; (l2)
    (k2)'s bf16 traffic: decode tok/s and TTFT at the client beside (b)'s
    and (k2)'s, ``mma_bf16`` only, 8 a forward step on each, the overlap
    ratio and each worker's peak memory; (l3) 8 distinct 1024-token
    prompts + 32 greedy, one at a time: each TTFT beside (k3)'s cold
    first-of-group TTFT, 63 blocks of 512 KiB a request, the handoff's
    bytes/s by phase (stage: the prefill worker's extracts, D2H; pull: the
    decode worker's fetch over loopback TCP through the port's codec;
    import: its injects, H2D and scatter), the prefill worker's waits for a
    step in flight, the codec's microseconds a MiB (on one card the
    handoff goes through the host); (l4) the f32 prefill worker SIGKILLed,
    (l1)'s first 8 prompts again: 8 of 8 equal (b'')'s through the decode
    worker's own prefill (its fallbacks, prefill tokens and launches).
    After the TTL no staging pin is left on the surviving prefill worker
    and no block is in use on the survivors, which drain and exit 0.
(m) faults: (m1), beside the kernels' build (it needs neither them nor
    the card), the port's chaos harness (``chaos/harness.py``) on this
    host, which has no JAX: the scenarios ``smoke``, ``worker_kill``,
    ``retire_under_load_smoke`` and ``worker_kill_mid_decode_smoke`` over
    fleets of mocker workers (coordinator, ``--engine mocker`` workers,
    the KV store process and the frontend), and the router component over
    two mocker workers, pricing pulls against recompute at the card's row
    of the cost model (``--global-prefix-cache --device-kind``; prefix
    repeats concentrate on one worker, distinct prefixes spread), all at
    once; each report must pass its invariants. After (l): (m2) a real engine
    killed by a chaos plan: a coordinator, the KV store process, the
    frontend (``--router-mode kv --migration-limit 3``) and one f32
    llama-3-8b-lite worker with (k1)'s settings and stream checkpoints
    every block (``--stream-ckpt-blocks 1``, to the store), whose
    ``DYN_CHAOS_PLAN`` SIGKILLs it at its 46th ``engine.step`` with work:
    mid-decode of one greedy request of 128 prompt tokens and 64 out,
    after its checkpoints at 8 and 10 blocks. A fresh worker without the
    plan starts when the victim dies (lazily captured graphs). The victim
    must exit by SIGKILL, the stream finish through Migration from its
    checkpoint (``stream_ckpt_resumes`` >= 1, at most (interval + 1) x 16
    tokens recomputed), its tokens equal an unkilled control of the same
    request id and the in-process f32 stream (or first differ at a
    near-tie), the frontend quarantine the dead instance, the survivor
    launch ``mma_f32`` only, 8 a forward step, and the port's
    ``InvariantChecker`` pass (streams, block leaks, orphan pins,
    checkpoint resume); prints the time from the kill to the resumed
    stream's next token. (m3) the KVBM's fault points on an in-process f32
    engine with a host tier and (m2)'s store: ``kvbm.remote`` errors open
    the store client's breaker with the streams of an unfaulted run and no
    orphan pin; a ``kvbm.offload`` error fails the in-flight streams
    through ``fail_all`` (finish reason error), every block comes back, and
    the next batch's streams equal the unfaulted run's.
(n) the SLA planner: (n1) the port's profiler (``planner/profiler.py``)
    in process on a bf16 llama-3-8b-lite engine sized by
    ``engine_config_for_sweep`` for the CLI's default grids (ISL 128, 512,
    2048; concurrency 1, 8, 32; context 256, 1024, 4096; 32 decode steps;
    lazy capture). The npz must keep the schema, every entry finite and
    positive; TTFT must rise with ISL, decode tok/s per card at
    concurrency 32 be at least that at 1 at each context, and no reading
    beat 0.95 x the card's roofline (``costmodel.decode_step_cost`` of the
    step; ``prefill_cost`` summed over the prompt's chunks). Each
    measurement window (a warmup's, a timed one) is read through the
    profiler's clock: no serve-source capture of the compile ledger in a
    timed window, ``mma_bf16`` only, 8 launches a forward step; prints the
    table, peak memory and the graph pool's growth. (n2) a coordinator,
    the port's aggregator (``--scrape-interval 0.5 --staleness-ttl 3``),
    a frontend (``--router-mode kv``) and the planner (``--mode process
    --fleet-url``, (n1)'s npz, a 5 s interval, 1-2 replicas, the
    ``constant`` predictor, ``--itl-sla`` the least ITL of the profile at
    context 128 + 64/2, whose arithmetic it prints) whose workers are bf16
    llama-3-8b-lite torch workers with (k2)'s settings and lazy capture.
    The first decision spawns A; (b)'s traffic back to back makes the
    planner decide 2 and B serve; a trickle of one request each half
    interval makes it decide 1 and retire B through the drain handshake
    (an interval without a completed request is no data point to the
    planner, as in the JAX package). B must exit 0 with a ``done`` report
    and no escalation, its target leave the aggregator; every decision
    equal ``Planner.compute_replicas`` of the load in its reason and carry
    the SLO stamp; every request finish with 64 tokens; the invariants
    (streams, block leaks, metrics balance, the fleet rollup) pass; each
    worker's ``compile_storm`` gauge equal its own serve captures over the
    window (flagged from 8 on), both read while the heavy traffic still
    holds both replicas (at a moment no capture falls between two reads of
    the worker's own count, 3 scrapes apart), so the planner cannot have
    retired B yet; both workers launch ``mma_bf16`` only, 8 a forward
    step, read as soon as the traffic stops. Prints the decisions, the time from the scale-up
    decision to B's first request, the SLO snapshot and the launches.
(o) the loading tools, a recipe, KServe v2 and the encode worker. (o0)
    llama-3-8b-lite's seed-0 bf16 weights ((b)'s) written as a GGUF file
    through the port's ``save_gguf``: every matrix as Q8_0 blocks that
    chip_smoke encodes itself on the card (an f16 scale of amax/127 and 32
    int8 values a block; Q and K rows in llama.cpp's interleaved-rope
    order), the norms F32, llama metadata; prints its bytes against bf16's.
    The file lives in a temporary directory, removed at the end of the
    phase whether it passes or fails. (o1) engine A loads the file through
    ``hub.resolve_model_path`` and the engine's ``.gguf`` branch; engine B
    holds the weights chip_smoke dequantizes from its own int8 values and
    scales (``q.float() * s.float()`` → bf16, no reader): every leaf equal
    byte for byte, (b)'s 32 x (128 + 64) greedy streams equal, ``mma_bf16``
    only, 8 a forward step; prints both builds' seconds (their difference
    the GGUF load). (o2) a ``TpuServeDeployment`` YAML (the GGUF model, a
    coordinator and a kv-routed frontend on free ports, an encoder at
    recipes/llama-3-8b/multimodal.yaml's geometry: 64 image tokens, LM
    hidden 4096, 448-pixel images; one worker with (k2)'s engine settings;
    the port's ``tokenizer`` key names a byte-level tokenizer whose ids
    from 256 read `` t<id>``, so every generated token is text) brought up
    by ``python -m dynamo_tpu_torch.launch.recipe up``, ready at
    ``RECIPE_UP``. (o3) KServe v2 REST on that frontend: health live and
    ready, the model's metadata and readiness; one prompt's greedy text
    from ``/infer``, ``/generate`` and the ``/generate_stream`` deltas equal
    to ``/v1/completions``'s; malformed tensors answer the JAX package's
    400 texts; (b)'s geometry (32 prompts of 128 tokens, 64 greedy) through
    ``/generate_stream`` from a client process of its own: decode tok/s and
    TTFT at the client, ``mma_bf16`` only, 8 a forward step in the worker.
    (o5) a ``StreamRecorder`` on the worker's KV-event subject during (o3):
    ``load_router_events`` replays its file into a ``RadixIndexer``, which
    must match every full block of (o3)'s one prompt on the worker. (o4) a
    640 x 480 RGB PNG whose rows cycle through the five filter types, as a
    data URL in a chat: the frontend calls the encode worker (PNG decode,
    Pillow's bicubic resize to 448, the ViT on the card) and the worker
    prefills the 64 embedding rows (``mma_bf16``, 8 a forward step); the
    same image twice answers alike (text and usage; the second reads the
    first's cached prefix, so their bf16 log-probs' largest difference is
    printed, with the prefix hits); a JPEG answers 400 naming the format;
    the encoder on the card is within 1e-4·max|ref| + 1e-5 of the CPU's on
    that image; prints the worker's decode-and-resize and device
    milliseconds. One SIGINT to the launcher stops every child, checked by
    PID.

(p) tensor-parallel engines at parity with one rank: llama-3-8b-lite's
widths with seed-0 f32 weights over the f32 cache, cut to 2 layers, every
engine's ranks on the card over gloo (eager steps, explicit pool).
(p0) ``paged_attention_sharded`` on the data axis, dp = tp = 2, every
route at the main decode shape: bit for bit the unsharded launch at its
split count, within the route's limit of the plain version at the ranks'
own. (p1) a tp=1 engine, then a tp=2 engine with the same host tier and
sessions (and a store on 127.0.0.1 for checkpoints and the global prefix
cache): two working sets of 16 x (512 + 32) over a pool of one, then the
first again (onboarded blocks > 0); streams equal tp=1's or first differ
at a near-tie; the first set's chains exported by tp=2 within
1e-4·max|ref| + 1e-5 of tp=1's, and imported by a fresh tp=1 engine give
its streams, prefilling only the last block; 8 sessions of 256 + 32, then
a turn of 64 new + 32 that resumes warm; 4 checkpointed streams of 256 +
48 cut at 20 by the tp=2 engine's shutdown, resumed from their records at
tp=1 equal to the uncut streams. (p2) tp=2 at ``decode_window=4``: 32 x
(128 + 32) against tp=2 at W=1. (p4) dp=2 and dp=2 x tp=2 (four ranks):
the same batch against tp=1. Every rank must launch ``mma_f32`` only,
once a layer and forward step, and all ranks the same steps; their
launches, collectives and block moves with their host ms, and peak
memory a rank are printed. (p3) a coordinator, a frontend, a ``--tp 2 --disagg
prefill`` worker and a ``--disagg decode`` worker at tp=1 (f32, 8 layers,
(l1)'s settings, lazy capture, a staging TTL of 10 s that outlasts an
eager tp=2 prefill): 8 x (128 + 32) equal (b'')'s streams,
every prefill remote, no staging pin after the TTL.

(q) MoE across ranks, every engine's ranks on the card over gloo (eager
steps, an explicit pool; each rank draws only its shard of the seed-0
weights). (q1) gpt-oss-120b's widths (H 2880, 64 heads, 8 kv heads, head
dim 64, 128 experts, top 4) with f32 weights over the f32 cache, cut to 1
layer: 16 x (128 + 16) greedy at tp=1 (lazily captured graphs), tp=2 (the
dense dispatch, the per-expert width split: TEP), ep=2 (the dropless
dispatch, 64 experts a rank) and tp=2 x ep=2 (four ranks); every stream
equals tp=1's or first differs at a near-tie; every rank launches
``mma_f32`` only, once a forward step, on 32 of the 64 heads and 4 of the
8 kv heads at tp=2 and on all 64 at ep=2. (q2) (j1)'s cut (bf16, 4
layers, 32 x (128 + 32)) at ep=2: each rank holds 64 experts, half of
(j1)'s expert bytes within 1%, and launches ``mma_bf16`` only, 4 a
forward step. Each run prints its setup s, TTFT, decode tok/s (beside
(j1)'s for (q2)) and, a rank, its expert and weight bytes, peak memory and
collective ms a forward step. No speed condition: the ranks share one
card over gloo, through host memory.

Phase (r), pipeline parallelism (models/llama.forward_pp): (r1)
llama-3-8b-lite, all 8 layers, seed-0 f32 weights over the f32 cache, as
two stages on cuda:0 over gloo (eager steps, an explicit pool of one
working set and a host tier), serves (b'')'s 32 x (128 + 32) greedy:
every stream equals (b'')'s or first differs at a near-tie; each stage
holds its 4 layers, half the layer bytes and half of a block's cache
bytes, and launches ``mma_f32`` only, 4 a microbatch of the schedule
(the microbatches its programs' shapes make, Σ (L/pp)·m over its forward
steps); then 32 fillers evict the pool to the host tier and the first 16
prompts come back over it with the same streams, their prefix blocks
onboarded. (r2) llama-3-8b-lite cut to 2 layers, bf16 weights over the
int8 cache, 16 x (128 + 16) at dp=2 x pp=2 (four ranks) and dp=2 x pp=1:
every stream ends with its length and finite logprobs, every rank of
both launches ``mma_int8`` only, by the schedule, and the first decode
step's logits at pp=2 are within 2e-2 of the largest of pp=1's. Each
run prints setup s, TTFT, decode tok/s and, a rank, collective ms a
forward step and peak memory. No speed condition.

After every phase the script collects garbage, empties the allocator's
cache and logs the card's allocated and reserved bytes (``[mem]``); an
engine (``EngineCore``, ``ModelRunner``) of the phase still alive fails
the run, named with the chain of references that holds it.

Prints the card's name and power limit (nvidia-smi), one ``ptxas`` line
per kernel instantiation (registers, spills), one JSON ``kernels`` line
(an entry per kernel of ``ROUTES``, its launches counted in the run that
serves its route: (b) for bf16 q, (b'') for f32 q over the f32 cache,
(c)'s f32 runs for f32 q over int8 and int4; ``verify_ms`` is the T=5
verify case's time; ``mma_bf16`` and ``mma_f32`` also carry their launches
in (i), (j), (k), (l) and (q), ``mma_f32`` in (m), (p) and (r),
``mma_bf16`` in (n) and (o), ``mma_int8`` in (r); and a
``paged_attention_sharded`` entry: one rank's
``mma_bf16`` launch at tp=2 decode, its launches those of both ranks in
(h) and (i3)), and as its last line
``{"ok": true, "device": {...}}``.
Without a CUDA card it exits non-zero and prints no result.

``python3 chip_smoke.py --only-p`` builds the kernels and runs (b'')'s
f32 run (the reference of (p3)) and (p) alone;
``python3 chip_smoke.py --only-g`` builds the kernels and runs (g) alone,
and prints neither the kernels line nor the result line;
``python3 chip_smoke.py --only-tp`` does the same for (a') and (h);
``python3 chip_smoke.py --only-ij`` for (b)'s bf16 run, (i), (j) and (h);
``python3 chip_smoke.py --only-k`` for (b'')'s f32 run (the reference of
(k1)) and (k); ``python3 chip_smoke.py --only-l`` the same for (l);
``python3 chip_smoke.py --only-m`` runs (m) alone; ``--only-n`` builds the
kernels and runs (n) alone, ``--only-o`` (o) alone, ``--only-q`` (j1)
(the reference of (q2)) and (q), ``--only-r`` (b'')'s f32 run (the
reference of (r1)) and (r).

``python3 chip_smoke.py --profile`` also runs phase (b), (b'), (i1), (j1)
and (j2) under ``torch.profiler`` and prints device time by kernel and
the device's busy share of the serving wall time, for each run
(``--only-ij --profile``: (b)'s bf16 run, (i1), (j1) and (j2)).
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
#: (a)'s cases at the attention shapes of the MoE serving runs (j1), (j2)
MOE_CASES = {"j1": "prefill D=64 KH=8 H=64 B=16 T=128 kv 128 (j1)",
             "j2 decode": "decode D=128 KH=8 H=128 B=8 kv 64-80 (j2)",
             "j2 prefill": "prefill D=128 KH=8 H=128 B=8 T=64 kv 64 (j2)"}


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
    # the plain version and SDPA are timed over 20 calls at the shapes the
    # kernels line reports, over 5 elsewhere (the script's time limit)
    reported = name in (MAIN_CASE, verify_case(VERIFY_TS[-1]), *MOE_CASES.values())
    few, warm = (3, 1) if heavy else (20, 3) if reported else (5, 1)
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


def kernel_cases(gen) -> dict:
    """Phase (a)'s shapes: {name: (attention_case, num_splits)}; every
    case runs every cache kind with each q dtype."""
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
    # the MoE serving runs (j1), (j2): gpt-oss's prefill step of 16 prompts
    # of 128 at D=64 (1024 query rows a kv head); deepseek-moe's GQA group
    # of 16 (H=128 over KH=8) at decode, kv 64-80 (16 rows a kv head: one
    # row group, the largest) and at its prefill step of 8 prompts of 64
    moe_lens = torch.randint(64, 81, (8,), generator=gen, device="cuda").tolist()
    cases[MOE_CASES["j1"]] = (attention_case(
        gen, 16, 128, 8, [0] * 16, [128] * 16, h=64, kh=8, d=64), 0)
    cases[MOE_CASES["j2 decode"]] = (attention_case(
        gen, 8, 1, 6, [n - 1 for n in moe_lens], [1] * 8, h=128, kh=8), 0)
    cases[MOE_CASES["j2 prefill"]] = (attention_case(
        gen, 8, 64, 4, [0] * 8, [64] * 8, h=128, kh=8), 0)
    return cases


def phase_kernels(bw: float, peak: float) -> dict:
    """Rows by route, then by shape."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls run in TF32: the plain version's f32 products "
                             "would not be f32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = kernel_cases(gen)
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


def bench_reqs(vocab: int, batch: int, prompt: int, decode: int) -> dict:
    """(b)'s greedy requests: {i: PreprocessedRequest} of ``prompt``
    tokens, ``decode`` tokens each."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    hi = vocab - 5
    return {i: PreprocessedRequest(
        token_ids=[(7 * i + 11 * j) % hi + 5 for j in range(prompt)],
        stop_conditions=StopConditions(max_tokens=decode, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
        request_id=f"bench-{i}") for i in range(batch)}


def phase_serve(kind: str, profile: bool = False, window: int = 1,
                f32: bool = False, quantization: str = "none",
                with_lps: bool = False) -> tuple[dict, dict]:
    """One serving run with the KV cache of ``kind`` after a full warmup
    (bf16 weights, or with ``f32`` f32 weights over the f32 model-precision
    cache; with ``quantization="int8"`` the weights quantized to int8): it
    must launch its route's kernel only, once per layer and forward step,
    all through replays of graphs the warmup captured. Returns the run's
    numbers and its token streams ({i: tokens}, or with ``with_lps``
    {i: (tokens, logprobs)})."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.models.quant import param_bytes
    from dynamo_tpu_torch.obs.compile_ledger import get_compile_ledger
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.utils.config import EngineConfig

    batch, prompt, decode = 32, 128, 32 if f32 else 64
    model = register_f32_model() if f32 else "llama-3-8b-lite"
    tag = ("[i1] int8 weights" if quantization == "int8" else "[b''] f32" if f32
           else f"[b] kv_dtype={KV_DTYPES[kind]}" if window == 1
           else f"[b'] decode_window={window}")
    free_engine()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine(EngineConfig(
        model=model, block_size=16, max_batch_size=batch,
        max_model_len=prompt + decode + 16, prefill_chunk=prompt,
        kv_dtype=KV_DTYPES[kind], allow_random_weights=True,
        decode_window=window, warmup_mode="full", quantization=quantization))
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
    # the KV blocks the engine's own rule (85% of free memory) would size
    # beside these weights and graphs without the max_batch_size x
    # max_model_len cap that sets kv_blocks here
    torch.cuda.empty_cache()
    kv_free = torch.cuda.mem_get_info()[0] + spec.num_blocks * spec.bytes_per_block()
    kv_uncapped = int(kv_free * 0.85) // spec.bytes_per_block()
    built = {"built_alloc_gib": torch.cuda.memory_allocated() / 2**30,
             "built_reserved_gib": torch.cuda.memory_reserved() / 2**30,
             "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    reqs = bench_reqs(vocab, batch, prompt, decode)

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
        "model": model, "kv_dtype": KV_DTYPES[kind], "decode_window": window,
        "quantization": quantization, "weight_bytes": param_bytes(core.runner.params),
        "requests": batch,
        "tokens": batch * decode, "steps": steps, "forward_steps": forward_steps,
        "windows": windows_run, "launches": launches, "launches_by_kernel": by_kernel,
        "launches_per_forward_step": launches / max(forward_steps, 1),
        "ttft_all_s": t_first - t_start,
        "decode_tok_s": batch * (decode - 1) / (t_end - t_first),
        "wall_s": t_end - t_start,
        "peak_mem_gib": max(built["build_peak_gib"], torch.cuda.max_memory_allocated() / 2**30),
        "serve_peak_gib": torch.cuda.max_memory_allocated() / 2**30, "base_mem_gib": base_gib,
        **built, "kv_blocks": spec.num_blocks, "kv_blocks_uncapped": kv_uncapped,
        "bytes_per_block": spec.bytes_per_block(),
        "warmup_s": warm["seconds"], "graphs_warmed": len(warmed),
        "graph_pool_gib": warm["graph_pool_gib"], "serve_captures": [list(k) for k in minted],
    }
    if live is not None:
        res["live_cache_check"] = live
    log(f"{tag} " + json.dumps(res))
    del engine, core, programs, warmed
    gc.collect()
    torch.cuda.empty_cache()
    if with_lps:
        return res, streams
    return res, {i: toks for i, (toks, _) in streams.items()}


# ---------------------------------------------------------------------------
# (c) coherence on the trained checkpoint
# ---------------------------------------------------------------------------

#: the trained checkpoint of (c) and (i2)
COHERENCE_CKPT = ROOT / "tests" / "data" / "tiny-real-llama"


def coherence_setup():
    """The trained checkpoint's path, tokenizer and the ids of "one two
    three four"; its f32 twin registered as a preset, and that preset's
    name with its params on the card and on the CPU."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS, ModelConfig
    from dynamo_tpu_torch.models.loader import load_params
    from dynamo_tpu_torch.tokenizer import load_tokenizer

    ckpt = str(COHERENCE_CKPT)
    tok = load_tokenizer(ckpt)
    ids = tok.encode("one two three four", add_bos=True)
    cfg32 = dataclasses.replace(ModelConfig.from_hf_config(ckpt), dtype="float32",
                                name="tiny-real-llama-f32")
    MODEL_PRESETS[cfg32.name] = cfg32
    params = {dev: load_params(cfg32, ckpt, device=dev) for dev in ("cuda", "cpu")}
    return ckpt, tok, ids, cfg32.name, params


def greedy(model: str, device: str, ids: list[int], params=None, hold_stream: bool = False,
           kv_dtype: str = "bfloat16", quantization: str = "none", max_tokens: int = 8):
    """Greedy tokens of ``ids`` through an ``EngineCore`` of ``model`` on
    ``device`` (lazily captured graphs on the card), and with
    ``hold_stream`` the count of held steps and of those whose dispatch
    waited for the card: from the third step on (first uses of the step
    shapes are past), the stream is held busy by a ~0.1 s sleep kernel
    before ``step_begin``; a dispatch that synchronises returns only after
    the sleep, with the stream idle."""
    from dynamo_tpu_torch.engine.engine import EngineCore
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.utils.config import EngineConfig

    core = EngineCore(EngineConfig(model=model, block_size=16, num_blocks=64,
                                   max_batch_size=4, max_model_len=256,
                                   kv_dtype=kv_dtype, quantization=quantization,
                                   allow_random_weights=True),
                      params=params, device=device)
    core.add_request(PreprocessedRequest(
        token_ids=ids, request_id="c",
        stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
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


def phase_coherence() -> dict:
    from dynamo_tpu_torch.ops import paged_attention as pa

    ckpt, tok, ids, f32, params = coherence_setup()

    res: dict = {}
    for kv_dtype in ("bfloat16", "int8", "int4"):
        toks, held, waited = greedy(ckpt, "cuda", ids, hold_stream=True, kv_dtype=kv_dtype)
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
    for kind, kv_dtype in KV_DTYPES.items():
        pa.reset_launches()
        gpu32 = greedy(f32, "cuda", ids, params["cuda"], kv_dtype=kv_dtype)[0]
        by_kernel = dict(pa.paged_attention.launches_by_kernel)
        cpu32 = greedy(f32, "cpu", ids, params["cpu"], kv_dtype=kv_dtype)[0]
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
# (i) weight-only int8, (j) the MoE family
# ---------------------------------------------------------------------------

def phase_int8(smi: str, b_serve: dict, b_streams: dict, profile: bool = False) -> dict:
    """(i1) llama-3-8b-lite with int8 weights over the bf16 cache, (b)'s
    traffic after a full warmup: ``mma_bf16`` only, 8 a forward step
    through replays; decode tok/s and weight bytes beside (b)'s bf16 run.
    (i2) tiny-real-llama at f32 with int8 weights: greedy tokens on the
    card equal the CPU plain path's, through ``mma_f32`` only; then the
    bf16 int8 continuation of "one two three four" on the card."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    res: dict = {}
    run, streams = phase_serve("float", profile=profile, quantization="int8")
    bf16 = b_serve["float"]
    same = sum(streams[i] == b_streams["float"].get(i) for i in streams)
    log(f"[i1] int8 weights: decode tok/s {run['decode_tok_s']} against (b)'s bf16 "
        f"{bf16['decode_tok_s']}; TTFT (all 32) {run['ttft_all_s']} s against "
        f"{bf16['ttft_all_s']} s; weight bytes {run['weight_bytes']} against "
        f"{bf16['weight_bytes']}; peak memory {run['peak_mem_gib']:.2f} GiB against "
        f"{bf16['peak_mem_gib']:.2f} GiB (allocated at the start {run['base_mem_gib']:.2f} "
        f"and {bf16['base_mem_gib']:.2f}; while serving {run['serve_peak_gib']:.2f} and "
        f"{bf16['serve_peak_gib']:.2f}; allocated / reserved once built "
        f"{run['built_alloc_gib']:.2f} / {run['built_reserved_gib']:.2f} and "
        f"{bf16['built_alloc_gib']:.2f} / {bf16['built_reserved_gib']:.2f}); KV blocks "
        f"{run['kv_blocks']} against {bf16['kv_blocks']}, {run['kv_blocks_uncapped']} against "
        f"{bf16['kv_blocks_uncapped']} without the cap; greedy streams equal to (b)'s bf16 "
        f"ones: {same} of {len(streams)} (int8 rounds the weights: no pass condition) on {smi}")
    res["i1"] = dict(run, streams_equal_to_b=same)

    ckpt, tok, ids, f32, params = coherence_setup()
    pa.reset_launches()
    gpu32 = greedy(f32, "cuda", ids, params["cuda"], quantization="int8")[0]
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    cpu32 = greedy(f32, "cpu", ids, params["cpu"], quantization="int8")[0]
    route = pa.ROUTES[(torch.float32, "float")]
    log(f"[i2] tiny-real-llama f32, int8 weights: greedy tokens card {gpu32} cpu {cpu32}; "
        f"launches by kernel {by_kernel}")
    if gpu32 != cpu32:
        raise AssertionError("[i2] int8 f32 greedy tokens on the card differ from the CPU "
                             "plain path")
    if by_kernel[route] <= 0 or any(n for k, n in by_kernel.items() if k != route):
        raise AssertionError(f"[i2] the int8 f32 run launched {by_kernel}, expected {route} only")
    text = tok.decode(greedy(ckpt, "cuda", ids, quantization="int8")[0])
    log(f"[i2] tiny-real-llama bf16, int8 weights, on the card: {text!r}")
    res["i2"] = {"f32_tokens": gpu32, "launches_by_kernel": by_kernel, "bf16_text": text}
    free_engine()
    return res


#: (j1): gpt-oss-120b at full width cut to 4 layers; (j2): deepseek-moe at
#: full width cut to 1 layer — (model, layers, requests, prompt, greedy
#: tokens, the most token rows a step)
MOE_RUNS = {"j1": ("gpt-oss-120b", 4, 32, 128, 32, 2048),
            "j2": ("deepseek-moe", 1, 8, 64, 16, 512)}


def moe_serve(tag: str, base: str, layers: int, batch: int, prompt: int, decode: int,
              max_rows: int, smi: str, profile: bool = False) -> dict:
    """One MoE serving run: ``base`` at full width cut to ``layers`` layers
    (random bf16 weights from seed 0), the bf16 cache, lazily captured
    graphs, legacy (not unified) steps whose prefill takes at most
    ``max_rows`` token rows, ``batch`` greedy requests entered at once. It
    must launch ``mma_bf16`` only, once a layer and forward step."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.models.quant import param_bytes
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.utils.config import EngineConfig

    free_engine()
    name = f"{base}-{layers}l"
    MODEL_PRESETS[name] = dataclasses.replace(MODEL_PRESETS[base], num_layers=layers,
                                              name=name)
    max_len = prompt + decode + 16
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine(EngineConfig(
        model=name, block_size=16, max_batch_size=batch, max_model_len=max_len,
        num_blocks=batch * -(-max_len // 16) + 1, prefill_chunk=prompt,
        max_tokens_per_step=max_rows, unified_step=False, allow_random_weights=True,
        warmup_mode="lazy"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    core = engine.core
    cfg = core.model_cfg
    hi = cfg.vocab_size - 5
    reqs = {i: PreprocessedRequest(
        token_ids=[(7 * i + 11 * j) % hi + 5 for j in range(prompt)],
        stop_conditions=StopConditions(max_tokens=decode, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
        request_id=f"{tag}-{i}") for i in range(batch)}
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
    for i, (toks, lps) in streams.items():
        if len(toks) != decode or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{tag} request {i}: {len(toks)} tokens, expected {decode}")
        if not all(lp <= 1e-3 and lp == lp for lp in lps):
            raise AssertionError(f"{tag} request {i}: bad logprobs {lps[:4]}")
    forward_steps = check_engine_launches(tag, core, by_kernel, pa.ROUTES[(torch.bfloat16,
                                                                           "float")])
    rows = max(k[0] * k[1] for k in core.runner.programs)
    if rows > max_rows:
        raise AssertionError(f"{tag}: a step of {rows} token rows, past {max_rows}")
    t_first, t_end = max(first_at.values()), max(done_at.values())
    ttfts = sorted(t - t_start for t in first_at.values())
    res = {"model": name, "layers": layers, "experts": cfg.num_experts,
           "experts_per_tok": cfg.num_experts_per_tok,
           "shared_experts": cfg.num_shared_experts, "hidden": cfg.hidden_size,
           "moe_intermediate": cfg.moe_intermediate_size, "head_dim": cfg.head_dim,
           "requests": batch, "prompt": prompt, "tokens": batch * decode,
           "setup_s": setup_s, "weight_bytes": param_bytes(core.runner.params),
           "expert_bytes": sum(param_bytes(core.runner.params["layers"][k])
                               for k in ("w_gate", "w_up", "w_down")),
           "forward_steps": forward_steps, "launches_by_kernel": by_kernel,
           "launches_per_forward_step": sum(by_kernel.values()) / forward_steps,
           "graphs": sorted(list(k) for k in core.runner.programs), "max_step_rows": rows,
           "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_all_s": t_first - t_start,
           "decode_tok_s": batch * (decode - 1) / (t_end - t_first),
           "wall_s": t_end - t_start,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "base_mem_gib": base_gib}
    log(f"{tag} {json.dumps(res)} on {smi}")
    del engine, core
    free_engine()
    return res


def phase_moe(smi: str, profile: bool = False) -> dict:
    """(j1), (j2) the MoE family at full width (``moe_serve``); (j3)
    tiny-moe at f32 with and without int8 weights: greedy tokens on the
    card equal the CPU plain path's, through ``mma_f32`` only."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    res = {tag: moe_serve(f"[{tag}]", *run, smi=smi, profile=profile)
           for tag, run in MOE_RUNS.items()}
    name = "tiny-moe-f32"
    cfg = MODEL_PRESETS[name] = dataclasses.replace(MODEL_PRESETS["tiny-moe"],
                                                    dtype="float32", name=name)
    p_cpu = llama.init_params(cfg, seed=0, device="cpu")
    p_gpu = {k: ({n: w.cuda() for n, w in v.items()} if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    ids = [1, 5, 9, 20, 33, 7, 7, 7, 100, 200, 250]
    route = pa.ROUTES[(torch.float32, "float")]
    for quantization in ("none", "int8"):
        pa.reset_launches()
        gpu = greedy(name, "cuda", ids, p_gpu, quantization=quantization, max_tokens=16)[0]
        by_kernel = dict(pa.paged_attention.launches_by_kernel)
        cpu = greedy(name, "cpu", ids, p_cpu, quantization=quantization, max_tokens=16)[0]
        log(f"[j3] tiny-moe f32, quantization={quantization}: greedy tokens card {gpu} "
            f"cpu {cpu}; launches by kernel {by_kernel}")
        if gpu != cpu:
            raise AssertionError(f"[j3] quantization={quantization}: tiny-moe f32 greedy "
                                 "tokens on the card differ from the CPU plain path")
        if by_kernel[route] <= 0 or any(n for k, n in by_kernel.items() if k != route):
            raise AssertionError(f"[j3] launched {by_kernel}, expected {route} only")
        res[f"j3_{quantization}"] = {"tokens": gpu, "launches_by_kernel": by_kernel}
    res["seconds"] = time.perf_counter() - t0
    log(f"[j] passed in {res['seconds']:.1f}s on {smi}")
    free_engine()
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


def throughput_clients(port: int, bodies: dict, path: str = "/v1/completions",
                       kind: str = "openai") -> tuple[float, list, float]:
    """(e2)'s and (o3)'s clients: every body of ``bodies`` ({request id:
    body}) sent at once to ``path`` and streamed; returns the start time,
    each answer's (status, ``sse_summary`` or, for ``kind`` "kserve",
    ``kserve_summary``) and the CPU seconds this process spent."""
    async def go():
        return await asyncio.gather(*(http_call(
            port, "POST", path, body, headers={"x-request-id": rid})
            for rid, body in bodies.items()))

    summary = kserve_summary if kind == "kserve" else sse_summary
    cpu0 = time.process_time()
    t_start = time.perf_counter()
    results = asyncio.run(go())
    return (t_start, [(r["status"], summary(r)) for r in results],
            time.process_time() - cpu0)


def _client_main(port: int, bodies: dict, conn, path: str, kind: str) -> None:
    conn.send(throughput_clients(port, bodies, path, kind))
    conn.close()


def client_in_own_process(port: int, bodies: dict, path: str = "/v1/completions",
                          kind: str = "openai") -> tuple[float, list, float]:
    """``throughput_clients`` in a spawned process of its own, as a user's
    client is, so that its parsing does not share this process's
    interpreter lock with the frontend and the engine (perf_counter is the
    system's monotonic clock, one timeline in both processes)."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_client_main, args=(port, bodies, send, path, kind))
    proc.start()
    try:
        send.close()
        if not recv.poll(300):
            raise AssertionError("the client process sent no result in 300 s")
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
#: (f)'s late prompts: 4 of 1,536 tokens, 4 greedy tokens each
LATE, LATE_PROMPT, LATE_DECODE = 4, 1536, 4


async def serve_with_late(engine, reqs: dict, late: dict, after=None):
    """Send ``reqs`` at once; when every one of them has two tokens (its
    first decode step is done), send ``late``. Collect each stream's tokens
    and the arrival time of each token; then await ``after(engine)``.
    Returns (start, time the late ones were sent, {key: (tokens, times)},
    ``after``'s result)."""
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
    first = [asyncio.ensure_future(one(k, r)) for k, r in reqs.items()]
    await started.wait()
    t_late = time.perf_counter()
    await asyncio.gather(*first, *(one(k, r) for k, r in late.items()))
    extra = await after(engine) if after is not None else None
    return t_start, t_late, streams, extra


def ewma(values: list[float]) -> float | None:
    """The step profiler's moving average over ``values``."""
    from dynamo_tpu_torch.obs.profiler import ewma_step

    out = None
    for v in values:
        out = ewma_step(out, v)
    return out


def slo_engine():
    """(f)'s engine after its full warmup, the ledgers' gates on; returns
    it and the seconds its build took."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
    from dynamo_tpu_torch.obs.sched_ledger import get_sched_ledger
    from dynamo_tpu_torch.utils.config import EngineConfig

    get_sched_ledger().reset()
    get_mem_ledger().reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = build_engine(EngineConfig(**SLO_CFG))
    torch.cuda.synchronize()
    warm = engine.core.warmup_summary
    if warm["failed"] or warm["deadline_skipped"] or warm["coverage"] != 1.0:
        raise AssertionError(f"[f]: warmup left buckets without a graph: {warm}")
    return engine, time.perf_counter() - t0


def ledgers_off(core) -> None:
    """Turn the ledgers' gates off on a live engine (what
    ``DYN_SCHED_LEDGER=0 DYN_MEM_LEDGER=0 DYN_PERF_PROFILE=0`` give at its
    construction) and empty its prefix cache, so the next run does the
    first one's work again on the same graphs (engine-core thread)."""
    core.sched_led.configure(False)
    core.mem_led.configure(False)
    core.perf.enabled = False
    core.pool.clear()


async def slo_run(engine, ledgers: bool, setup_s: float) -> dict:
    """One (f) run on ``engine``: (b)'s 32 x (128 + 64 greedy), and after
    their first decode step 4 prompts of 1,536 tokens (4 greedy tokens
    each); with the ledgers' gates off when ``ledgers`` is False."""
    from dynamo_tpu_torch.obs.tracer import get_tracer
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    batch, prompt, decode = 32, 128, 64
    tag = "[f]" if ledgers else "[f] ledgers off"
    core = engine.core
    if not ledgers:
        await engine.run_in_core(ledgers_off)
    warm = core.warmup_summary
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

    run = "on" if ledgers else "off"
    reqs = {i: req(f"slo-{run}-{i}", [(7 * i + 11 * j) % hi + 5 for j in range(prompt)],
                   decode) for i in range(batch)}
    late = {f"late-{i}": req(f"slo-{run}-late-{i}", [(13 * i + 3 * j) % hi + 5
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

    def zero_counts(c):
        for prog in c.runner.programs.values():
            prog.calls = 0
        pa.reset_launches()

    await engine.run_in_core(zero_counts)   # this run's launches and steps alone
    epoch0 = time.time()
    t_start, t_late, streams, fin = await serve_with_late(engine, reqs, late, after)
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
    traffic on the same engine and graphs with the ledgers' gates off (as
    ``DYN_SCHED_LEDGER=0 DYN_MEM_LEDGER=0 DYN_PERF_PROFILE=0`` give; its
    prefix cache emptied first): both decode tok/s. One warmup serves
    both runs: a second engine would capture the 432 graphs again."""
    from dynamo_tpu_torch.engine.engine import GRAPH_POOL_SHARE

    async def both():
        engine, setup_s = slo_engine()
        try:
            return (await slo_run(engine, True, setup_s),
                    await slo_run(engine, False, setup_s))
        finally:
            await engine.shutdown()

    on, off = asyncio.run(both())
    gc.collect()
    torch.cuda.empty_cache()
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
        "warmup_s": on["warmup_s"],
        "graph_pool_gib": on["graph_pool_gib"],
        "graph_pool_share_of_card": on["graph_pool_share_of_card"],
        "graph_pool_over_limit": on["graph_pool_share_of_card"] > GRAPH_POOL_SHARE,
        "graph_pool_top": on["graph_pool_top"][:4],
        "perf_ewma": on["perf_ewma"],
    }
    log(f"[f] summary {json.dumps(summary)} on {smi}")
    return {"on": on, "off": off}


# ---------------------------------------------------------------------------
# (g) the KVBM tiers, sessions, stream checkpoints, blocks across engines
# ---------------------------------------------------------------------------

#: (g1): two working sets of 16 greedy requests, 1024-token prompts, 32
#: tokens (the depth is cut to keep the script inside its time limit)
KV_BATCH, KV_PROMPT, KV_DECODE = 16, 1024, 32
#: (g2): 8 prompts of 1024 tokens, 32 greedy tokens
PUB_BATCH = 8
#: (g3): 16 sessions; turn 1 a 512-token prompt, each later turn 64 new
#: tokens after the previous turn; 32 greedy tokens a turn; the TTL
SES_BATCH, SES_PROMPT, SES_NEW, SES_DECODE, SES_TTL = 16, 512, 64, 32, 4.0
#: (g4): a greedy and a seeded sampled stream, 256-token prompts, 48
#: tokens, cut once both have 20
CKPT_PROMPT, CKPT_DECODE, CKPT_CUT = 256, 48, 20


def kv_prompts(seed: int, n: int, length: int, vocab: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(5, vocab - 5, length).tolist() for _ in range(n)]


def kv_reqs(prompts: list[list[int]], tag: str, max_tokens: int, sessions: bool = False,
            annotations: list[dict] | None = None, **so) -> dict:
    """{i: PreprocessedRequest} (greedy unless ``so`` says otherwise); with
    ``sessions`` each carries session id ``s{i}``."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    out = {}
    for i, p in enumerate(prompts):
        ann = dict(annotations[i]) if annotations else {}
        if sessions:
            ann["session.id"] = f"s{i}"
        out[i] = PreprocessedRequest(
            token_ids=list(p), request_id=f"{tag}-{i}", annotations=ann,
            stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=so.get("temperature", 0.0),
                                             seed=so.get("seed")))
    return out


def kv_engine(kv_dtype: str, num_blocks: int, max_model_len: int, prefill_chunk: int = 512,
              model: str = "llama-3-8b-lite", **kw):
    """A lazily captured engine of ``model`` (random weights from seed 0)
    for (g)."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.utils.config import EngineConfig

    return build_engine(EngineConfig(
        model=model, block_size=16, max_batch_size=32, num_blocks=num_blocks,
        max_model_len=max_model_len, prefill_chunk=prefill_chunk, kv_dtype=kv_dtype,
        allow_random_weights=True, **kw))


def program_calls(core) -> dict:
    return {k: p.calls for k, p in core.runner.programs.items()}


async def serve_on(engine, reqs: dict, route: str, tag: str) -> dict:
    """Serve ``reqs`` at once on a running engine (not shut down after):
    the streams, TTFT (all requests, and the median), and a check that the
    run launched ``route`` only, 8 a forward step, counted through replays
    (the counts are set to 0 just before and read just after)."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    core = engine.core
    calls0 = program_calls(core)
    first_at, done_at, streams = {}, {}, {}

    async def one(key):
        toks, lps = [], []
        async for out in engine.generate(reqs[key]):
            if out.error:
                raise RuntimeError(f"{tag}: request {key} failed: {out.error}")
            if not toks:
                first_at[key] = time.perf_counter()
            toks += out.token_ids
            lps += out.log_probs or []
        done_at[key] = time.perf_counter()
        streams[key] = (toks, lps)

    pa.reset_launches()
    t0 = time.perf_counter()
    # Every request enters before the first step: the engine thread is held
    # in an exec while the requests queue behind it, so a run's first step
    # (and so its batch composition) does not depend on thread timing.
    gate = threading.Event()
    held = asyncio.ensure_future(engine.run_in_core(lambda _core: gate.wait(120)))
    await asyncio.sleep(0)
    tasks = [asyncio.ensure_future(one(k)) for k in reqs]
    await asyncio.sleep(0)
    gate.set()
    await held
    await asyncio.gather(*tasks)
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    layers = core.model_cfg.num_layers
    programs = core.runner.programs
    steps = sum((p.calls - calls0.get(k, 0)) * (p.shape[3] if len(p.shape) > 3 else 1)
                for k, p in programs.items())
    launches = schedule_launches(core, [(k, p.calls - calls0.get(k, 0))
                                        for k, p in programs.items()])
    want = {k: (launches if k == route else 0) for k in by_kernel}
    if steps <= 0 or by_kernel != want:
        raise AssertionError(f"{tag}: kernel launches {by_kernel}, expected {want} "
                             f"({layers} per forward step, or at pp > 1 a layer of the "
                             f"stage and microbatch; {route} only)")
    ttft = sorted(first_at[k] - t0 for k in reqs)
    return {"streams": {k: v[0] for k, v in streams.items()},
            "lps": {k: v[1] for k, v in streams.items()},
            "ttft_all_s": ttft[-1], "ttft_median_s": ttft[len(ttft) // 2],
            "wall_s": max(done_at.values()) - t0, "forward_steps": steps,
            "launches": sum(by_kernel.values())}


def schedule_launches(core, calls: list) -> int:
    """The attention launches one rank makes in ``calls`` ([(program key,
    calls)]): a launch a layer and forward step, and at pp > 1 a launch a
    layer of the rank's stage and microbatch of the schedule
    (``models/llama.pp_microbatch_count`` of the program's shape)."""
    from dynamo_tpu_torch.models.llama import pp_microbatch_count

    ec = core.engine_cfg
    per = core.model_cfg.num_layers // ec.pp
    out = 0
    for key, n in calls:
        window = key[3] if len(key) > 4 else 1    # a verify key is ("verify", b, t, nblk)
        b, t = (key[1], key[2]) if key[0] == "verify" else (key[0], key[1])
        m = pp_microbatch_count(b, t, ec.pp, ec.pp_microbatches) if ec.pp > 1 else 1
        out += n * window * per * m
    return out


def cache_ptrs(runner) -> list[int]:
    return [t.data_ptr() for c in (runner.cache_k, runner.cache_v)
            for t in (c.values() if isinstance(c, dict) else [c])]


def chains(prompts: list[list[int]]) -> list[list[int]]:
    from dynamo_tpu_torch.tokens import TokenBlockSequence

    return [TokenBlockSequence.from_tokens(p, 16).sequence_hashes() for p in prompts]


def free_engine() -> None:
    """Give the card back the memory of the engines just gone out of use."""
    gc.collect()
    torch.cuda.empty_cache()


def live_engines() -> list:
    """The port's engine objects (``EngineCore``, ``ModelRunner``) still
    alive after a full collection."""
    from dynamo_tpu_torch.engine.engine import EngineCore, ModelRunner

    gc.collect()
    return [o for o in gc.get_objects() if isinstance(o, (EngineCore, ModelRunner))]


def _edge(holder, held) -> str:
    """How ``holder`` refers to ``held``, for :func:`holder_chain`."""
    if isinstance(holder, dict):
        return f"[{next((k for k, v in holder.items() if v is held), '?')!r}]"
    attrs = getattr(holder, "__dict__", None)
    if isinstance(attrs, dict):
        key = next((k for k, v in attrs.items() if v is held), None)
        if key is not None:
            return f"{type(holder).__qualname__}.{key}"
    name = getattr(holder, "__qualname__", None)
    return f"<{type(holder).__name__}{'' if name is None else ' ' + str(name)}>"


def holder_chain(obj, ignore: tuple = (), depth: int = 16) -> str:
    """What keeps ``obj`` alive: a breadth-first walk up its referrers
    (frames and the ids in ``ignore`` left out) to a module's globals,
    written "module['name'] -> ... -> obj"; or, when no module holds it,
    the referrers where the walk ended."""
    import types

    modules = {id(vars(m)): name for name, m in list(sys.modules.items())
               if m is not None and hasattr(m, "__dict__")}
    objs, paths = [obj], [type(obj).__qualname__]
    seen = {id(obj), *ignore}
    for _ in range(depth):
        next_objs: list = []
        next_paths: list[str] = []
        mine = {id(objs), id(paths), id(next_objs), id(next_paths)}
        for i in range(len(objs)):
            for r in gc.get_referrers(objs[i]):
                if id(r) in seen or id(r) in mine or isinstance(r, types.FrameType):
                    continue
                seen.add(id(r))
                if id(r) in modules:
                    return f"{modules[id(r)]}{_edge(r, objs[i])} -> {paths[i]}"
                next_objs.append(r)
                next_paths.append(f"{_edge(r, objs[i])} -> {paths[i]}")
        if not next_objs:
            break
        objs, paths = next_objs, next_paths
    return "held by no module; the walk ended at: " + "; ".join(paths[:8])


def audit_memory(tag: str) -> dict:
    """After a phase: the card's allocated and reserved bytes, and no
    engine of the phase still alive (each holds its weights, KV cache
    and graphs): an engine that outlives its phase fails the run, named
    with what holds it."""
    free_engine()
    alive = live_engines()
    chains = [holder_chain(o, ignore=(id(alive),)) for o in alive]
    del alive
    storages = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    res = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
           "reserved_gib": torch.cuda.memory_reserved() / 2**30,
           # bytes of the card tensors Python still holds; the rest of
           # allocated_gib is held by no Python object
           "python_tensors_gib": sum(storages.values()) / 2**30}
    log(f"[mem] after {tag}: {json.dumps(res)}"
        + "".join(f"\n[mem]   alive: {c}" for c in chains))
    if chains:
        raise AssertionError(f"after {tag}: {len(chains)} engine objects still alive: "
                             f"{chains}")
    return res


class StoreThread:
    """The port's RemoteBlockServer on 127.0.0.1, in an event loop of its
    own thread (the engines' clients are synchronous)."""

    def __init__(self, capacity_bytes: int = 8 << 30):
        from dynamo_tpu_torch.kvbm.remote import RemoteBlockServer

        self.loop = asyncio.new_event_loop()
        self.server = RemoteBlockServer(capacity_bytes=capacity_bytes)
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        port = asyncio.run_coroutine_threadsafe(
            self.server.start("127.0.0.1", 0), self.loop).result(30)
        self.addr = f"127.0.0.1:{port}"

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def kv_transfer_check(smi: str, device: str = "cuda") -> dict:
    """(g1) on the card at llama-3-8b-lite's block geometry (8 layers, 16
    tokens, 8 kv heads, 128): ``extract`` of ``inject(x)`` is ``x`` byte for
    byte at every kv dtype, written in place (the caches' ``data_ptr()``
    unchanged), and bf16 blocks injected into an int8 or int4 cache (the
    card quantizes them) extract as the CPU's ``quantize_block``."""
    from dynamo_tpu_torch.engine.cache import KVCacheSpec, allocate_cache
    from dynamo_tpu_torch.kvbm.transfer import BlockTransferEngine, quantize_block

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    ids, dst = [3, 17, 40, 41], [5, 6, 50, 63]
    out, bf16_blocks = {}, None
    for kv in ("bfloat16", "int8", "int4"):
        spec = KVCacheSpec(num_blocks=64, block_size=16, num_layers=8, num_kv_heads=8,
                           head_dim=128, dtype="bfloat16", kv_dtype=kv)
        src = allocate_cache(spec, dev)
        for c in src:
            if isinstance(c, dict):
                c["q"].copy_(torch.randint(-128, 128, c["q"].shape, generator=gen,
                                           device=dev).to(c["q"].dtype))
                c["s"].copy_(torch.rand(c["s"].shape, generator=gen, device=dev) + 0.01)
            else:
                c.copy_(torch.randn(c.shape, generator=gen, device=dev))
        eng = BlockTransferEngine()
        blocks = eng.extract(*src, ids)
        if kv == "bfloat16":
            bf16_blocks = blocks
        zk, zv = allocate_cache(spec, dev)
        ptrs = [t.data_ptr() for c in (zk, zv)
                for t in (c.values() if isinstance(c, dict) else [c])]
        eng.inject(zk, zv, dst, blocks)
        back = eng.extract(zk, zv, dst)
        same = all(a.tobytes() == b.tobytes() for a, b in zip(blocks, back))
        moved = ptrs != [t.data_ptr() for c in (zk, zv)
                         for t in (c.values() if isinstance(c, dict) else [c])]
        quant_ok = None
        if kv != "bfloat16":
            eng.inject(zk, zv, dst, bf16_blocks)
            got = eng.extract(zk, zv, dst)
            quant_ok = all(g.tobytes() == quantize_block(b, kv).tobytes()
                           for g, b in zip(got, bf16_blocks))
        out[kv] = {"bytes_per_block": int(blocks[0].nbytes), "roundtrip_equal": same,
                   "cache_moved": moved, "card_quantize_equals_cpu": quant_ok}
        if not same or moved or quant_ok is False:
            raise AssertionError(f"[g1] transfer at kv_dtype={kv}: {out[kv]}")
        del src, zk, zv
    log(f"[g1] extract(inject(x)) == x on the card at every kv dtype, in place: "
        f"{json.dumps(out)} on {smi}")
    return out


def phase_g1(kv_dtype: str, smi: str, disk: bool = False) -> dict:
    """(g1) one kv dtype: set A (16 x 1024 + 32 greedy), then set B of the
    same shape on a device pool that holds one working set, evicting A's
    blocks to the host tier (``disk``: a host tier of an eighth of a
    working set spilling to a disk tier in a fresh temporary directory), then A again, which must
    onboard A's blocks, prefill only each prompt's last block, replay
    graphs captured before the first inject, and give the streams of A's
    second run on an engine whose pool keeps A's blocks on the device."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.cache import KVCacheSpec
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.ops import paged_attention as pa

    kind = {"bfloat16": "float", "int8": "int8", "int4": "int4"}[kv_dtype]
    route = pa.ROUTES[(torch.bfloat16, kind)]
    tag = f"[g1] kv_dtype={kv_dtype}{' disk' if disk else ''}"
    cfg = MODEL_PRESETS["llama-3-8b-lite"]
    a, b = (kv_prompts(seed, KV_BATCH, KV_PROMPT, cfg.vocab_size) for seed in (11, 12))
    per_req = -(-(KV_PROMPT + KV_DECODE) // 16)
    work = KV_BATCH * per_req  # one working set, in blocks
    max_len = KV_PROMPT + KV_DECODE + 16
    tmp = tempfile.mkdtemp(prefix="kvdisk-") if disk else None

    async def tiered() -> dict:
        block_bytes = KVCacheSpec.for_model(cfg, 1, 16, kv_dtype).bytes_per_block()
        tiers = (dict(host_kv_blocks=work // 8, disk_kv_path=tmp,
                      disk_kv_bytes=(2 * work + 2 * KV_BATCH) * block_bytes) if disk
                 else dict(host_kv_blocks=2 * work + 2 * KV_BATCH))
        engine = kv_engine(kv_dtype, work + 2 * KV_BATCH, max_len, prefill_chunk=KV_PROMPT, **tiers)
        core = engine.core
        try:
            r1 = await serve_on(engine, kv_reqs(a, "a1", KV_DECODE), route, tag)
            r2 = await serve_on(engine, kv_reqs(b, "b", KV_DECODE), route, tag)
            offloaded = core.kvbm.stats.offloaded_blocks
            before, ptrs = program_calls(core), cache_ptrs(core.runner)
            pre = core.metrics.num_prefill_tokens
            r3 = await serve_on(engine, kv_reqs(a, "a3", KV_DECODE), route, tag)
            return {
                "first": r1["streams"], "third": r3["streams"], "offloaded": offloaded,
                "onboarded": core.kvbm.stats.onboarded_blocks,
                "third_prefill_tokens": core.metrics.num_prefill_tokens - pre,
                "replayed_pre_inject_graphs": sum(
                    core.runner.programs[k].calls > c for k, c in before.items()),
                "cache_moved": ptrs != cache_ptrs(core.runner),
                "tiers": core.kvbm.snapshot(), "transfer": core.kvbm.transfer.stats.snapshot(),
                "ttft_first_all_s": r1["ttft_all_s"], "ttft_b_all_s": r2["ttft_all_s"],
                "ttft_third_all_s": r3["ttft_all_s"], "launches_third": r3["launches"]}
        finally:
            await engine.shutdown()

    async def device_only() -> dict:
        """A's second run on a pool that kept A: its streams and TTFT."""
        engine = kv_engine(kv_dtype, 2 * work + 2 * KV_BATCH, max_len, prefill_chunk=KV_PROMPT)
        try:
            await serve_on(engine, kv_reqs(a, "a1", KV_DECODE), route, tag)
            return await serve_on(engine, kv_reqs(a, "a2", KV_DECODE), route, tag)
        finally:
            await engine.shutdown()

    try:
        res = asyncio.run(tiered())
        free_engine()
        ref = asyncio.run(device_only())
        free_engine()
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    differ = [i for i in ref["streams"] if ref["streams"][i] != res["third"][i]]
    t = res["transfer"]
    summary = {k: v for k, v in res.items() if k not in ("first", "third", "transfer")}
    summary.update({
        "ttft_device_cached_all_s": ref["ttft_all_s"],
        "streams_equal_device_only": KV_BATCH - len(differ),
        "d2h_bytes_per_s": t["d2h_bytes_per_s"], "h2d_bytes_per_s": t["h2d_bytes_per_s"],
        "extract_bytes": t["extract_bytes"], "inject_bytes": t["inject_bytes"],
        "flushes": t["extracts"], "flushes_waited": t["waits"],
        "flush_wait_ms": t["wait_s"] * 1e3, "inject_stage_ms": t["stage_s"] * 1e3})
    log(f"{tag} {json.dumps(summary)} on {smi}")
    suffix_tokens = KV_BATCH * (KV_PROMPT - 16 * ((KV_PROMPT - 1) // 16))
    # (a few of A's blocks may still be on the device when A comes back: the
    # suffix-only prefill shows that every prompt found its whole prefix)
    if (res["offloaded"] <= 0 or res["onboarded"] <= 0
            or res["third_prefill_tokens"] != suffix_tokens or differ
            or res["replayed_pre_inject_graphs"] <= 0 or res["cache_moved"]):
        raise AssertionError(f"{tag}: offloaded {res['offloaded']}, onboarded "
                             f"{res['onboarded']}, third-run prefill "
                             f"{res['third_prefill_tokens']} (want {suffix_tokens}), streams "
                             f"{differ} differ from the device-only engine's, "
                             f"{res['replayed_pre_inject_graphs']} graphs from before the "
                             f"inject replayed, cache moved: {res['cache_moved']}")
    if disk and not (res["tiers"]["disk"]["stores"] > 0 and res["tiers"]["disk"]["hits"] > 0):
        raise AssertionError(f"{tag}: blocks did not cascade to disk and back: {res['tiers']}")
    return summary


def phase_g2(smi: str) -> dict:
    """(g2) the remote tier and blocks across kv dtypes: a bf16 engine with
    ``global_prefix_cache`` publishes 8 prompts' blocks to a store on
    127.0.0.1; an int8 engine onboards them from the store; its quantized
    blocks must equal the CPU's ``quantize_block`` of the stored bytes, and
    its streams those of int8 engines into which the same blocks were
    imported (quantized on the CPU, and as bf16 blocks the card quantizes,
    whose bytes must equal the CPU's too). ``export_blocks`` from the bf16
    engine into another bf16 engine's ``import_blocks`` gives the exporting
    engine's continuation (its own second run, over its own blocks)."""
    from dynamo_tpu_torch.engine.cache import KVCacheSpec
    from dynamo_tpu_torch.kvbm.remote import RemoteBlockPool
    from dynamo_tpu_torch.kvbm.transfer import quantize_block
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = MODEL_PRESETS["llama-3-8b-lite"]
    bf16_route, int8_route = (pa.ROUTES[(torch.bfloat16, k)] for k in ("float", "int8"))
    prompts = kv_prompts(21, PUB_BATCH, KV_PROMPT, cfg.vocab_size)
    hashes = chains(prompts)
    cap = (KV_PROMPT - 1) // 16  # blocks admission matches
    max_len, nb = KV_PROMPT + KV_DECODE + 16, 1200
    store = StoreThread()
    res: dict = {}

    async def publisher() -> list:
        engine = kv_engine("bfloat16", nb, max_len, prefill_chunk=KV_PROMPT,
                           remote_kv_addr=store.addr, global_prefix_cache=True)
        try:
            await serve_on(engine, kv_reqs(prompts, "p1", KV_DECODE), bf16_route, "[g2] publish")
            again = await serve_on(engine, kv_reqs(prompts, "p2", KV_DECODE), bf16_route,
                                   "[g2] publisher's own continuation")
            plan = await engine.run_in_core(lambda c: [c.export_blocks(h) for h in hashes])
            res["published_blocks"] = engine.core.kvbm.stats.published_blocks
            res["own_continuation"] = again["streams"]
            return plan
        finally:
            await engine.shutdown()

    async def importer(kv: str, plans: list | None, route: str, tag: str, rid: str,
                       **kw) -> dict:
        engine = kv_engine(kv, nb, max_len, prefill_chunk=KV_PROMPT, **kw)
        core = engine.core
        try:
            n = 0
            if plans is not None:
                n = await engine.run_in_core(lambda c: sum(c.import_blocks(p) for p in plans))
            pre = core.metrics.num_prefill_tokens
            r = await serve_on(engine, kv_reqs(prompts, rid, KV_DECODE), route, tag)
            blocks = await engine.run_in_core(
                lambda c: [c.export_blocks(h[:cap]) for h in hashes])
            return {"imported": n, "streams": r["streams"],
                    "prefill": core.metrics.num_prefill_tokens - pre,
                    "onboarded": core.kvbm.stats.onboarded_blocks if core.kvbm else 0,
                    "blocks": [[blk for _, _, blk in p] for p in blocks],
                    "transfer": core.transfer.stats.snapshot()}
        finally:
            await engine.shutdown()

    try:
        plans = asyncio.run(publisher())
        free_engine()
        spec = KVCacheSpec.for_model(cfg, 1, 16, "bfloat16")
        reader = RemoteBlockPool(spec, store.addr, fingerprint="llama-3-8b-lite")
        stored = [[reader.get(h) for h in chain[:cap]] for chain in hashes]
        reader.close()
        if any(b is None for chain in stored for b in chain):
            raise AssertionError("[g2] the store lacks published prompt blocks")
        same = asyncio.run(importer("bfloat16", plans, bf16_route, "[g2] bf16 import", "q"))
        free_engine()
        onboard = asyncio.run(importer("int8", None, int8_route, "[g2] int8 onboard", "x",
                                       remote_kv_addr=store.addr))
        free_engine()
        cpu_q = [[(h, par, quantize_block(blk, "int8")) for h, par, blk in p[:cap]]
                 for p in plans]
        cpu_imp = asyncio.run(importer("int8", cpu_q, int8_route, "[g2] int8 cpu-quantized",
                                       "y"))
        free_engine()
        card_imp = asyncio.run(importer("int8", [p[:cap] for p in plans], int8_route,
                                        "[g2] int8 card-quantized", "z"))
        free_engine()
    finally:
        store.close()
    want_q = [[quantize_block(b, "int8").tobytes() for b in chain] for chain in stored]
    checks = {
        "published_blocks": res["published_blocks"],
        "store": store.server.stats.to_dict(),
        "bf16_import_equals_own_continuation": same["streams"] == res["own_continuation"],
        "bf16_import_prefill_tokens": same["prefill"],
        "int8_onboarded_blocks": onboard["onboarded"],
        "int8_onboarded_bytes_equal_cpu_quantize": [[b.tobytes() for b in c]
                                                   for c in onboard["blocks"]] == want_q,
        "int8_card_quantized_bytes_equal_cpu": [[b.tobytes() for b in c]
                                                for c in card_imp["blocks"]] == want_q,
        "int8_streams_equal_cpu_quantized_import": onboard["streams"] == cpu_imp["streams"],
        "int8_streams_equal_card_quantized_import": onboard["streams"] == card_imp["streams"],
        "int8_onboard_prefill_tokens": onboard["prefill"],
        "h2d_bytes_per_s": onboard["transfer"]["h2d_bytes_per_s"],
        "d2h_bytes_per_s_export": card_imp["transfer"]["d2h_bytes_per_s"],
    }
    log(f"[g2] {json.dumps(checks)} on {smi}")
    want_prefill = PUB_BATCH * (KV_PROMPT - 16 * cap)
    equal = ("bf16_import_equals_own_continuation", "int8_onboarded_bytes_equal_cpu_quantize",
             "int8_card_quantized_bytes_equal_cpu", "int8_streams_equal_cpu_quantized_import",
             "int8_streams_equal_card_quantized_import")
    if not (checks["published_blocks"] > 0 and checks["int8_onboarded_blocks"] == PUB_BATCH * cap
            and all(checks[k] for k in equal)
            and same["prefill"] == want_prefill and onboard["prefill"] == want_prefill):
        raise AssertionError(f"[g2] failed: {checks} (suffix prefill wants {want_prefill})")
    return checks


def phase_g3(smi: str) -> dict:
    """(g3) sessions, bf16: 16 sessions. Turn 2 prefills only its suffix
    (the prefill token count) and equals the same turn on an engine without
    sessions whose prefix cache kept turn 1 (same bytes, same suffix); its
    TTFT is printed beside a full recompute's (an engine with prefix caching
    off). While sessions are retained the memory ledger shows ``session``
    pins; after the TTL a request's sweep demotes them to the host tier
    (none left, no orphan pin), the device copies are evicted, and turn 3
    re-imports them and equals the engine without sessions' turn 3. The
    two timed engines capture their graphs before serving
    (``warmup_mode="full"``), so neither TTFT holds a capture."""
    from dynamo_tpu_torch.engine.session import get_session_metrics
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
    from dynamo_tpu_torch.ops import paged_attention as pa

    route = pa.ROUTES[(torch.bfloat16, "float")]
    vocab = MODEL_PRESETS["llama-3-8b-lite"].vocab_size
    p1 = kv_prompts(31, SES_BATCH, SES_PROMPT, vocab)
    extra = [kv_prompts(32 + t, SES_BATCH, SES_NEW, vocab) for t in range(2)]
    max_len = SES_PROMPT + 3 * SES_DECODE + 2 * SES_NEW + 32
    led = get_mem_ledger()
    sm = get_session_metrics()
    res: dict = {}

    async def with_sessions() -> dict:
        engine = kv_engine("bfloat16", 1600, max_len, session_ttl=SES_TTL,
                           host_kv_blocks=2400, warmup_mode="full")
        core = engine.core
        try:
            t1 = await serve_on(engine, kv_reqs(p1, "t1", SES_DECODE, sessions=True), route,
                                "[g3] turn 1")
            pins = led.owner_blocks()["session"]
            p2 = [p + t1["streams"][i] + extra[0][i] for i, p in enumerate(p1)]
            pre, avoided0 = core.metrics.num_prefill_tokens, sm.avoided_tokens.get()
            t2 = await serve_on(engine, kv_reqs(p2, "t2", SES_DECODE, sessions=True), route,
                                "[g3] turn 2")
            res.update(turn2_prefill=core.metrics.num_prefill_tokens - pre,
                       turn2_avoided=sm.avoided_tokens.get() - avoided0,
                       turn1_session_pins=pins, turn2_ttft=t2["ttft_all_s"],
                       turn2_ttft_median=t2["ttft_median_s"])
            dem0 = sm.demoted_blocks.get()
            await asyncio.sleep(SES_TTL + 1.0)
            await serve_on(engine, kv_reqs(kv_prompts(39, 1, 32, vocab), "sweep", 1), route,
                           "[g3] sweep")
            audit = led.audit()
            res.update(sessions_after_ttl=len(core.sessions),
                       session_pins_after_ttl=led.owner_blocks()["session"],
                       demoted_blocks=sm.demoted_blocks.get() - dem0,
                       orphan_pins=audit["orphan_pins"])
            await engine.run_in_core(lambda c: c.pool.release(c.pool.allocate(c.pool.num_free)))
            p3 = [p + t2["streams"][i] + extra[1][i] for i, p in enumerate(p2)]
            on0 = core.kvbm.stats.onboarded_blocks
            t3 = await serve_on(engine, kv_reqs(p3, "t3", SES_DECODE, sessions=True), route,
                                "[g3] turn 3")
            res.update(turn3_onboarded=core.kvbm.stats.onboarded_blocks - on0)
            return {"p2": p2, "p3": p3, "t2": t2["streams"], "t3": t3["streams"]}
        finally:
            await engine.shutdown()

    async def without_sessions(p2, p3) -> dict:
        engine = kv_engine("bfloat16", 4000, max_len)
        try:
            await serve_on(engine, kv_reqs(p1, "n1", SES_DECODE), route, "[g3] no session")
            n2 = await serve_on(engine, kv_reqs(p2, "n2", SES_DECODE), route, "[g3] no session")
            n3 = await serve_on(engine, kv_reqs(p3, "n3", SES_DECODE), route, "[g3] no session")
            return {"t2": n2["streams"], "t3": n3["streams"]}
        finally:
            await engine.shutdown()

    async def recompute(p2) -> dict:
        engine = kv_engine("bfloat16", 1600, max_len, enable_prefix_caching=False,
                           warmup_mode="full")
        try:
            return await serve_on(engine, kv_reqs(p2, "r2", SES_DECODE), route,
                                  "[g3] recompute")
        finally:
            await engine.shutdown()

    led.reset()
    s = asyncio.run(with_sessions())
    free_engine()
    n = asyncio.run(without_sessions(s["p2"], s["p3"]))
    free_engine()
    rc = asyncio.run(recompute(s["p2"]))
    free_engine()
    # the retained chain: every block turn 1 committed (the pipelined loop's
    # speculative last step computes the last token's KV too)
    kept = 16 * res["turn1_session_pins"] // SES_BATCH
    want_prefill = sum(len(p) - kept for p in s["p2"])
    res.update(
        turn2_prefill_want=want_prefill,
        turn2_equal_no_session=sum(s["t2"][i] == n["t2"][i] for i in n["t2"]),
        turn3_equal_no_session=sum(s["t3"][i] == n["t3"][i] for i in n["t3"]),
        turn2_equal_recompute=sum(s["t2"][i] == rc["streams"][i] for i in rc["streams"]),
        recompute_ttft=rc["ttft_all_s"], recompute_ttft_median=rc["ttft_median_s"])
    log(f"[g3] {json.dumps(res)} on {smi}")
    if not (res["turn2_prefill"] == want_prefill
            and res["turn2_avoided"] == SES_BATCH * kept
            and kept >= 16 * ((SES_PROMPT + SES_DECODE - 1) // 16)
            and res["turn2_equal_no_session"] == SES_BATCH
            and res["turn3_equal_no_session"] == SES_BATCH
            and res["sessions_after_ttl"] == 0 and res["session_pins_after_ttl"] == 0
            and res["demoted_blocks"] > 0 and res["orphan_pins"] == 0
            and res["turn3_onboarded"] > 0):
        raise AssertionError(f"[g3] failed: {res}")
    return res


def phase_g4(smi: str) -> dict:
    """(g4) stream checkpoints, f32 (llama-3-8b-lite with f32 weights over
    the f32 cache): a greedy and a seeded sampled stream under
    ``stream_ckpt_blocks=1`` against the remote store, cut when both have
    20 tokens by shutting the engine down with their records stored; a
    fresh engine resumes each from its record (the stored blocks onboard,
    the draw counter and penalty counts restore) and both must equal an
    uninterrupted run token for token; a finished stream's record is gone."""
    from dynamo_tpu_torch.kvbm.remote import ckpt_client
    from dynamo_tpu_torch.kvbm.stream_ckpt import CKPT_DRAWS_KEY, CKPT_GENERATED_KEY
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.ops import paged_attention as pa

    model = register_f32_model()
    route = pa.ROUTES[(torch.float32, "float")]
    vocab = MODEL_PRESETS[model].vocab_size
    prompts = kv_prompts(41, 2, CKPT_PROMPT, vocab)
    so = [dict(), dict(temperature=0.8, seed=1234)]
    rids = ["ckpt-greedy", "ckpt-sampled"]
    max_len, nb = CKPT_PROMPT + CKPT_DECODE + 32, 256
    store = StoreThread()
    tiers = dict(remote_kv_addr=store.addr, stream_ckpt_blocks=1)

    def reqs(plist, max_tokens, ann=None) -> dict:
        out = {}
        for i in range(2):
            out.update({i: kv_reqs([plist[i]], "x", max_tokens[i],
                                   annotations=[ann[i]] if ann else None, **so[i])[0]})
            out[i].request_id = rids[i]
        return out

    async def uninterrupted() -> dict:
        engine = kv_engine("bfloat16", nb, max_len, model=model)
        try:
            return (await serve_on(engine, reqs(prompts, [CKPT_DECODE] * 2), route,
                                   "[g4] uninterrupted"))["streams"]
        finally:
            await engine.shutdown()

    async def interrupted() -> dict:
        engine = kv_engine("bfloat16", nb, max_len, model=model, **tiers)
        got = {0: [], 1: []}
        enough = asyncio.Event()

        async def one(i, r):
            async for out in engine.generate(r):
                got[i] += out.token_ids
                if all(len(v) >= CKPT_CUT for v in got.values()):
                    enough.set()

        tasks = [asyncio.ensure_future(one(i, r))
                 for i, r in reqs(prompts, [CKPT_DECODE] * 2).items()]
        await enough.wait()
        await engine.shutdown()  # the worker dies: nothing reaps the records
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        return got

    async def resumed(recs: list[dict]) -> dict:
        engine = kv_engine("bfloat16", nb, max_len, model=model, **tiers)
        core = engine.core
        try:
            gen = [r["generated"] for r in recs]
            ann = [{CKPT_GENERATED_KEY: len(g), CKPT_DRAWS_KEY: r["draws"]}
                   for g, r in zip(gen, recs)]
            r = await serve_on(engine, reqs([prompts[i] + gen[i] for i in range(2)],
                                            [CKPT_DECODE - len(g) for g in gen], ann),
                               route, "[g4] resumed")
            return {"streams": {i: gen[i] + r["streams"][i] for i in range(2)},
                    "onboarded": core.kvbm.stats.onboarded_blocks,
                    "resumes": core.metrics.stream_ckpt_resumes}
        finally:
            await engine.shutdown()

    try:
        full = asyncio.run(uninterrupted())
        free_engine()
        cut = asyncio.run(interrupted())
        free_engine()
        client = ckpt_client(store.addr)
        recs = [client.get_stream_ckpt(rid) for rid in rids]
        if any(r is None for r in recs):
            raise AssertionError(f"[g4] no record stored for {rids}: {recs}")
        res = asyncio.run(resumed(recs))
        free_engine()
        gone = [client.get_stream_ckpt(rid) is None for rid in rids]
        client.close()
    finally:
        store.close()
    out = {"cut_at": {rids[i]: len(cut[i]) for i in range(2)},
           "record_generated": {rids[i]: len(recs[i]["generated"]) for i in range(2)},
           "record_blocks": {rids[i]: len(recs[i]["hashes"]) for i in range(2)},
           "onboarded": res["onboarded"], "resumes": res["resumes"],
           "greedy_equal": res["streams"][0] == full[0],
           "sampled_equal": res["streams"][1] == full[1],
           "cut_prefix_equal": all(cut[i] == full[i][: len(cut[i])] for i in range(2)),
           "records_gone": gone}
    log(f"[g4] {json.dumps(out)} on {smi}")
    if not (out["greedy_equal"] and out["sampled_equal"] and out["cut_prefix_equal"]
            and all(gone) and out["onboarded"] > 0 and out["resumes"] == 2):
        raise AssertionError(f"[g4] failed: {out}")
    return out


def phase_kvbm(smi: str) -> dict:
    """(g): the KVBM tiers, sessions, stream checkpoints and blocks across
    engines at llama-3-8b-lite width (8 layers, random weights)."""
    t0 = time.perf_counter()
    res = {"transfer": kv_transfer_check(smi)}
    for kv in ("bfloat16", "int8", "int4"):
        res[f"g1_{kv}"] = phase_g1(kv, smi)
    res["g1_disk"] = phase_g1("bfloat16", smi, disk=True)
    res["g2"] = phase_g2(smi)
    res["g3"] = phase_g3(smi)
    res["g4"] = phase_g4(smi)
    log(f"[g] passed in {time.perf_counter() - t0:.1f}s on {smi}")
    return res


# ---------------------------------------------------------------------------
# (a) paged_attention_sharded: per-rank launches against the unsharded one
# ---------------------------------------------------------------------------

#: the tensor-parallel degrees phase (a) splits llama-3-8b-lite's 8 kv heads
#: over (kv heads a rank: 4, 2, 1)
TP_DEGREES = (2, 4, 8)
#: the sharded cases: the main decode shape and the 128-token prefill
SHARDED_PREFILL = "prefill B=32 T=128 kv 128"
#: the sharded entry's source and the JAX function it replaces
SHARDED_REPLACES = "dynamo_tpu/ops/paged_attention.py:467"


def phase_sharded(bw: float, peak: float) -> dict:
    """``ops.paged_attention.paged_attention_sharded`` at tp 2, 4 and 8 on
    every route, at the main decode shape and the 128-token prefill: with
    the split count forced to the unsharded launch's it must equal that
    launch bit for bit (heads are independent: a CTA computes one (row,
    kv head, split) alike however many heads the cache holds); with each
    rank's own split choice (``num_splits_for`` on its local kv heads, as
    JAX's shard_map'd call chooses) it must keep the route's limit against
    the plain version. Each call must launch the route's kernel once a
    rank. Times one rank's launch on its local heads (rank 0's shards),
    its bound, SDPA on the same local heads and, at tp=2, the plain
    version. Rows by route, then ``"{case} tp={tp}"``."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    lens = torch.randint(128, 193, (32,), generator=gen, device="cuda").tolist()
    cases = {
        MAIN_CASE: attention_case(gen, 32, 1, 16, [n - 1 for n in lens], [1] * 32),
        SHARDED_PREFILL: attention_case(gen, 32, 128, 8, [0] * 32, [128] * 32),
    }
    results: dict[str, dict] = {route: {} for route in pa.ROUTE_KERNELS}
    for name, (q32, k32, v32, bt, qs, kl) in cases.items():
        k, v = k32.bfloat16(), v32.bfloat16()
        for kind in KV_DTYPES:
            kq, vq = (None, None) if kind == "float" else (quantize(k, kind), quantize(v, kind))
            for q_dtype in Q_DTYPES:
                q = q32.to(q_dtype)
                kc, vc = (((k32, v32) if q_dtype == torch.float32 else (k, v))
                          if kind == "float" else (kq, vq))
                route = pa.ROUTES[(q_dtype, kind)]
                kv_heads = (kc if kind == "float" else kc["q"]).shape[2]
                ns = pa.num_splits_for(q, kv_heads, bt.shape[1], 0, kind)
                whole = pa.paged_attention(q, kc, vc, bt, qs, kl, num_splits=ns)
                ref = plain_by_rows(pa, q, kc, vc, bt, qs, kl, num_splits=ns).float()
                rel, abs_ = err_limit(q_dtype)
                limit = rel * ref.abs() + abs_
                for tp in TP_DEGREES:
                    pa.reset_launches()
                    forced = pa.paged_attention_sharded(q, kc, vc, bt, qs, kl, tp=tp,
                                                        num_splits=ns)
                    auto = pa.paged_attention_sharded(q, kc, vc, bt, qs, kl, tp=tp)
                    torch.cuda.synchronize()
                    launches = dict(pa.paged_attention.launches_by_kernel)
                    want = {r: (2 * tp if r == route else 0) for r in pa.ROUTE_KERNELS}
                    bitwise = torch.equal(forced, whole)
                    diff = (auto.float() - ref).abs()
                    err, ratio = diff.max().item(), (diff / limit).max().item()
                    ql = q.chunk(tp, dim=2)[0].contiguous()
                    kr, vr = pa.shard_heads(kc, 0, tp), pa.shard_heads(vc, 0, tp)
                    largs = (ql, kr, vr, bt, qs, kl)
                    ns_rank = pa.num_splits_for(ql, kv_heads // tp, bt.shape[1], 0, kind)
                    nbytes, ops = attention_work(ql, kr, bt, qs, kl)
                    if q_dtype == torch.bfloat16:
                        ops_s = ops / peak
                    else:
                        ops_s = min(ops / CARD_PEAK_F32, ops * F32_MMAS[kind] / peak)
                    bytes_ms, ops_ms = nbytes / bw * 1e3, ops_s * 1e3
                    row = {
                        "route": route, "tp": tp, "heads": ql.shape[2],
                        "kv_heads": kv_heads // tp, "num_splits_whole": ns,
                        "num_splits_rank": ns_rank, "bitwise_at_equal_splits": bitwise,
                        "launches": launches[route], "max_abs_err": err,
                        "err_over_limit": ratio, "err_limit": [rel, abs_],
                        "ms": time_ms(lambda: pa.paged_attention(*largs)),
                        # the same launch at the unsharded launch's split count
                        "ms_at_whole_splits": (
                            time_ms(lambda: pa.paged_attention(*largs, num_splits=ns))
                            if ns_rank != ns else None),
                        "plain_ms": (time_ms(lambda: plain_by_rows(pa, *largs,
                                                                   num_splits=ns_rank))
                                     if tp == 2 else None),
                        "library_ms": time_ms(library_fn(*largs)),
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    }
                    results[route][f"{name} tp={tp}"] = row
                    log(f"[a'] paged_attention_sharded {route} {name} tp={tp}: "
                        + " ".join(f"{key}={row[key]}" for key in (
                            "heads", "kv_heads", "num_splits_whole", "num_splits_rank",
                            "bitwise_at_equal_splits", "launches", "err_over_limit", "ms",
                            "ms_at_whole_splits", "plain_ms", "library_ms", "bound_ms",
                            "bound_by")))
                    if launches != want:
                        raise AssertionError(f"sharded {route} {name} tp={tp}: launches "
                                             f"{launches}, expected {want}")
                    if not bitwise:
                        raise AssertionError(
                            f"sharded {route} {name} tp={tp}: at {ns} splits the per-rank "
                            "launches differ from the unsharded launch")
                    if not (ratio <= 1.0 and bool(torch.isfinite(auto.float()).all())):
                        raise AssertionError(f"sharded {route} {name} tp={tp}: err/limit "
                                             f"{ratio} with the ranks' own splits")
                    del forced, auto, ql, kr, vr
                del q, kc, vc, whole, ref, limit
            del kq, vq
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# (h) tensor parallelism: llama-3-8b-lite at tp=2
# ---------------------------------------------------------------------------

#: (h)'s traffic: (b)'s 32 prompts of 128, 32 greedy tokens
TP_BATCH, TP_PROMPT, TP_DECODE = 32, 128, 32
#: (h)'s and (i3)'s models are cut to this depth, which keeps the script,
#: (p) included, inside its time limit
TP_LAYERS = 4


def tp_cut(model: str) -> str:
    """Register ``model`` cut to TP_LAYERS layers as a preset of its own;
    returns its name."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS

    name = f"{model}-{TP_LAYERS}l"
    MODEL_PRESETS[name] = dataclasses.replace(MODEL_PRESETS[model], num_layers=TP_LAYERS,
                                              name=name)
    return name
#: the KV pool of every (h) engine: ranks that share a card size it
#: explicitly (32 rows of 13 blocks, and the trash block)
TP_BLOCKS = 480


def tp_engine(model: str, kv_dtype: str, tp: int, backend: str = "gloo",
              devices: tuple[int, ...] = (), quantization: str = "none"):
    """An eager (warmup off) engine of ``model`` at ``tp`` for (h) and (i3):
    random weights from seed 0, every rank building the full tree and
    keeping its shard (with int8 quantizing its shard, the row-parallel
    scales over the group)."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.utils.config import EngineConfig

    return build_engine(EngineConfig(
        model=model, block_size=16, max_batch_size=TP_BATCH, num_blocks=TP_BLOCKS,
        max_model_len=TP_PROMPT + TP_DECODE + 16, prefill_chunk=TP_PROMPT,
        kv_dtype=kv_dtype, allow_random_weights=True, warmup_mode="off",
        tp=tp, dist_backend=backend, tp_devices=devices, quantization=quantization))


def tp_run(tag: str, model: str, kv_dtype: str, tp: int, backend: str = "gloo",
           devices: tuple[int, ...] = (), quantization: str = "none") -> tuple[dict, dict]:
    """One (h) serving run: (b)'s traffic through ``AsyncTorchEngine``, all
    requests entered before the first step. At tp > 1 every rank's counts
    are set to 0 just before it and read just after, and every rank must
    have launched its route's kernel only, once a layer and forward step,
    over its local heads. Returns the run's numbers and its streams
    {i: (tokens, logprobs)}."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    t0 = time.perf_counter()
    engine = tp_engine(model, kv_dtype, tp, backend, devices, quantization)
    core = engine.core
    setup_s = time.perf_counter() - t0
    cfg = core.model_cfg
    hi = cfg.vocab_size - 5
    reqs = {i: PreprocessedRequest(
        token_ids=[(7 * i + 11 * j) % hi + 5 for j in range(TP_PROMPT)],
        stop_conditions=StopConditions(max_tokens=TP_DECODE, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0),
        request_id=f"tp-{i}") for i in range(TP_BATCH)}
    if tp > 1:
        core.reset_tp_stats()
    pa.reset_launches()
    stats = (lambda eng: eng.run_in_core(lambda c: c.tp_stats())) if tp > 1 else None
    t_start, first_at, done_at, streams, (_fin, ranks) = asyncio.run(
        serve(engine, reqs, after=stats))
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    for i, (toks, lps) in streams.items():
        if len(toks) != TP_DECODE or len(lps) != TP_DECODE:
            raise AssertionError(f"{tag}: request {i}: {len(toks)} tokens, {len(lps)} "
                                 f"logprobs, expected {TP_DECODE}")
    q_dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    route = pa.ROUTES[(q_dtype, {"int8": "int8", "int4": "int4"}.get(kv_dtype, "float"))]
    t_first, t_end = max(first_at.values()), max(done_at.values())
    res = {"model": model, "kv_dtype": kv_dtype, "quantization": quantization, "tp": tp,
           "backend": backend if tp > 1 else None,
           "setup_s": setup_s, "ttft_all_s": t_first - t_start,
           "decode_tok_s": TP_BATCH * (TP_DECODE - 1) / (t_end - t_first),
           "wall_s": t_end - t_start, "route": route, "launches": by_kernel[route]}
    if tp > 1:
        from dynamo_tpu_torch.parallel.mesh import local_heads

        layers = cfg.num_layers
        heads = local_heads(cfg, tp)
        steps = {r["forward_steps"] for r in ranks}
        for r in ranks:
            want = {k: layers * r["forward_steps"] if k == route else 0
                    for k in r["launches_by_kernel"]}
            if (r["launches_by_kernel"] != want or r["forward_steps"] <= 0
                    or (r["heads"], r["kv_heads"], r["cache_kv_heads"]) != (*heads, heads[1])):
                raise AssertionError(f"{tag}: rank {r['rank']} launched "
                                     f"{r['launches_by_kernel']} in {r['forward_steps']} "
                                     f"forward steps on {r['heads']} heads / {r['kv_heads']} "
                                     f"kv heads; expected {layers} of {route} a step on "
                                     f"{heads[0]} / {heads[1]}")
        if len(steps) != 1 or by_kernel != ranks[0]["launches_by_kernel"]:
            raise AssertionError(f"{tag}: ranks ran {steps} forward steps; leader counts "
                                 f"{by_kernel} against its report {ranks[0]}")
        res["ranks"] = [{"rank": r["rank"], "launches": r["launches_by_kernel"][route],
                         "forward_steps": r["forward_steps"], "heads": r["heads"],
                         "kv_heads": r["kv_heads"], "collectives": r["collectives"],
                         "collective_ms_per_step": 1e3 * r["collective_s"] / r["forward_steps"]}
                        for r in ranks]
        res["launches"] = sum(r["launches_by_kernel"][route] for r in ranks)
        res["launches_per_rank_step"] = by_kernel[route] / ranks[0]["forward_steps"]
    log(f"{tag} " + json.dumps(res))
    del engine, core
    free_engine()
    return res, streams


def compare_streams(tag: str, got: dict, ref: dict) -> tuple[int, list, list]:
    """Streams equal to ``ref``'s, those that first differ at a near-tie
    (|dlp| < NEAR_TIE between the two runs' log-probs of their chosen
    tokens there), and the others."""
    equal, ties, bad = 0, [], []
    for i, (toks, lps) in got.items():
        ref_toks, ref_lps = ref[i]
        j = next((j for j, (a, b) in enumerate(zip(toks, ref_toks)) if a != b), None)
        if j is None:
            equal += 1
        elif abs(lps[j] - ref_lps[j]) < NEAR_TIE:
            ties.append((i, j, abs(lps[j] - ref_lps[j])))
        else:
            bad.append((i, j, toks[j], ref_toks[j], lps[j], ref_lps[j]))
    log(f"{tag}: streams equal: {equal} of {len(got)}; first differing at a near-tie "
        f"(|dlp| < {NEAR_TIE}): {len(ties)} {ties}; otherwise: {len(bad)} {bad[:4]}")
    return equal, ties, bad


def phase_tp(smi: str, b_serve: dict) -> dict:
    """(h) llama-3-8b-lite cut to TP_LAYERS layers served at tp=2 as two
    processes on cuda:0 over gloo (eager steps, an explicit KV pool): (h1)
    f32 weights over the f32 cache, every stream equal to tp=1's or first
    differing at a near-tie; (h2) bf16 over the bf16 and int8 caches,
    decode tok/s and TTFT beside (b)'s (8 layers) and the milliseconds a
    step spends in collectives (no speed condition). With two cards or more, (h1) again over nccl, one card a
    rank. Then (i3): f32 weights quantized to int8 at tp=2 (each rank its
    shard) against tp=1, by (h1)'s stream rule."""
    free_engine()
    t0 = time.perf_counter()
    f32, bf16 = tp_cut(register_f32_model()), tp_cut("llama-3-8b-lite")
    res: dict = {"layers": TP_LAYERS}
    one, s_one = tp_run("[h1] f32 tp=1", f32, "bfloat16", 1)
    two, s_two = tp_run("[h1] f32 tp=2 gloo, both ranks on cuda:0", f32, "bfloat16", 2,
                        devices=(0, 0))
    equal, ties, bad = compare_streams("[h1] f32 tp=2 against tp=1", s_two, s_one)
    if bad:
        raise AssertionError(f"[h1] {len(bad)} tp=2 streams leave tp=1's at no near-tie: "
                             f"{bad[:4]}")
    res["h1"] = {"tp1": one, "tp2": two, "equal": equal, "near_ties": len(ties)}
    if torch.cuda.device_count() >= 2:
        nccl, s_nccl = tp_run("[h1] f32 tp=2 nccl, cuda:0 and cuda:1", f32, "bfloat16", 2,
                              backend="nccl")
        equal, ties, bad = compare_streams("[h1] f32 tp=2 nccl against tp=1", s_nccl, s_one)
        if bad:
            raise AssertionError(f"[h1] nccl: {len(bad)} streams leave tp=1's at no near-tie")
        res["h1_nccl"] = {"tp2": nccl, "equal": equal, "near_ties": len(ties)}
    else:
        log(f"[h1] the nccl configuration (one card a rank) was not run: this host has "
            f"{torch.cuda.device_count()} CUDA device")
    for kind in ("float", "int8"):
        kv = KV_DTYPES[kind]
        run, _ = tp_run(f"[h2] bf16 kv_dtype={kv} tp=2 gloo, both ranks on cuda:0",
                        bf16, kv, 2, devices=(0, 0))
        log(f"[h2] bf16 kv_dtype={kv} tp=2, {TP_LAYERS} layers: decode tok/s "
            f"{run['decode_tok_s']} against (b)'s (8 layers) {b_serve[kind]['decode_tok_s']}, "
            f"TTFT (all 32) {run['ttft_all_s']} s against {b_serve[kind]['ttft_all_s']} s; "
            f"collectives {[r['collective_ms_per_step'] for r in run['ranks']]} ms a step "
            f"(no pass condition) on {smi}")
        res[f"h2_{kv}"] = run
    res["seconds"] = time.perf_counter() - t0
    log(f"[h] passed in {res['seconds']:.1f}s on {smi}")
    t1 = time.perf_counter()
    one, s_one = tp_run("[i3] f32 int8 tp=1", f32, "bfloat16", 1, quantization="int8")
    two, s_two = tp_run("[i3] f32 int8 tp=2 gloo, both ranks on cuda:0", f32, "bfloat16", 2,
                        devices=(0, 0), quantization="int8")
    equal, ties, bad = compare_streams("[i3] f32 int8 tp=2 against tp=1", s_two, s_one)
    if bad:
        raise AssertionError(f"[i3] {len(bad)} int8 tp=2 streams leave tp=1's at no "
                             f"near-tie: {bad[:4]}")
    res["i3"] = {"tp1": one, "tp2": two, "equal": equal, "near_ties": len(ties),
                 "seconds": time.perf_counter() - t1}
    log(f"[i3] passed in {res['i3']['seconds']:.1f}s on {smi}")
    return res


# ---------------------------------------------------------------------------
# (k) the distributed deployment: coordinator, frontend, workers as processes
# ---------------------------------------------------------------------------

#: (k)'s processes: the lease TTL within which a killed worker leaves
#: discovery, and the workers' KV pools (explicit: four processes share the
#: card, and sizing from free memory would race)
K_TTL_S = 6.0
K_MODEL = "llama-3-8b-lite"
K_F32_NAME = "llama-3-8b-lite-f32"
K_F32_BLOCKS, K_BF16_BLOCKS = 512, 1280
K_BATCH, K_PROMPT = 32, 128
K_PREFIX, K_SUFFIX, K_GROUPS, K_GROUP, K_GROUP_DECODE = 1024, 16, 4, 8, 32
K4_STREAMS, K4_DECODE = 8, 64


def k_prompts(vocab: int) -> list[list[int]]:
    """(b)'s prompts (and (b'')'s, the reference of (k1))."""
    hi = vocab - 5
    return [[(7 * i + 11 * j) % hi + 5 for j in range(K_PROMPT)] for i in range(K_BATCH)]


def k_tokenizer(root: Path, vocab: int) -> Path:
    """A byte-level BPE tokenizer.json whose id ``i`` is the text `` t<i>``
    (no merges): the frontend streams every token of the random-weight
    model as text the client maps back to its id."""
    d = root / "k-tokenizer"
    d.mkdir(parents=True, exist_ok=True)
    spec = {"model": {"type": "BPE", "vocab": {f"\u0120t{i}": i for i in range(vocab)},
                      "merges": []}, "added_tokens": []}
    (d / "tokenizer.json").write_text(json.dumps(spec))
    return d


class KCluster:
    """(k)'s processes, each a module of the port started with
    ``python -m`` from the checkout, its output in a log file."""

    def __init__(self, root: Path, env: dict):
        self.root, self.env = root, env
        self.procs: dict[str, tuple[subprocess.Popen, Path]] = {}
        self.expected_dead: set[str] = set()

    def start(self, name: str, module: str, args: list[str], env: dict | None = None) -> None:
        path = self.root / f"{name}.log"
        out = open(path, "w")
        proc = subprocess.Popen([sys.executable, "-u", "-m", module, *args], cwd=ROOT,
                                env={**self.env, **(env or {})}, stdout=out,
                                stderr=subprocess.STDOUT)
        out.close()
        self.procs[name] = (proc, path)

    def log_of(self, name: str) -> str:
        return self.procs[name][1].read_text(errors="replace")

    def wait_line(self, name: str, needle: str, timeout: float) -> str:
        proc, _ = self.procs[name]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in self.log_of(name).splitlines():
                if needle in line:
                    return line
            if proc.poll() is not None:
                raise AssertionError(f"[k] {name} exited rc={proc.returncode} before "
                                     f"{needle!r}:\n{self.log_of(name)[-4000:]}")
            time.sleep(0.1)
        raise AssertionError(f"[k] {name}: no {needle!r} in {timeout}s:\n"
                             f"{self.log_of(name)[-4000:]}")

    def check_alive(self) -> None:
        """A process that dies unasked fails the run."""
        for name, (proc, _) in self.procs.items():
            if name not in self.expected_dead and proc.poll() is not None:
                raise AssertionError(f"[k] {name} died (rc={proc.returncode}):\n"
                                     f"{self.log_of(name)[-4000:]}")

    def kill(self, name: str) -> None:
        self.expected_dead.add(name)
        self.procs[name][0].kill()

    def terminate(self, name: str, timeout: float) -> int:
        self.expected_dead.add(name)
        proc = self.procs[name][0]
        proc.terminate()
        return proc.wait(timeout)

    def stop_all(self) -> None:
        for name, (proc, _) in self.procs.items():
            if proc.poll() is None:
                proc.terminate()
        for name, (proc, _) in self.procs.items():
            try:
                proc.wait(20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)


def k_get(port: int, path: str) -> dict:
    res = asyncio.run(http_call(port, "GET", path))
    if res["status"] != 200:
        raise AssertionError(f"[k] GET {path}: {res['status']} {res['body'][:300]}")
    return json.loads(res["body"]) if path != "/metrics" else res["body"].decode()


def k_stats(port: int, model: str) -> dict:
    return k_get(port, "/engine_stats").get(model, {})


def k_settled(port: int, model: str, workers: list[str]) -> dict:
    """The model's stats once every worker's published engine is idle (each
    worker publishes every 0.25 s: the wait lets the last step's counts
    arrive)."""
    time.sleep(0.6)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = k_stats(port, model)
        ws = st.get("workers", {})
        if all(w in ws and ws[w]["num_running"] == 0 and ws[w]["num_waiting"] == 0
               for w in workers):
            return st
        time.sleep(0.1)
    raise AssertionError(f"[k] {model}: workers {workers} never went idle: {st}")


def k_launches(tag: str, before: dict, after: dict, workers: list[str], route: str,
               layers: int) -> dict:
    """Each worker's launches and forward steps between two stats reads:
    ``route`` only, ``layers`` a forward step; returns them by worker."""
    out = {}
    for w in workers:
        a0, a1 = before["workers"][w]["attention"], after["workers"][w]["attention"]
        steps = a1["forward_steps"] - a0["forward_steps"]
        by_kernel = {k: a1["launches"][k] - a0["launches"].get(k, 0) for k in a1["launches"]}
        want = {k: layers * steps if k == route else 0 for k in by_kernel}
        if by_kernel != want:
            raise AssertionError(f"{tag}: worker {w} launched {by_kernel} in {steps} "
                                 f"forward steps; expected {layers} of {route} a step")
        out[w] = {"launches": by_kernel[route], "forward_steps": steps,
                  "launches_per_forward_step": by_kernel[route] / steps if steps else None,
                  "peak_mem_gib": a1["max_memory_allocated"] / 2**30}
    return out


def k_ids(text: str) -> list[int]:
    """The ids of a stream's text (every token is `` t<id>``)."""
    words = text.split()
    if not all(w.startswith("t") and w[1:].isdigit() for w in words):
        raise AssertionError(f"[k] text not made of `` t<id>`` tokens: {text[:200]!r}")
    return [int(w[1:]) for w in words]


async def k_stream(port: int, model: str, prompt: list[int], max_tokens: int,
                   headers: dict | None = None) -> dict:
    res = await http_call(port, "POST", "/v1/completions", {
        "model": model, "prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
        "logprobs": 0, "ignore_eos": True, "stream": True,
        "stream_options": {"include_usage": True}}, headers=headers)
    if res["status"] != 200:
        raise AssertionError(f"[k] {model}: status {res['status']} {res['body'][:300]}")
    s = sse_summary(res)
    ids = k_ids(s["text"])
    if len(ids) != max_tokens or len(s["lps"]) != max_tokens or s["finish"] != "length":
        raise AssertionError(f"[k] {model}: {len(ids)} ids, {len(s['lps'])} logprobs, "
                             f"finish {s['finish']}; expected {max_tokens}")
    return {"ids": ids, "lps": s["lps"], "t0": res["t0"], "first": s["first"],
            "last": s["last"], "times": res["times"]}


def k_batch(port: int, model: str, prompts: list[list[int]], max_tokens: int) -> list[dict]:
    async def go():
        return await asyncio.gather(*(k_stream(port, model, p, max_tokens) for p in prompts))
    return asyncio.run(go())


def k_compare(tag: str, got: list[dict], ref: dict) -> dict:
    """``compare_streams`` of the client's streams against ``ref``
    ({i: (tokens, logprobs)}); fails on a stream that leaves it at no
    near-tie."""
    equal, ties, bad = compare_streams(tag, {i: (g["ids"], g["lps"]) for i, g in
                                             enumerate(got)}, ref)
    if bad:
        raise AssertionError(f"{tag}: streams leave the reference at no near-tie: {bad[:4]}")
    return {"streams_equal": equal, "near_ties": ties}


def codec_us_per_frame(n: int = 20000) -> float:
    """The port's codec on one streamed token's DATA frame, packed and
    unpacked (the worker packs it, the frontend unpacks it): microseconds a
    frame on this host."""
    from dynamo_tpu_torch.protocols.common import LLMEngineOutput
    from dynamo_tpu_torch.transports.wire import Frame, encode_frame
    from dynamo_tpu_torch.utils import msgpack

    frame = {"t": Frame.DATA, "id": 123456,
             "d": LLMEngineOutput(token_ids=[91234], cum_log_probs=-12.5,
                                  log_probs=[-0.25]).to_dict()}
    t0 = time.perf_counter()
    for _ in range(n):
        msgpack.unpackb(encode_frame(frame)[4:])
    return 1e6 * (time.perf_counter() - t0) / n


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def k_worker_args(url: str, component: str, served: str, blocks: int, max_len: int,
                  tokenizer: Path, device: str, extra: list[str]) -> list[str]:
    return ["--coordinator", url, "--model", K_MODEL, "--allow-random-weights",
            "--component", component, "--served-model-name", served,
            "--num-blocks", str(blocks), "--block-size", "16", "--max-batch-size", "32",
            "--max-model-len", str(max_len), "--prefill-chunk", "128",
            "--warmup-mode", "full", "--warmup-deadline", "0", "--tokenizer", str(tokenizer),
            *(["--device", device] if device != "cuda" else []), *extra]


def phase_cluster(smi: str, f32_ref: dict, b_bf16: dict | None, e2: dict | None,
                  device: str = "cuda") -> dict:
    """(k): see the module docstring. ``f32_ref`` is (b'')'s in-process f32
    streams {i: (tokens, logprobs)}, ``b_bf16`` and ``e2`` (b)'s bf16 and
    (e2)'s numbers to print beside (k2)'s."""
    import tempfile

    from dynamo_tpu_torch.models.config import resolve_model_config
    from dynamo_tpu_torch.ops.paged_attention import ROUTES

    cfg = resolve_model_config(K_MODEL)
    layers, vocab = cfg.num_layers, cfg.vocab_size
    tmp = Path(tempfile.mkdtemp(prefix="k-cluster-"))
    tok = k_tokenizer(tmp, vocab)

    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1",
           "DYN_LEASE_TTL_S": str(K_TTL_S), "DYN_LOG": "info"}
    cl = KCluster(tmp, env)
    out: dict = {"smi": smi}
    t_phase = time.perf_counter()
    try:
        coord_port, http_port = free_port(), free_port()
        cl.start("coordinator", "dynamo_tpu_torch.transports.coordinator",
                 ["--host", "127.0.0.1", "--port", str(coord_port)])
        cl.wait_line("coordinator", "COORDINATOR_READY", 60)
        url = f"tcp://127.0.0.1:{coord_port}"
        f32_len = K_PROMPT + K4_DECODE + 16
        bf16_len = max(K_PREFIX + K_SUFFIX + K_GROUP_DECODE, K_PROMPT + 64) + 16
        for name in ("f32a", "f32b"):
            cl.start(name, "dynamo_tpu_torch.components.worker", k_worker_args(
                url, "f32", K_F32_NAME, K_F32_BLOCKS, f32_len, tok, device,
                ["--dtype", "float32"]))
        for name in ("bf16a", "bf16b"):
            cl.start(name, "dynamo_tpu_torch.components.worker", k_worker_args(
                url, "bf16", K_MODEL, K_BF16_BLOCKS, bf16_len, tok, device, []))
        cl.start("frontend", "dynamo_tpu_torch.components.frontend",
                 ["--coordinator", url, "--host", "127.0.0.1", "--port", str(http_port),
                  "--router-mode", "kv"])
        cl.wait_line("frontend", "FRONTEND_READY", 120)
        ids = {}
        for name in ("f32a", "f32b", "bf16a", "bf16b"):
            ids[name] = cl.wait_line(name, "WORKER_READY", 600).split(
                "instance=")[1].strip().lstrip("0")
        name_of = {v: k for k, v in ids.items()}
        f32_w, bf16_w = [ids["f32a"], ids["f32b"]], [ids["bf16a"], ids["bf16b"]]
        deadline = time.monotonic() + 60
        while True:
            st = k_get(http_port, "/engine_stats")
            if all(sorted(st.get(m, {}).get("instances", [])) == sorted(ws)
                   and set(st.get(m, {}).get("workers", {})) >= set(ws)
                   for m, ws in ((K_F32_NAME, f32_w), (K_MODEL, bf16_w))):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"[k] the frontend did not discover the workers: {st}")
            time.sleep(0.2)
        out["startup_s"] = time.perf_counter() - t_phase
        for name in ids:
            warm = [ln for ln in cl.log_of(name).splitlines() if "bucket warmup" in ln]
            log(f"[k] {name} ({ids[name]}) {warm[-1].split(': ', 2)[-1] if warm else ''}")
        log(f"[k] coordinator, frontend and 4 workers up in {out['startup_s']:.1f}s")
        cl.check_alive()

        # (k1) f32 against (b'')'s in-process streams
        prompts = k_prompts(vocab)
        s0 = k_settled(http_port, K_F32_NAME, f32_w)
        got = k_batch(http_port, K_F32_NAME, prompts, len(f32_ref[0][0]))
        s1 = k_settled(http_port, K_F32_NAME, f32_w)
        k1 = k_compare("[k1] f32 through the frontend against (b'')", got, f32_ref)
        k1["workers"] = k_launches("[k1]", s0, s1, f32_w, ROUTES[(torch.float32, "float")],
                                   layers)
        k1["requests_per_worker"] = {w: s1["router"]["routed"].get(w, 0)
                                     - s0["router"]["routed"].get(w, 0) for w in f32_w}
        out["k1"] = k1
        log("[k1] " + json.dumps(k1))
        # (k4)'s reference: its 8 prompts unbroken, 64 tokens
        k4_prompts = prompts[:K4_STREAMS]
        k4_ref = {i: (g["ids"], g["lps"]) for i, g in enumerate(
            k_batch(http_port, K_F32_NAME, k4_prompts, K4_DECODE))}
        cl.check_alive()

        # (k2) bf16 at (b)'s traffic
        s0 = k_settled(http_port, K_MODEL, bf16_w)
        t_start = time.perf_counter()
        got = k_batch(http_port, K_MODEL, prompts, 64)
        t_first = max(g["first"] for g in got)
        t_end = max(g["last"] for g in got)
        s1 = k_settled(http_port, K_MODEL, bf16_w)
        k2 = {"requests": K_BATCH, "prompt": K_PROMPT, "decode": 64,
              "decode_tok_s": K_BATCH * 63 / (t_end - t_first), "ttft_all_s": t_first - t_start,
              "ttft_median_s": float(np.median([g["first"] - g["t0"] for g in got])),
              "wall_s": t_end - t_start,
              "requests_per_worker": {w: s1["router"]["routed"].get(w, 0)
                                      - s0["router"]["routed"].get(w, 0) for w in bf16_w},
              "workers": k_launches("[k2]", s0, s1, bf16_w, ROUTES[(torch.bfloat16, "float")],
                                    layers),
              "codec_us_per_frame": codec_us_per_frame()}
        if device == "cuda":
            for w, r in k2["workers"].items():
                if r["launches_per_forward_step"] != layers:
                    raise AssertionError(f"[k2] worker {w}: {r}")
        k2["b_in_process"] = ({k: b_bf16[k] for k in ("decode_tok_s", "ttft_all_s")}
                              if b_bf16 else None)
        k2["e2_http"] = ({k: e2["client_own_process"][k] for k in ("decode_tok_s", "ttft_all_s")}
                         if e2 else None)
        out["k2"] = k2
        log("[k2] " + json.dumps(k2))
        log(f"[k2] bf16 through the frontend and 2 workers: decode tok/s {k2['decode_tok_s']}, "
            f"TTFT (all 32) {k2['ttft_all_s']} s; (b) in process {k2['b_in_process']}, (e2) "
            f"over HTTP {k2['e2_http']}; on {smi}")
        cl.check_alive()

        # (k3) prefix affinity
        rng = np.random.default_rng(3)
        groups, k3 = [], {"groups": []}
        r0 = k_stats(http_port, K_MODEL)["router"]
        for g in range(K_GROUPS):
            prefix = [int(x) for x in rng.integers(5, vocab - 5, K_PREFIX)]
            served, ttft = [], []
            hits0 = k_settled(http_port, K_MODEL, bf16_w)
            for r in range(K_GROUP):
                suffix = [int(x) for x in rng.integers(5, vocab - 5, K_SUFFIX)]
                before = k_stats(http_port, K_MODEL)["router"]["routed"]
                res = k_batch(http_port, K_MODEL, [prefix + suffix], K_GROUP_DECODE)[0]
                after = k_stats(http_port, K_MODEL)["router"]["routed"]
                moved = [w for w in bf16_w if after.get(w, 0) != before.get(w, 0)]
                if len(moved) != 1:
                    raise AssertionError(f"[k3] group {g} request {r}: routed {before} -> "
                                         f"{after}")
                served.append(moved[0])
                ttft.append(res["first"] - res["t0"])
                if r == 0:
                    time.sleep(0.3)  # the first's KV events reach the router
            hits1 = k_settled(http_port, K_MODEL, bf16_w)
            same = sum(w == served[0] for w in served)
            rise = (hits1["workers"][served[0]]["prefix_hit_blocks"]
                    - hits0["workers"][served[0]]["prefix_hit_blocks"])
            entry = {"worker": served[0], "same_worker": same, "served": served,
                     "prefix_hit_blocks_rise": rise, "ttft_first_s": ttft[0],
                     "ttft_repeat_mean_s": float(np.mean(ttft[1:]))}
            k3["groups"].append(entry)
            log(f"[k3] group {g}: " + json.dumps(entry))
            if same < K_GROUP - 1 or rise < (same - 1) * (K_PREFIX // 16):
                raise AssertionError(f"[k3] group {g}: {same} of {K_GROUP} on the first's "
                                     f"worker, its prefix hits rose {rise}")
        r1 = k_stats(http_port, K_MODEL)["router"]
        n = r1["decisions"] - r0["decisions"]
        k3["route_ms_per_decision"] = 1e3 * (r1["route_s"] - r0["route_s"]) / n
        k3["prompt_tokens"] = K_PREFIX + K_SUFFIX
        out["k3"] = k3
        log(f"[k3] router ms per decision ({K_PREFIX + K_SUFFIX}-token prompts) "
            f"{k3['route_ms_per_decision']}; on {smi}")
        cl.check_alive()

        # (k4) a worker killed mid-stream
        m0 = k_get(http_port, "/metrics")
        att0 = sum(float(ln.rsplit(" ", 1)[1]) for ln in m0.splitlines()
                   if ln.startswith("dynamo_migration_attempts_total"))
        st0 = k_stats(http_port, K_F32_NAME)
        k4: dict = {}

        async def run_k4():
            tasks = [asyncio.create_task(k_stream(http_port, K_F32_NAME, p, K4_DECODE))
                     for p in k4_prompts]
            victim = None
            deadline = time.monotonic() + 120
            while victim is None:
                if time.monotonic() > deadline:
                    raise AssertionError("[k4] no worker ever had running streams")
                st = await asyncio.to_thread(k_stats, http_port, K_F32_NAME)
                for w in f32_w:
                    m = st["workers"].get(w, {})
                    took = st["router"]["routed"].get(w, 0) - st0["router"]["routed"].get(w, 0)
                    if took > 0 and m.get("num_running", 0) > 0 and \
                            m.get("decode_tokens", 0) > st0["workers"][w]["decode_tokens"]:
                        victim, k4["victim_streams"] = w, took
                        break
                await asyncio.sleep(0.02)
            cl.kill(name_of[victim])
            t_kill = time.monotonic()
            k4["victim"] = victim

            async def discovery():
                # when the frontend stops discovering the victim, read
                # beside the streams' recovery
                while time.monotonic() - t_kill < K_TTL_S + 10:
                    st = await asyncio.to_thread(k_stats, http_port, K_F32_NAME)
                    if victim not in st["instances"]:
                        return time.monotonic() - t_kill
                    await asyncio.sleep(0.05)
                raise AssertionError("[k4] the dead instance is still discovered")

            gone = asyncio.create_task(discovery())
            streams = await asyncio.gather(*tasks)
            k4["gone_after_s"] = await gone
            return streams

        got = asyncio.run(run_k4())
        k4.update(k_compare("[k4] streams after the kill against the unbroken run", got, k4_ref))
        m1 = k_get(http_port, "/metrics")
        att1 = sum(float(ln.rsplit(" ", 1)[1]) for ln in m1.splitlines()
                   if ln.startswith("dynamo_migration_attempts_total"))
        k4["migrations"] = att1 - att0
        if k4["migrations"] < k4["victim_streams"]:
            raise AssertionError(f"[k4] {k4['victim_streams']} streams on the victim, "
                                 f"{k4['migrations']} migrations")
        if k4["gone_after_s"] > K_TTL_S + 1.0:
            raise AssertionError(f"[k4] the dead instance left after {k4['gone_after_s']} s, "
                                 f"past its lease TTL of {K_TTL_S} s")
        k_batch(http_port, K_F32_NAME, prompts[K4_STREAMS:K4_STREAMS + 4], 8)
        out["k4"] = k4
        log("[k4] " + json.dumps(k4))
        cl.check_alive()

        # shutdown: the survivors drain and exit 0
        drains = {}
        for name in [n for n in ("f32a", "f32b", "bf16a", "bf16b") if n not in cl.expected_dead]:
            rc = cl.terminate(name, 120)
            line = [ln for ln in cl.log_of(name).splitlines() if "WORKER_DRAINED" in ln]
            if rc != 0 or not line:
                raise AssertionError(f"[k] {name} exited {rc} without a drain report:\n"
                                     f"{cl.log_of(name)[-3000:]}")
            drains[name] = json.loads(line[-1].split("WORKER_DRAINED ", 1)[1])
            if drains[name]["state"] != "done":
                raise AssertionError(f"[k] {name}'s drain: {drains[name]}")
        out["drains"] = drains
        log("[k] drains " + json.dumps(drains))
    finally:
        cl.stop_all()
    left = [n for n, (p, _) in cl.procs.items() if p.poll() is None]
    if left:
        raise AssertionError(f"[k] processes left over: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[k] passed in {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# (l) disaggregated prefill/decode: prefill and decode workers as processes
# ---------------------------------------------------------------------------

#: (l)'s transfer TTL (an unpulled transfer's pins go after it), its long
#: prompts, and (l4)'s repeats of (l1)
L_TTL_S = 4.0
L_LONG, L_LONG_N, L_LONG_DECODE = 1024, 8, 32
L4_STREAMS = 8


def l_health(port: int) -> dict:
    """A worker's published engine stats, from its status server."""
    res = asyncio.run(http_call(port, "GET", "/health"))
    if res["status"] not in (200, 503):
        raise AssertionError(f"[l] GET /health on {port}: {res['status']}")
    return json.loads(res["body"])["engine"]


def l_counters(port: int) -> dict:
    """A worker's ``dynamo_kv_transfer_*`` family from its /metrics: bytes
    and waves by phase, and the last overlap ratio."""
    res = asyncio.run(http_call(port, "GET", "/metrics"))
    out: dict = {"bytes": {}, "waves": {}, "overlap_ratio": None}
    for ln in res["body"].decode().splitlines():
        for key, name in (("bytes", "dynamo_kv_transfer_bytes_total"),
                          ("waves", "dynamo_kv_transfer_waves_total")):
            if ln.startswith(name + "{"):
                phase = ln.split('phase="', 1)[1].split('"', 1)[0]
                out[key][phase] = float(ln.rsplit(" ", 1)[1])
        if ln.startswith("dynamo_kv_transfer_overlap_ratio "):
            out["overlap_ratio"] = float(ln.rsplit(" ", 1)[1])
    return out


def l_idle(port: int, tag: str, timeout: float = 30.0) -> dict:
    """A worker's stats once its engine is idle (its stats are computed at
    the call: no publishing delay)."""
    deadline = time.monotonic() + timeout
    while True:
        st = l_health(port)
        if st["num_running"] == 0 and st["num_waiting"] == 0:
            return st
        if time.monotonic() > deadline:
            raise AssertionError(f"{tag}: the worker on {port} never went idle: {st}")
        time.sleep(0.05)


def l_delta(after: dict, before: dict, *path) -> float:
    a, b = after, before
    for k in path:
        a, b = a[k], b[k]
    return a - b


def codec_us_per_mib(n: int = 200) -> float:
    """The port's codec on one pulled block's frame (``{"i", "d": 1 MiB}``),
    packed and unpacked (the shard server packs it, the decode side's
    client unpacks it): microseconds a MiB on this host."""
    from dynamo_tpu_torch.transports.wire import encode_frame
    from dynamo_tpu_torch.utils import msgpack

    frame = {"i": 3, "d": bytes(2**20)}
    t0 = time.perf_counter()
    for _ in range(n):
        msgpack.unpackb(encode_frame(frame)[4:])
    return 1e6 * (time.perf_counter() - t0) / n


def phase_disagg(smi: str, f32_ref: dict, b_bf16: dict | None, k: dict | None,
                 device: str = "cuda") -> dict:
    """(l): see the module docstring. ``f32_ref`` is (b'')'s in-process f32
    streams, ``b_bf16`` (b)'s bf16 numbers and ``k`` (k)'s results, printed
    beside (l2)'s and (l3)'s."""
    import tempfile

    from dynamo_tpu_torch.models.config import resolve_model_config
    from dynamo_tpu_torch.ops.paged_attention import ROUTES

    cfg = resolve_model_config(K_MODEL)
    layers, vocab = cfg.num_layers, cfg.vocab_size
    block_bytes = {"f32": 2 * layers * 16 * cfg.num_kv_heads * cfg.head_dim * 4}
    block_bytes["bf16"] = block_bytes["f32"] // 2
    f32_route, bf16_route = ROUTES[(torch.float32, "float")], ROUTES[(torch.bfloat16, "float")]
    tmp = Path(tempfile.mkdtemp(prefix="l-disagg-"))
    tok = k_tokenizer(tmp, vocab)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1",
           "DYN_LEASE_TTL_S": str(K_TTL_S), "DYN_LOG": "info"}
    cl = KCluster(tmp, env)
    out: dict = {"smi": smi}
    t_phase = time.perf_counter()
    try:
        coord_port, http_port = free_port(), free_port()
        status = {name: free_port() for name in ("f32p", "f32d", "bf16p", "bf16d")}
        cl.start("coordinator", "dynamo_tpu_torch.transports.coordinator",
                 ["--host", "127.0.0.1", "--port", str(coord_port)])
        cl.wait_line("coordinator", "COORDINATOR_READY", 60)
        url = f"tcp://127.0.0.1:{coord_port}"
        f32_len = K_PROMPT + K4_DECODE + 16
        bf16_len = max(K_PREFIX + K_SUFFIX + K_GROUP_DECODE, K_PROMPT + 64) + 16
        ttl = ["--kv-transfer-ttl", str(L_TTL_S)]
        roles = {
            "f32p": ("f32prefill", K_F32_NAME, K_F32_BLOCKS, f32_len,
                     ["--dtype", "float32", "--disagg", "prefill", *ttl]),
            "f32d": ("f32", K_F32_NAME, K_F32_BLOCKS, f32_len,
                     ["--dtype", "float32", "--disagg", "decode",
                      "--prefill-endpoint", "dyn://dynamo.f32prefill.generate"]),
            "bf16p": ("bf16prefill", K_MODEL, K_BF16_BLOCKS, bf16_len,
                      ["--disagg", "prefill", *ttl]),
            "bf16d": ("bf16", K_MODEL, K_BF16_BLOCKS, bf16_len,
                      ["--disagg", "decode",
                       "--prefill-endpoint", "dyn://dynamo.bf16prefill.generate"]),
        }
        for name, (component, served, blocks, max_len, extra) in roles.items():
            cl.start(name, "dynamo_tpu_torch.components.worker", k_worker_args(
                url, component, served, blocks, max_len, tok, device, extra),
                env={"DYN_SYSTEM_ENABLED": "true", "DYN_SYSTEM_PORT": str(status[name])})
        cl.start("frontend", "dynamo_tpu_torch.components.frontend",
                 ["--coordinator", url, "--host", "127.0.0.1", "--port", str(http_port),
                  "--router-mode", "kv"])
        cl.wait_line("frontend", "FRONTEND_READY", 120)
        ids = {name: cl.wait_line(name, "WORKER_READY", 600).split("instance=")[1]
               .strip().lstrip("0") for name in roles}
        deadline = time.monotonic() + 60
        while True:
            st = k_get(http_port, "/engine_stats")
            found = all(st.get(m, {}).get("instances", []) == [ids[d]]
                        and ids[d] in st.get(m, {}).get("workers", {})
                        for m, d in ((K_F32_NAME, "f32d"), (K_MODEL, "bf16d")))
            # each decode worker's prefill router has found its prefill worker
            if found and all(l_health(status[d])["disagg"]["prefill_instances"] == 1
                             for d in ("f32d", "bf16d")):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"[l] the decode workers or their prefill routers did "
                                     f"not discover their peers: {st}")
            time.sleep(0.2)
        out["startup_s"] = time.perf_counter() - t_phase
        log(f"[l] coordinator, frontend, 2 prefill and 2 decode workers up in "
            f"{out['startup_s']:.1f}s")
        cl.check_alive()

        def snap(*names) -> dict:
            return {n: l_idle(status[n], "[l]") for n in names}

        def counters(*names) -> dict:
            return {n: l_counters(status[n]) for n in names}

        def launches(tag, before, after, names, route) -> dict:
            return k_launches(tag, {"workers": before}, {"workers": after}, list(names),
                              route, layers)

        # (l1) f32: every prefill on the prefill worker, 7 blocks a request pulled
        prompts = k_prompts(vocab)
        s0, c0 = snap("f32p", "f32d"), counters("f32p", "f32d")
        got = k_batch(http_port, K_F32_NAME, prompts, len(f32_ref[0][0]))
        s1, c1 = snap("f32p", "f32d"), counters("f32p", "f32d")
        l1 = k_compare("[l1] f32 through the prefill and decode workers against (b'')",
                       got, f32_ref)
        blocks = K_BATCH * ((K_PROMPT - 1) // 16)
        l1.update({
            "remote_prefills": l_delta(s1["f32d"], s0["f32d"], "disagg", "remote_prefills"),
            "local_fallbacks": l_delta(s1["f32d"], s0["f32d"], "disagg", "local_fallbacks"),
            "pulled_blocks": l_delta(s1["f32d"], s0["f32d"], "kv_transfer", "pull", "blocks"),
            "staged_blocks": l_delta(s1["f32p"], s0["f32p"], "kv_transfer", "extract_blocks"),
            "pull_bytes": c1["f32d"]["bytes"].get("pull", 0) - c0["f32d"]["bytes"].get("pull", 0),
            "stage_bytes": (c1["f32p"]["bytes"].get("stage", 0)
                            - c0["f32p"]["bytes"].get("stage", 0)),
            "workers": launches("[l1]", s0, s1, ("f32p", "f32d"), f32_route)})
        want = {"remote_prefills": K_BATCH, "local_fallbacks": 0, "pulled_blocks": blocks,
                "staged_blocks": blocks, "pull_bytes": blocks * block_bytes["f32"],
                "stage_bytes": blocks * block_bytes["f32"]}
        if {key: l1[key] for key in want} != want:
            raise AssertionError(f"[l1] handoff counts {l1}; expected {want}")
        if l1["workers"]["f32p"]["forward_steps"] == 0:
            raise AssertionError(f"[l1] the prefill worker ran no forward step: {l1}")
        out["l1"] = l1
        log("[l1] " + json.dumps(l1))
        cl.check_alive()

        # (l2) bf16 at (b)'s traffic
        s0, c0 = snap("bf16p", "bf16d"), counters("bf16p", "bf16d")
        t_start = time.perf_counter()
        got = k_batch(http_port, K_MODEL, prompts, 64)
        t_first = max(g["first"] for g in got)
        t_end = max(g["last"] for g in got)
        s1, c1 = snap("bf16p", "bf16d"), counters("bf16p", "bf16d")
        l2 = {"requests": K_BATCH, "prompt": K_PROMPT, "decode": 64,
              "decode_tok_s": K_BATCH * 63 / (t_end - t_first),
              "ttft_all_s": t_first - t_start,
              "ttft_median_s": float(np.median([g["first"] - g["t0"] for g in got])),
              "wall_s": t_end - t_start,
              "remote_prefills": l_delta(s1["bf16d"], s0["bf16d"], "disagg", "remote_prefills"),
              "pulled_blocks": l_delta(s1["bf16d"], s0["bf16d"], "kv_transfer", "pull",
                                       "blocks"),
              "overlap_ratio": c1["bf16d"]["overlap_ratio"],
              "workers": launches("[l2]", s0, s1, ("bf16p", "bf16d"), bf16_route)}
        if l2["remote_prefills"] != K_BATCH or l2["pulled_blocks"] != blocks:
            raise AssertionError(f"[l2] {l2}")
        if device == "cuda":
            for w, r in l2["workers"].items():
                if r["launches_per_forward_step"] != layers:
                    raise AssertionError(f"[l2] worker {w}: {r}")
        l2["b_in_process"] = ({key: b_bf16[key] for key in ("decode_tok_s", "ttft_all_s")}
                              if b_bf16 else None)
        l2["k2_aggregated"] = ({key: k["k2"][key] for key in ("decode_tok_s", "ttft_all_s")}
                               if k else None)
        out["l2"] = l2
        log("[l2] " + json.dumps(l2))
        log(f"[l2] bf16 through a prefill and a decode worker: decode tok/s "
            f"{l2['decode_tok_s']}, TTFT (all 32) {l2['ttft_all_s']} s, overlap ratio "
            f"{l2['overlap_ratio']}; (b) in process {l2['b_in_process']}, (k2) aggregated "
            f"workers {l2['k2_aggregated']}; on {smi}")
        cl.check_alive()

        # (l3) bf16 long prompts, one at a time
        rng = np.random.default_rng(5)
        long_prompts = [[int(x) for x in rng.integers(5, vocab - 5, L_LONG)]
                        for _ in range(L_LONG_N)]
        s0 = snap("bf16p", "bf16d")
        ttft = []
        for p in long_prompts:
            res = k_batch(http_port, K_MODEL, [p], L_LONG_DECODE)[0]
            ttft.append(res["first"] - res["t0"])
        s1 = snap("bf16p", "bf16d")
        per_req = (L_LONG - 1) // 16
        pre, dec = s1["bf16p"]["kv_transfer"], s0["bf16p"]["kv_transfer"]
        d1, d0 = s1["bf16d"]["kv_transfer"], s0["bf16d"]["kv_transfer"]
        stage_b, stage_s = pre["extract_bytes"] - dec["extract_bytes"], \
            pre["extract_s"] - dec["extract_s"]
        pull_b, pull_s = d1["pull"]["bytes"] - d0["pull"]["bytes"], \
            d1["pull"]["seconds"] - d0["pull"]["seconds"]
        imp_b, imp_s = d1["inject_bytes"] - d0["inject_bytes"], d1["inject_s"] - d0["inject_s"]
        l3 = {"requests": L_LONG_N, "prompt": L_LONG, "decode": L_LONG_DECODE,
              "ttft_s": ttft, "ttft_mean_s": float(np.mean(ttft)),
              "k3_cold_first_ttft_s": ([g["ttft_first_s"] for g in k["k3"]["groups"]]
                                       if k else None),
              "blocks_per_request": (d1["pull"]["blocks"] - d0["pull"]["blocks"]) / L_LONG_N,
              "mib_per_request": pull_b / L_LONG_N / 2**20,
              "stage_gb_s": stage_b / stage_s / 1e9 if stage_s else None,
              "pull_gb_s": pull_b / pull_s / 1e9 if pull_s else None,
              "import_gb_s": imp_b / imp_s / 1e9 if imp_s else None,
              "stage_s": stage_s, "pull_s": pull_s, "import_s": imp_s,
              "prefill_waits": pre["waits"] - dec["waits"],
              "prefill_wait_s": pre["wait_s"] - dec["wait_s"],
              "codec_us_per_mib": codec_us_per_mib(),
              "codec_us_per_data_frame": codec_us_per_frame()}
        if l3["blocks_per_request"] != per_req or \
                pull_b != L_LONG_N * per_req * block_bytes["bf16"]:
            raise AssertionError(f"[l3] {l3}; expected {per_req} blocks of "
                                 f"{block_bytes['bf16']} B a request")
        out["l3"] = l3
        log("[l3] " + json.dumps(l3))
        log(f"[l3] {L_LONG}-token prompts: TTFT {l3['ttft_mean_s']} s in the mean (k3's cold "
            f"first of a group, aggregated: {l3['k3_cold_first_ttft_s']}); the handoff of "
            f"{l3['mib_per_request']} MiB a request: stage (D2H) {l3['stage_gb_s']} GB/s, "
            f"pull (loopback TCP through the port's codec) {l3['pull_gb_s']} GB/s, import "
            f"(H2D and inject) {l3['import_gb_s']} GB/s; the prefill worker waited "
            f"{l3['prefill_waits']} times ({l3['prefill_wait_s']} s) for a step in flight; "
            f"on one card the handoff goes through the host; on {smi}")
        cl.check_alive()

        # (l4) the f32 prefill worker killed: local prefill
        s0 = snap("f32d")
        cl.kill("f32p")
        cl.procs["f32p"][0].wait(30)
        got = k_batch(http_port, K_F32_NAME, prompts[:L4_STREAMS], len(f32_ref[0][0]))
        s1 = snap("f32d")
        l4 = k_compare("[l4] f32 streams through local prefill against (b'')", got,
                       {i: f32_ref[i] for i in range(L4_STREAMS)})
        l4.update({
            "local_fallbacks": l_delta(s1["f32d"], s0["f32d"], "disagg", "local_fallbacks"),
            "remote_prefills": l_delta(s1["f32d"], s0["f32d"], "disagg", "remote_prefills"),
            "pulled_blocks": l_delta(s1["f32d"], s0["f32d"], "kv_transfer", "pull", "blocks"),
            "prefill_tokens": l_delta(s1["f32d"], s0["f32d"], "prefill_tokens"),
            "workers": launches("[l4]", s0, s1, ("f32d",), f32_route)})
        if (l4["local_fallbacks"], l4["remote_prefills"], l4["pulled_blocks"]) != \
                (L4_STREAMS, 0, 0) or l4["prefill_tokens"] <= 0:
            raise AssertionError(f"[l4] {l4}")
        out["l4"] = l4
        log("[l4] " + json.dumps(l4))
        cl.check_alive()

        # no staging pin left on the surviving prefill worker after the TTL,
        # and every block back on the survivors
        t_last = time.monotonic()
        deadline = t_last + L_TTL_S + 10
        while True:
            left = {n: l_health(status[n]) for n in ("bf16p", "bf16d", "f32d")}
            pins = left["bf16p"]["kv_transfer"]["staged_pins"]
            owners = left["bf16p"]["mem"]["device_blocks"]
            used = {n: st["kv_usage"] for n, st in left.items()}
            if pins == 0 and not owners.get("staging") and not any(used.values()) \
                    and time.monotonic() - t_last >= L_TTL_S:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"[l] staging pins {pins}, owners {owners}, kv usage "
                                     f"{used} after the TTL")
            time.sleep(0.2)
        out["end"] = {"staged_pins": pins, "kv_usage": used,
                      "orphan_pins": left["bf16p"]["mem"]["orphan_pins"]}
        drains = {}
        for name in ("f32d", "bf16d", "bf16p"):
            rc = cl.terminate(name, 120)
            line = [ln for ln in cl.log_of(name).splitlines() if "WORKER_DRAINED" in ln]
            if rc != 0 or not line:
                raise AssertionError(f"[l] {name} exited {rc} without a drain report:\n"
                                     f"{cl.log_of(name)[-3000:]}")
            drains[name] = json.loads(line[-1].split("WORKER_DRAINED ", 1)[1])
            if drains[name]["state"] != "done":
                raise AssertionError(f"[l] {name}'s drain: {drains[name]}")
        out["drains"] = drains
        log("[l] end " + json.dumps(out["end"]) + " drains " + json.dumps(drains))
    finally:
        cl.stop_all()
    left = [n for n, (p, _) in cl.procs.items() if p.poll() is None]
    if left:
        raise AssertionError(f"[l] processes left over: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[l] passed in {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# (m) the chaos harness over mocker fleets, and a real engine killed by a
# chaos plan and resumed from its stream checkpoint
# ---------------------------------------------------------------------------

M_SCENARIOS = ("smoke", "worker_kill", "retire_under_load_smoke",
               "worker_kill_mid_decode_smoke")
#: (m2): the stream, the step-loop iterations the victim runs before its
#: kill (the prefill, then ~44 decode steps: past the checkpoints at
#: prefill completion, 8 blocks, and at 10 blocks), and the checkpoint
#: cadence (a standard-priority stream checkpoints every 2 x base blocks)
M_PROMPT, M_DECODE, M_KILL_AFTER, M_CKPT_BLOCKS = 128, 64, 45, 1
M_INTERVAL = 2 * M_CKPT_BLOCKS
#: (m3): batches of f32 streams on an in-process engine with KVBM tiers
M3_BATCH, M3_DECODE = 4, 16


async def m_call_router(url: str, reqs: list, concurrent: bool = False) -> None:
    """Send ``reqs`` (PreprocessedRequests) to the router component's
    endpoint through the port's runtime, one at a time or all at once."""
    from dynamo_tpu_torch.runtime.client import EndpointClient, PushRouter
    from dynamo_tpu_torch.runtime.protocols import EndpointId
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    rt = await DistributedRuntime.create(RuntimeConfig(coordinator_url=url))
    try:
        client = await EndpointClient.create(rt, EndpointId("dynamo", "router", "generate"))
        await client.wait_for_instances(30.0)
        push = PushRouter(client)

        async def one(req):
            async for _ in push.generate(req.to_dict(), req.request_id):
                pass

        if concurrent:
            await asyncio.gather(*(one(r) for r in reqs))
        else:
            for r in reqs:
                await one(r)
    finally:
        await rt.shutdown()


def m_router(root: Path, env: dict, device_kind: str) -> dict:
    """(m1)'s router check, the shape of tests/test_router_component.py: the
    router component over two mocker workers; 6 requests sharing a
    16-block prefix, one at a time, concentrate on one worker from the
    third on; 6 distinct prompts at once use both. The router arbitrates
    with the prefix-cache cost model of llama-3-8b-lite at ``device_kind``'s
    row (``--global-prefix-cache``)."""
    import re

    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    def reqs(tag: str, prompts: list[list[int]]) -> list:
        return [PreprocessedRequest(
            token_ids=p, request_id=f"{tag}{i}",
            stop_conditions=StopConditions(max_tokens=4, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0)) for i, p in enumerate(prompts)]

    def routed(tag: str) -> list[str]:
        return [m.group(2) for m in re.finditer(r"routed (\S+) -> worker ([0-9a-f]+)",
                                                 cl.log_of("router"))
                if m.group(1).startswith(tag)]

    root.mkdir(parents=True, exist_ok=True)
    cl = KCluster(root, env)
    t0 = time.perf_counter()
    try:
        port = free_port()
        url = f"tcp://127.0.0.1:{port}"
        cl.start("coordinator", "dynamo_tpu_torch.transports.coordinator",
                 ["--host", "127.0.0.1", "--port", str(port)])
        cl.wait_line("coordinator", "COORDINATOR_READY", 30)
        for i in range(2):
            cl.start(f"pool{i}", "dynamo_tpu_torch.components.worker", [
                "--engine", "mocker", "--coordinator", url, "--component", "pool",
                "--block-size", "4", "--speedup-ratio", "50", "--max-model-len", "512",
                "--num-blocks", "128"])
        for i in range(2):
            cl.wait_line(f"pool{i}", "WORKER_READY", 60)
        cl.start("router", "dynamo_tpu_torch.components.router",
                 ["--coordinator", url, "--target", "dyn://dynamo.pool.generate",
                  "--block-size", "4", "--global-prefix-cache", "--model", K_MODEL,
                  "--device-kind", device_kind], env={"DYN_LOG": "debug"})
        cl.wait_line("router", "ROUTER_READY", 60)
        arbiter = cl.wait_line("router", "prefix-cache arbitration on", 1)
        shared = list(range(100, 164))
        asyncio.run(m_call_router(url, reqs("warm", [shared + [1000 + i] for i in range(6)])))
        asyncio.run(m_call_router(url, reqs("cold", [[2000 + 97 * i + j for j in range(64)]
                                                     for i in range(6)]), concurrent=True))
        warm, cold = routed("warm"), routed("cold")
        cl.check_alive()
    finally:
        cl.stop_all()
    out = {"warm": warm, "cold": cold, "arbiter": arbiter.split(": ", 1)[-1],
           "wall_s": time.perf_counter() - t0}
    if len(warm) != 6 or len(set(warm[2:])) != 1 or warm[2] not in warm[:2]:
        raise AssertionError(f"[m1] prefix traffic did not concentrate: {out}")
    if len(cold) != 6 or len(set(cold)) != 2:
        raise AssertionError(f"[m1] distinct prefixes did not spread: {out}")
    return out


def phase_harness(device_kind: str) -> dict:
    """(m1): the port's chaos harness on this host (it has no JAX): each
    scenario of ``M_SCENARIOS`` over mocker workers, and the router
    component over two, all at once (each fleet is processes of its own on
    ports of its own, light on the CPU). Each report must pass. ``main``
    runs it beside the kernels' build, which it does not need."""
    import concurrent.futures
    import tempfile

    from dynamo_tpu_torch.chaos.harness import run_scenario

    root = Path(tempfile.mkdtemp(prefix="m1-harness-"))

    def scenario(name: str) -> dict:
        t0 = time.perf_counter()
        try:
            rep = run_scenario(name).report.to_dict()
        except Exception as exc:  # noqa: BLE001 - reported beside the others
            rep = {"passed": False, "checks": [], "details": {},
                   "failures": [f"{type(exc).__name__}: {str(exc)[-3000:]}"]}
        return {"report": rep, "wall_s": time.perf_counter() - t0}

    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1", "DYN_LOG": "info"}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(M_SCENARIOS) + 1) as ex:
        futs = {name: ex.submit(scenario, name) for name in M_SCENARIOS}
        router = ex.submit(m_router, root / "m1-router", env, device_kind)
        out = {name: f.result() for name, f in futs.items()}
        out["router"] = router.result()
    for name in M_SCENARIOS:
        rep = out[name]["report"]
        log(f"[m1] {name}: passed {rep['passed']} in {out[name]['wall_s']:.1f}s, checks "
            f"{rep['checks']}, streams {rep['details'].get('streams')}")
    failed = {name: out[name]["report"]["failures"] for name in M_SCENARIOS
              if not out[name]["report"]["passed"]}
    if failed:
        raise AssertionError(f"[m1] scenarios failed: {failed}")
    log(f"[m1] router component ({out['router']['arbiter']}): prefix repeats on "
        f"{out['router']['warm']}, distinct prefixes on {out['router']['cold']}, "
        f"{out['router']['wall_s']:.1f}s")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[m1] passed in {out['wall_s']:.1f}s")
    return out


async def m_serve(engine, reqs: dict) -> dict:
    """Each request's (tokens, logprobs, finish reason) from ``engine``,
    all sent at once; the engine keeps running."""
    async def one(req):
        toks, lps, fin = [], [], None
        async for out in engine.generate(req):
            toks += out.token_ids
            lps += out.log_probs or []
            fin = str(out.finish_reason) if out.finish_reason is not None else fin
        return toks, lps, fin
    got = await asyncio.gather(*(one(r) for r in reqs.values()))
    return dict(zip(reqs, got))


def m_engine(model: str, device: str, **kw):
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.utils.config import EngineConfig

    cfg = dict(model=model, block_size=16, num_blocks=128, max_batch_size=8,
               max_model_len=M_PROMPT + M_DECODE + 16, prefill_chunk=128,
               allow_random_weights=True, warmup_mode="lazy")
    cfg.update(kw)
    return build_engine(EngineConfig(**cfg), device=device)


def m_reqs(tag: str, prompts: list[list[int]], decode: int) -> dict:
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    return {i: PreprocessedRequest(
        token_ids=p, request_id=f"{tag}-{i}",
        stop_conditions=StopConditions(max_tokens=decode, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0)) for i, p in enumerate(prompts)}


def phase_kvbm_faults(smi: str, store_addr: str, device: str = "cuda") -> dict:
    """(m3): the KVBM's fault points on an in-process f32 llama-3-8b-lite
    engine with a host tier and (m2)'s store (publish on commit): batches A,
    B and C of ``M3_BATCH`` greedy streams, first on an engine without a
    plan, then on a fresh one where ``kvbm.remote`` errors twice (the
    store client opens its breaker: A's streams as the unfaulted run's, no
    orphan pin), then ``kvbm.offload`` errors once (B's in-flight streams
    end with finish reason error through ``fail_all``, every block comes
    back), then no fault (C's streams as the unfaulted run's)."""
    from dynamo_tpu_torch import chaos
    from dynamo_tpu_torch.models.config import resolve_model_config
    from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops.paged_attention import ROUTES

    model = register_f32_model()
    route = ROUTES[(torch.float32, "float")]
    kw = dict(host_kv_blocks=256, remote_kv_addr=store_addr, global_prefix_cache=True)
    vocab = resolve_model_config(model).vocab_size
    rng = np.random.default_rng(13)
    b = {tag: m_reqs(f"m3{tag}", [[int(x) for x in rng.integers(5, vocab - 5, M_PROMPT)]
                                  for _ in range(M3_BATCH)], M3_DECODE) for tag in "ABC"}
    t0 = time.perf_counter()

    def as_ref(streams: dict) -> dict:
        return {i: (t, lp) for i, (t, lp, _) in streams.items()}

    def blocks_back(core) -> bool:
        return core.pool.num_free == core.pool.num_blocks - 1

    async def unfaulted() -> dict:
        engine = m_engine(model, device, **kw)
        try:
            return {tag: await m_serve(engine, b[tag]) for tag in "ABC"}
        finally:
            await engine.shutdown()

    async def faulted() -> dict:
        out: dict = {}
        engine = m_engine(model, device, **kw)
        core = engine.core
        try:
            get_mem_ledger().reset()
            chaos.configure({"seed": 0, "rules": [
                {"point": "kvbm.remote", "kind": "error", "rate": 1.0, "count": 2}]})
            pa.reset_launches()
            got = await m_serve(engine, b["A"])
            tiers = [t for t in [*core.kvbm.tiers, core.kvbm.publish_tier]
                     if getattr(t, "name", "") == "remote"]
            out["remote"] = {"fired": [k[1] for k in chaos.injection_log()],
                             "breaker_open": any(t._broken_until > time.monotonic()
                                                 for t in tiers),
                             "orphan_pins": get_mem_ledger().audit()["orphan_pins"],
                             "blocks_back": blocks_back(core)}
            eq, ties, bad = compare_streams("[m3] A under kvbm.remote errors against the "
                                            "unfaulted run", as_ref(got), as_ref(ref["A"]))
            out["remote"].update(streams_equal=eq, near_ties=ties)
            r = out["remote"]
            if r["fired"] != ["kvbm.remote"] * 2 or not r["breaker_open"] or bad \
                    or r["orphan_pins"] or not r["blocks_back"]:
                raise AssertionError(f"[m3] kvbm.remote: {r} {bad[:2]}")

            chaos.configure({"seed": 0, "rules": [
                {"point": "kvbm.offload", "kind": "error", "rate": 1.0, "count": 1}]})
            got = await m_serve(engine, b["B"])
            out["offload"] = {"fired": [k[1] for k in chaos.injection_log()],
                              "finish": sorted({fin for _, _, fin in got.values()}),
                              "blocks_back": blocks_back(core)}
            chaos.reset()
            if out["offload"]["fired"] != ["kvbm.offload"] or \
                    out["offload"]["finish"] != ["error"] or not out["offload"]["blocks_back"]:
                raise AssertionError(f"[m3] kvbm.offload: {out['offload']}")
            got = await m_serve(engine, b["C"])
            eq, ties, bad = compare_streams("[m3] C after the offload fault against the "
                                            "unfaulted run", as_ref(got), as_ref(ref["C"]))
            out["after"] = {"streams_equal": eq, "near_ties": ties}
            if bad:
                raise AssertionError(f"[m3] C's streams differ: {bad[:2]}")
            by_kernel = dict(pa.paged_attention.launches_by_kernel)
            if device == "cuda" and any(n for k, n in by_kernel.items() if k != route):
                raise AssertionError(f"[m3] launched {by_kernel}; expected {route} only")
            out["launches"] = by_kernel.get(route, 0)
            return out
        finally:
            chaos.reset()
            await engine.shutdown()

    ref = asyncio.run(unfaulted())
    free_engine()
    out = {"smi": smi, **asyncio.run(faulted())}
    free_engine()
    out["wall_s"] = time.perf_counter() - t0
    log("[m3] " + json.dumps(out))
    log(f"[m3] passed in {out['wall_s']:.1f}s")
    return out


def phase_chaos(smi: str, m1, device: str = "cuda") -> dict:
    """(m): see the module docstring. ``m1`` is (m1)'s future, started by
    ``main`` beside the build."""
    import tempfile

    from dynamo_tpu_torch.chaos.invariants import InvariantChecker, StreamOutcome
    from dynamo_tpu_torch.models.config import resolve_model_config
    from dynamo_tpu_torch.ops.paged_attention import ROUTES

    tmp = Path(tempfile.mkdtemp(prefix="m-chaos-"))
    out: dict = {"smi": smi, "m1": m1.result()}
    t_phase = time.perf_counter()
    cfg = resolve_model_config(K_MODEL)
    layers, vocab = cfg.num_layers, cfg.vocab_size
    route = ROUTES[(torch.float32, "float")]
    prompt = k_prompts(vocab)[0]
    rid = "m2-victim"

    # the in-process f32 stream of the request
    async def in_process():
        engine = m_engine(register_f32_model(), device)
        try:
            return (await m_serve(engine, m_reqs("m2", [prompt], M_DECODE)))[0]
        finally:
            await engine.shutdown()

    ref = asyncio.run(in_process())
    free_engine()

    tok = k_tokenizer(tmp, vocab)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1",
           "DYN_LEASE_TTL_S": str(K_TTL_S), "DYN_LOG": "info"}
    cl = KCluster(tmp, env)
    try:
        coord_port, http_port, store_port, status_port = (free_port() for _ in range(4))
        url, store = f"tcp://127.0.0.1:{coord_port}", f"127.0.0.1:{store_port}"
        cl.start("coordinator", "dynamo_tpu_torch.transports.coordinator",
                 ["--host", "127.0.0.1", "--port", str(coord_port)])
        cl.wait_line("coordinator", "COORDINATOR_READY", 60)
        cl.start("kv_store", "dynamo_tpu_torch.components.kv_store",
                 ["--host", "127.0.0.1", "--port", str(store_port), "--coordinator", url])
        cl.wait_line("kv_store", "KV_STORE_READY", 60)
        # no health canaries: a canary's steps would count against the
        # plan's ``after``
        extra = ["--dtype", "float32", "--stream-ckpt-blocks", str(M_CKPT_BLOCKS),
                 "--remote-kv-addr", store, "--health-interval", "0"]
        plan = {"seed": 0, "rules": [{"point": "engine.step", "kind": "kill", "rate": 1.0,
                                      "count": 1, "after": M_KILL_AFTER}]}
        t_victim = time.perf_counter()
        cl.start("victim", "dynamo_tpu_torch.components.worker", k_worker_args(
            url, "f32", K_F32_NAME, K_F32_BLOCKS, M_PROMPT + M_DECODE + 16, tok, device,
            extra), env={"DYN_CHAOS_PLAN": json.dumps(plan)})
        cl.start("frontend", "dynamo_tpu_torch.components.frontend",
                 ["--coordinator", url, "--host", "127.0.0.1", "--port", str(http_port),
                  "--router-mode", "kv", "--migration-limit", "3"])
        cl.wait_line("frontend", "FRONTEND_READY", 120)
        victim = cl.wait_line("victim", "WORKER_READY", 600).split("instance=")[1].strip()
        victim_up_s = time.perf_counter() - t_victim
        deadline = time.monotonic() + 60
        while victim.lstrip("0") not in k_stats(http_port, K_F32_NAME).get("instances", []):
            if time.monotonic() > deadline:
                raise AssertionError("[m2] the frontend did not discover the victim")
            time.sleep(0.2)
        m2: dict = {"victim": victim, "victim_up_s": victim_up_s}

        async def run_m2():
            stream = asyncio.create_task(k_stream(http_port, K_F32_NAME, prompt, M_DECODE,
                                                  headers={"x-request-id": rid}))
            proc = cl.procs["victim"][0]
            while proc.poll() is None:
                if stream.done():
                    raise AssertionError(f"[m2] the stream ended before the kill: "
                                         f"{stream.result()['ids'][:8]}")
                await asyncio.sleep(0.01)
            t_kill = time.perf_counter()
            cl.expected_dead.add("victim")
            m2["victim_rc"] = proc.returncode
            # the fresh worker, without the plan; lazily captured graphs: the
            # migration's three attempts wait 29.5 s in all for an instance
            cl.start("survivor", "dynamo_tpu_torch.components.worker", [
                *k_worker_args(url, "f32", K_F32_NAME, K_F32_BLOCKS,
                               M_PROMPT + M_DECODE + 16, tok, device, extra),
                "--warmup-mode", "lazy"],
                env={"DYN_SYSTEM_ENABLED": "true", "DYN_SYSTEM_PORT": str(status_port)})
            while "WORKER_READY" not in cl.log_of("survivor"):
                if stream.done():
                    break
                await asyncio.sleep(0.05)
            m2["survivor_up_s"] = time.perf_counter() - t_kill
            got = await stream
            after = [t for t in got["times"] if t > t_kill]
            m2["kill_to_next_token_s"] = after[0] - t_kill if after else None
            m2["tokens_before_kill"] = len(got["times"]) - len(after)
            return got

        got = asyncio.run(run_m2())
        if m2["victim_rc"] != -9:
            raise AssertionError(f"[m2] the victim exited rc={m2['victim_rc']}, not by "
                                 f"SIGKILL:\n{cl.log_of('victim')[-3000:]}")
        if "chaos: killing process at point engine.step" not in cl.log_of("victim"):
            raise AssertionError("[m2] the victim did not die at engine.step")
        survivor = cl.wait_line("survivor", "WORKER_READY", 10).split("instance=")[1].strip()
        m2["survivor"] = survivor
        before = l_idle(status_port, "[m2]")
        recomputed = before["prefill_tokens"]
        metrics = asyncio.run(http_call(status_port, "GET", "/metrics"))["body"].decode()
        counter = sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                      if ln.startswith("dynamo_stream_ckpt_resume_recomputed_tokens "))
        # the control: the same request id, unkilled, on the survivor
        control = asyncio.run(k_stream(http_port, K_F32_NAME, prompt, M_DECODE,
                                       headers={"x-request-id": rid}))
        after = l_idle(status_port, "[m2]")
        m2.update({"stream_ckpt_resumes": before["stream_ckpt_resumes"],
                   "recomputed_tokens": recomputed, "recomputed_counter": counter,
                   "recompute_bound": (M_INTERVAL + 1) * 16})
        m2["vs_control"] = k_compare("[m2] the resumed stream against the unkilled control",
                                     [got], {0: (control["ids"], control["lps"])})
        m2["vs_in_process"] = k_compare("[m2] the resumed stream against the in-process "
                                        "f32 stream", [got], {0: (ref[0], ref[1])})
        launches = k_launches(
            "[m2] survivor", {"workers": {survivor: {"attention": {
                "launches": {}, "forward_steps": 0}}}},
            {"workers": {survivor: after}}, [survivor], route, layers)[survivor]
        m2["survivor_launches"] = launches
        if m2["stream_ckpt_resumes"] < 1 or not recomputed == counter <= m2["recompute_bound"]:
            raise AssertionError(f"[m2] checkpoint resume: {m2}")
        if device == "cuda" and launches["launches_per_forward_step"] != layers:
            raise AssertionError(f"[m2] survivor launches: {launches}")
        m1 = k_get(http_port, "/metrics")
        m2["migrations_resumed"] = sum(
            float(ln.rsplit(" ", 1)[1]) for ln in m1.splitlines()
            if ln.startswith("dynamo_migration_attempts_total") and 'outcome="resumed"' in ln)
        m2["quarantined"] = "quarantined" in cl.log_of("frontend")
        # the victim's last published stats (a stream running) stay in the
        # router's view until its lease expires and discovery drops it
        deadline = time.monotonic() + K_TTL_S + 10
        while True:
            st = k_stats(http_port, K_F32_NAME)
            if victim.lstrip("0") not in {*st.get("instances", []), *st.get("workers", {})}:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"[m2] the dead victim is still discovered: {st}")
            time.sleep(0.2)
        stats = {K_F32_NAME: k_settled(http_port, K_F32_NAME, [survivor.lstrip("0")])}
        inv = InvariantChecker()
        inv.check_streams([StreamOutcome(rid, "finished", "length"),
                           StreamOutcome(f"{rid} control", "finished", "length")])
        inv.check_block_leaks(stats)
        inv.check_ckpt_resume(stats)
        orphans = sum(int((m.get("mem") or {}).get("orphan_pins", 0) or 0)
                      for m in stats[K_F32_NAME].get("workers", {}).values())
        if orphans:
            inv.report.fail(f"orphan pins: {orphans}")
        else:
            inv.report.ok("orphan_pins_zero")
        if m2["quarantined"]:
            inv.report.ok("killed_instance_quarantined")
        else:
            inv.report.fail("the frontend never quarantined the killed instance")
        if m2["migrations_resumed"] < 1:
            inv.report.fail("no migration resumed from a checkpoint")
        m2["invariants"] = inv.finish().to_dict()
        log("[m2] " + json.dumps(m2))
        if not m2["invariants"]["passed"]:
            raise AssertionError(f"[m2] invariants: {m2['invariants']['failures']}")
        log(f"[m2] f32 stream killed at engine.step after {m2['tokens_before_kill']} tokens, "
            f"resumed from its checkpoint on a fresh worker: {m2['kill_to_next_token_s']} s "
            f"from the kill to its next token, {recomputed} tokens recomputed (bound "
            f"{m2['recompute_bound']}); on {smi}")
        rc = cl.terminate("survivor", 120)
        if rc != 0:
            raise AssertionError(f"[m2] the survivor exited {rc}:\n"
                                 f"{cl.log_of('survivor')[-3000:]}")
        out["m2"] = m2
        cl.check_alive()
        out["m3"] = phase_kvbm_faults(smi, store, device)
        cl.check_alive()
    finally:
        cl.stop_all()
    left = [n for n, (p, _) in cl.procs.items() if p.poll() is None]
    if left:
        raise AssertionError(f"[m] processes left over: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[m] (m2), (m3) passed in {out['wall_s']:.1f}s, (m1) in "
        f"{out['m1']['wall_s']:.1f}s beside the build")
    return out


# ---------------------------------------------------------------------------
# (n) the SLA profile of llama-3-8b-lite on the card, and the planner scaling
# torch workers from it, watched by the fleet aggregator
# ---------------------------------------------------------------------------

#: (n1): the profiler CLI's default grids
N_ISL, N_CONC, N_CTX, N_STEPS = [128, 512, 2048], [1, 8, 32], [256, 1024, 4096], 32
#: (n2): the planner's interval, (b)'s traffic (a batch of 32 streams, 128
#: prompt ids, 64 greedy tokens) and the workers' model length ((k2)'s)
N_INTERVAL, N_PROMPT, N_DECODE, N_MAX_LEN = 5.0, 128, 64, 1088
#: the aggregator's sweep cadence and staleness TTL
N_SCRAPE, N_STALE = 0.5, 3.0


class TimedWindows:
    """A ``time`` stand-in for the profiler module: each pair of its
    ``perf_counter`` calls brackets one measurement window (a warmup's or a
    timed one). Records, across each window, the compile ledger's
    serve-source captures, the engine's decode tokens and forward steps and
    the kernels' launches."""

    def __init__(self):
        self.core = None
        self.open: dict | None = None
        self.windows: list[dict] = []

    def state(self) -> dict:
        from dynamo_tpu_torch.obs.compile_ledger import get_compile_metrics
        from dynamo_tpu_torch.ops.paged_attention import paged_attention as pa_fn
        from dynamo_tpu_torch.utils.metrics import metric_sum, parse_prometheus

        core = self.core
        # the ledger's event list stops at its cap (earlier phases fill
        # it); its counter stays exact
        events = parse_prometheus("\n".join(get_compile_metrics().events.samples()))
        return {"captures": metric_sum(events, "dynamo_xla_compile_events_total",
                                       source="serve"),
                "decode_tokens": core.metrics.num_decode_tokens,
                "forward_steps": sum(p.calls * (p.shape[3] if len(p.shape) > 3 else 1)
                                     for p in core.runner.programs.values()),
                "launches": dict(pa_fn.launches_by_kernel)}

    def perf_counter(self) -> float:
        if self.open is None:
            self.open = self.state()
        else:
            end = self.state()
            self.windows.append({
                **{k: end[k] - self.open[k] for k in ("captures", "decode_tokens",
                                                       "forward_steps")},
                "launches": {k: v - self.open["launches"].get(k, 0)
                             for k, v in end["launches"].items() if v - self.open["launches"].get(k, 0)}})
            self.open = None
        return time.perf_counter()


def n_bounds(core, isl: list[int], conc: list[int], ctx: list[int]) -> tuple[dict, dict]:
    """The card's least time for each profile point from its row of the cost
    model (``obs/costmodel.py``): a TTFT's prefill chunks, each at its
    context, and an all-decode step of ``c`` rows at context ``x``."""
    from dynamo_tpu_torch.obs import costmodel as cm

    hw = cm.hw_spec_for(core.device_name)
    cfg, ec = core.model_cfg, core.engine_cfg
    ttft = {}
    for n in isl:
        ends = list(range(ec.prefill_chunk, n, ec.prefill_chunk)) + [n]
        ttft[n] = sum(cm.total_cost(cm.prefill_cost(
            cfg, batch=1, chunk=end - start, kv_len=end, block_size=ec.block_size)).time_bound(hw)
            for start, end in zip([0] + ends[:-1], ends))
    itl = {(c, x): cm.total_cost(cm.decode_step_cost(
        cfg, batch=c, kv_len=x, block_size=ec.block_size)).time_bound(hw)
        for c in conc for x in ctx}
    return ttft, itl


def phase_profile(smi: str, root: Path, device: str = "cuda") -> dict:
    """(n1): see the module docstring. Writes the npz under ``root``."""
    from dynamo_tpu_torch.ops.paged_attention import ROUTES
    from dynamo_tpu_torch.planner import profiler as prof_mod

    route = ROUTES[(torch.bfloat16, "float")]
    t_phase = time.perf_counter()
    cfg = prof_mod.engine_config_for_sweep(K_MODEL, N_ISL, N_CONC, N_CTX, N_STEPS)
    win = TimedWindows()
    saved_time = prof_mod.time
    prof_mod.time = win
    try:
        prof = prof_mod.SlaProfiler(cfg, device=device)
        core = win.core = prof.core
        layers = core.model_cfg.num_layers
        cuda = device == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        data = prof.run(N_ISL, N_CONC, N_CTX, N_STEPS)
        sweep_s = time.perf_counter() - t0
        mem = {}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem = {"peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "graph_pool_growth_gib": (torch.cuda.memory_reserved() - reserved0) / 2**30}
        ttft_b, itl_b = n_bounds(core, N_ISL, N_CONC, N_CTX)
        programs = len(core.runner.programs)
    finally:
        prof_mod.time = saved_time
    path = root / "profile.npz"
    prof_mod.save_profile(str(path), data)
    loaded = prof_mod.load_profile(str(path))
    out: dict = {"smi": smi, "path": str(path), "sweep_s": sweep_s, "programs": programs,
                 **mem, "engine": {k: getattr(cfg, k) for k in (
                     "num_blocks", "max_batch_size", "max_model_len", "prefill_chunk",
                     "max_tokens_per_step", "decode_bucket")}}
    ni, nc, nx = len(N_ISL), len(N_CONC), len(N_CTX)
    shapes = {"prefill_isl": (ni,), "prefill_ttft_s": (ni,), "prefill_thpt_per_chip": (ni,),
              "decode_concurrency": (nc,), "decode_context": (nx,), "decode_itl_s": (nc, nx),
              "decode_thpt_per_chip": (nc, nx)}
    got_shapes = {k: tuple(v.shape) for k, v in loaded.items()}
    if got_shapes != shapes or not all(np.isfinite(v).all() and (v > 0).all()
                                       for v in loaded.values()):
        raise AssertionError(f"[n1] profile schema or values: {got_shapes}, {loaded}")
    # the windows: a warmup and a timed one for each point, prefill first
    names = [("ttft", n) for n in N_ISL] + [("itl", c, x) for c in N_CONC for x in N_CTX]
    if len(win.windows) != 2 * len(names):
        raise AssertionError(f"[n1] {len(win.windows)} windows for {len(names)} points")
    rows, faults = [], []
    for i, name in enumerate(names):
        warm, timed = win.windows[2 * i], win.windows[2 * i + 1]
        if name[0] == "ttft":
            n = name[1]
            j = N_ISL.index(n)
            got, bound = float(data["prefill_ttft_s"][j]), ttft_b[n]
            row = {"point": f"ttft isl={n}", "ms": 1e3 * got, "bound_ms": 1e3 * bound,
                   "tok_s_card": float(data["prefill_thpt_per_chip"][j])}
        else:
            c, x = name[1], name[2]
            got, bound = float(data["decode_itl_s"][N_CONC.index(c), N_CTX.index(x)]), itl_b[(c, x)]
            row = {"point": f"itl conc={c} ctx={x}", "ms": 1e3 * got, "bound_ms": 1e3 * bound,
                   "tok_s_card": float(data["decode_thpt_per_chip"][N_CONC.index(c),
                                                                    N_CTX.index(x)]),
                   "window_decode_tokens": timed["decode_tokens"]}
            if timed["decode_tokens"] < c * N_STEPS:
                faults.append(f"{row['point']}: the timed window counted "
                              f"{timed['decode_tokens']} decode tokens")
        row.update({"timed_captures": timed["captures"], "warmup_captures": warm["captures"],
                    "launches": timed["launches"], "forward_steps": timed["forward_steps"]})
        rows.append(row)
        if got < 0.95 * bound:
            faults.append(f"{row['point']}: {row['ms']:.4f} ms beats 0.95 x the card's "
                          f"roofline {row['bound_ms']:.4f} ms")
        if timed["captures"]:
            faults.append(f"{row['point']}: {timed['captures']} serve captures in its timed "
                          f"window")
        for w in (warm, timed):
            want = {route: layers * w["forward_steps"]} if cuda and w["forward_steps"] else {}
            if w["launches"] != want:
                faults.append(f"{row['point']}: launches {w['launches']} in "
                              f"{w['forward_steps']} forward steps; expected {want}")
    ttft = data["prefill_ttft_s"]
    if not all(a < b for a, b in zip(ttft, ttft[1:])):
        faults.append(f"TTFT does not rise with ISL: {ttft.tolist()}")
    thpt = data["decode_thpt_per_chip"]
    for j, x in enumerate(N_CTX):
        if thpt[-1, j] < thpt[0, j]:
            faults.append(f"ctx {x}: {thpt[-1, j]:.1f} tok/s at concurrency {N_CONC[-1]} "
                          f"below {thpt[0, j]:.1f} at {N_CONC[0]}")
    out.update({"rows": rows, "launches": sum(r["launches"].get(route, 0) for r in rows),
                "wall_s": time.perf_counter() - t_phase})
    for r in rows:
        log(f"[n1] {r['point']:>22}: {r['ms']:10.4f} ms (bound {r['bound_ms']:.4f}), "
            f"{r['tok_s_card']:10.1f} tok/s per card, timed-window captures "
            f"{r['timed_captures']} (warmup {r['warmup_captures']}), launches {r['launches']}")
    log(f"[n1] sweep {sweep_s:.1f}s, {programs} programs, peak allocated "
        f"{mem.get('peak_allocated_gib')} GiB, graph pool growth "
        f"{mem.get('graph_pool_growth_gib')} GiB; on {smi}")
    if faults:
        raise AssertionError("[n1] " + "; ".join(faults))
    del prof, core
    win.core = None
    return out


def n_itl_sla(data: dict) -> tuple[float, dict]:
    """(n2)'s ``--itl-sla``: the least ITL of the profile's column at
    (b)'s mean context. Under it the planner sizes a decode replica at that
    point's throughput, the least capacity any SLA gives (a tighter
    corrected ITL falls back to the same point), which (b)'s traffic back
    to back exceeds and a trickle does not."""
    from dynamo_tpu_torch.planner.interpolator import DecodeInterpolator

    di = DecodeInterpolator.from_data(data)
    ctx = N_PROMPT + N_DECODE / 2
    col = np.array([np.interp(ctx, di.context, row) for row in di.itl_s])
    sla = float(col.min())
    thpt, conc = di.find_best_throughput_per_chip(sla, ctx)
    return sla, {"context": ctx, "itl_column_s": col.tolist(), "itl_sla_s": sla,
                 "capacity_tok_s": thpt, "concurrency": conc}


def n_procs_of(marker: str) -> list[int]:
    """Pids of this user's processes whose command line holds ``marker``."""
    pids = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit() and int(d.name) != os.getpid():
            try:
                if marker in (d / "cmdline").read_bytes().decode(errors="replace"):
                    pids.append(int(d.name))
            except OSError:
                pass
    return pids


class FleetWatch:
    """(n2)'s observer thread: every 0.2 s the aggregator's exposition and
    /debug/fleet, the frontend's router counts, and the planner's log."""

    def __init__(self, cl: "KCluster", http_port: int, agg_port: int):
        self.cl, self.http_port, self.agg_port = cl, http_port, agg_port
        self.samples: list[dict] = []
        self.decisions: list[dict] = []
        self.stop = threading.Event()
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self.run, daemon=True)

    def run(self) -> None:
        import re

        from dynamo_tpu_torch.utils.metrics import parse_prometheus

        pat = re.compile(r"decision prefill=(\d+) decode=(\d+) reason=(.*)$")
        try:
            while not self.stop.is_set():
                t = time.perf_counter()
                lines = [ln for ln in self.cl.log_of("planner").splitlines()
                         if "decision prefill=" in ln]
                for ln in lines[len(self.decisions):]:
                    m = pat.search(ln)
                    self.decisions.append({"t": t, "prefill": int(m.group(1)),
                                           "decode": int(m.group(2)), "reason": m.group(3)})
                text = asyncio.run(http_call(self.agg_port, "GET", "/metrics"))["body"].decode()
                debug = k_get(self.agg_port, "/debug/fleet")
                routed = k_stats(self.http_port, K_MODEL).get("router", {}).get("routed", {})
                self.samples.append({"t": t, "metrics": parse_prometheus(text),
                                     "targets": debug["targets"],
                                     "storms": debug["compile_storms"], "routed": routed})
                self.stop.wait(0.2)
        except BaseException as exc:  # noqa: BLE001 - read by the phase
            self.error = exc

    def check(self) -> None:
        if self.error is not None:
            raise AssertionError(f"[n2] the watch failed: {self.error!r}")

    def serve_series(self, instance: str) -> list[tuple[float, float]]:
        """(t, the aggregator's copy of ``instance``'s serve captures) from
        each sample that re-exposes the instance's own series (the ones
        with a ``role`` label; 0 before its first capture: the family
        appears with it)."""
        out = []
        for s in self.samples:
            mine = [(name, labels, v) for (name, labels), v in s["metrics"].items()
                    if ("instance", instance) in labels and any(k == "role" for k, _ in labels)]
            if mine:
                out.append((s["t"], sum(v for name, labels, v in mine
                                        if name == "dynamo_xla_compile_events_total"
                                        and ("source", "serve") in labels)))
        return out


def phase_planner(smi: str, n1: dict, device: str = "cuda") -> dict:
    """(n2): see the module docstring; ``n1`` is (n1)'s result."""
    import re
    import shlex
    import tempfile

    from dynamo_tpu_torch.chaos.invariants import InvariantChecker, StreamOutcome
    from dynamo_tpu_torch.models.config import resolve_model_config
    from dynamo_tpu_torch.obs.fleet import COMPILE_STORM_THRESHOLD, COMPILE_STORM_WINDOW_S
    from dynamo_tpu_torch.ops.paged_attention import ROUTES
    from dynamo_tpu_torch.planner.interpolator import DecodeInterpolator, PrefillInterpolator
    from dynamo_tpu_torch.planner.planner_core import Planner, PlannerConfig
    from dynamo_tpu_torch.planner.profiler import load_profile
    from dynamo_tpu_torch.runtime.drain import drain_status_key
    from dynamo_tpu_torch.transports.client import CoordinatorClient
    from dynamo_tpu_torch.utils.metrics import parse_prometheus

    route = ROUTES[(torch.bfloat16, "float")]
    cfg = resolve_model_config(K_MODEL)
    layers, vocab = cfg.num_layers, cfg.vocab_size
    data = load_profile(n1["path"])
    sla, arith = n_itl_sla(data)
    pcfg = dict(itl_sla_s=sla, adjustment_interval_s=N_INTERVAL, min_replicas=1, max_replicas=2,
                load_predictor="constant")
    log(f"[n2] --itl-sla {sla}: find_best_throughput_per_chip at context {arith['context']} "
        f"-> {arith['capacity_tok_s']:.1f} tok/s a replica (concurrency "
        f"{arith['concurrency']:.0f}; ITL column {arith['itl_column_s']}); a replica is "
        f"needed for each {arith['capacity_tok_s'] * N_INTERVAL / N_DECODE:.1f} requests "
        f"of {N_DECODE} tokens completed in a {N_INTERVAL} s interval (num_req x osl / "
        f"interval against it)")
    tmp = Path(tempfile.mkdtemp(prefix="n-planner-"))
    tok = k_tokenizer(tmp, vocab)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1",
           "DYN_LEASE_TTL_S": str(K_TTL_S), "DYN_LOG": "info"}
    cl = KCluster(tmp, env)
    out: dict = {"smi": smi, "itl_sla": arith}
    t_phase = time.perf_counter()
    watch = None
    outcomes: list = []
    prompts = k_prompts(vocab)
    try:
        coord_port, http_port, agg_port = free_port(), free_port(), free_port()
        url = f"tcp://127.0.0.1:{coord_port}"
        cl.start("coordinator", "dynamo_tpu_torch.transports.coordinator",
                 ["--host", "127.0.0.1", "--port", str(coord_port)])
        cl.wait_line("coordinator", "COORDINATOR_READY", 60)
        cl.start("aggregator", "dynamo_tpu_torch.components.aggregator",
                 ["--coordinator", url, "--host", "127.0.0.1", "--port", str(agg_port),
                  "--scrape-interval", str(N_SCRAPE), "--staleness-ttl", str(N_STALE)])
        cl.start("frontend", "dynamo_tpu_torch.components.frontend",
                 ["--coordinator", url, "--host", "127.0.0.1", "--port", str(http_port),
                  "--router-mode", "kv"])
        cl.wait_line("aggregator", "AGGREGATOR_READY", 60)
        cl.wait_line("frontend", "FRONTEND_READY", 120)
        worker = k_worker_args(url, "bf16", K_MODEL, K_BF16_BLOCKS, N_MAX_LEN, tok, device,
                               ["--warmup-mode", "lazy"])
        # the workers the planner spawns inherit its environment: a status
        # server each, advertised to the aggregator
        cl.start("planner", "dynamo_tpu_torch.components.planner", [
            "--mode", "process", "--coordinator", url,
            "--fleet-url", f"http://127.0.0.1:{agg_port}", "--model", K_MODEL,
            "--profile-data", n1["path"], "--adjustment-interval", str(N_INTERVAL),
            "--min-replicas", "1", "--max-replicas", "2", "--itl-sla", repr(sla),
            "--load-predictor", "constant", "--decode-worker-args", shlex.join(worker)],
            env={"DYN_SYSTEM_ENABLED": "1"})
        cl.wait_line("planner", "PLANNER_READY", 60)
        t_ready = time.perf_counter()
        watch = FleetWatch(cl, http_port, agg_port)
        watch.thread.start()

        def ready_ids() -> list[str]:
            return re.findall(r"WORKER_READY instance=([0-9a-f]{16})", cl.log_of("planner"))

        def wait_for(pred, timeout: float, what: str):
            deadline = time.monotonic() + timeout
            while True:
                got = pred()
                if got:
                    return got
                watch.check()
                cl.check_alive()
                if time.monotonic() > deadline:
                    raise AssertionError(f"[n2] {what} in {timeout}s:\n"
                                         f"{cl.log_of('planner')[-4000:]}")
                time.sleep(0.1)

        def fleet_roles() -> list[str]:
            return sorted(t["role"] for t in k_get(agg_port, "/debug/fleet")["targets"]
                          if t["fresh"])

        # 1. the first decision spawns worker A; the aggregator finds it
        wait_for(lambda: len(ready_ids()) >= 1, 300, "no first worker")
        a_hex = ready_ids()[0]
        a = a_hex.lstrip("0")
        out["a_up_s"] = time.perf_counter() - t_ready
        wait_for(lambda: a in k_stats(http_port, K_MODEL).get("instances", []), 60,
                 "the frontend did not discover A")
        wait_for(lambda: fleet_roles() == ["frontend", "worker"], 30,
                 "the aggregator did not find the frontend and A")
        a_inst = next(t["instance"] for t in k_get(agg_port, "/debug/fleet")["targets"]
                      if t["role"] == "worker")
        if watch.decisions[0]["decode"] != 1:
            raise AssertionError(f"[n2] first decision: {watch.decisions[0]}")
        log(f"[n2] A ({a_hex}) up {out['a_up_s']:.1f}s after the planner; the aggregator "
            f"sees the frontend and A")

        # 2. (b)'s traffic back to back: the planner decides 2, B serves
        stop = threading.Event()
        errors: list[BaseException] = []

        def traffic(batch: int, pause: float) -> None:
            k = 0
            try:
                while not stop.is_set():
                    got = k_batch(http_port, K_MODEL, prompts[:batch], N_DECODE)
                    outcomes.extend(StreamOutcome(f"n2-{len(outcomes) + i}", "finished",
                                                  "length") for i in range(len(got)))
                    k += 1
                    stop.wait(pause)
            except BaseException as exc:  # noqa: BLE001 - read below
                errors.append(exc)

        t_heavy = time.perf_counter()
        heavy = threading.Thread(target=traffic, args=(len(prompts), 0.0), daemon=True)
        heavy.start()
        up = wait_for(lambda: next((d for d in watch.decisions if d["decode"] == 2), None),
                      120, "no decision for 2 replicas")
        wait_for(lambda: len(ready_ids()) >= 2, 300, "no second worker")
        b_hex = ready_ids()[1]
        b = b_hex.lstrip("0")
        t_b_ready = time.perf_counter()
        first_b = wait_for(lambda: next((s["t"] for s in watch.samples
                                         if s["routed"].get(b, 0) > 0), None), 120,
                           "the router sent B no request")
        wait_for(lambda: fleet_roles() == ["frontend", "worker", "worker"], 30,
                 "the aggregator did not find B")
        b_inst = next(t["instance"] for t in k_get(agg_port, "/debug/fleet")["targets"]
                      if t["role"] == "worker" and t["instance"] != a_inst)
        wait_for(lambda: time.perf_counter() - t_heavy >= 3 * N_INTERVAL, 60, "")

        # the compile storms against each worker's own serve captures, read
        # while the heavy traffic still holds both replicas (once the load
        # falls the planner may decide 1 and retire B before it is read):
        # both workers' own counts, the aggregator after 3 scrapes, the own
        # counts again; taken when no capture fell between the two reads
        def own_captures(inst: str) -> float:
            port = int(inst.rsplit(":", 1)[1])
            own = parse_prometheus(asyncio.run(http_call(port, "GET", "/metrics"))[
                "body"].decode())
            return sum(v for (name, labels), v in own.items()
                       if name == "dynamo_xla_compile_events_total"
                       and ("source", "serve") in labels)

        insts = ((a, a_inst), (b, b_inst))
        deadline = time.monotonic() + 60
        while True:
            before = {w: own_captures(inst) for w, inst in insts}
            time.sleep(3 * N_SCRAPE)
            debug = k_get(agg_port, "/debug/fleet")
            gauges = parse_prometheus(asyncio.run(http_call(agg_port, "GET", "/metrics"))[
                "body"].decode())
            now = time.perf_counter()
            after = {w: own_captures(inst) for w, inst in insts}
            if after == before:
                break
            if errors or time.monotonic() > deadline:
                raise AssertionError(f"[n2] serve captures still moving under the heavy "
                                     f"traffic after 60 s ({before} -> {after}); {errors}")
        storms = {s["instance"] for s in debug["compile_storms"]}
        out["compile_storm"] = {}
        for w, inst in insts:
            own_now = after[w]
            series = watch.serve_series(inst)
            base = series[0][1]
            for ts, v in series:
                if ts <= now - COMPILE_STORM_WINDOW_S:
                    base = v
            want = own_now - base
            gauge = sum(v for (name, labels), v in gauges.items()
                        if name == "dynamo_fleet_compile_storm" and ("instance", inst) in labels)
            out["compile_storm"][w] = {"instance": inst, "gauge": gauge,
                                       "own_serve_captures": own_now, "base": base,
                                       "flagged": inst in storms}
            if gauge != want or (inst in storms) != (want >= COMPILE_STORM_THRESHOLD):
                raise AssertionError(f"[n2] compile storm of {inst}: gauge {gauge}, "
                                     f"flagged {inst in storms}; the worker's own serve "
                                     f"captures {own_now} - {base} = {want} (threshold "
                                     f"{COMPILE_STORM_THRESHOLD})")
        stop.set()
        heavy.join(300)
        if errors:
            raise AssertionError(f"[n2] heavy traffic: {errors[0]!r}")
        out["heavy_s"] = time.perf_counter() - t_heavy
        out["decision_to_b_ready_s"] = t_b_ready - up["t"]
        out["decision_to_b_first_request_s"] = first_b - up["t"]
        log(f"[n2] scale-up decision ({up['reason']}) -> B ({b_hex}) ready "
            f"{out['decision_to_b_ready_s']:.2f}s, first request routed to B "
            f"{out['decision_to_b_first_request_s']:.2f}s; on {smi}")

        # the quiet, at once: both workers' launches
        settled = k_settled(http_port, K_MODEL, [a, b])
        zero = {"workers": {w: {"attention": {"launches": {}, "forward_steps": 0}}
                            for w in (a, b)}}
        out["launches"] = k_launches("[n2]", zero, settled, [a, b], route, layers)
        log("[n2] compile storms " + json.dumps(out["compile_storm"]))

        # 3. a trickle: the planner decides 1 and the connector retires B
        n_up = len(watch.decisions)
        stop.clear()
        trickle = threading.Thread(target=traffic, args=(1, N_INTERVAL / 2), daemon=True)
        trickle.start()
        down = wait_for(lambda: next((d for d in watch.decisions[n_up:] if d["decode"] == 1),
                                     None), 120, "no decision back to 1")
        exited = wait_for(lambda: re.search(r"instance=%s exited rc=(\S+)" % b_hex,
                                            cl.log_of("planner")), 120, "B never exited")
        t_exit = time.perf_counter()
        stop.set()
        trickle.join(120)
        if errors:
            raise AssertionError(f"[n2] trickle: {errors[0]!r}")
        planner_log = cl.log_of("planner")
        drained = [json.loads(ln.split("WORKER_DRAINED ", 1)[1])
                   for ln in planner_log.splitlines() if "WORKER_DRAINED " in ln]

        async def drain_report():
            c = await CoordinatorClient.connect(url)
            try:
                raw = await c.get(drain_status_key("dynamo", int(b_hex, 16)))
                return json.loads(raw) if raw else None
            finally:
                await c.close()

        report = asyncio.run(drain_report())
        out["retired"] = {"instance": b_hex, "rc": exited.group(1), "report": report,
                          "decision_to_exit_s": t_exit - down["t"]}
        if exited.group(1) != "0" or not report or report.get("state") != "done" \
                or len(drained) != 1 or drained[0]["state"] != "done":
            raise AssertionError(f"[n2] B's retirement: {out['retired']}, {drained}")
        if "SIGKILL" in planner_log or "ignored the drain window" in planner_log:
            raise AssertionError("[n2] the retirement escalated:\n" + planner_log[-3000:])
        # B's target: its lease goes with it (deregistered, last sample kept),
        # then it leaves the aggregator
        wait_for(lambda: b_inst not in {t["instance"] for t in
                                        k_get(agg_port, "/debug/fleet")["targets"]},
                 N_STALE + 10, "B's target never left the aggregator")
        states = [next((t for t in s["targets"] if t["instance"] == b_inst), None)
                  for s in watch.samples if s["t"] >= t_exit - 5]
        seen = [st for st in states if st is not None]
        out["retired"]["target_states"] = sorted({(st["registered"], st["fresh"]) for st in seen})
        if not any(not st["registered"] or not st["fresh"] for st in seen):
            raise AssertionError(f"[n2] B's target left without going stale or "
                                 f"deregistered: {states}")
        log("[n2] B retired: " + json.dumps(out["retired"]))

        # every decision equals compute_replicas from its reason's load
        planner = Planner(PlannerConfig(**pcfg), PrefillInterpolator.from_data(data),
                          DecodeInterpolator.from_data(data))
        pred = re.compile(r"pred: ([\d.]+) req × isl (\d+) / osl (\d+); p_corr ([\d.]+) "
                          r"d_corr ([\d.]+)")
        for d in watch.decisions:
            if "slo[" not in d["reason"] or "budget=" not in d["reason"]:
                raise AssertionError(f"[n2] a decision without the SLO stamp: {d}")
            m = pred.search(d["reason"])
            if m:
                planner.p_correction, planner.d_correction = float(m.group(4)), float(m.group(5))
                want = planner.compute_replicas(float(m.group(1)), float(m.group(2)),
                                                float(m.group(3)))
            elif d["reason"].startswith("no load"):
                want = planner.compute_replicas(0.0, 0.0, 0.0)
            else:
                raise AssertionError(f"[n2] a reason without its load: {d}")
            if (want.prefill_replicas, want.decode_replicas) != (d["prefill"], d["decode"]):
                raise AssertionError(f"[n2] decision {d} against compute_replicas {want}")
        seq = [d["decode"] for d in watch.decisions]
        out["decisions"] = [{k: d[k] for k in ("decode", "reason")} | {
            "t": d["t"] - t_ready} for d in watch.decisions]
        for d in out["decisions"]:
            log(f"[n2] decision at {d['t']:.1f}s: decode {d['decode']}: {d['reason']}")

        # the invariants, after the drain
        stats = {K_MODEL: k_settled(http_port, K_MODEL, [a])}
        inv = InvariantChecker()
        inv.check_streams(outcomes)
        inv.check_block_leaks(stats)
        inv.check_metrics_balance(k_get(http_port, "/metrics"))
        inv.check_fleet_rollup(asyncio.run(http_call(agg_port, "GET", "/metrics"))[
            "body"].decode())
        out["invariants"] = inv.finish().to_dict()
        if not out["invariants"]["passed"]:
            raise AssertionError(f"[n2] invariants: {out['invariants']['failures']}")
        out["slos"] = {name: {k: s[k] for k in ("burn_rates", "budget_remaining", "good",
                                                "total", "page", "warn")}
                       for name, s in k_get(agg_port, "/debug/fleet")["slos"].items()}
        log("[n2] aggregator SLOs " + json.dumps(out["slos"]))
        out["requests"] = len(outcomes)
        if seq[0] != 1 or 2 not in seq or seq[-1] != 1:
            raise AssertionError(f"[n2] decisions {seq}")
        # the planner retires A through the drain when it stops
        watch.stop.set()
        watch.thread.join(10)
        rc = cl.terminate("planner", 120)
        final = cl.log_of("planner")
        if rc != 0 or not re.search(r"instance=%s exited rc=0" % a_hex, final):
            raise AssertionError(f"[n2] the planner exited {rc}, A's retirement:\n"
                                 f"{final[-3000:]}")
        log(f"[n2] {len(outcomes)} requests of {N_DECODE} tokens, decisions {seq}, A and B "
            f"launched {json.dumps(out['launches'])}")
    finally:
        if watch is not None:
            watch.stop.set()
        cl.stop_all()
        # workers the planner spawned, should it have died before retiring them
        for pid in n_procs_of(str(tmp)):
            try:
                os.kill(pid, 9)
            except OSError:
                pass
    left = [n for n, (p, _) in cl.procs.items() if p.poll() is None] + n_procs_of(str(tmp))
    if left:
        raise AssertionError(f"[n] processes left over: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[n2] passed in {out['wall_s']:.1f}s")
    return out


def phase_planning(smi: str, device: str = "cuda") -> dict:
    """(n): (n1), then (n2) on its profile."""
    import tempfile

    from dynamo_tpu_torch.planner.profiler import load_profile

    root = Path(tempfile.mkdtemp(prefix="n-profile-"))
    n1 = phase_profile(smi, root, device)
    free_engine()
    # (n2) sizes a replica at the least ITL of the column; a column that
    # falls with concurrency is a noisy window (one H100 run read 4.58 ms
    # at concurrency 1 against 4.10 at 8), and a planner sized on it
    # retires B before (n2) reads it: the sweep is taken once more
    col = n_itl_sla(load_profile(n1["path"]))[1]["itl_column_s"]
    if any(b < a for a, b in zip(col, col[1:])):
        log(f"[n1] the ITL column {col} falls with concurrency: sweeping again")
        n1 = phase_profile(smi, root, device)
        free_engine()
    audit_memory("(n1)")
    n2 = phase_planner(smi, n1, device)
    log(f"[n] passed: (n1) {n1['wall_s']:.1f}s, (n2) {n2['wall_s']:.1f}s")
    return {"n1": n1, "n2": n2}


# ---------------------------------------------------------------------------
# (o) the loading tools, a recipe, KServe v2 and the encode worker
# ---------------------------------------------------------------------------

#: (o)'s model, served name, engine settings ((k2)'s), encoder geometry
#: (recipes/llama-3-8b/multimodal.yaml's) and image
O_MODEL = "llama-3-8b-lite"
O_SERVED = "llama-3-8b-lite-gguf"
O_ENGINE = {"blockSize": 16, "numBlocks": 1280, "maxBatchSize": 32, "maxModelLen": 1088}
O_ENCODER = {"imageTokens": 64, "lmHidden": 4096, "imageSize": 448}
O_IMAGE = (480, 640)
O_PROMPT = "one two three four five six seven eight nine ten eleven twelve thirteen"
O_DECODE = 16
#: the encoder on the card against the CPU: within 1e-4·max|ref| + 1e-5
O_ENC_TOL = (1e-4, 1e-5)
#: llama.cpp's tensor names of the layer leaves (the port's [in, out]
#: layout is the transpose of each matrix's)
O_NAMES = {"wq": "attn_q.weight", "wk": "attn_k.weight", "wv": "attn_v.weight",
           "wo": "attn_output.weight", "attn_norm": "attn_norm.weight",
           "mlp_norm": "ffn_norm.weight", "w_gate": "ffn_gate.weight",
           "w_up": "ffn_up.weight", "w_down": "ffn_down.weight"}
#: malformed v2 tensors and the JAX package's 400 texts for them
O_BAD_INFER = [
    ({"inputs": [{"name": "text_input", "datatype": "FP32", "shape": [1], "data": ["x"]}]},
     "expected 'text_input' to be BYTES, got 'FP32'"),
    ({"inputs": [{"name": "text_input", "datatype": "BYTES", "shape": [2],
                  "data": ["a", "b"]}]},
     "expected 'text_input' to have shape [1], got [2]"),
    ({"inputs": []}, "missing required input tensor 'text_input'"),
    ({"inputs": [{"name": "text_input", "datatype": "BYTES", "shape": [1], "data": ["x"]},
                 {"name": "streaming", "datatype": "BOOL", "shape": [1], "data": [True]}]},
     "REST ModelInfer is unary; use /generate_stream"),
    (b"{not json", "invalid JSON body"),
]


def q8_0(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GGML Q8_0 of a [rows, cols] matrix: int8 values [rows, cols] and
    f16 scales [rows, cols // 32], each 32-value block's scale its amax /
    127 and its values rounded against that scale."""
    rows, cols = w.shape
    b = w.float().reshape(rows, cols // 32, 32)
    d = (b.abs().amax(-1) / 127.0).half()
    df = d.float()[..., None]
    q = torch.where(df > 0, torch.round(b / torch.where(df > 0, df, 1.0)), 0.0)
    return q.clamp(-127, 127).to(torch.int8).reshape(rows, cols), d


def q8_0_blob(q: torch.Tensor, d: torch.Tensor) -> np.ndarray:
    """The blocks as GGUF stores them: each 32-value block's f16 scale, then
    its 32 int8 values (34 bytes a block)."""
    return torch.cat([d.reshape(-1, 1).view(torch.uint8),
                      q.reshape(-1, 32).view(torch.uint8)], 1).cpu().numpy()


def o_dequant(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    rows, cols = q.shape
    return (q.float().reshape(rows, cols // 32, 32) * d.float()[..., None]) \
        .reshape(rows, cols).to(torch.bfloat16)


def write_gguf(path: Path, device: str) -> tuple[dict, dict]:
    """(o0): ``O_MODEL``'s seed-0 bf16 weights ((b)'s) as a GGUF file: every
    matrix Q8_0 (Q and K rows in llama.cpp's interleaved-rope order), the
    norms F32. Returns the weights chip_smoke dequantizes from its own int8
    values and scales, in the engine's layout (no reader involved), and the
    numbers of the file."""
    from dynamo_tpu_torch.models import gguf, llama
    from dynamo_tpu_torch.models.config import resolve_model_config

    cfg = resolve_model_config(O_MODEL)
    t0 = time.perf_counter()
    w = llama.init_params(cfg, seed=0, device=device)
    md = {"general.architecture": "llama", "general.name": O_SERVED,
          "llama.block_count": cfg.num_layers, "llama.embedding_length": cfg.hidden_size,
          "llama.feed_forward_length": cfg.intermediate_size,
          "llama.attention.head_count": cfg.num_heads,
          "llama.attention.head_count_kv": cfg.num_kv_heads,
          "llama.attention.key_length": cfg.head_dim, "llama.rope.freq_base": cfg.rope_theta,
          "llama.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
          "llama.context_length": cfg.max_position_embeddings,
          "llama.vocab_size": cfg.vocab_size}
    if not cfg.tie_word_embeddings or "lm_head" in w:
        raise AssertionError(f"[o0] {O_MODEL} is expected to tie its embeddings")
    tensors: dict = {}
    ref: dict = {"layers": {}}
    params = 0

    def matrix(name: str, hf: torch.Tensor, heads: int | None = None) -> torch.Tensor:
        """Store ``hf`` ([out, in]) as Q8_0; its dequantized bf16 values back."""
        nonlocal params
        q, d = q8_0(hf)
        stored_q, stored_d = ((gguf.permute_qk(q, heads), gguf.permute_qk(d, heads))
                              if heads else (q, d))
        tensors[name] = (tuple(hf.shape), gguf.GGML_Q8_0, q8_0_blob(stored_q, stored_d))
        params += hf.numel()
        return o_dequant(q, d)

    ref["embed"] = matrix("token_embd.weight", w["embed"])
    tensors["output_norm.weight"] = w["final_norm"].float().cpu()
    ref["final_norm"] = w["final_norm"].clone()
    heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads}
    for our, suffix in O_NAMES.items():
        stack = w["layers"][our]
        out = []
        for i in range(cfg.num_layers):
            if stack.dim() == 2:     # a norm
                tensors[f"blk.{i}.{suffix}"] = stack[i].float().cpu()
                out.append(stack[i].clone())
                params += stack[i].numel()
            else:
                out.append(matrix(f"blk.{i}.{suffix}", stack[i].T.contiguous(),
                                  heads.get(our)).T)
        ref["layers"][our] = torch.stack(out).contiguous()
    del w
    free_engine()
    quant_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    gguf.save_gguf(path, md, tensors)
    write_s = time.perf_counter() - t1
    size = path.stat().st_size
    info = {"params": params, "file_bytes": size, "bf16_bytes": 2 * params,
            "ratio": size / (2 * params), "quantize_s": quant_s, "write_s": write_s}
    log("[o0] " + json.dumps(info))
    return ref, info


def o_params_equal(tag: str, got: dict, want: dict, path: str = "") -> int:
    """Every leaf of ``got`` equals ``want``'s byte for byte; returns the
    leaves compared."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{tag}: leaves {sorted(got)} != {sorted(want)} at {path}")
        return sum(o_params_equal(tag, got[k], want[k], f"{path}/{k}") for k in want)
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(
            got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"{tag}: leaf {path} differs ({got.dtype} {tuple(got.shape)} "
                             f"vs {want.dtype} {tuple(want.shape)})")
    return 1


def o_serve(tag: str, engine, device: str) -> tuple[dict, dict]:
    """(b)'s 32 x (128 + 64) greedy requests on ``engine``: their streams, and
    the run's launches (``mma_bf16`` only, 8 a forward step on the card)."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)

    core = engine.core
    prompts = k_prompts(core.model_cfg.vocab_size)
    reqs = {i: PreprocessedRequest(
        token_ids=p, stop_conditions=StopConditions(max_tokens=64, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0), request_id=f"{tag}-{i}")
        for i, p in enumerate(prompts)}
    pa.reset_launches()
    t_start, first_at, done_at, streams, _ = asyncio.run(serve(engine, reqs))
    by_kernel = dict(pa.paged_attention.launches_by_kernel)
    route = pa.ROUTES[(torch.bfloat16, "float")]
    steps = check_engine_launches(tag, core, by_kernel, route) if device == "cuda" else None
    if any(len(toks) != 64 for toks, _ in streams.values()):
        raise AssertionError(f"{tag}: a stream is not 64 tokens long")
    t_first = max(first_at.values())
    res = {"launches": by_kernel.get(route, 0), "forward_steps": steps,
           "launches_per_forward_step": (by_kernel.get(route, 0) / steps) if steps else None,
           "decode_tok_s": 32 * 63 / (max(done_at.values()) - t_first),
           "ttft_all_s": t_first - t_start}
    return {i: toks for i, (toks, _) in streams.items()}, res


def o_loader(path: Path, ref: dict, device: str) -> dict:
    """(o1): engine A loads the file (hub resolution, the engine's .gguf
    branch), engine B holds chip_smoke's own dequantized weights: equal
    leaves, equal streams."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.models.config import MODEL_PRESETS, resolve_model_config
    from dynamo_tpu_torch.models.hub import resolve_model_path
    from dynamo_tpu_torch.utils.config import EngineConfig

    kw = dict(block_size=16, max_batch_size=32, max_model_len=128 + 64 + 16,
              prefill_chunk=128, warmup_mode="lazy")
    resolved = resolve_model_path(str(path))
    if resolved != str(path):
        raise AssertionError(f"[o1] the hub resolved {path} to {resolved}")
    free_engine()
    t0 = time.perf_counter()
    a = build_engine(EngineConfig(model=resolved, **kw), device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    a_build_s = time.perf_counter() - t0
    leaves = o_params_equal("[o1] the GGUF engine's weights against chip_smoke's dequant",
                            a.core.runner.params, ref)
    a_streams, a_run = o_serve("[o1] A", a, device)
    del a
    free_engine()
    # engine B: the same config under another name, chip_smoke's weights
    ref_name = "o-gguf-reference"
    MODEL_PRESETS[ref_name] = dataclasses.replace(resolve_model_config(resolved),
                                                  name=ref_name)
    try:
        t0 = time.perf_counter()
        b = build_engine(EngineConfig(model=ref_name, **kw), device=device, params=ref)
        b_build_s = time.perf_counter() - t0
        b_streams, b_run = o_serve("[o1] B", b, device)
        del b
    finally:
        del MODEL_PRESETS[ref_name]
    free_engine()
    differ = [i for i in a_streams if a_streams[i] != b_streams[i]]
    res = {"leaves_equal": leaves, "engine_a_build_s": a_build_s,
           "engine_b_build_s": b_build_s, "gguf_load_s": a_build_s - b_build_s,
           "streams_equal": len(a_streams) - len(differ), "a": a_run, "b": b_run}
    log("[o1] " + json.dumps(res))
    if differ:
        raise AssertionError(f"[o1] streams {differ[:8]} of the GGUF engine differ from "
                             "the dequantized reference's")
    if device == "cuda" and (a_run["launches_per_forward_step"] != 8
                             or b_run["launches_per_forward_step"] != 8):
        raise AssertionError(f"[o1] launches a forward step: {a_run} {b_run}")
    return res


def o_tokenizer(root: Path, vocab: int) -> Path:
    """A byte-level BPE tokenizer.json for the random-weight model: ids 0-255
    are the bytes (text prompts encode to them), id ``i`` >= 256 the text
    `` t<i>``, so every generated token is visible in text and SSE deltas."""
    from dynamo_tpu_torch.tokenizer.base import _bytes_to_unicode

    d = root / "o-tokenizer"
    d.mkdir(parents=True, exist_ok=True)
    b2u = _bytes_to_unicode()
    vocab_map = {b2u[b]: b for b in range(256)}
    vocab_map.update({f"Ġt{i}": i for i in range(256, vocab)})
    (d / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": "BPE", "vocab": vocab_map, "merges": []}, "added_tokens": []}))
    return d


def o_recipe(root: Path, gguf_path: Path, tok: Path, coord_port: int,
             http_port: int) -> Path:
    """(o2)'s TpuServeDeployment: the GGUF model, a coordinator, a kv-routed
    frontend, one encoder at the multimodal recipe's geometry and one
    worker with (k2)'s engine settings."""
    enc = ", ".join(f"{k}: {v}" for k, v in O_ENCODER.items())
    eng = ", ".join(f"{k}: {v}" for k, v in O_ENGINE.items())
    text = f"""# chip_smoke (o2): a GGUF model and an encode worker on one card
apiVersion: dynamo-tpu/v1
kind: TpuServeDeployment
metadata: {{name: o-gguf-multimodal}}
spec:
  model: "{gguf_path}"
  servedModelName: {O_SERVED}
  tokenizer: "{tok}"
  coordinator: {{port: {coord_port}}}
  encoder: {{replicas: 1, {enc}}}
  frontend: {{port: {http_port}, routerMode: kv}}
  workers:
    - name: worker
      replicas: 1
      engine: {{{eng}}}
"""
    path = root / "o-recipe.yaml"
    path.write_text(text)
    return path


class RecorderThread:
    """(o5)'s ``StreamRecorder`` on a subject, in an event loop of its own."""

    def __init__(self, url: str, subject: str, out: Path):
        from dynamo_tpu_torch.transports.client import CoordinatorClient
        from dynamo_tpu_torch.utils.recorder import StreamRecorder

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

        async def start():
            coord = await CoordinatorClient.connect(url)
            rec = StreamRecorder(coord, subject, str(out))
            await rec.start()
            return coord, rec

        self.coord, self.rec = self._run(start())

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def stop(self) -> int:
        async def stop():
            await self.rec.stop()
            await self.coord.close()

        self._run(stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()
        return self.rec.count


def kserve_summary(res: dict) -> dict:
    """Text, finish reason and the times of the first and last events of
    a ``/generate_stream`` answer."""
    text, finish = "", None
    for ev in res["events"]:
        d = json.loads(ev)
        text += d.get("text_output", "")
        finish = d.get("finish_reason") or finish
    return {"text": text, "finish": finish, "events": len(res["events"]),
            "first": res["times"][0] if res["times"] else None,
            "last": res["times"][-1] if res["times"] else None}


def o_worker_stats(port: int) -> tuple[dict, list[str]]:
    st = k_settled(port, O_SERVED, k_stats(port, O_SERVED).get("instances", []))
    return st, list(st.get("instances", []))


def o_launches(tag: str, before: dict, after: dict, workers: list[str], device: str) -> dict:
    from dynamo_tpu_torch.models.config import resolve_model_config
    from dynamo_tpu_torch.ops.paged_attention import ROUTES

    if device != "cuda":     # the CPU has no kernel: forward steps only
        return {w: {"forward_steps": after["workers"][w]["attention"]["forward_steps"]
                    - before["workers"][w]["attention"]["forward_steps"]} for w in workers}
    layers = resolve_model_config(O_MODEL).num_layers
    out = k_launches(tag, before, after, workers, ROUTES[(torch.bfloat16, "float")], layers)
    for w, r in out.items():
        if r["launches_per_forward_step"] != layers:
            raise AssertionError(f"{tag}: worker {w}: {r}")
    return out


def o_kserve(port: int, device: str, smi: str) -> dict:
    """(o3): the v2 routes on the recipe's frontend."""
    out: dict = {}
    m = f"/v2/models/{O_SERVED}"
    for path in ("/v2/health/live", "/v2/health/ready", m, f"{m}/ready"):
        res = asyncio.run(http_call(port, "GET", path))
        if res["status"] != 200:
            raise AssertionError(f"[o3] GET {path}: {res['status']} {res['body'][:300]}")
    meta = json.loads(asyncio.run(http_call(port, "GET", m))["body"])
    if meta["name"] != O_SERVED or meta["inputs"][0]["name"] != "text_input":
        raise AssertionError(f"[o3] metadata {meta}")
    params = {"max_tokens": O_DECODE, "temperature": 0, "ignore_eos": True}

    def post(path, body):
        res = asyncio.run(http_call(port, "POST", path, body))
        if res["status"] != 200:
            raise AssertionError(f"[o3] POST {path}: {res['status']} {res['body'][:300]}")
        return res

    openai = json.loads(post("/v1/completions", {
        "model": O_SERVED, "prompt": O_PROMPT, **params})["body"])["choices"][0]
    want = openai["text"]
    infer = json.loads(post(f"{m}/infer", {"inputs": [{
        "name": "text_input", "datatype": "BYTES", "shape": [1], "data": [O_PROMPT]}],
        "parameters": params})["body"])
    gen = json.loads(post(f"{m}/generate", {"text_input": O_PROMPT,
                                            "parameters": params})["body"])
    stream = kserve_summary(post(f"{m}/generate_stream", {"text_input": O_PROMPT,
                                                          "parameters": params}))
    texts = {"infer": infer["outputs"][0]["data"][0], "generate": gen["text_output"],
             "generate_stream": stream["text"]}
    finishes = {"v1": openai["finish_reason"], "infer": infer["outputs"][1]["data"][0],
                "generate": gen["finish_reason"], "generate_stream": stream["finish"]}
    if any(t != want for t in texts.values()) or set(finishes.values()) != {"length"} \
            or not want or stream["events"] < 2:
        raise AssertionError(f"[o3] v2 texts {texts} / finishes {finishes} against the "
                             f"OpenAI route's {want!r}")
    out["one_prompt"] = {"text": want, "stream_events": stream["events"]}
    log(f"[o3] one prompt: /v1/completions, /infer, /generate and /generate_stream all give "
        f"{want!r}")
    for body, text in O_BAD_INFER:
        raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        res = asyncio.run(o_raw_post(port, f"{m}/infer", raw))
        if res != (400, {"error": text}):
            raise AssertionError(f"[o3] malformed {body!r}: {res}, expected 400 {text!r}")
    out["malformed_400"] = len(O_BAD_INFER)

    # (b)'s geometry through /generate_stream from a client process of its own
    prompts = ["".join(chr(33 + t % 94) for t in p) for p in k_prompts(512)]
    bodies = {f"o3-{i}": {"text_input": p, "parameters": {
        "max_tokens": 64, "temperature": 0, "ignore_eos": True}} for i, p in enumerate(prompts)}
    s0, workers = o_worker_stats(port)
    t_start, sums, client_cpu = client_in_own_process(
        port, bodies, f"{m}/generate_stream", "kserve")
    s1, _ = o_worker_stats(port)
    bad = [(st, s["finish"]) for st, s in sums if st != 200 or s["finish"] != "length"]
    if bad:
        raise AssertionError(f"[o3] streams failed: {bad[:4]}")
    t_first = max(s["first"] for _, s in sums)
    t_end = max(s["last"] for _, s in sums)
    out["throughput"] = {
        "requests": len(sums), "prompt_tokens": 128, "decode": 64,
        "decode_tok_s": len(sums) * 63 / (t_end - t_first), "ttft_all_s": t_first - t_start,
        "ttft_median_s": float(np.median([s["first"] - t_start for _, s in sums])),
        "client_cpu_s": client_cpu,
        "workers": o_launches("[o3]", s0, s1, workers, device)}
    log("[o3] " + json.dumps(out["throughput"]))
    log(f"[o3] KServe /generate_stream, 32 x (128 + 64) from a client process: decode tok/s "
        f"{out['throughput']['decode_tok_s']}, TTFT (all 32) {out['throughput']['ttft_all_s']}"
        f" s; on {smi}")
    return out


async def o_raw_post(port: int, path: str, raw: bytes) -> tuple[int, dict]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n"
                  f"Content-Type: application/json\r\nContent-Length: {len(raw)}\r\n\r\n")
                 .encode() + raw)
    try:
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
        n = int(next(ln.split(":", 1)[1] for ln in head if ln.lower().startswith(
            "content-length")))
        return int(head[0].split(" ")[1]), json.loads(await reader.readexactly(n))
    finally:
        writer.close()


def o_images(port: int, launcher_log: Path, device: str, smi: str) -> dict:
    """(o4): a 640 x 480 PNG through the frontend, the encode worker and the
    worker's prefill of its 64 rows; the encoder on the card against the
    CPU; a JPEG refused by name."""
    from dynamo_tpu_torch.models.image import encode_png
    from dynamo_tpu_torch.models.vision import VisionConfig, VisionEncoder

    # gradients and an 8-pixel checkerboard: it compresses to a request body
    # well under the server's 1 MiB limit (random pixels would not)
    h, w = O_IMAGE
    yy, xx = np.mgrid[0:h, 0:w]
    board = ((yy // 8 + xx // 8) % 2) * 64
    px = np.stack([xx * 191 // (w - 1) + board, yy * 191 // (h - 1) + board,
                   (xx + yy) % 192 + board], -1).astype(np.uint8)
    png = encode_png(px, 2, filters=(0, 1, 2, 3, 4))

    def body(image: bytes, mime: str) -> dict:
        url = f"data:{mime};base64," + base64.b64encode(image).decode()
        return {"model": O_SERVED, "max_tokens": 8, "temperature": 0, "logprobs": True,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "describe "},
                    {"type": "image_url", "image_url": {"url": url}}]}]}

    def chat(image: bytes, mime: str = "image/png") -> tuple[int, dict]:
        res = asyncio.run(http_call(port, "POST", "/v1/chat/completions", body(image, mime)))
        try:
            return res["status"], json.loads(res["body"])
        except ValueError:
            raise AssertionError(f"[o4] chat: {res['status']} {res['body'][:300]!r}") from None

    s0, workers = o_worker_stats(port)
    answers = []
    for _ in range(2):
        status, d = chat(png)
        if status != 200 or d["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"[o4] image chat: {status} {str(d)[:300]}")
        answers.append((d["choices"][0]["message"]["content"],
                        [e["logprob"] for e in d["choices"][0]["logprobs"]["content"]],
                        d["usage"]))
    s1, _ = o_worker_stats(port)
    # the same answer: text and usage; the second request's prefix (image
    # rows included, digest-salted) comes from the first's cached blocks, so
    # its bf16 log-probs may differ in the last bits (printed)
    if answers[0][0] != answers[1][0] or answers[0][2] != answers[1][2]:
        raise AssertionError(f"[o4] the same image answered twice differently: {answers}")
    lp_diff = max(abs(a - b) for a, b in zip(answers[0][1], answers[1][1]))
    hits = {w: s1["workers"][w]["prefix_hit_blocks"] - s0["workers"][w]["prefix_hit_blocks"]
            for w in workers}
    jpeg = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(64)
    status, d = chat(jpeg, "image/jpeg")
    if status != 400 or "bad image: JPEG images are not read" not in d.get(
            "error", {}).get("message", json.dumps(d)):
        raise AssertionError(f"[o4] a JPEG: {status} {d}")
    lines = [ln for ln in launcher_log.read_text(errors="replace").splitlines()
             if "encoded 1 image(s)" in ln]
    if len(lines) < 2:
        raise AssertionError("[o4] the encode worker logged no encode")
    worker_ms = [(float(ln.split("decode+resize ")[1].split(" ms")[0]),
                  float(ln.split("device ")[1].split(" ms")[0])) for ln in lines]
    # the encoder in this process on the card against the CPU
    cfg = VisionConfig(num_image_tokens=O_ENCODER["imageTokens"],
                       lm_hidden_size=O_ENCODER["lmHidden"], image_size=O_ENCODER["imageSize"])
    card = VisionEncoder(cfg, device=device)
    got = card.encode([png])
    got = card.encode([png])        # the second call's timing: no first-use cost
    timing = dict(card.last_timing)
    ref = VisionEncoder(cfg, device="cpu").encode([png])
    err = float(np.abs(got - ref).max())
    limit = O_ENC_TOL[0] * float(np.abs(ref).max()) + O_ENC_TOL[1]
    del card
    res = {"png_bytes": len(png), "image": list(O_IMAGE), "resized": O_ENCODER["imageSize"],
           "prompt_tokens": answers[0][2]["prompt_tokens"], "answers_equal": True,
           "answer": answers[0][0], "repeat_lp_max_diff": lp_diff, "prefix_hit_blocks": hits,
           "jpeg_status": status, "worker_decode_resize_ms": [a for a, _ in worker_ms],
           "worker_device_ms": [b for _, b in worker_ms],
           "in_process_decode_resize_ms": timing["decode_ms"],
           "in_process_device_ms": timing["device_ms"], "card_vs_cpu_max_abs_err": err,
           "card_vs_cpu_limit": limit,
           "workers": o_launches("[o4]", s0, s1, workers, device)}
    log("[o4] " + json.dumps(res) + f" on {smi}")
    if answers[0][2]["prompt_tokens"] < O_ENCODER["imageTokens"]:
        raise AssertionError(f"[o4] the prompt holds {answers[0][2]} tokens, fewer than the "
                             f"image's {O_ENCODER['imageTokens']} rows")
    if not err <= limit:
        raise AssertionError(f"[o4] the encoder on {device} is {err} from the CPU's "
                             f"(limit {limit})")
    return res


def o_pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:      # a zombie has exited
        return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except OSError:
        return False


def phase_gguf_recipe(smi: str, device: str = "cuda") -> dict:
    """(o): see the module docstring."""
    import shutil
    import signal
    import tempfile

    from dynamo_tpu_torch.models.config import resolve_model_config
    from dynamo_tpu_torch.router.indexer import RadixIndexer
    from dynamo_tpu_torch.tokenizer import load_tokenizer
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_tokens
    from dynamo_tpu_torch.utils.recorder import load_router_events

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="o-gguf-"))
    out: dict = {"smi": smi}
    launcher = None
    pids: list[int] = []
    try:
        gguf_path = tmp / f"{O_SERVED}.gguf"
        ref, out["o0"] = write_gguf(gguf_path, device)
        out["o1"] = o_loader(gguf_path, ref, device)
        del ref
        free_engine()
        audit_memory("(o1)")

        # (o2) the recipe, brought up by the launcher
        tok = o_tokenizer(tmp, resolve_model_config(O_MODEL).vocab_size)
        coord_port, http_port = free_port(), free_port()
        recipe = o_recipe(tmp, gguf_path, tok, coord_port, http_port)
        log_path = tmp / "recipe-up.log"
        env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1",
               "DYN_LOG": "info"}
        t_up = time.perf_counter()
        with open(log_path, "w") as f:
            launcher = subprocess.Popen(
                [sys.executable, "-u", "-m", "dynamo_tpu_torch.launch.recipe", "up",
                 str(recipe), "--start-timeout", "600",
                 *(["--device", device] if device != "cuda" else [])],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 660
        while not pids:
            line = next((ln for ln in log_path.read_text(errors="replace").splitlines()
                         if "RECIPE_UP" in ln), None)
            if line:
                pids = [int(x) for x in line.split("pids=", 1)[1].split()]
            elif launcher.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"[o2] recipe up failed (rc {launcher.poll()}):\n"
                                     + log_path.read_text(errors="replace")[-4000:])
            else:
                time.sleep(0.2)
        deadline = time.monotonic() + 60
        while not k_stats(http_port, O_SERVED).get("instances"):
            if time.monotonic() > deadline:
                raise AssertionError("[o2] the frontend never discovered the worker")
            time.sleep(0.2)
        out["o2"] = {"processes": len(pids), "up_s": time.perf_counter() - t_up}
        log("[o2] " + json.dumps(out["o2"]))

        # (o3) KServe v2, with (o5)'s recorder on the worker's KV events
        rec_path = tmp / "kv-events.jsonl"
        rec = RecorderThread(f"tcp://127.0.0.1:{coord_port}", "kv_events.dynamo.backend",
                             rec_path)
        try:
            out["o3"] = o_kserve(http_port, device, smi)
        finally:
            time.sleep(0.5)      # the last step's events
            recorded = rec.stop()
        # (o5) the recording replayed into the router's indexer
        events = load_router_events(str(rec_path))
        idx = RadixIndexer()
        for e in events:
            idx.apply_event(e)
        ids = load_tokenizer(str(tok)).encode(O_PROMPT, add_bos=True)
        hashes = compute_block_hashes_for_tokens(ids, O_ENGINE["blockSize"])
        scores = idx.find_matches(hashes).scores
        out["o5"] = {"recorded": recorded, "events": len(events),
                     "prompt_blocks": len(hashes), "matched": scores}
        log("[o5] " + json.dumps({**out["o5"], "matched": {str(k): v for k, v in
                                                          scores.items()}}))
        if not hashes or sorted(scores.values()) != [len(hashes)]:
            raise AssertionError(f"[o5] the replayed index matched {scores} of the prompt's "
                                 f"{len(hashes)} full blocks")

        out["o4"] = o_images(http_port, log_path, device, smi)

        # one SIGINT stops every child
        launcher.send_signal(signal.SIGINT)
        rc = launcher.wait(120)
        time.sleep(0.5)
        left = [p for p in pids if o_pid_alive(p)]
        out["shutdown"] = {"rc": rc, "children_left": left}
        log("[o2] after SIGINT: " + json.dumps(out["shutdown"]))
        if rc != 0 or left:
            raise AssertionError(f"[o2] recipe up exited {rc}, children left {left}:\n"
                                 + log_path.read_text(errors="replace")[-3000:])
    finally:
        if launcher is not None and launcher.poll() is None:
            launcher.send_signal(signal.SIGINT)     # the launcher stops its children
            try:
                launcher.wait(120)
            except subprocess.TimeoutExpired:
                launcher.kill()
                launcher.wait(30)
        for pid in pids:
            if o_pid_alive(pid):
                os.kill(pid, signal.SIGKILL)
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[o] passed in {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# (p) tensor-parallel engines at parity with one rank
# ---------------------------------------------------------------------------

#: (p)'s in-process engines: llama-3-8b-lite's widths with f32 weights over
#: the f32 cache, cut to P_LAYERS layers (four ranks of (p4) each draw the
#: whole tree before keeping their shard)
P_LAYERS = 2
P_MODEL = "llama-3-8b-lite-f32-p"
#: (p1): two working sets of 16 greedy requests (512-token prompts, 32
#: tokens) over a pool that holds one; sessions 8 x (256 + 32), then a turn
#: of 64 new tokens + 32; checkpoints: 4 greedy streams of 256 + 48, cut at 20
P_SET, P_SET_PROMPT, P_SET_DECODE = 16, 512, 32
P_SES, P_SES_PROMPT, P_SES_NEW, P_SES_DECODE = 8, 256, 64, 32
P_CKPT, P_CKPT_PROMPT, P_CKPT_DECODE, P_CKPT_CUT = 4, 256, 48, 20
#: (p2), (p4): 32 x (128 + 32) greedy; (p3): 8 x (128 + 32)
P_BATCH, P_PROMPT, P_DECODE, P_DISAGG = 32, 128, 32, 8
#: the pool holds one working set (a block of slack a request, and the trash block)
P_BLOCKS = P_SET * (-(-(P_SET_PROMPT + P_SET_DECODE) // 16) + 1) + 1
P_HOST_BLOCKS = 3 * P_BLOCKS
P_MAX_LEN = P_SET_PROMPT + P_SET_DECODE + 16
#: (p3)'s staging TTL: a streamed transfer's TTL runs from its registration
#: (as in the JAX package), so it must outlast a prefill, and an eager
#: tp=2 prefill over gloo takes seconds ((h1)'s TTFT of 32 x 128: 4.9 s);
#: (l)'s 4 s expired one of 8 transfers mid-prefill in an H100 run
P3_TTL_S = 10.0
#: exported blocks of tp=2 against tp=1's: |x - ref| <= 1e-4 max|ref| + 1e-5
P_EXPORT_TOL = (1e-4, 1e-5)


def register_p_model() -> str:
    """Register (p)'s model as a preset of its own; returns its name."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS

    MODEL_PRESETS[P_MODEL] = dataclasses.replace(
        MODEL_PRESETS["llama-3-8b-lite"], dtype="float32", num_layers=P_LAYERS, name=P_MODEL)
    return P_MODEL


def p_engine(device: str, tp: int = 1, dp: int = 1, **kw):
    """A (p) engine of ``dp`` x ``tp`` ranks (on one card over gloo, eager
    steps; lazily captured graphs at one rank), random weights from seed 0."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.utils.config import EngineConfig

    ranks = tp * dp
    cfg = dict(model=P_MODEL, block_size=16, max_batch_size=32, num_blocks=P_BLOCKS,
               max_model_len=P_MAX_LEN, prefill_chunk=512, allow_random_weights=True,
               warmup_mode="off", tp=tp, dp=dp, dist_backend="gloo",
               tp_devices=(0,) * ranks if ranks > 1 and device != "cpu" else ())
    cfg.update(kw)
    return build_engine(EngineConfig(**cfg), device=device)


def p_rank_check(tag: str, ranks: list[dict], route: str, layers: int) -> list[dict]:
    """Every rank launched ``route`` only, ``layers`` a forward step, and
    all ran the same forward steps; returns each rank's numbers."""
    steps = {r["forward_steps"] for r in ranks}
    out = []
    for r in ranks:
        want = {k: layers * r["forward_steps"] if k == route else 0
                for k in r["launches_by_kernel"]}
        if r["launches_by_kernel"] != want or r["forward_steps"] <= 0:
            raise AssertionError(f"{tag}: rank {r['rank']} launched {r['launches_by_kernel']} "
                                 f"in {r['forward_steps']} forward steps; expected {layers} "
                                 f"of {route} a step")
        out.append({"rank": r["rank"], "data_rank": r["data_rank"],
                    "launches": r["launches_by_kernel"][route],
                    "forward_steps": r["forward_steps"], "collectives": r["collectives"],
                    "collective_ms": 1e3 * r["collective_s"],
                    "block_moves": r["block_moves"], "block_bytes": r["block_bytes"],
                    "block_ms": 1e3 * r["block_s"],
                    "peak_mem_gib": r["max_memory_allocated"] / 2**30})
    if len(steps) != 1:
        raise AssertionError(f"{tag}: the ranks ran {steps} forward steps")
    return out


async def p_serve(engine, reqs: dict, tag: str, route: str) -> dict:
    """``serve_on`` (the leader's launches through its steps), and at more
    than one rank every rank's launches, counts set to 0 just before."""
    core = engine.core
    multi = core.runner.tp is not None
    if multi:
        await engine.run_in_core(lambda c: c.reset_tp_stats())
    res = await serve_on(engine, reqs, route, tag)
    if multi:
        ranks = await engine.run_in_core(lambda c: c.tp_stats())
        res["ranks"] = p_rank_check(tag, ranks, route, core.model_cfg.num_layers)
    return res


def p_pairs(r: dict) -> dict:
    return {i: (r["streams"][i], r["lps"][i]) for i in r["streams"]}


def p_same(tag: str, got: dict, ref: dict) -> dict:
    """``compare_streams``; fails on a stream that leaves ``ref`` at no
    near-tie."""
    equal, ties, bad = compare_streams(tag, p_pairs(got), p_pairs(ref))
    if bad:
        raise AssertionError(f"{tag}: streams leave the reference at no near-tie: {bad[:4]}")
    return {"equal": equal, "near_ties": len(ties)}


async def p1_traffic(engine, tag: str, route: str, sets: dict, ses: tuple,
                     batch: list) -> dict:
    """(p1)'s traffic on one engine: sets A, B, A; the export of A's
    chains; two session turns; (p2)'s batch."""
    from dynamo_tpu_torch.engine.session import get_session_metrics

    core = engine.core
    out: dict = {}
    for name in ("a1", "b", "a2"):
        on0 = core.kvbm.stats.onboarded_blocks
        out[name] = await p_serve(engine, kv_reqs(sets[name[0]], f"{tag}-{name}",
                                                  P_SET_DECODE), f"[p1] {tag} {name}", route)
        out[name]["onboarded"] = core.kvbm.stats.onboarded_blocks - on0
    t0 = time.perf_counter()
    out["export"] = await engine.run_in_core(
        lambda c: [c.export_blocks(ch) for ch in chains(sets["a"])])
    out["export_s"] = time.perf_counter() - t0
    sm = get_session_metrics()
    out["t1"] = await p_serve(engine, kv_reqs(ses[0], f"{tag}-t1", P_SES_DECODE,
                                              sessions=True), f"[p1] {tag} turn 1", route)
    p2 = [p + out["t1"]["streams"][i] + ses[1][i] for i, p in enumerate(ses[0])]
    pre, avoided0 = core.metrics.num_prefill_tokens, sm.avoided_tokens.get()
    out["t2"] = await p_serve(engine, kv_reqs(p2, f"{tag}-t2", P_SES_DECODE, sessions=True),
                              f"[p1] {tag} turn 2", route)
    out["t2_prefill"] = core.metrics.num_prefill_tokens - pre
    out["t2_avoided"] = sm.avoided_tokens.get() - avoided0
    out["t2_prompt_tokens"] = sum(len(p) for p in p2)
    await engine.run_in_core(lambda c: c.sessions.release_all())
    out["batch"] = await p_serve(engine, kv_reqs(batch, f"{tag}-p2", P_DECODE),
                                 f"[p2] {tag} W=1", route)
    out["transfer"] = core.transfer.stats.snapshot()
    return out


def p_export_check(tag: str, got: list, ref: list) -> dict:
    """tp=2's exported chains against tp=1's: the same hashes, whole
    blocks of tp=1's shape, within P_EXPORT_TOL."""
    rel, abs_ = P_EXPORT_TOL
    worst, n = 0.0, 0
    for g_chain, r_chain in zip(got, ref, strict=True):
        if [(h, p) for h, p, _ in g_chain] != [(h, p) for h, p, _ in r_chain]:
            raise AssertionError(f"{tag}: exported chains differ in hashes")
        for (_, _, g), (_, _, r) in zip(g_chain, r_chain):
            if g.shape != r.shape or g.dtype != r.dtype:
                raise AssertionError(f"{tag}: block {g.shape} {g.dtype} against {r.shape} "
                                     f"{r.dtype}")
            limit = rel * float(np.abs(r).max()) + abs_
            worst = max(worst, float(np.abs(g - r).max()) / limit)
            n += 1
    if worst > 1.0 or n == 0:
        raise AssertionError(f"{tag}: exported blocks {worst} of their limit ({n} blocks)")
    return {"blocks": n, "err_over_limit": worst}


def p_data_rows(bw: float, peak: float, device: str = "cuda") -> dict:
    """The per-rank launch on the data axis at the main decode shape:
    ``paged_attention_sharded`` at dp = tp = 2 on every route, each rank's
    launch on its 16 rows and its heads. At the unsharded launch's split
    count it equals that launch bit for bit; at the ranks' own it keeps
    the route's limit against the plain version; 4 launches a call. Times
    rank (0, 0)'s launch, its bound and SDPA on its rows."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    lens = torch.randint(128, 193, (32,), generator=gen, device=device).tolist()
    q32, k32, v32, bt, qs, kl = attention_case(gen, 32, 1, 16, [n - 1 for n in lens], [1] * 32)
    k, v = k32.bfloat16(), v32.bfloat16()
    out: dict = {}
    for kind in KV_DTYPES:
        kq, vq = (None, None) if kind == "float" else (quantize(k, kind), quantize(v, kind))
        for q_dtype in Q_DTYPES:
            q = q32.to(q_dtype)
            kc, vc = (((k32, v32) if q_dtype == torch.float32 else (k, v))
                      if kind == "float" else (kq, vq))
            route = pa.ROUTES[(q_dtype, kind)]
            kv_heads = (kc if kind == "float" else kc["q"]).shape[2]
            ns = pa.num_splits_for(q, kv_heads, bt.shape[1], 0, kind)
            whole = pa.paged_attention(q, kc, vc, bt, qs, kl, num_splits=ns)
            ref = plain_by_rows(pa, q, kc, vc, bt, qs, kl, num_splits=ns).float()
            rel, abs_ = err_limit(q_dtype)
            pa.reset_launches()
            forced = pa.paged_attention_sharded(q, kc, vc, bt, qs, kl, tp=2, dp=2,
                                                num_splits=ns)
            auto = pa.paged_attention_sharded(q, kc, vc, bt, qs, kl, tp=2, dp=2)
            torch.cuda.synchronize()
            launches = dict(pa.paged_attention.launches_by_kernel)
            diff = (auto.float() - ref).abs()
            ratio = (diff / (rel * ref.abs() + abs_)).max().item()
            rows = slice(0, 16)
            largs = (q[rows].chunk(2, dim=2)[0].contiguous(), pa.shard_heads(kc, 0, 2),
                     pa.shard_heads(vc, 0, 2), bt[rows].contiguous(), qs[rows].contiguous(),
                     kl[rows].contiguous())
            ns_rank = pa.num_splits_for(largs[0], kv_heads // 2, bt.shape[1], 0, kind)
            nbytes, ops = attention_work(*largs[:2], *largs[3:])
            ops_s = (ops / peak if q_dtype == torch.bfloat16
                     else min(ops / CARD_PEAK_F32, ops * F32_MMAS[kind] / peak))
            bytes_ms, ops_ms = nbytes / bw * 1e3, ops_s * 1e3
            row = {"launches": launches[route], "bitwise_at_equal_splits":
                   torch.equal(forced, whole), "max_abs_err": diff.max().item(),
                   "err_over_limit": ratio, "ms": time_ms(lambda: pa.paged_attention(*largs)),
                   "plain_ms": time_ms(lambda: plain_by_rows(pa, *largs, num_splits=ns_rank)),
                   "library_ms": time_ms(library_fn(*largs)),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            out[route] = row
            log(f"[p0] paged_attention_sharded dp=2 tp=2 {route} {MAIN_CASE}: "
                + json.dumps(row))
            want = {r: (8 if r == route else 0) for r in pa.ROUTE_KERNELS}
            if launches != want or not row["bitwise_at_equal_splits"] or not ratio <= 1.0:
                raise AssertionError(f"[p0] data-axis launch {route}: launches {launches} "
                                     f"(want {want}), {row}")
            del forced, auto, whole, ref, diff
        del kq, vq
    torch.cuda.empty_cache()
    return out


def p_disagg(smi: str, f32_ref: dict, device: str = "cuda") -> dict:
    """(p3): a coordinator, a frontend, a ``--tp 2 --disagg prefill``
    worker (two ranks on the card over gloo, eager steps) and a ``--disagg
    decode`` worker at tp=1, f32 llama-3-8b-lite (8 layers) with (l1)'s
    settings but lazy capture and a staging TTL of P3_TTL_S; 8 x (128 +
    32) through the frontend equal ``f32_ref`` (in-process f32 streams, or
    first differ at a near-tie),
    every prefill remote (its 7 whole blocks gathered from both ranks),
    and no staging pin left after the TTL; both workers drain to exit 0."""
    import tempfile

    from dynamo_tpu_torch.models.config import resolve_model_config
    from dynamo_tpu_torch.ops.paged_attention import ROUTES

    cfg = resolve_model_config(K_MODEL)
    layers, vocab = cfg.num_layers, cfg.vocab_size
    route = ROUTES[(torch.float32, "float")]
    block_bytes = 2 * layers * 16 * cfg.num_kv_heads * cfg.head_dim * 4
    tmp = Path(tempfile.mkdtemp(prefix="p-disagg-"))
    tok = k_tokenizer(tmp, vocab)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1",
           "DYN_LEASE_TTL_S": str(K_TTL_S), "DYN_LOG": "info"}
    cl = KCluster(tmp, env)
    out: dict = {"smi": smi}
    t_phase = time.perf_counter()
    try:
        coord_port, http_port = free_port(), free_port()
        status = {name: free_port() for name in ("p", "d")}
        cl.start("coordinator", "dynamo_tpu_torch.transports.coordinator",
                 ["--host", "127.0.0.1", "--port", str(coord_port)])
        cl.wait_line("coordinator", "COORDINATOR_READY", 60)
        url = f"tcp://127.0.0.1:{coord_port}"
        max_len = K_PROMPT + P_DECODE + 16
        tp_args = ["--tp", "2", "--dist-backend", "gloo",
                   *(["--tp-devices", "0,0"] if device != "cpu" else [])]
        roles = {
            "p": ("p3prefill", ["--dtype", "float32", "--disagg", "prefill",
                                "--kv-transfer-ttl", str(P3_TTL_S), "--warmup-mode", "off",
                                *tp_args]),
            "d": ("p3", ["--dtype", "float32", "--disagg", "decode", "--warmup-mode", "lazy",
                         "--prefill-endpoint", "dyn://dynamo.p3prefill.generate"]),
        }
        for name, (component, extra) in roles.items():
            cl.start(name, "dynamo_tpu_torch.components.worker", k_worker_args(
                url, component, K_F32_NAME, 256, max_len, tok, device, extra),
                env={"DYN_SYSTEM_ENABLED": "true", "DYN_SYSTEM_PORT": str(status[name])})
        cl.start("frontend", "dynamo_tpu_torch.components.frontend",
                 ["--coordinator", url, "--host", "127.0.0.1", "--port", str(http_port),
                  "--router-mode", "kv"])
        cl.wait_line("frontend", "FRONTEND_READY", 120)
        ids = {name: cl.wait_line(name, "WORKER_READY", 600).split("instance=")[1]
               .strip().lstrip("0") for name in roles}
        deadline = time.monotonic() + 60
        while True:
            st = k_get(http_port, "/engine_stats").get(K_F32_NAME, {})
            if (st.get("instances", []) == [ids["d"]] and ids["d"] in st.get("workers", {})
                    and l_health(status["d"])["disagg"]["prefill_instances"] == 1):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"[p3] the decode worker or its prefill router did not "
                                     f"discover its peers: {st}")
            time.sleep(0.2)
        out["startup_s"] = time.perf_counter() - t_phase
        log(f"[p3] coordinator, frontend, a tp=2 prefill worker and a tp=1 decode worker "
            f"up in {out['startup_s']:.1f}s")
        s0 = {n: l_idle(status[n], "[p3]") for n in roles}
        prompts = k_prompts(vocab)[:P_DISAGG]
        t0 = time.perf_counter()
        got = k_batch(http_port, K_F32_NAME, prompts, P_DECODE)
        out["wall_s_traffic"] = time.perf_counter() - t0
        s1 = {n: l_idle(status[n], "[p3]") for n in roles}
        ref = {i: (f32_ref[i][0][:P_DECODE], f32_ref[i][1][:P_DECODE]) for i in range(P_DISAGG)}
        res = k_compare("[p3] f32 through a tp=2 prefill and a tp=1 decode worker", got, ref)
        blocks = P_DISAGG * ((K_PROMPT - 1) // 16)
        res.update({
            "remote_prefills": l_delta(s1["d"], s0["d"], "disagg", "remote_prefills"),
            "local_fallbacks": l_delta(s1["d"], s0["d"], "disagg", "local_fallbacks"),
            "pulled_blocks": l_delta(s1["d"], s0["d"], "kv_transfer", "pull", "blocks"),
            "staged_blocks": l_delta(s1["p"], s0["p"], "kv_transfer", "extract_blocks"),
            "staged_bytes": l_delta(s1["p"], s0["p"], "kv_transfer", "extract_bytes"),
            "gather_bytes": l_delta(s1["p"], s0["p"], "kv_transfer", "gather_bytes"),
            "gather_s": l_delta(s1["p"], s0["p"], "kv_transfer", "gather_s"),
            "workers": k_launches("[p3]", {"workers": s0}, {"workers": s1}, list(roles),
                                  route, layers)})
        want = {"remote_prefills": P_DISAGG, "local_fallbacks": 0, "pulled_blocks": blocks,
                "staged_blocks": blocks, "staged_bytes": blocks * block_bytes}
        if {key: res[key] for key in want} != want or res["gather_bytes"] <= 0:
            warned = {n: [ln for ln in cl.log_of(n).splitlines()
                          if " W " in ln or " E " in ln or "Error" in ln][-12:] for n in roles}
            raise AssertionError(f"[p3] handoff counts {res}; expected {want}; the workers' "
                                 f"warnings: {json.dumps(warned, indent=1)}")
        out["p3"] = res
        log("[p3] " + json.dumps(res))
        t_last = time.monotonic()
        deadline = t_last + P3_TTL_S + 10
        while True:
            left = l_health(status["p"])
            pins = left["kv_transfer"]["staged_pins"]
            if pins == 0 and not left["mem"]["device_blocks"].get("staging") \
                    and time.monotonic() - t_last >= P3_TTL_S:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"[p3] staging pins {pins} after the TTL")
            time.sleep(0.2)
        out["staged_pins_after_ttl"] = pins
        for name in ("d", "p"):
            rc = cl.terminate(name, 120)
            line = [ln for ln in cl.log_of(name).splitlines() if "WORKER_DRAINED" in ln]
            if rc != 0 or not line:
                raise AssertionError(f"[p3] {name} exited {rc} without a drain report:\n"
                                     f"{cl.log_of(name)[-3000:]}")
    finally:
        cl.stop_all()
    left = [n for n, (p, _) in cl.procs.items() if p.poll() is None]
    if left:
        raise AssertionError(f"[p3] processes left over: {left}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[p3] passed in {out['wall_s']:.1f}s")
    return out


def phase_parity(smi: str, f32_ref: dict, bw: float, peak: float,
                 device: str = "cuda") -> dict:
    """(p): see the module docstring. ``f32_ref`` is (b'')'s in-process f32
    streams of (k)'s prompts, (p3)'s reference."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    model = register_p_model()
    route = pa.ROUTES[(torch.float32, "float")]
    vocab = MODEL_PRESETS[model].vocab_size
    res: dict = {"model": model, "layers": P_LAYERS}
    if device != "cpu":
        res["p0"] = p_data_rows(bw, peak, device)
    sets = {"a": kv_prompts(51, P_SET, P_SET_PROMPT, vocab),
            "b": kv_prompts(52, P_SET, P_SET_PROMPT, vocab)}
    ses = (kv_prompts(53, P_SES, P_SES_PROMPT, vocab),
           kv_prompts(54, P_SES, P_SES_NEW, vocab))
    batch = kv_prompts(55, P_BATCH, P_PROMPT, vocab)
    ckpt = kv_prompts(56, P_CKPT, P_CKPT_PROMPT, vocab)
    tier = dict(host_kv_blocks=P_HOST_BLOCKS, session_ttl=600.0)
    store = StoreThread()
    try:
        # (p1) the tp=1 reference, then tp=2 with the same tier, sessions
        # and, on the store, checkpoints and the global prefix cache
        async def reference():
            engine = p_engine(device, **tier)
            try:
                out = await p1_traffic(engine, "tp1", route, sets, ses, batch)
                out["ckpt"] = await p_serve(engine, kv_reqs(ckpt, "ckpt", P_CKPT_DECODE),
                                            "[p1] tp1 checkpoint reference", route)
                return out
            finally:
                await engine.shutdown()

        t0 = time.perf_counter()
        one = asyncio.run(reference())
        free_engine()
        res["tp1_s"] = time.perf_counter() - t0

        async def tp2():
            t0 = time.perf_counter()
            engine = p_engine(device, tp=2, remote_kv_addr=store.addr, stream_ckpt_blocks=1,
                              global_prefix_cache=True, **tier)
            setup = time.perf_counter() - t0
            try:
                out = await p1_traffic(engine, "tp2", route, sets, ses, batch)
            except BaseException:
                await engine.shutdown()
                raise
            out["setup_s"] = setup
            out["published"] = engine.core.kvbm.stats.published_blocks
            got = {i: [] for i in range(P_CKPT)}
            enough = asyncio.Event()

            async def stream(i, r):
                async for o in engine.generate(r):
                    got[i] += o.token_ids
                    if all(len(v) >= P_CKPT_CUT for v in got.values()):
                        enough.set()

            reqs = kv_reqs(ckpt, "ckpt", P_CKPT_DECODE)
            tasks = [asyncio.ensure_future(stream(i, r)) for i, r in reqs.items()]
            try:
                await asyncio.wait_for(enough.wait(), 300)
            finally:
                await engine.shutdown()     # the worker dies: nothing reaps the records
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            out["cut"] = got
            return out

        t0 = time.perf_counter()
        two = asyncio.run(tp2())
        free_engine()
        res["tp2_s"] = time.perf_counter() - t0
        p1: dict = {}
        for name in ("a1", "b", "a2", "t1"):
            p1[name] = p_same(f"[p1] {name} tp=2 against tp=1", two[name], one[name])
        # turn 2's prompts carry turn 1's streams: held where those agree
        same_t1 = [i for i in one["t1"]["streams"]
                   if one["t1"]["streams"][i] == two["t1"]["streams"][i]]
        p1["t2"] = p_same("[p1] t2 tp=2 against tp=1", *(
            {key: {i: r[key][i] for i in same_t1} for key in ("streams", "lps")}
            for r in (two["t2"], one["t2"])))
        p1["t2"]["rows"] = len(same_t1)
        p1["onboarded"] = {"tp1": one["a2"]["onboarded"], "tp2": two["a2"]["onboarded"]}
        p1["export"] = p_export_check("[p1] tp=2's export against tp=1's", two["export"],
                                      one["export"])
        p1["export_s"] = two["export_s"]
        p1["t2"].update(prefill=two["t2_prefill"], avoided=two["t2_avoided"],
                        prompt_tokens=two["t2_prompt_tokens"])
        p1["ranks_a2"] = two["a2"]["ranks"]
        p1["transfer"] = two["transfer"]
        p1["published"] = two["published"]
        if not (two["a2"]["onboarded"] > 0 and two["t2_avoided"] >= P_SES * P_SES_PROMPT
                and two["t2_prefill"] <= two["t2_prompt_tokens"] - P_SES * P_SES_PROMPT
                and two["published"] > 0):
            raise AssertionError(f"[p1] tiers or sessions at tp=2: {p1}")

        # tp=2's blocks into a tp=1 engine; the records resumed at tp=1
        async def importer():
            engine = p_engine(device)
            try:
                n = await engine.run_in_core(lambda c: sum(c.import_blocks(ch)
                                                           for ch in two["export"]))
                pre = engine.core.metrics.num_prefill_tokens
                r = await p_serve(engine, kv_reqs(sets["a"], "imp", P_SET_DECODE),
                                  "[p1] tp=1 after importing tp=2's blocks", route)
                return n, engine.core.metrics.num_prefill_tokens - pre, r
            finally:
                await engine.shutdown()

        n, prefill, imp = asyncio.run(importer())
        free_engine()
        p1["import"] = {"blocks": n, "prefill_tokens": prefill,
                        **p_same("[p1] tp=1 importing tp=2's blocks against tp=1", imp,
                                 one["a2"])}
        if n != P_SET * (P_SET_PROMPT // 16) or prefill > P_SET * 16:
            raise AssertionError(f"[p1] import of tp=2's blocks: {p1['import']}")

        async def resumed(recs):
            from dynamo_tpu_torch.kvbm.stream_ckpt import CKPT_DRAWS_KEY, CKPT_GENERATED_KEY

            engine = p_engine(device, remote_kv_addr=store.addr, stream_ckpt_blocks=1)
            try:
                gen = [r["generated"] for r in recs]
                reqs = {}
                for i, g in enumerate(gen):
                    reqs[i] = kv_reqs([ckpt[i] + g], "x", P_CKPT_DECODE - len(g), annotations=[
                        {CKPT_GENERATED_KEY: len(g), CKPT_DRAWS_KEY: recs[i]["draws"]}])[0]
                    reqs[i].request_id = f"ckpt-{i}"
                r = await p_serve(engine, reqs, "[p1] checkpoints resumed at tp=1", route)
                return ({i: gen[i] + r["streams"][i] for i in range(P_CKPT)},
                        engine.core.kvbm.stats.onboarded_blocks,
                        engine.core.metrics.stream_ckpt_resumes)
            finally:
                await engine.shutdown()

        from dynamo_tpu_torch.kvbm.remote import ckpt_client

        client = ckpt_client(store.addr)
        recs = [client.get_stream_ckpt(f"ckpt-{i}") for i in range(P_CKPT)]
        if any(r is None for r in recs):
            raise AssertionError(f"[p1] tp=2 stored no checkpoint record for some of "
                                 f"{P_CKPT} streams: {[r is None for r in recs]}")
        streams, onboarded, resumes = asyncio.run(resumed(recs))
        free_engine()
        gone = [client.get_stream_ckpt(f"ckpt-{i}") is None for i in range(P_CKPT)]
        client.close()
        full = one["ckpt"]["streams"]
        p1["ckpt"] = {"cut_at": [len(two["cut"][i]) for i in range(P_CKPT)],
                      "record_generated": [len(r["generated"]) for r in recs],
                      "onboarded": onboarded, "resumes": resumes, "records_gone": gone,
                      "equal": sum(streams[i] == full[i] for i in range(P_CKPT)),
                      "cut_prefix_equal": all(two["cut"][i] == full[i][: len(two["cut"][i])]
                                              for i in range(P_CKPT))}
        log("[p1] " + json.dumps(p1))
        if not (p1["ckpt"]["equal"] == P_CKPT and p1["ckpt"]["cut_prefix_equal"]
                and all(gone) and onboarded > 0 and resumes == P_CKPT):
            raise AssertionError(f"[p1] checkpoints at tp=2: {p1['ckpt']}")
        res["p1"] = p1
    finally:
        store.close()

    # (p2) fused windows at tp=2 against tp=2's W=1 streams of the batch
    async def run(tag, **kw):
        t0 = time.perf_counter()
        engine = p_engine(device, **kw)
        setup = time.perf_counter() - t0
        try:
            r = await p_serve(engine, kv_reqs(batch, tag, P_DECODE), f"[{tag}]", route)
            r["setup_s"] = setup
            return r
        finally:
            await engine.shutdown()

    t0 = time.perf_counter()
    win = asyncio.run(run("p2", tp=2, decode_window=4))
    free_engine()
    res["p2"] = {**p_same("[p2] tp=2 W=4 against tp=2 W=1", win, two["batch"]),
                 "ranks": win["ranks"], "setup_s": win["setup_s"], "wall_s": win["wall_s"],
                 "seconds": time.perf_counter() - t0}
    log("[p2] " + json.dumps(res["p2"]))
    # (p4) dp inside the engine against tp=1's streams of the batch
    res["p4"] = {}
    for tag, kw in (("dp2", dict(dp=2)), ("dp2_tp2", dict(dp=2, tp=2))):
        t0 = time.perf_counter()
        r = asyncio.run(run(f"p4 {tag}", **kw))
        free_engine()
        res["p4"][tag] = {**p_same(f"[p4] {tag} against tp=1", r, one["batch"]),
                          "ranks": r["ranks"], "setup_s": r["setup_s"],
                          "wall_s": r["wall_s"], "seconds": time.perf_counter() - t0}
        log(f"[p4] {tag} " + json.dumps(res["p4"][tag]))
    res["p3"] = p_disagg(smi, f32_ref, device)
    res["launches_p"] = {
        "p1 tp2 (a2)": sum(r["launches"] for r in res["p1"]["ranks_a2"]),
        "p2 tp2 W=4": sum(r["launches"] for r in res["p2"]["ranks"]),
        **{f"p4 {tag}": sum(r["launches"] for r in v["ranks"])
           for tag, v in res["p4"].items()},
        **{f"p3 {w}": r["launches"] for w, r in res["p3"]["p3"]["workers"].items()}}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[p] passed in {res['seconds']:.1f}s on {smi}: launches of {route} "
        + json.dumps(res["launches_p"]))
    return res


# ---------------------------------------------------------------------------
# (q) MoE across ranks: the expert width over tp, the experts over ep
# ---------------------------------------------------------------------------

#: (q1): gpt-oss-120b's widths with seed-0 f32 weights over the f32 cache,
#: cut to Q1_LAYERS layers; Q1_BATCH greedy requests of Q1_PROMPT + Q1_DECODE
Q1_BASE, Q1_LAYERS, Q1_BATCH, Q1_PROMPT, Q1_DECODE = "gpt-oss-120b", 1, 16, 128, 16
#: (q1)'s meshes: the tp=1 reference, TEP, EP and both (four ranks)
Q1_MESHES = {"tp1": {}, "tp2": dict(tp=2), "ep2": dict(ep=2), "tp2_ep2": dict(tp=2, ep=2)}
#: (q2): (j1)'s cut (gpt-oss-120b, bf16, 4 layers, 32 x (128 + 32)) at ep=2
Q2_EP = 2
#: (q2): each rank's expert bytes against half of (j1)'s, relative
Q2_BYTES_TOL = 0.01


def q_model(base: str, layers: int, dtype: str) -> str:
    """Register ``base`` at ``dtype`` cut to ``layers`` layers as a preset
    of its own; returns its name."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS

    name = f"{base}-{dtype}-{layers}l-q"
    MODEL_PRESETS[name] = dataclasses.replace(MODEL_PRESETS[base], dtype=dtype,
                                              num_layers=layers, name=name)
    return name


def q_engine(device: str, model: str, batch: int, max_len: int, prompt: int, max_rows: int,
             tp: int = 1, ep: int = 1):
    """A (q) engine of ``ep`` x ``tp`` ranks (on one card over gloo, eager
    steps, an explicit pool; lazily captured graphs at one rank), random
    weights from seed 0 (each rank draws only its shard), legacy steps
    whose prefill takes ``prompt``-token chunks, at most ``max_rows``
    token rows a step."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.utils.config import EngineConfig

    ranks = tp * ep
    return build_engine(EngineConfig(
        model=model, block_size=16, max_batch_size=batch, max_model_len=max_len,
        num_blocks=batch * -(-max_len // 16) + 1, prefill_chunk=prompt,
        max_tokens_per_step=max_rows, unified_step=False, allow_random_weights=True,
        warmup_mode="lazy" if ranks == 1 else "off", tp=tp, ep=ep, dist_backend="gloo",
        tp_devices=(0,) * ranks if ranks > 1 and device != "cpu" else ()), device=device)


async def q_serve(device: str, tag: str, model: str, prompts: list, decode: int,
                  max_rows: int, route: str, mesh: dict) -> dict:
    """Build a (q) engine at ``mesh``, serve ``prompts`` once (``p_serve``:
    ``route`` only, a launch a layer and forward step, on every rank),
    and return the streams with the run's numbers: setup s, TTFT, decode
    tok/s, and each rank's heads, experts, expert and weight bytes, peak
    memory and collective ms a forward step."""
    from dynamo_tpu_torch.models.quant import param_bytes

    batch, prompt = len(prompts), len(prompts[0])
    t0 = time.perf_counter()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    engine = q_engine(device, model, batch, prompt + decode + 16, prompt, max_rows, **mesh)
    setup = time.perf_counter() - t0
    try:
        core = engine.core
        r = await p_serve(engine, kv_reqs(prompts, tag, decode), f"[{tag}]", route)
        ranks = (await engine.run_in_core(lambda c: c.tp_stats())
                 if core.runner.tp is not None else None)
        layers = core.runner.params["layers"]
        one = {"rank": 0, "heads": layers["wq"].shape[-1] // core.model_cfg.head_dim,
               "kv_heads": core.runner.spec.num_kv_heads, "launches": r["launches"],
               "local_experts": layers["w_gate"].shape[1],
               "expert_bytes": sum(param_bytes(layers[k]) for k in ("w_gate", "w_up", "w_down")),
               "weight_bytes": param_bytes(core.runner.params),
               "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                                if device != "cpu" else 0.0)}
    finally:
        await engine.shutdown()
    steps = r["forward_steps"]
    if ranks is None:
        per_rank = [one]
    else:
        by_rank = {x["rank"]: x for x in r["ranks"]}
        per_rank = [{"rank": x["rank"], "expert_rank": x["expert_rank"],
                     "model_rank": x["model_rank"], "heads": x["heads"],
                     "kv_heads": x["kv_heads"], "local_experts": x["local_experts"],
                     "expert_bytes": x["expert_bytes"], "weight_bytes": x["weight_bytes"],
                     "peak_mem_gib": x["max_memory_allocated"] / 2**30,
                     "launches": by_rank[x["rank"]]["launches"],
                     "collective_ms_per_step": by_rank[x["rank"]]["collective_ms"] / steps}
                    for x in ranks]
    out = {"mesh": mesh, "setup_s": setup, "ttft_all_s": r["ttft_all_s"],
           "ttft_median_s": r["ttft_median_s"], "wall_s": r["wall_s"],
           "decode_tok_s": batch * (decode - 1) / max(r["wall_s"] - r["ttft_all_s"], 1e-9),
           "forward_steps": steps, "launches": r["launches"], "ranks": per_rank,
           "streams": r["streams"], "lps": r["lps"]}
    log(f"[{tag}] " + json.dumps({k: v for k, v in out.items() if k not in ("streams", "lps")}))
    return out


def q_heads_check(tag: str, run: dict, cfg, tp: int, ep: int) -> None:
    """Each rank attends its model shard's heads (every expert rank the
    same ones) and holds its experts."""
    for r in run["ranks"]:
        want = (cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.num_experts // ep)
        if (r["heads"], r["kv_heads"], r["local_experts"]) != want:
            raise AssertionError(f"{tag}: rank {r['rank']} holds {r['heads']} heads, "
                                 f"{r['kv_heads']} kv heads, {r['local_experts']} experts; "
                                 f"expected {want}")


def phase_moe_parallel(smi: str, j1: dict | None, device: str = "cuda") -> dict:
    """(q): see the module docstring. ``j1`` is (j1)'s result (its expert
    bytes and its speed, printed beside (q2)'s)."""
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    res: dict = {"smi": smi}
    # (q1) f32 streams at four meshes against tp=1's
    model = q_model(Q1_BASE, Q1_LAYERS, "float32")
    cfg = MODEL_PRESETS[model]
    route = pa.ROUTES[(torch.float32, "float")]
    prompts = kv_prompts(61, Q1_BATCH, Q1_PROMPT, cfg.vocab_size)
    runs = {}
    for tag, mesh in Q1_MESHES.items():
        t0 = time.perf_counter()
        runs[tag] = asyncio.run(q_serve(device, f"q1 {tag}", model, prompts, Q1_DECODE,
                                        Q1_BATCH * Q1_PROMPT, route, mesh))
        free_engine()
        audit_memory(f"(q1) {tag}")
        q_heads_check(f"[q1] {tag}", runs[tag], cfg, mesh.get("tp", 1), mesh.get("ep", 1))
        runs[tag]["seconds"] = time.perf_counter() - t0
    q1 = {}
    for tag, run in runs.items():
        q1[tag] = {k: v for k, v in run.items() if k not in ("streams", "lps")}
        if tag != "tp1":
            q1[tag].update(p_same(f"[q1] {tag} against tp=1", run, runs["tp1"]))
    res["q1"] = q1
    log("[q1] " + json.dumps(q1))
    # (q2) bf16 at (j1)'s cut, ep=2: half of (j1)'s expert bytes a rank
    base, layers, batch, prompt, decode, max_rows = MOE_RUNS["j1"]
    model = q_model(base, layers, "bfloat16")
    cfg = MODEL_PRESETS[model]
    route = pa.ROUTES[(torch.bfloat16, "float")]
    t0 = time.perf_counter()
    run = asyncio.run(q_serve(device, "q2 ep2", model,
                              kv_prompts(62, batch, prompt, cfg.vocab_size), decode, max_rows,
                              route, dict(ep=Q2_EP)))
    free_engine()
    audit_memory("(q2)")
    q_heads_check("[q2] ep2", run, cfg, 1, Q2_EP)
    for r in run["streams"].values():
        if len(r) != decode or not all(0 <= t < cfg.vocab_size for t in r):
            raise AssertionError(f"[q2] a stream of {len(r)} tokens, expected {decode}")
    q2 = {k: v for k, v in run.items() if k not in ("streams", "lps")}
    q2["seconds"] = time.perf_counter() - t0
    if j1 is not None:
        q2["j1"] = {k: j1.get(k) for k in ("decode_tok_s", "ttft_all_s", "ttft_p50_s",
                                           "weight_bytes", "expert_bytes", "peak_mem_gib")}
        half = j1["expert_bytes"] / Q2_EP
        q2["expert_bytes_over_half_j1"] = [r["expert_bytes"] / half for r in run["ranks"]]
        if any(abs(x - 1) > Q2_BYTES_TOL for x in q2["expert_bytes_over_half_j1"]):
            raise AssertionError(f"[q2] expert bytes a rank {q2['expert_bytes_over_half_j1']} "
                                 f"of half (j1)'s, beyond {Q2_BYTES_TOL}")
    res["q2"] = q2
    log("[q2] " + json.dumps(q2))
    # every rank's launches of the route, summed
    res["launches_q"] = {f"q1 {tag}": sum(r["launches"] for r in run["ranks"])
                         for tag, run in q1.items()}
    res["launches_q2"] = sum(r["launches"] for r in q2["ranks"])
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[q] passed in {res['seconds']:.1f}s on {smi}")
    return res


# ---------------------------------------------------------------------------
# (r) pipeline parallelism: the layers and their cache over stages
# ---------------------------------------------------------------------------

#: (r): pipeline stages; (r1)'s pool holds one working set of (b'')'s 32 x
#: (128 + 32) (a block of slack a request, and the trash block), its host
#: tier every block the fillers evict; fillers: 32 prompts of 160 tokens
#: (11 blocks with their one token: together the whole pool), then the
#: first R1_AGAIN prompts again
R_PP = 2
R1_BLOCKS = 32 * 11 + 1
R1_HOST_BLOCKS = 512
R1_FILLER_PROMPT, R1_AGAIN = 160, 16
#: (r2): llama-3-8b-lite cut to R2_LAYERS layers, bf16 weights over the
#: int8 cache, dp=2 x pp=2 against dp=2 x pp=1; R2_BATCH x (R2_PROMPT +
#: R2_DECODE), the prompts prefilled in one step
R2_LAYERS, R2_BATCH, R2_PROMPT, R2_DECODE = 2, 16, 128, 16
#: (r2): the first decode step's logits against pp=1's, within this share
#: of the largest logit (the bf16 forward's limit, tests/test_torch_moe.py)
R2_LOGIT_TOL = 2e-2


def r_engine(device: str, model: str, batch: int, max_len: int, num_blocks: int,
             pp: int = R_PP, dp: int = 1, **kw):
    """An (r) engine of ``dp`` x ``pp`` ranks, all on one card over gloo
    (eager steps), random weights from seed 0 (each stage draws only its
    layers), prompts prefilled in chunks of 128."""
    from dynamo_tpu_torch.engine.engine import build_engine
    from dynamo_tpu_torch.utils.config import EngineConfig

    ranks = dp * pp
    if device != "cpu":     # the leader's peak is its own engine's
        torch.cuda.reset_peak_memory_stats()
    return build_engine(EngineConfig(
        model=model, block_size=16, max_batch_size=batch, max_model_len=max_len,
        num_blocks=num_blocks, prefill_chunk=128, allow_random_weights=True,
        warmup_mode="off", pp=pp, dp=dp, dist_backend="gloo",
        tp_devices=(0,) * ranks if device != "cpu" else (), **kw), device=device)


def r_layer_bytes(cfg) -> int:
    """The bytes of every stacked layer leaf of a dense model (norms
    included) at its dtype."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    per_layer = 2 * h * cfg.q_size + 2 * h * cfg.kv_size + 3 * h * i + 2 * h
    return cfg.num_layers * per_layer * torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()


def r_rank_check(tag: str, core, ranks: list[dict], route: str) -> list[dict]:
    """Every rank launched ``route`` only, a launch a layer of its stage
    and microbatch of its programs' schedule (``schedule_launches``), ran
    that many microbatches (none at pp = 1), holds its stage's layers and
    its share of a block's cache bytes; all ran the same forward steps.
    Returns each rank's numbers."""
    from dynamo_tpu_torch.engine.cache import KVCacheSpec
    from dynamo_tpu_torch.models.llama import pp_microbatch_count

    cfg, ec = core.model_cfg, core.engine_cfg
    per = cfg.num_layers // ec.pp
    whole = KVCacheSpec.for_model(cfg, 1, ec.block_size, kv_dtype=ec.kv_dtype).bytes_per_block()
    out = []
    for r in ranks:
        calls = [(tuple(k), n) for k, n in r["programs"]]
        want_mb = sum(n * k[3] * pp_microbatch_count(k[0], k[1], ec.pp, ec.pp_microbatches)
                      for k, n in calls) if ec.pp > 1 else 0
        launches = schedule_launches(core, calls)
        want = {k: launches if k == route else 0 for k in r["launches_by_kernel"]}
        stage = r["stage"]
        if (r["launches_by_kernel"] != want or r["microbatches"] != want_mb or launches <= 0
                or r["layers"] != [stage * per, (stage + 1) * per]
                or r["cache_block_bytes"] * ec.pp != whole):
            raise AssertionError(
                f"{tag}: rank {r['rank']} (stage {stage}, layers {r['layers']}) launched "
                f"{r['launches_by_kernel']} in {r['microbatches']} microbatches; expected "
                f"{want} in {want_mb}; {r['cache_block_bytes']} cache bytes a block of "
                f"{whole}")
        steps = r["forward_steps"]
        out.append({"rank": r["rank"], "data_rank": r["data_rank"], "stage": stage,
                    "layers": r["layers"], "launches": launches,
                    "microbatches": r["microbatches"], "forward_steps": steps,
                    "layer_bytes": r["layer_bytes"], "weight_bytes": r["weight_bytes"],
                    "cache_block_bytes": r["cache_block_bytes"],
                    "collectives": r["collectives"],
                    "collective_ms_per_step": 1e3 * r["collective_s"] / max(steps, 1),
                    "block_moves": r["block_moves"], "block_bytes": r["block_bytes"],
                    "peak_mem_gib": r["max_memory_allocated"] / 2**30})
    if len({r["forward_steps"] for r in ranks}) != 1:
        raise AssertionError(f"{tag}: the ranks ran {[r['forward_steps'] for r in ranks]} "
                             "forward steps")
    return out


async def r_serve(engine, reqs: dict, tag: str, route: str) -> dict:
    """``serve_on`` with every rank's counts set to 0 just before and read
    just after (``r_rank_check``), and the run's decode tok/s."""
    await engine.run_in_core(lambda c: c.reset_tp_stats())
    res = await serve_on(engine, reqs, route, tag)
    ranks = await engine.run_in_core(lambda c: c.tp_stats())
    res["ranks"] = r_rank_check(tag, engine.core, ranks, route)
    decode = len(next(iter(res["streams"].values())))
    res["decode_tok_s"] = (len(reqs) * (decode - 1)
                           / max(res["wall_s"] - res["ttft_all_s"], 1e-9))
    return res


def phase_pipeline(smi: str, f32_ref: dict, device: str = "cuda") -> dict:
    """(r): see the module docstring. ``f32_ref`` is (b'')'s streams
    ({i: (tokens, logprobs)}), (r1)'s reference."""
    from dynamo_tpu_torch.engine.engine import StepProgram
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    res: dict = {"smi": smi, "pp": R_PP}
    # (r1) f32 llama-3-8b-lite, all 8 layers, two stages on one card
    model = register_f32_model()
    cfg = MODEL_PRESETS[model]
    route = pa.ROUTES[(torch.float32, "float")]
    batch, prompt, decode = len(f32_ref), 128, len(next(iter(f32_ref.values()))[0])
    reqs = bench_reqs(cfg.vocab_size, batch, prompt, decode)
    fillers = kv_prompts(71, batch, R1_FILLER_PROMPT, cfg.vocab_size)

    async def r1():
        t0 = time.perf_counter()
        engine = r_engine(device, model, batch, R1_FILLER_PROMPT + 16, R1_BLOCKS,
                          host_kv_blocks=R1_HOST_BLOCKS)
        out = {"setup_s": time.perf_counter() - t0}
        try:
            core = engine.core
            out["first"] = await r_serve(engine, reqs, "[r1] f32 pp=2", route)
            off0 = core.kvbm.stats.offloaded_blocks
            await r_serve(engine, kv_reqs(fillers, "r1-fill", 1), "[r1] fillers", route)
            out["offloaded"] = core.kvbm.stats.offloaded_blocks - off0
            on0, hit0 = core.kvbm.stats.onboarded_blocks, core.metrics.prefix_hit_blocks
            pre0 = core.metrics.num_prefill_tokens
            again = bench_reqs(cfg.vocab_size, R1_AGAIN, prompt, decode)
            for i, r in again.items():
                r.request_id = f"again-{i}"
            out["again"] = await r_serve(engine, again, "[r1] first 16 again", route)
            out["onboarded"] = core.kvbm.stats.onboarded_blocks - on0
            out["prefix_hit_blocks"] = core.metrics.prefix_hit_blocks - hit0
            out["again_prefill_tokens"] = core.metrics.num_prefill_tokens - pre0
            out["transfer"] = core.transfer.stats.snapshot()
        finally:
            await engine.shutdown()
        return out

    t0 = time.perf_counter()
    one = asyncio.run(r1())
    free_engine()
    audit_memory("(r1)")
    first = one["first"]
    got = {i: (first["streams"][i], first["lps"][i]) for i in first["streams"]}
    equal, ties, bad = compare_streams("[r1] f32 pp=2 against (b'')", got, f32_ref)
    if bad:
        raise AssertionError(f"[r1] pp=2 streams leave (b'')'s at no near-tie: {bad[:4]}")
    whole = r_layer_bytes(cfg)
    halves = [r["layer_bytes"] for r in first["ranks"]]
    if halves != [whole // R_PP] * R_PP:
        raise AssertionError(f"[r1] the stages hold {halves} layer bytes, expected half of "
                             f"{whole} each")
    again_eq = [i for i in range(R1_AGAIN)
                if one["again"]["streams"][i] == first["streams"][i]]
    r1_res = {"setup_s": one["setup_s"], "equal": equal, "near_ties": len(ties),
              "ttft_all_s": first["ttft_all_s"], "ttft_median_s": first["ttft_median_s"],
              "decode_tok_s": first["decode_tok_s"], "wall_s": first["wall_s"],
              "ranks": first["ranks"],
              "whole_layer_bytes": whole, "offloaded": one["offloaded"],
              "onboarded": one["onboarded"], "prefix_hit_blocks": one["prefix_hit_blocks"],
              "again_prefill_tokens": one["again_prefill_tokens"],
              "again_equal": len(again_eq), "again_ranks": one["again"]["ranks"],
              "transfer": one["transfer"], "seconds": time.perf_counter() - t0}
    log("[r1] " + json.dumps(r1_res))
    if (len(again_eq) != R1_AGAIN or one["offloaded"] <= 0 or one["onboarded"] <= 0
            or one["prefix_hit_blocks"] < R1_AGAIN * (prompt // 16 - 1)):
        raise AssertionError(f"[r1] the first {R1_AGAIN} prompts again over the host tier: "
                             f"{len(again_eq)} streams equal, offloaded {one['offloaded']}, "
                             f"onboarded {one['onboarded']}, prefix hits "
                             f"{one['prefix_hit_blocks']}")
    res["r1"] = r1_res

    # (r2) bf16 over the int8 cache at dp=2 x pp=2 against dp=2 x pp=1
    model2 = q_model("llama-3-8b-lite", R2_LAYERS, "bfloat16")
    cfg2 = MODEL_PRESETS[model2]
    route2 = pa.ROUTES[(torch.bfloat16, "int8")]
    prompts = kv_prompts(72, R2_BATCH, R2_PROMPT, cfg2.vocab_size)
    blocks = R2_BATCH * -(-(R2_PROMPT + R2_DECODE) // 16) + 1
    runs = {}
    for tag, pp in (("dp2_pp1", 1), ("dp2_pp2", R_PP)):
        # the leader's logits of its first two program calls: the prefill
        # step's, then the first decode step's (a program's warm run, made
        # outside its calls, is not recorded)
        logits: list = []
        calling = [False]
        plain, call = llama.logits_from_hidden, StepProgram.__call__

        def recorded(*a, **kw):
            out = plain(*a, **kw)
            if calling[0] and len(logits) < 2:
                logits.append(out.float().cpu())
            return out

        def called(self, *a):
            calling[0] = True
            try:
                return call(self, *a)
            finally:
                calling[0] = False

        async def r2():
            t0 = time.perf_counter()
            engine = r_engine(device, model2, R2_BATCH, R2_PROMPT + R2_DECODE + 16, blocks,
                              pp=pp, dp=2, kv_dtype="int8",
                              max_tokens_per_step=R2_BATCH * R2_PROMPT)
            setup = time.perf_counter() - t0
            try:
                r = await r_serve(engine, kv_reqs(prompts, f"r2-{tag}", R2_DECODE),
                                  f"[r2] {tag}", route2)
            finally:
                await engine.shutdown()
            r["setup_s"] = setup
            return r

        llama.logits_from_hidden, StepProgram.__call__ = recorded, called
        try:
            t0 = time.perf_counter()
            runs[tag] = asyncio.run(r2())
        finally:
            llama.logits_from_hidden, StepProgram.__call__ = plain, call
        free_engine()
        audit_memory(f"(r2) {tag}")
        runs[tag]["logits"] = logits
        runs[tag]["seconds"] = time.perf_counter() - t0
        for i, (toks, lps) in enumerate(zip(runs[tag]["streams"].values(),
                                            runs[tag]["lps"].values())):
            if len(toks) != R2_DECODE or not all(lp == lp and lp <= 1e-3 for lp in lps):
                raise AssertionError(f"[r2] {tag} stream {i}: {len(toks)} tokens of "
                                     f"{R2_DECODE}, logprobs {lps[:4]}")
    one2, two2 = runs["dp2_pp1"], runs["dp2_pp2"]
    rows = [i for i in range(R2_BATCH)
            if one2["streams"][i][:1] == two2["streams"][i][:1]]
    if len(one2["logits"] + two2["logits"]) != 4 or any(
            x.shape[0] < R2_BATCH for x in one2["logits"] + two2["logits"]):
        raise AssertionError(f"[r2] recorded logits of {[tuple(x.shape) for x in one2['logits']]}"
                             f" and {[tuple(x.shape) for x in two2['logits']]}; expected "
                             f"a prefill and a decode step of {R2_BATCH} rows or more")
    ref, got2 = one2["logits"][1][rows], two2["logits"][1][rows]
    ratio = ((got2 - ref).abs().max() / (R2_LOGIT_TOL * ref.abs().max())).item()
    r2_res = {tag: {k: v for k, v in run.items() if k not in ("streams", "lps", "logits")}
              for tag, run in runs.items()}
    r2_res.update(first_decode_rows=len(rows), logit_err_over_limit=ratio,
                  streams_equal=sum(one2["streams"][i] == two2["streams"][i]
                                    for i in range(R2_BATCH)))
    log("[r2] " + json.dumps(r2_res))
    if not (ratio <= 1.0 and len(rows) > R2_BATCH // 2 and len(two2["ranks"]) == 2 * R_PP):
        raise AssertionError(f"[r2] the first decode step's logits at pp=2 against pp=1: "
                             f"err/limit {ratio} over {len(rows)} rows")
    res["r2"] = r2_res
    res["launches_r"] = {
        route: {f"r1 rank {r['rank']} (stage {r['stage']})": r["launches"]
                for r in r1_res["ranks"]},
        route2: {f"r2 dp2 x pp2 rank {r['rank']} (replica {r['data_rank']}, stage "
                 f"{r['stage']})": r["launches"] for r in two2["ranks"]}}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[r] passed in {res['seconds']:.1f}s on {smi}: " + json.dumps(res["launches_r"]))
    return res


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
    m1 = None
    if sys.argv[1:2] in ([], ["--profile"], ["--only-m"]):
        import concurrent.futures

        # (m1) needs neither the card nor the kernels: it runs beside the build
        m1 = concurrent.futures.ThreadPoolExecutor(1).submit(phase_harness, name)
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f}s")
    for kname in libs:
        for r in build.ptxas_report(kname):
            log(f"  ptxas {kname} {r['kernel']}: {r.get('registers')} registers, spill "
                f"stores {r.get('spill_stores')} B, loads {r.get('spill_loads')} B")

    if sys.argv[1:2] == ["--only-g"]:
        # a rehearsal of (g) alone: no kernels line and no result line
        phase_kvbm(smi)
        audit_memory("(g)")
        log(f"(g) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-ij"]:
        # a rehearsal of (i) and (j) beside (b)'s bf16 run: no kernels or result line
        profile = "--profile" in sys.argv[2:]
        serve, streams = phase_serve("float", profile=profile)
        audit_memory("(b) bf16")
        phase_int8(smi, {"float": serve}, {"float": streams}, profile=profile)
        audit_memory("(i1), (i2)")
        phase_moe(smi, profile=profile)
        audit_memory("(j)")
        b_serve = {kind: {"decode_tok_s": None, "ttft_all_s": None} for kind in KV_DTYPES}
        phase_tp(smi, b_serve)
        audit_memory("(h), (i3)")
        log(f"(i) and (j) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-tp"]:
        # a rehearsal of (a)'s sharded cases and (h): no kernels or result line
        phase_sharded(bw, peak)
        b_serve = {kind: {"decode_tok_s": None, "ttft_all_s": None} for kind in KV_DTYPES}
        phase_tp(smi, b_serve)
        audit_memory("(h), (i3)")
        log(f"(a) sharded and (h) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-k"]:
        # a rehearsal of (k), with (b'')'s f32 run for (k1)'s reference: no
        # kernels or result line
        _, f32_streams = phase_serve("float", f32=True, with_lps=True)
        audit_memory("(b'')")
        phase_cluster(smi, f32_streams, None, None)
        audit_memory("(k)")
        log(f"(k) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-m"]:
        # a rehearsal of (m) alone: no kernels or result line
        phase_chaos(smi, m1)
        audit_memory("(m)")
        log(f"(m) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-n"]:
        # a rehearsal of (n) alone: no kernels or result line
        phase_planning(smi)
        audit_memory("(n)")
        log(f"(n) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-o"]:
        # a rehearsal of (o) alone: no kernels or result line
        phase_gguf_recipe(smi)
        audit_memory("(o)")
        log(f"(o) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-p"]:
        # a rehearsal of (p), with (b'')'s f32 run for (p3)'s reference: no
        # kernels or result line
        _, f32_streams = phase_serve("float", f32=True, with_lps=True)
        audit_memory("(b'')")
        phase_parity(smi, f32_streams, bw, peak)
        audit_memory("(p)")
        log(f"(p) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-q"]:
        # a rehearsal of (q), with (j1) for (q2)'s reference: no kernels or
        # result line
        j1 = moe_serve("[j1]", *MOE_RUNS["j1"], smi=smi)
        audit_memory("(j1)")
        phase_moe_parallel(smi, j1)
        audit_memory("(q)")
        log(f"(q) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-r"]:
        # a rehearsal of (r), with (b'')'s f32 run for (r1)'s reference: no
        # kernels or result line
        _, f32_streams = phase_serve("float", f32=True, with_lps=True)
        audit_memory("(b'')")
        phase_pipeline(smi, f32_streams)
        audit_memory("(r)")
        log(f"(r) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    if sys.argv[1:2] == ["--only-l"]:
        # a rehearsal of (l), with (b'')'s f32 run for (l1)'s reference: no
        # kernels or result line
        _, f32_streams = phase_serve("float", f32=True, with_lps=True)
        audit_memory("(b'')")
        phase_disagg(smi, f32_streams, None, None)
        audit_memory("(l)")
        log(f"(l) alone passed in {time.perf_counter() - t0:.1f}s")
        return 0
    kern = phase_kernels(bw, peak)
    sharded = phase_sharded(bw, peak)
    audit_memory("(a), (a')")
    profile = "--profile" in sys.argv[1:]
    serve, streams = {}, {}
    for kind in KV_DTYPES:
        serve[kind], streams[kind] = phase_serve(kind, profile=profile)
        audit_memory(f"(b) kv_dtype={KV_DTYPES[kind]}")
    _, win_streams = phase_serve("float", profile=profile, window=4)
    audit_memory("(b')")
    differ = [i for i in streams["float"] if win_streams[i] != streams["float"][i]]
    log(f"[b'] decode_window=4 greedy streams equal to (b)'s bf16 streams: "
        f"{len(streams['float']) - len(differ)} of {len(streams['float'])}")
    if differ:
        raise AssertionError(f"[b'] streams {differ} differ from decode_window=1's")
    serve_f32, f32_streams = phase_serve("float", profile=profile, f32=True, with_lps=True)
    audit_memory("(b'')")
    log(f"[b''] f32 llama-3-8b-lite decode tok/s {serve_f32['decode_tok_s']} on {smi}, "
        f"{serve_f32['launches_per_forward_step']} launches of "
        f"{ROUTES[(torch.float32, 'float')]} a forward step")
    coherence = phase_coherence()
    audit_memory("(c)")
    int8 = phase_int8(smi, serve, streams, profile=profile)
    audit_memory("(i1), (i2)")
    moe = phase_moe(smi, profile=profile)
    audit_memory("(j)")
    moe_par = phase_moe_parallel(smi, moe["j1"])
    audit_memory("(q)")
    phase_spec(True, smi)
    phase_spec(False, smi, serve["float"]["decode_tok_s"])
    audit_memory("(d1), (d2)")
    phase_guided()
    phase_mm_embed()
    audit_memory("(d3)-(d5)")
    phase_http_f32()
    http = phase_http_bf16(smi, serve["float"]["decode_tok_s"])
    audit_memory("(e)")
    phase_slo(smi, serve["float"]["decode_tok_s"])
    audit_memory("(f)")
    phase_kvbm(smi)
    audit_memory("(g)")
    tp = phase_tp(smi, serve)
    audit_memory("(h), (i3)")
    cluster = phase_cluster(smi, f32_streams, serve["float"], http["e2"])
    audit_memory("(k)")
    disagg = phase_disagg(smi, f32_streams, serve["float"], cluster)
    audit_memory("(l)")
    chaos_m = phase_chaos(smi, m1)
    audit_memory("(m)")
    planning = phase_planning(smi)
    audit_memory("(n)")
    loading = phase_gguf_recipe(smi)
    audit_memory("(o)")
    parity = phase_parity(smi, f32_streams, bw, peak)
    audit_memory("(p)")
    pipeline = phase_pipeline(smi, f32_streams)
    audit_memory("(r)")
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
        k_run = {ROUTES[(torch.bfloat16, "float")]: "k2", ROUTES[(torch.float32, "float")]: "k1"}
        if route in k_run:
            # the launches of (k)'s two worker processes of the route, and
            # of (l)'s prefill and decode workers
            lines[-1]["launches_k"] = {w: r["launches"] for w, r in
                                       cluster[k_run[route]]["workers"].items()}
            l_run = "l2" if k_run[route] == "k2" else "l1"
            lines[-1]["launches_l"] = {w: r["launches"] for w, r in
                                       disagg[l_run]["workers"].items()}
        if route == ROUTES[(torch.float32, "float")]:
            # (m2)'s fresh worker, after the victim's kill, and (m3)'s engine
            lines[-1]["launches_m"] = {
                "m2 survivor": chaos_m["m2"]["survivor_launches"]["launches"],
                "m3": chaos_m["m3"]["launches"]}
            # (p)'s tensor- and data-parallel engines, every rank, and (p3)'s
            # prefill (leader) and decode workers
            lines[-1]["launches_p"] = parity["launches_p"]
            # (q1)'s MoE engines at tp=1, tp=2, ep=2 and tp=2 x ep=2, every rank
            lines[-1]["launches_q"] = moe_par["launches_q"]
        if route in pipeline["launches_r"]:
            # (r1)'s two stages (mma_f32), (r2)'s four ranks of dp=2 x pp=2 (mma_int8)
            lines[-1]["launches_r"] = pipeline["launches_r"][route]
        if route == ROUTES[(torch.bfloat16, "float")]:
            lines[-1]["moe_shapes"] = {name: {key: rows[name][key] for key in (
                "ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "err_over_limit")}
                for name in MOE_CASES.values()}
            # (n1)'s profile sweep, and (n2)'s two workers the planner spawned
            lines[-1]["launches_n"] = {
                "n1 profile": planning["n1"]["launches"],
                **{f"n2 {w}": r["launches"] for w, r in zip(
                    ("A", "B"), planning["n2"]["launches"].values())}}
            # (o1)'s GGUF engine and its reference, and the recipe's worker
            # under (o3)'s KServe streams and (o4)'s image prefills
            lines[-1]["launches_o"] = {
                "o1 GGUF engine": loading["o1"]["a"]["launches"],
                "o1 dequantized reference": loading["o1"]["b"]["launches"],
                **{f"o3 worker {w}": r["launches"]
                   for w, r in loading["o3"]["throughput"]["workers"].items()},
                **{f"o4 worker {w}": r["launches"] for w, r in loading["o4"]["workers"].items()}}
            # (q2)'s ep=2 engine, both ranks
            lines[-1]["launches_q"] = {"q2 ep2": moe_par["launches_q2"]}
            lines[-1]["launches_int8_moe"] = {
                "i1 int8 llama-3-8b-lite": int8["i1"]["launches_by_kernel"][route],
                **{f"{tag} {moe[tag]['model']}": moe[tag]["launches_by_kernel"][route]
                   for tag in MOE_RUNS}}
        elif route == ROUTES[(torch.float32, "float")]:
            lines[-1]["launches_int8_moe"] = {
                "i2 int8 tiny-real-llama f32": int8["i2"]["launches_by_kernel"][route],
                **{f"j3 tiny-moe f32 {q}": moe[f"j3_{q}"]["launches_by_kernel"][route]
                   for q in ("none", "int8")}}
    # the per-rank launch: its numbers are one rank's mma_bf16 launch at
    # tp=2 decode (KH=4, H=16); every route and degree is in (a)'s lines
    main_tp = sharded[ROUTES[(torch.bfloat16, "float")]][f"{MAIN_CASE} tp=2"]
    runs = [tp["h1"]["tp2"], tp["h2_bfloat16"], tp["h2_int8"], tp["i3"]["tp2"]]
    lines.append({
        "name": "paged_attention_sharded", "route": "cuda", "source": SOURCE,
        "replaces": SHARDED_REPLACES, "tp": 2,
        "launches": sum(r["launches"] for r in runs),
        "launched_in": "(h) and (i3) tp=2, both ranks: " + ", ".join(
            f"{r['route']} {r['launches']}" for r in runs),
        "max_abs_err": max(r["max_abs_err"] for rows in sharded.values()
                           for r in rows.values()),
        "err_over_limit": max(r["err_over_limit"] for rows in sharded.values()
                              for r in rows.values()),
        "bitwise_at_equal_splits": all(r["bitwise_at_equal_splits"]
                                       for rows in sharded.values() for r in rows.values()),
        "ms": main_tp["ms"], "plain_ms": main_tp["plain_ms"],
        "bound_ms": main_tp["bound_ms"], "bound_by": main_tp["bound_by"],
        "library_ms": main_tp["library_ms"], "pass": True,
        # (p0): the launch on the data axis, dp = tp = 2, every route at the
        # main decode shape (rank (0, 0)'s launch on its 16 rows)
        "data_axis": parity["p0"],
    })
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
