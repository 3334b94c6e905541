"""The port's engine against the JAX package's, on the CPU.

Model runs are float32 (``tiny-llama`` with bridged weights, and the
trained ``tests/data/tiny-real-llama`` checkpoint loaded at f32 by each
package's own loader), so greedy streams must be identical token for
token: bf16 rounds at different places in XLA and ATen and could flip a
near-tie. The bf16 path is checked for coherence on the trained checkpoint.
"""

from __future__ import annotations

import asyncio
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "tests" / "data" / "tiny-real-llama"
REAL32 = "tiny-real-llama-f32"


def _tcfg(jcfg) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


@pytest.fixture(scope="module")
def real32():
    """tiny-real-llama at f32 as a preset of both packages, with each
    package's own loader's params."""
    jcfg = dataclasses.replace(JModelConfig.from_hf_config(str(CKPT)),
                               dtype="float32", name=REAL32)
    JAX_PRESETS[REAL32] = jcfg
    TORCH_PRESETS[REAL32] = _tcfg(jcfg)
    yield (jloader.load_params(jcfg, CKPT),
           tloader.load_params(TORCH_PRESETS[REAL32], CKPT, device="cpu"))
    del JAX_PRESETS[REAL32], TORCH_PRESETS[REAL32]


def _kw(**kw):
    d = dict(model=REAL32, block_size=4, num_blocks=64, max_batch_size=8,
             max_model_len=256, prefill_chunk=32, decode_bucket=(4, 8))
    d.update(kw)
    return d


def _req(proto, prompt, rid, max_tokens=8, **so):
    return proto.PreprocessedRequest(
        token_ids=list(prompt), request_id=rid,
        stop_conditions=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=proto.SamplingOptions(temperature=so.pop("temperature", 0.0), **so))


def _run(core, reqs, pipelined=False, max_steps=2000):
    for r in reqs:
        assert core.add_request(r) is None
    got = {r.request_id: [] for r in reqs}
    fin = set()

    def take(outs):
        for rid, out in outs.items():
            got[rid].extend(out.token_ids)
            if out.finish_reason is not None:
                fin.add(rid)

    pending = None
    for _ in range(max_steps):
        if not core.has_work() and pending is None:
            break
        if pipelined:
            nxt = core.step_begin() if core.has_work() else None
            if pending is not None:
                take(core.step_finalize(pending))
            pending = nxt
        else:
            take(core.step())
    return got, fin


def _pair(real32, cfg_kw, prompts, max_tokens, pipelined=False, jax_too=True):
    jp, tp = real32
    treqs = [_req(tproto, p, f"r{i}", m) for i, (p, m) in enumerate(zip(prompts, max_tokens))]
    tcore = teng.EngineCore(TEngineConfig(**cfg_kw), params=tp, device="cpu")
    tgot, tfin = _run(tcore, treqs, pipelined=pipelined)
    assert tfin == set(tgot)
    jgot = None
    if jax_too:
        jreqs = [_req(jproto, p, f"r{i}", m) for i, (p, m) in enumerate(zip(prompts, max_tokens))]
        jgot, _ = _run(jeng.EngineCore(JEngineConfig(**cfg_kw), params=jp), jreqs)
    return tgot, jgot, tcore


# ---------------------------------------------------------------------------
# ModelRunner.dispatch
# ---------------------------------------------------------------------------

def test_dispatch_matches_jax_runner():
    """Decode rows, prefill rows and unified mixed rows through both
    runners (tiny-llama at f32, bridged weights) give the same greedy
    tokens, step after step."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32")
    jp = jllama.init_params(jcfg, jax.random.key(1))
    tp = tloader.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(model="tiny-llama", block_size=4, num_blocks=64, max_batch_size=8,
              max_model_len=128, prefill_chunk=32, decode_bucket=(4, 8))
    jr = jeng.ModelRunner(jcfg, JEngineConfig(**kw), params=jp)
    tr = teng.ModelRunner(_tcfg(jcfg), TEngineConfig(**kw), params=tp, device="cpu")

    def seqs(sched, proto, prompt, slot, blocks):
        s = sched.Seq(req=_req(proto, prompt, f"s{slot}"), block_size=4)
        s.slot, s.block_ids = slot, list(blocks)
        return s

    prompts = [[5, 9, 17, 33, 2, 8, 40], [100, 3, 77], [250, 251, 252, 253, 254, 255, 1, 2, 3]]
    blocks = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12, 13]]
    js = [seqs(jsched, jproto, p, i, b) for i, (p, b) in enumerate(zip(prompts, blocks))]
    ts = [seqs(tsched, tproto, p, i, b) for i, (p, b) in enumerate(zip(prompts, blocks))]
    for i in range(3):
        jr.reset_slot(i, 42)
        tr.reset_slot(i, 42)

    def step(rows_j, rows_t, sample, mixed=False):
        jt, jl = jr.dispatch(rows_j, sample, mixed=mixed)
        tt, tl = tr.dispatch(rows_t, sample, mixed=mixed).materialize()
        n = len(rows_j)
        np.testing.assert_array_equal(tt[:n], np.asarray(jt)[:n])
        np.testing.assert_allclose(tl[:n], np.asarray(jl)[:n], atol=1e-4, rtol=1e-4)
        for (js_, _, _), (ts_, start, length), tok, s in zip(rows_j, rows_t, tt[:n], sample):
            js_.num_computed = ts_.num_computed = start + length
            if s:
                js_.tokens.append(int(tok))
                ts_.tokens.append(int(tok))
        return tt[:n]

    # prefill rows (two seqs, ragged lengths), then two decode steps
    step([(s, 0, len(s.tokens)) for s in js[:2]], [(s, 0, len(s.tokens)) for s in ts[:2]],
         [True, True])
    for _ in range(2):
        step([(s, s.num_computed, 1) for s in js[:2]], [(s, s.num_computed, 1) for s in ts[:2]],
             [True, True])
    # unified mixed: two decode rows + a prefill chunk that samples; then a
    # fourth prompt in two chunks, the first intermediate (no sample)
    step([(s, s.num_computed, 1) for s in js[:2]] + [(js[2], 0, 9)],
         [(s, s.num_computed, 1) for s in ts[:2]] + [(ts[2], 0, 9)],
         [True, True, True], mixed=True)
    long_prompt = [(13 * j) % 500 for j in range(20)]
    js.append(seqs(jsched, jproto, long_prompt, 3, range(14, 20)))
    ts.append(seqs(tsched, tproto, long_prompt, 3, range(14, 20)))
    jr.reset_slot(3, 42)
    tr.reset_slot(3, 42)
    for start, length, sample in ((0, 8, False), (8, 12, True)):
        step([(s, s.num_computed, 1) for s in js[:3]] + [(js[3], start, length)],
             [(s, s.num_computed, 1) for s in ts[:3]] + [(ts[3], start, length)],
             [True, True, True, sample], mixed=True)
    step([(s, s.num_computed, 1) for s in js], [(s, s.num_computed, 1) for s in ts],
         [True] * 4)


# ---------------------------------------------------------------------------
# EngineCore twins of tests/test_engine.py
# ---------------------------------------------------------------------------

def test_batch_matches_solo(real32):
    probe = [10, 11, 12, 13, 14]
    solo, _, _ = _pair(real32, _kw(), [probe], [8], jax_too=False)
    prompts = [[20 + i, 30 + i, 40 + i] for i in range(4)] + [probe]
    busy, jbusy, _ = _pair(real32, _kw(), prompts, [8] * 5)
    assert busy == jbusy
    assert busy["r4"] == solo["r0"]


def test_preemption_under_block_pressure(real32):
    prompts = [list(range(10 + 20 * i, 26 + 20 * i)) for i in range(3)]
    roomy, _, _ = _pair(real32, _kw(num_blocks=256, max_model_len=64), prompts[:1], [30],
                        jax_too=False)
    tight, jtight, core = _pair(real32, _kw(num_blocks=16, max_model_len=64), prompts, [30] * 3)
    assert core.sched.preemption_count > 0, "test did not exercise preemption"
    assert core.metrics.num_preemptions == core.sched.preemption_count
    assert tight == jtight
    assert tight["r0"] == roomy["r0"]


def test_pipelined_matches_sync_greedy(real32):
    prompts = [[3 * i + j for j in range(5 + i)] for i in range(4)]
    lens = [6 + i for i in range(4)]
    pipe, jsync, _ = _pair(real32, _kw(), prompts, lens, pipelined=True)
    assert pipe == jsync
    assert [len(pipe[f"r{i}"]) for i in range(4)] == lens


def test_unified_matches_legacy_greedy(real32):
    prompts = [[(3 * i + j) % 100 for j in range(5 + 17 * i)] for i in range(4)]
    lens = [6 + 2 * i for i in range(4)]
    legacy, jlegacy, _ = _pair(real32, _kw(unified_step=False), prompts, lens)
    unified, _, _ = _pair(real32, _kw(), prompts, lens, jax_too=False)
    assert unified == legacy == jlegacy
    assert [len(unified[f"r{i}"]) for i in range(4)] == lens


def test_seeded_sampled_streams_repeat_in_the_engine(real32):
    _, tp = real32
    cfg = TEngineConfig(**_kw())

    def stream(neighbors):
        core = teng.EngineCore(cfg, params=tp, device="cpu")
        reqs = [_req(tproto, [7, 8, 9, 10], "s", 10, temperature=0.8, seed=5,
                     frequency_penalty=0.2)]
        reqs += [_req(tproto, [20 + i, 21], f"n{i}", 6, temperature=1.0)
                 for i in range(neighbors)]
        return _run(core, reqs)[0]["s"]

    assert stream(0) == stream(3) and len(stream(0)) == 10


# ---------------------------------------------------------------------------
# Host pieces, async facade, launcher
# ---------------------------------------------------------------------------

def test_bpe_matches_jax_hf_tokenizer():
    from dynamo_tpu.tokenizer import load_tokenizer as jload_tok
    from dynamo_tpu_torch.tokenizer import BPETokenizer, load_tokenizer

    tok, ref = load_tokenizer(str(CKPT)), jload_tok(str(CKPT))
    assert isinstance(tok, BPETokenizer)
    assert tok.encode("one two three four", add_bos=True) == [1, 278, 290, 295, 296]
    for text in ["one two three four five six", "Hello, world! 42 x_y  z\n\nw",
                 "héllo it's</s>", "  lead"]:
        ids = tok.encode(text, add_bos=True)
        assert ids == ref.encode(text, add_bos=True), text
        assert tok.decode(ids) == ref.decode(ids), text
    assert (tok.bos_id, tok.eos_id) == (ref.bos_id, ref.eos_id)


@pytest.mark.parametrize("block_size", [1, 4, 16, 61, 100])
def test_block_hashes_match_jax(block_size):
    from dynamo_tpu import tokens as jtok
    from dynamo_tpu_torch import tokens as ttok

    rng = np.random.default_rng(block_size)
    toks = rng.integers(0, 2**32, size=block_size * 5 + 3).tolist()
    assert (ttok.compute_block_hashes_for_tokens(toks, block_size)
            == jtok.compute_block_hashes_for_tokens(toks, block_size))
    js = jtok.TokenBlockSequence.from_tokens(toks, block_size)
    ts = ttok.TokenBlockSequence.from_tokens(toks, block_size)
    assert ts.sequence_hashes() == js.sequence_hashes()
    assert [b.block_hash for b in ts.blocks] == [b.block_hash for b in js.blocks]
    for n in (0, 1, 3, 4, 8, 9, 16, 17, 128, 129, 240, 241, 1024, 1025, 3000):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert ttok.xxh3_64(data) == jtok.xxhash.xxh3_64_intdigest(data), n


def test_kv_cache_spec_bytes_match_jax():
    from dynamo_tpu.engine.cache import KVCacheSpec as JSpec
    from dynamo_tpu_torch.engine.cache import KVCacheSpec as TSpec

    for name in ("tiny-llama", "llama-3-8b-lite"):
        for dtype in ("bfloat16", "float32"):
            for kv in ("bfloat16", "int8", "int4"):
                jcfg = dataclasses.replace(JAX_PRESETS[name], dtype=dtype)
                assert (TSpec.for_model(_tcfg(jcfg), 10, 16, kv).bytes_per_block()
                        == JSpec.for_model(jcfg, 10, 16, kv).bytes_per_block())


def test_block_allocator_matches_jax():
    from dynamo_tpu.engine.cache import BlockAllocator as JAlloc
    from dynamo_tpu_torch.engine.cache import BlockAllocator as TAlloc
    from dynamo_tpu_torch.engine.errors import NoFreeBlocks

    ja, ta = JAlloc(8), TAlloc(8)
    assert ta.allocate(3) == ja.allocate(3) == [1, 2, 3]
    ja.free([2])
    ta.free([2])
    assert ta.allocate(4) == ja.allocate(4) and ta.num_free == ja.num_free
    with pytest.raises(NoFreeBlocks):
        ta.allocate(ta.num_free + 1)
    with pytest.raises(ValueError):
        ta.free([0])


@pytest.mark.parametrize("setting", [
    dict(tp=2, warmup_mode="full"), dict(pp=2), dict(dp=2, pp=2), dict(ep=2),
    dict(sp=2, warmup_mode="lazy"),
    dict(kv_dtype="fp8"),
    dict(quantization="int4"), dict(quantization="fp8"),
    dict(spec_ngram=3, decode_window=4), dict(warmup_mode="eager"), dict(warmup_deadline=-1.0), dict(kv_dtype="int2"),
])
def test_unsupported_settings_raise(setting):
    kw = dict(model="tiny-llama", block_size=4, num_blocks=16, max_batch_size=2,
              max_model_len=64, **setting)
    if any(setting.get(axis, 1) > 1 for axis in ("tp", "dp", "pp", "sp", "ep")):
        # More than one rank with lazy or full warmup: refused until warmup
        # came to every mesh, accepted now (tests/test_torch_tp_programs*.py
        # build and serve such engines over gloo). On the CPU the default
        # backend, nccl, is refused by name before any follower starts.
        teng.check_supported(TEngineConfig(**kw), TORCH_PRESETS["tiny-llama"])
        with pytest.raises(ValueError, match="on the CPU need dist_backend='gloo'"):
            teng.EngineCore(TEngineConfig(**kw), device="cpu")
        return
    with pytest.raises(ValueError, match="port|supported|exclusive|warmup"):
        teng.EngineCore(TEngineConfig(**kw), device="cpu")


@pytest.mark.parametrize("field", [
    "tokenizer", "dtype", "kv_event_publishing",
    "attn_impl", "ring_prefill_threshold",
])
def test_settings_the_port_does_not_read_are_refused(field):
    """A JAX EngineConfig field that nothing in the port reads is not a
    field of the port's config: setting it fails instead of doing nothing.
    ``ring_prefill_threshold`` is read since the ring prefill came (the
    sp twins, tests/test_torch_sp_*.py): it is the port's field, with
    JAX's default, and reaches the engine."""
    value = getattr(JEngineConfig(), field)
    if field == "ring_prefill_threshold":
        assert getattr(TEngineConfig(**{field: 7}), field) == 7
        assert getattr(TEngineConfig(), field) == value == 0
        return
    with pytest.raises(TypeError, match=field):
        TEngineConfig(**{field: value})


def test_async_engine_generate_is_coherent_in_bf16():
    """AsyncTorchEngine.generate on the trained checkpoint at its own bf16
    dtype (plain attention on the CPU); an abort mid-stream frees the slot."""
    from dynamo_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer(str(CKPT))
    engine = teng.build_engine(TEngineConfig(
        model=str(CKPT), block_size=4, num_blocks=128, max_batch_size=4,
        max_model_len=256), device="cpu")

    async def go():
        async def one(prompt, n):
            toks, last = [], None
            async for out in engine.generate(_req(tproto, tok.encode(prompt, add_bos=True),
                                                  prompt, n)):
                toks += out.token_ids
                last = out
            return toks, last.finish_reason

        async def bail():
            async for _ in engine.generate(_req(tproto, [1, 5, 6], "bail", 50)):
                break

        try:
            return await asyncio.gather(one("one two three four", 8), one("five six", 4),
                                        bail())
        finally:
            await engine.shutdown()

    (a, ra), (b, rb), _ = asyncio.run(go())
    assert " five six seven eight" in tok.decode(a) and len(a) == 8
    assert tok.decode(b).startswith(" seven eight")
    assert ra == rb == tproto.FinishReason.LENGTH
    assert engine.stats()["requests_finished"] == 2
    assert not engine.core.has_work()


def test_launcher_batch_on_cpu(tmp_path):
    src = tmp_path / "prompts.jsonl"
    src.write_text('{"prompt": "one two three four", "max_tokens": 8}\n')
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
         "--model", str(CKPT), "--device", "cpu", "--block-size", "4",
         "--num-blocks", "64", "--max-model-len", "128", "--max-batch-size", "2",
         "--input-jsonl", str(src)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert '" five six seven eight' in line and '"tokens": 8' in line
