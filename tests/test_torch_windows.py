"""Fused decode windows in the port (``decode_window > 1``): one step
program runs W decode steps. Twins of the windowed tests of
tests/test_engine.py — emitted streams must equal single-step decoding, so
stop-condition lag and window overrun stay invisible to the client — and
the port's windowed streams against the JAX engine's at every kv dtype.

Everything runs on the CPU, where a step program runs its body eagerly.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.scheduler import Scheduler, Seq
from dynamo_tpu_torch.engine.prefix_pool import PrefixPool
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import CKPT, ROOT, _req, _run, _tcfg

TINY32 = "tiny-llama-f32"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny model's steps are a few ms on one thread and far slower
    when several test workers each spread torch over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw) -> TEngineConfig:
    d = dict(model="tiny-llama", block_size=4, num_blocks=64, max_batch_size=8,
             max_model_len=256, prefill_chunk=32, decode_bucket=(4, 8))
    d.update(kw)
    return TEngineConfig(**d)


def _streams(cfg_kw, reqs_fn, pipelined=False):
    """The same requests through a single-step engine and through
    ``cfg_kw``'s; returns both stream dicts (keyed alike)."""
    got = []
    for kw, pipe in (({}, False), (cfg_kw, pipelined)):
        core = teng.EngineCore(_cfg(**kw), device="cpu")
        reqs = reqs_fn()
        out, fin = _run(core, reqs, pipelined=pipe)
        assert fin == {r.request_id for r in reqs}
        got.append(out)
    return got


def test_windowed_matches_sync_greedy():
    def reqs():
        return [_req(tproto, [3 * i + j for j in range(5 + i)], f"r{i}", 6 + 2 * i)
                for i in range(4)]

    sync, win = _streams({"decode_window": 4}, reqs)
    assert win == sync
    assert [len(win[f"r{i}"]) for i in range(4)] == [6 + 2 * i for i in range(4)]  # overrun discarded


def test_windowed_sampled_reproducible():
    """Seeded sampling with penalties advances each slot's draw counter
    once per token in both modes: windowed reproduces the sync stream."""
    def reqs():
        return [_req(tproto, [7 * i + j for j in range(6)], f"r{i}", 10, temperature=0.8,
                     seed=42 + i, frequency_penalty=0.3) for i in range(3)]

    sync, win = _streams({"decode_window": 4}, reqs)
    assert win == sync


def test_windowed_pipelined_matches_sync():
    """Window + one step in flight (the production loop shape)."""
    def reqs():
        return [_req(tproto, [5 * i + j for j in range(4 + i)], f"r{i}", 7 + i)
                for i in range(3)]

    sync, win = _streams({"decode_window": 4}, reqs, pipelined=True)
    assert win == sync


def test_windowed_under_block_pressure():
    """A pool small enough to force preemption still converges to the same
    streams: windowed growth (w tokens ahead) preempts and resumes."""
    def reqs():
        return [_req(tproto, [11 * i + j for j in range(8)], f"r{i}", 12) for i in range(4)]

    core = teng.EngineCore(_cfg(num_blocks=20, decode_window=4), device="cpu")
    win, _ = _run(core, reqs())
    assert core.sched.preemption_count > 0, "test did not exercise preemption"
    sync, _ = _run(teng.EngineCore(_cfg(num_blocks=20), device="cpu"), reqs())
    assert win == sync


def test_windowed_max_model_len_cap():
    """Windows shrink so the block table never outgrows max_model_len."""
    def reqs():
        return [_req(tproto, list(range(10, 22)), "r0", 64)]

    # max_model_len 20 caps output at 8 tokens; window 8 must shrink near the cap
    kw = dict(max_model_len=20, num_blocks=16)
    core = teng.EngineCore(_cfg(**kw, decode_window=8), device="cpu")
    win, _ = _run(core, reqs())
    sync, _ = _run(teng.EngineCore(_cfg(**kw), device="cpu"), reqs())
    assert win == sync
    assert len(win["r0"]) == 20 - 12


def test_window_shrinks_to_pow2_of_the_useful_horizon():
    """The scheduler's window: pow2 of min(decode_window, room under
    max_model_len, tokens still useful), blocks grown that far ahead, and
    the prefill budget net of decode rows x window."""
    pool = PrefixPool(64, 4)
    sched = Scheduler(pool, max_batch_size=4, prefill_chunk=32, max_model_len=40,
                      max_tokens_per_step=20, decode_window=8)
    seqs = [Seq(req=_req(tproto, list(range(12)), f"s{i}", mt), block_size=4)
            for i, mt in enumerate((3, 6))]
    for s in seqs:
        sched.add(s)
    plan = sched.plan()                 # both prompts prefill (12 + 8 of the budget)
    assert plan.decode_window == 1 and [w.length for w in plan.prefill] == [12, 8]
    seqs[0].num_computed = 12           # s0 decodes; s1 still prefills
    seqs[1].num_computed = 8
    plan = sched.plan()
    # useful = max_tokens 3 - 0 decoded → w = 2; s0 grows to 12 + 2 tokens
    assert plan.decode == [seqs[0]] and plan.decode_window == 2
    assert len(seqs[0].block_ids) == 4
    assert [w.length for w in plan.prefill] == [4]      # 20 - 1 row x 2 of the budget
    seqs[0].num_computed = 36           # room under max_model_len: 4
    seqs[1].num_computed = 12
    plan = sched.plan()
    assert plan.decode_window == 4 and len(plan.decode) == 2


def test_window_dispatch_equals_w_single_steps():
    """dispatch(window=4) covers start + 3 more positions, returns [B, 4]
    tokens and logprobs, and equals four single-step dispatches from the
    same state; the window's program is a bucket of its own (W in the
    key)."""
    def fresh():
        r = teng.EngineCore(_cfg(), device="cpu").runner
        r.reset_slot(0, 7)
        s = Seq(req=_req(tproto, [1, 2, 3, 4, 5, 6, 7], "w"), block_size=4)
        s.slot, s.block_ids = 0, [1, 2, 3, 4, 5]
        s.tokens.append(int(r.run([(s, 0, 7)], [True])[0][0]))
        s.num_computed = 7
        return r, s

    r, s = fresh()
    toks, lps = r.dispatch([(s, 7, 1)], [True], window=4).materialize()
    assert toks.shape == lps.shape == (4, 4)
    assert (4, 1, 4, 4, True) in r.programs     # 7 + 1 + 3 positions: 3 blocks → 4
    one, s1 = fresh()
    ref_lps = []
    for j in range(4):
        t, lp = one.run([(s1, 7 + j, 1)], [True])
        s1.tokens.append(int(t[0]))
        ref_lps.append(float(lp[0]))
    assert toks[0].tolist() == s1.tokens[8:12]
    np.testing.assert_allclose(lps[0], ref_lps, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Against the JAX engine's windows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny32():
    """tiny-llama at f32 as a preset of both packages, with JAX params
    from a seed bridged into the port."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name=TINY32)
    JAX_PRESETS[TINY32] = jcfg
    TORCH_PRESETS[TINY32] = _tcfg(jcfg)
    jp = jllama.init_params(jcfg, jax.random.key(3))
    yield jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del JAX_PRESETS[TINY32], TORCH_PRESETS[TINY32]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_windowed_streams_match_jax_windows(tiny32, kv_dtype):
    """decode_window=4 greedy streams of the port equal the JAX engine's
    decode_window=4 streams (tiny-llama f32, same weights) at every kv
    dtype — int4 against JAX int4 only — and the port's own sync streams."""
    jp, tp = tiny32
    kw = dict(model=TINY32, block_size=4, num_blocks=64, max_batch_size=4,
              max_model_len=64, prefill_chunk=16, decode_bucket=(4,), kv_dtype=kv_dtype)
    prompts = [[(5 * i + 3 * j) % 500 for j in range(6 + 3 * i)] for i in range(3)]
    lens = [7, 9, 6]

    def reqs(proto):
        return [_req(proto, p, f"r{i}", n) for i, (p, n) in enumerate(zip(prompts, lens))]

    twin, _ = _run(teng.EngineCore(TEngineConfig(**kw, decode_window=4), params=tp,
                                   device="cpu"), reqs(tproto), pipelined=True)
    tsync, _ = _run(teng.EngineCore(TEngineConfig(**kw), params=tp, device="cpu"),
                    reqs(tproto))
    jwin, _ = _run(jeng.EngineCore(JEngineConfig(**kw, decode_window=4), params=jp),
                   reqs(jproto))
    assert twin == jwin
    assert twin == tsync
    assert [len(twin[f"r{i}"]) for i in range(3)] == lens


def test_launcher_decode_window_and_full_warmup_on_cpu(tmp_path):
    src = tmp_path / "prompts.jsonl"
    src.write_text('{"prompt": "one two three four", "max_tokens": 8}\n')
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
         "--model", str(CKPT), "--device", "cpu", "--block-size", "4",
         "--num-blocks", "64", "--max-model-len", "64", "--max-batch-size", "2",
         "--prefill-chunk", "16", "--decode-window", "4", "--warmup-mode", "full",
         "--input-jsonl", str(src)],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env={**os.environ, "OMP_NUM_THREADS": "1", "DYN_LOG": "info"})
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert '" five six seven eight' in line and '"tokens": 8' in line
    warm = [ln for ln in (res.stdout + res.stderr).splitlines() if "bucket warmup" in ln]
    assert warm and "'failed': 0" in warm[0] and "'coverage': 1.0" in warm[0], warm
