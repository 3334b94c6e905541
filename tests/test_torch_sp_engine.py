"""The port's engine at sp=2 (``EngineConfig.sp``, the ring prefill of
``models/llama.forward_ring``) against the JAX package's
``EngineCore(sp=2)`` and against the port at sp=1, on the CPU: tiny-llama
at f32 with bridged weights (``tests/test_torch_tp.py``'s ``tiny32``),
the seq ranks gloo processes on the CPU, eager steps. One sp=2 engine of
each package (``ring_prefill_threshold=32``) serves the cases in turn, each
with prompts of its own (the prefix cache keeps every earlier case's
blocks); the twins are JAX's ``tests/test_ring_attention.py:101-276``.

Tolerances, with their reasons:
- streams: identical greedy tokens (f32, as the tp=2 twins hold them);
- blocks a step that did not ring wrote: byte for byte sp=1's (every seq
  rank runs that step as one rank does);
- blocks and embeddings a ring step wrote: 1e-4 of sp=1's (the ring's f32
  sums against the kernel's plain version, as ``FWD_TOL`` of
  tests/test_torch_tp.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.obs.ring_prefill import get_ring_prefill_metrics
from dynamo_tpu_torch.parallel.collectives import TPFailure
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.tokens import TokenBlockSequence
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import ROOT, _req, _run
from tests.test_torch_tp import TCFG, TINY32, tiny32  # noqa: F401

FWD_TOL = dict(atol=1e-4, rtol=1e-4)
THRESHOLD = 32


def engine_kw(**kw) -> dict:
    d = dict(model=TINY32, block_size=4, num_blocks=192, max_batch_size=4,
             max_model_len=128, prefill_chunk=32, decode_bucket=(4, 8))
    d.update(kw)
    return d


def _port(full, **kw):
    extra = dict(dist_backend="gloo", warmup_mode="off") if kw.get("sp", 1) > 1 else {}
    return teng.EngineCore(TEngineConfig(**engine_kw(**kw), **extra), params=full, device="cpu")


def _reqs(proto, prompts: dict, max_tokens: int = 4) -> list:
    return [_req(proto, p, rid, max_tokens) for rid, p in prompts.items()]


def _counts() -> tuple:
    rpm = get_ring_prefill_metrics()
    return rpm.invocations.get(), rpm.tokens.get(), rpm.bypassed.get()


def _calls(core) -> dict:
    """Leader program calls by kind: ring ("sp") and other."""
    progs = core.runner.programs.values()
    return {"ring": sum(p.calls for p in progs if p.sp_prefill),
            "other": sum(p.calls for p in progs if not p.sp_prefill)}


@pytest.fixture(scope="module")
def engines(tiny32):  # noqa: F811
    """The port's sp=2 engine, JAX's sp=2 engine and the port's sp=1 engine
    (prompts' ids stay inside the 512-token vocabulary),
    each at ``ring_prefill_threshold=32``; the leader's attention-kernel
    calls counted."""
    jp, full = tiny32
    calls = [0]
    plain = tl.paged_attention_kernel

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    tl.paged_attention_kernel = counted
    core = _port(full, sp=2, ring_prefill_threshold=THRESHOLD)
    try:
        jcore = jeng.EngineCore(JEngineConfig(**engine_kw(sp=2,
                                                           ring_prefill_threshold=THRESHOLD)),
                                params=jp)
        yield core, jcore, _port(full), calls
    finally:
        tl.paged_attention_kernel = plain
        core.close()


def _serve(engines, prompts: dict, max_tokens: int = 4) -> tuple[dict, dict, dict]:
    core, jcore, one, _ = engines
    got, fin = _run(core, _reqs(tproto, prompts, max_tokens))
    assert fin == set(prompts)
    want, _ = _run(jcore, _reqs(jproto, prompts, max_tokens))
    ref, _ = _run(one, _reqs(tproto, prompts, max_tokens))
    return got, want, ref


def test_sp2_streams_equal_jax_sp2_and_sp1(engines):
    """Three fresh prompts admitted together (40, 33 and 12 tokens: the
    longest past the threshold, so the whole step rings, the short row
    too) give JAX sp=2's and sp=1's greedy streams; the ring counters move
    by one step and its tokens, the engine's config was raised so that a
    whole prompt is one chunk, as JAX's."""
    core, jcore, _, _ = engines
    prompts = {"a": list(range(3, 43)), "b": list(range(100, 133)), "c": [7] * 12}
    before, ring0 = _counts(), _calls(core)["ring"]
    got, want, ref = _serve(engines, prompts)
    after = _counts()
    assert got == want == ref and all(len(s) == 4 for s in got.values())
    assert after[0] - before[0] == 1 and after[1] - before[1] == 85
    assert _calls(core)["ring"] - ring0 == 1
    for key in ("prefill_chunk", "max_tokens_per_step"):
        assert getattr(core.engine_cfg, key) == getattr(jcore.engine_cfg, key)
    assert core.engine_cfg.prefill_chunk == 128


def test_ring_vs_chunked_walk(engines, tiny32):  # noqa: F811
    """A 48-token prompt rung at sp=2 against the chunked walk at sp=1
    (``prefill_chunk=16``: three chunks): the same greedy tokens, in both
    packages."""
    _, full = tiny32
    prompt = {"walk": list(range(1, 49))}
    got, want, _ = _serve(engines, prompt)
    chunked = _port(full, prefill_chunk=16)
    walked, _ = _run(chunked, _reqs(tproto, prompt))
    assert not any(p.sp_prefill for p in chunked.runner.programs.values())
    assert got == want == walked and len(got["walk"]) == 4


def test_threshold_gates_the_ring(engines):
    """A 16-token prompt stays below the threshold: bypassed, no ring step;
    a 32-token one (at it) rings: invocations and tokens move."""
    core = engines[0]
    before, calls0 = _counts(), _calls(core)
    got, want, ref = _serve(engines, {"short": list(range(320, 336))})
    mid, calls1 = _counts(), _calls(core)
    assert got == want == ref
    assert mid[2] - before[2] == 1 and mid[:2] == before[:2]
    assert calls1["ring"] == calls0["ring"]
    got, want, ref = _serve(engines, {"at": list(range(280, 312))})
    after = _counts()
    assert got == want == ref
    assert after[0] - mid[0] == 1 and after[1] - mid[1] == 32 and after[2] == mid[2]


def test_ring_written_blocks_are_prefix_hits(engines):
    """The blocks a ring step wrote serve a later prompt that extends it:
    the second request prefills only its tail (bypassing the ring: its row
    starts past 0), as at sp=1, with sp=1's and JAX's streams."""
    core, jcore, one, _ = engines
    prompt = list(range(240, 272))
    _serve(engines, {"first": prompt})
    pre = [c.metrics.num_prefill_tokens for c in (core, jcore, one)]
    got, want, ref = _serve(engines, {"second": prompt + [7, 8, 9]})
    tails = [c.metrics.num_prefill_tokens - p for c, p in zip((core, jcore, one), pre)]
    assert got == want == ref
    assert tails[0] == tails[1] == tails[2] < len(prompt)


def test_launches_per_rank_are_the_steps_that_did_not_ring(engines):
    """Every seq rank ran the same programs the same number of times, and
    hopped sp - 1 = 1 time a layer of every ring step; the leader called
    the attention kernel once a layer of each forward step that did not
    ring and of each new such program's warm run, never in a ring step."""
    core, _, _, calls = engines
    before = {k: p.calls for k, p in core.runner.programs.items()}
    calls[0] = 0
    got, fin = _run(core, _reqs(tproto, {"count": list(range(60, 100)),
                                         "count2": list(range(150, 160))}))
    assert len(fin) == 2
    steps = 0
    for key, prog in core.runner.programs.items():
        if not prog.sp_prefill:
            steps += (prog.calls - before.get(key, 0)) * prog.shape[3] + (key not in before)
    assert calls[0] == TCFG.num_layers * steps > 0
    ranks = core.tp_stats()
    assert [(r["rank"], r["seq_rank"]) for r in ranks] == [(0, 0), (1, 1)]
    assert ranks[0]["programs"] == ranks[1]["programs"]
    ring = ranks[0]["ring_steps"]
    assert ring >= 5 and all(r["ring_hops"] == ring * TCFG.num_layers for r in ranks)
    assert all(r["ring_bytes"] > 0 and r["ring_s"] > 0 for r in ranks)


def test_embeddings_and_blocks_equal_sp1(engines):
    """Embeddings (never a ring step) and the whole blocks the leader
    exports: byte for byte sp=1's for a prompt below the threshold, within
    1e-4 for one that rang; the blocks come from seq rank 0's cache, which
    holds what seq rank 1's holds."""
    core, _, one, _ = engines
    inputs = [list(range(1, 12)), [5, 9, 13] * 7]
    np.testing.assert_array_equal(core.embed(inputs), one.embed(inputs))
    for rid, prompt, exact in (("below", list(range(170, 186)), True),
                               ("rang", list(range(190, 230)), False)):
        _serve(engines, {rid: prompt}, max_tokens=1)
        hashes = TokenBlockSequence.from_tokens(prompt, 4).sequence_hashes()
        got, ref = core.export_blocks(hashes), one.export_blocks(hashes)
        assert len(got) == len(ref) == len(hashes)
        for (_, _, b), (_, _, r) in zip(got, ref):
            assert b.shape == r.shape == (2, TCFG.num_layers, 4, TCFG.num_kv_heads,
                                          TCFG.head_dim)
            if exact:
                assert b.tobytes() == r.tobytes()
            else:
                np.testing.assert_allclose(b, r, **FWD_TOL)


def test_multimodal_request_answered_with_jax_error(engines):
    core, jcore, _, _ = engines
    wire = tproto.tensor_to_wire(np.zeros((3, TCFG.hidden_size), np.float32))
    mm = _req(tproto, list(range(1, 9)), "mm", 4)
    mm.mm_embeddings = [{"pos": 2, **wire}]
    jmm = _req(jproto, list(range(1, 9)), "mm", 4)
    jmm.mm_embeddings = mm.mm_embeddings
    out, jout = core.add_request(mm), jcore.add_request(jmm)
    assert out.error == jout.error and "sp=1" in out.error
    assert str(out.finish_reason) == str(jout.finish_reason)
    assert not core.has_work()


@pytest.mark.parametrize("setting,match", [
    (dict(sp=2, pp=2), "pp>1 currently composes only with dp"),
    (dict(sp=2, pp=2, dp=2), "pp>1 currently composes only with dp"),
])
def test_pp_with_sp_is_refused_by_both_packages(setting, match):
    kw = engine_kw(model="tiny-llama", **setting)
    with pytest.raises(ValueError, match=match):
        jeng.EngineCore(JEngineConfig(**kw))
    with pytest.raises(ValueError, match=match):
        teng.EngineCore(TEngineConfig(**kw, dist_backend="gloo", warmup_mode="off"),
                        device="cpu")


@pytest.mark.parametrize("mode", ["lazy", "full"])
def test_cuda_graphs_at_sp2_are_refused(mode):
    """Refused until warmup came to every mesh (ROADMAP item 14f): sp=2
    with lazy or full warmup builds and warms up (in a process of its own:
    this module's shared engine holds this one's group), its programs
    eager, on the CPU and on the card (a ring step's host read: ROADMAP
    14h)."""
    kw = dict(engine_kw(model="tiny-llama", sp=2, block_size=16, num_blocks=16,
                        max_batch_size=2, max_model_len=64, decode_bucket=(2,)),
              dist_backend="gloo", warmup_mode=mode)
    script = ("import json\n"
              "from dynamo_tpu_torch.engine import engine as teng\n"
              "from dynamo_tpu_torch.utils.config import EngineConfig\n"
              f"core = teng.EngineCore(EngineConfig(**{kw!r}), device='cpu')\n"
              "print(json.dumps(core.warmup()))\n"
              "core.close()\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["mode"] == mode and summary["graphs"] is False
    assert "CUDA graphs" in summary["graph_reason"]
    assert summary["coverage"] == (1.0 if mode == "full" else 0.0)
    assert "14h" in teng.step_graphs(TEngineConfig(**{**kw, "dist_backend": "nccl"}), "cuda")[1]


def test_a_seq_rank_that_fails_fails_the_leader_with_its_traceback(engines):
    """Last on the shared engine: seq rank 1 raises on an op it does not
    know and exits; the leader's next ring step fails at once with its
    traceback and exit code instead of hanging in the hop."""
    core = engines[0]
    procs = list(core._tp_followers.procs)
    core.runner.tp.post("no-such-op")
    core.add_request(_req(tproto, list(range(440, 480)), "after", 4))
    with pytest.raises(TPFailure, match=r"(?s)exit code 1.*no-such-op"):
        core.step()
    core.close()
    assert not any(p.is_alive() for p in procs)
