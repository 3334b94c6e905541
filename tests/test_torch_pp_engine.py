"""The port's pipeline-parallel engine (two gloo stages on the CPU)
against the JAX package's ``EngineCore(pp=2)`` on the conftest's fake
devices, tiny-llama at f32 with bridged weights (tests/test_torch_tp.py's
``tiny32``): greedy streams at the automatic microbatch count and at 1
(the sequential schedule; 4 in tests/test_torch_pp_engine4.py), and what
each stage ran and holds. The
requests are tests/test_torch_tp.py's three and tests/test_pp.py's four
decode rows of 8 tokens. Sampling, embeddings, a multimodal request,
int8 weights are in tests/test_torch_pp_misc.py, the launcher in
tests/test_torch_pp_launch.py; decode windows and dp x pp in
tests/test_torch_pp_parity.py.

Tolerance: identical tokens (JAX's own pp=2 streams equal its pp=1 ones
at f32, tests/test_pp.py; so do the port's).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.cache import KVCacheSpec
from dynamo_tpu_torch.models.llama import pp_microbatch_count
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _req, _run
from tests.test_torch_tp import PROMPTS, MAX_TOKENS, TCFG, TINY32, _cfg, tiny32  # noqa: F401

DECODE_ROWS = [[40 + 2 * i + j for j in range(6)] for i in range(4)]


def _reqs(proto, tag=""):
    prompts = PROMPTS + DECODE_ROWS
    tokens = MAX_TOKENS + [8] * len(DECODE_ROWS)
    return [_req(proto, p, f"{tag}r{i}", m) for i, (p, m) in enumerate(zip(prompts, tokens))]


def _jax(jp, **kw):
    return jeng.EngineCore(JEngineConfig(**_cfg(TINY32, **kw)), params=jax.tree.map(jnp.copy, jp))


def _port(full, **kw):
    return teng.EngineCore(TEngineConfig(**_cfg(TINY32, **kw), dist_backend="gloo",
                                         warmup_mode="off"), params=full, device="cpu")


def check_stages(ranks: list[dict], pp: int = 2, mb: int = 0, dp: int = 1) -> None:
    """Stage s of each replica holds layers [s L/pp, (s+1) L/pp) and half of
    the layer bytes and of a block's cache bytes; every stage ran every
    forward step, each microbatch the schedule makes of its program's
    shape: Σ over calls of window·m (and (L/pp)·m kernel launches, which
    the card counts: chip_smoke (r1))."""
    per = TCFG.num_layers // pp
    whole = KVCacheSpec.for_model(TCFG, 1, 4).bytes_per_block()
    assert [r["rank"] for r in ranks] == list(range(dp * pp))
    assert [(r["data_rank"], r["stage"]) for r in ranks] == [
        (d, s) for d in range(dp) for s in range(pp)]
    for r in ranks:
        assert r["layers"] == [r["stage"] * per, (r["stage"] + 1) * per]
        assert r["cache_block_bytes"] * pp == whole
        want = sum(calls * k[3] * pp_microbatch_count(k[0], k[1], pp, mb)
                   for k, calls in r["programs"])
        assert r["microbatches"] == want > 0
        assert r["collectives"] > 0
    assert len({r["layer_bytes"] for r in ranks}) == 1
    assert len({r["forward_steps"] for r in ranks}) == 1 and ranks[0]["forward_steps"] > 0
    assert ranks[0]["weight_bytes"] > ranks[1]["weight_bytes"] == ranks[1]["layer_bytes"]


@pytest.fixture(scope="module")
def port_pp1(tiny32):  # noqa: F811
    core = teng.EngineCore(TEngineConfig(**_cfg(TINY32)), params=tiny32[1], device="cpu")
    got, _ = _run(core, _reqs(tproto))
    return got


@pytest.mark.parametrize("mb", [0, 1], ids=["auto", "sequential"])
def test_pp2_streams_equal_jax_pp2(tiny32, port_pp1, mb):  # noqa: F811
    engine_case(tiny32, port_pp1, mb)


def engine_case(tiny32, port_pp1, mb: int) -> None:  # noqa: F811
    """Greedy streams of the port's EngineCore(pp=2) equal JAX's
    EngineCore(pp=2) at the same microbatch count, and the port's pp=1
    (the pipelined loop at auto: the in-flight tokens reach stage 0,
    which embeds); each stage ran the schedule's microbatches."""
    jp, full = tiny32
    core = _port(full, pp=2, pp_microbatches=mb)
    try:
        got, fin = _run(core, _reqs(tproto), pipelined=mb == 0)
        ranks = core.tp_stats()
    finally:
        core.close()
    assert fin == set(got) and all(len(t) > 0 for t in got.values())
    want, _ = _run(_jax(jp, pp=2, pp_microbatches=mb), _reqs(jproto))
    assert got == want == port_pp1
    check_stages(ranks, mb=mb)
