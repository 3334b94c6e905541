"""The port's MoE engines across ranks (gloo processes on the CPU) against
the JAX package's ``EngineCore`` on the same mesh of fake devices
(``tests/conftest.py``): tp = 2 (the dense dispatch with the per-expert
width split, TEP) and ep = 2 (the dropless dispatch); tp = 2 x ep = 2 is
in ``tests/test_torch_moe_parallel_ep.py``, int8 weights in
``tests/test_torch_moe_parallel_int8.py``, block export, the refusals,
the launcher and a recipe in ``tests/test_torch_moe_parallel_misc.py``.

Tolerance: identical greedy streams at f32 (JAX's own streams at these
meshes equal its tp = 1 streams at f32; at bf16 they do not, so bf16 is
no stream oracle across meshes: ROADMAP, gaps in the reference).

Each engine of more than one rank starts its followers (a few seconds
each), so the cases are few.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _run, _tcfg
from tests.test_torch_quant import _np
from tests.test_torch_tp import _cfg, _reqs

NAMES = {1: "tiny-moe-f32-eng", 0: "tiny-moe-f32-eng-ns"}


@pytest.fixture(scope="module")
def moe32():
    """tiny-moe at f32, with its shared expert and without, as presets of
    both packages: {shared: (JAX's params, the port's full tree)}."""
    out = {}
    for shared, name in NAMES.items():
        jcfg = dataclasses.replace(JAX_PRESETS["tiny-moe"], dtype="float32", name=name,
                                   num_shared_experts=shared)
        JAX_PRESETS[name], TORCH_PRESETS[name] = jcfg, _tcfg(jcfg)
        jp = jl.init_params(jcfg, jax.random.key(0))
        out[shared] = (jp, from_jax_params(_np(jp), device="cpu"))
    yield out
    for name in NAMES.values():
        del JAX_PRESETS[name], TORCH_PRESETS[name]


def _jax_streams(jp, **kw):
    got, _ = _run(jeng.EngineCore(JEngineConfig(**kw), params=jax.tree.map(jnp.copy, jp)),
                  _reqs(jproto))
    return got


def _port(full, **kw):
    return teng.EngineCore(TEngineConfig(**kw, dist_backend="gloo", warmup_mode="off"),
                           params=full, device="cpu")


@pytest.mark.parametrize("mesh,shared,quantization", [
    (dict(tp=2), 1, "none"),
    (dict(ep=2), 1, "none"),
], ids=["tp2", "ep2"])
def test_moe_engine_streams_equal_jax_at_the_same_mesh(moe32, mesh, shared, quantization):
    engine_case(moe32, mesh, shared, quantization)


def engine_case(moe32, mesh: dict, shared: int, quantization: str) -> None:
    """Greedy streams of the port's EngineCore over gloo ranks equal JAX's
    EngineCore on the same mesh (the pipelined loop). Every rank ran the
    same forward steps on its heads (attention replicated over "expert")
    and holds its experts: all 8 at ep = 1, 4 at ep = 2. int8 at ep = 2 is
    served where JAX serves it, without a shared expert."""
    jp, full = moe32[shared]
    kw = _cfg(NAMES[shared], quantization=quantization)
    core = _port(full, **mesh, **kw)
    try:
        got, fin = _run(core, _reqs(tproto), pipelined=True)
        ranks = core.tp_stats()
    finally:
        core.close()
    assert fin == set(got) and all(len(t) > 0 for t in got.values())
    assert got == _jax_streams(jp, **mesh, **kw)
    tp, ep = mesh.get("tp", 1), mesh.get("ep", 1)
    assert [r["rank"] for r in ranks] == list(range(tp * ep))
    assert [(r["expert_rank"], r["model_rank"]) for r in ranks] == [
        (e, m) for e in range(ep) for m in range(tp)]
    assert len({r["forward_steps"] for r in ranks}) == 1 and ranks[0]["forward_steps"] > 0
    assert all((r["heads"], r["kv_heads"], r["local_experts"]) == (4 // tp, 2 // tp, 8 // ep)
               for r in ranks)
    assert len({r["expert_bytes"] for r in ranks}) == 1
    assert all(r["collectives"] > 0 for r in ranks)
