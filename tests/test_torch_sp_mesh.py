"""The port's engine at sp > 1 composed with the other axes — sp=2 x tp=2
here; sp=2 x dp=2, sp=4 and tiny-moe at sp=2 x ep=2 in
``tests/test_torch_sp_mesh_dp.py``, ``_mesh4.py`` and ``_moe.py``, a case
a file for time — against the JAX
package's ``EngineCore`` on the same mesh of fake CPU devices
(``tests/conftest.py``) and against the port at sp=1, with
``ring_prefill_threshold=1``: every step of fresh prompts rings. f32
weights bridged into presets of both packages (tiny-llama as
``tests/test_torch_tp.py``'s ``tiny32``, tiny-moe as
``tests/test_torch_moe_parallel_engine.py``'s ``moe32``).

Tolerance: identical greedy streams (f32).

Each engine starts three followers (a few seconds), so each mesh serves
one set of requests: two steps of fresh prompts alone, which ring (three
admitted together, then one after they finish), and a prompt admitted
beside the last one's decode, which bypasses the ring.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _req
from tests.test_torch_tp import TINY32, tiny32  # noqa: F401

PROMPTS = {"a": list(range(3, 35)), "b": list(range(40, 60)), "c": [7] * 9}


def engine_kw(model: str, **kw) -> dict:
    d = dict(model=model, block_size=4, num_blocks=96, max_batch_size=4, max_model_len=64,
             decode_bucket=(4, 8), ring_prefill_threshold=1)
    d.update(kw)
    return d


def serve(core, proto) -> dict:
    """The three prompts together, then a fourth alone once they finished,
    then a fifth beside the fourth's decode (a step that bypasses the
    ring)."""
    got: dict = {}

    def step():
        for rid, out in core.step().items():
            got.setdefault(rid, []).extend(out.token_ids)

    for rid, p in PROMPTS.items():
        core.add_request(_req(proto, p, rid, 3))
    while core.has_work():
        step()
    core.add_request(_req(proto, list(range(100, 120)), "d", 4))
    step()
    core.add_request(_req(proto, list(range(130, 150)), "e", 3))
    while core.has_work():
        step()
    return got


_REFS: dict = {}


def mesh_case(params: tuple, model: str, mesh: dict, ranks: int) -> None:
    jp, full = params
    kw = engine_kw(model, **mesh)
    want = serve(jeng.EngineCore(JEngineConfig(**kw), params=jax.tree.map(jnp.copy, jp)),
                 jproto)
    if model not in _REFS:   # the port at sp=1, once a model
        _REFS[model] = serve(teng.EngineCore(TEngineConfig(**engine_kw(model)), params=full,
                                             device="cpu"), tproto)
    ref = _REFS[model]
    core = teng.EngineCore(TEngineConfig(**kw, dist_backend="gloo", warmup_mode="off"),
                           params=full, device="cpu")
    try:
        got = serve(core, tproto)
        stats = core.tp_stats()
    finally:
        core.close()
    assert got == want == ref and len(got) == 5 and all(len(s) >= 3 for s in got.values())
    sp = mesh["sp"]
    assert len(stats) == ranks and sorted(r["seq_rank"] for r in stats) == sorted(
        q for q in range(sp) for _ in range(ranks // sp))
    assert len({tuple(map(str, r["programs"])) for r in stats}) == 1
    ring = stats[0]["ring_steps"]
    assert ring == 2, stats[0]["programs"]
    layers = params[1]["layers"]["wq"].shape[0]
    assert all(r["ring_hops"] == ring * layers * (sp - 1) for r in stats)


def test_sp2_tp2_streams_equal_jax_and_sp1(tiny32):  # noqa: F811
    """Each seq rank's model group (two ranks, a kv head each) sums its own
    chunk's ``wo`` partials in a ring step."""
    mesh_case(tiny32, TINY32, dict(sp=2, tp=2), 4)
