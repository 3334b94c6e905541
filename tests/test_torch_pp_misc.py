"""The port's pipeline-parallel engine around its streams, on the CPU
(two gloo stages): seeded sampling against the port's pp=1, embeddings
against JAX's ``EngineCore(pp=2)``, a multimodal request answered with
JAX's error and int8 weights against JAX's pp=2 (tiny-llama at f32 with
bridged weights, tests/test_torch_tp.py's ``tiny32``). The launcher's and
the worker's ``--pp`` are in tests/test_torch_pp_launch.py.

Tolerances, with their reasons:
- streams: identical tokens (sampling draws from the leader's state,
  which pp does not touch);
- embeddings: 1e-4, as the forward (tests/test_torch_pp.py), one input a
  call (JAX's batched embedding shares one block table between rows).
"""

from __future__ import annotations

import numpy as np

from dynamo_tpu.protocols import common as jproto
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.protocols import common as tproto
from tests.test_torch_engine import _req, _run
from tests.test_torch_pp_engine import DECODE_ROWS, _jax, _port, _reqs
from tests.test_torch_tp import TCFG, tiny32  # noqa: F401


def test_pp2_sampling_embeddings_and_multimodal(tiny32):  # noqa: F811
    """On one pp=2 engine: seeded sampling gives the port's pp=1 streams;
    embeddings equal JAX's pp=2 engine's; a multimodal request is answered
    with JAX's error, and nothing of it is scheduled."""
    jp, full = tiny32
    so = dict(temperature=0.8, top_p=0.9, seed=11)
    sampled = [_req(tproto, list(range(20, 30)), "s", 8, **so),
               _req(tproto, DECODE_ROWS[1], "t", 8, temperature=0.7, seed=3)]
    one, _ = _run(_port(full), sampled)
    inputs = [list(range(1, 12)), [5, 9, 13] * 7]
    jcore = _jax(jp, pp=2)
    core = _port(full, pp=2)
    try:
        got, _ = _run(core, [_req(tproto, r.token_ids, r.request_id, 8, **(
            so if r.request_id == "s" else dict(temperature=0.7, seed=3))) for r in sampled])
        emb = [core.embed([x]) for x in inputs]
        mm = _req(tproto, list(range(1, 9)), "mm", 4)
        mm.mm_embeddings = [{"pos": 2, **tproto.tensor_to_wire(
            np.zeros((3, TCFG.hidden_size), np.float32))}]
        out = core.add_request(mm)
        assert not core.has_work()
    finally:
        core.close()
    assert got == one and len(got["s"]) == 8
    for x, e in zip(inputs, emb):
        np.testing.assert_allclose(e, jcore.embed([x]), atol=1e-4, rtol=1e-4)
    jmm = _req(jproto, list(range(1, 9)), "mm", 4)
    jmm.mm_embeddings = mm.mm_embeddings
    jout = jcore.add_request(jmm)
    assert out.error == jout.error and "pp=1" in out.error
    assert str(out.finish_reason) == str(jout.finish_reason)


def test_int8_weights_at_pp2_equal_jax_pp2_and_repeat(tiny32):  # noqa: F811
    """int8 weights at pp=2 (each stage quantizes its layers; stage 0 the
    embeddings): the port's streams equal JAX's int8 EngineCore(pp=2), and
    the same requests again on the same engine (prefix caching off) give
    the same streams."""
    jp, full = tiny32
    kw = dict(quantization="int8", enable_prefix_caching=False)
    core = _port(full, pp=2, **kw)
    try:
        first, _ = _run(core, _reqs(tproto, "a"))
        again, _ = _run(core, _reqs(tproto, "b"))
        ranks = core.tp_stats()
    finally:
        core.close()
    assert list(first.values()) == list(again.values())
    want, _ = _run(_jax(jp, pp=2, **kw), _reqs(jproto, "a"))
    assert first == want
    assert all(r["layer_bytes"] < tq.param_bytes(full["layers"]) // 2 for r in ranks)
