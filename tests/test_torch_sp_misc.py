"""The port's sp=2 engine's ring thresholds against the JAX package's
``EngineCore(sp=2)`` on the CPU (tiny-llama at f32
with bridged weights: ``tests/test_torch_kvbm.py``'s ``tiny32``; seq ranks
as gloo processes). Windows, an int8 cache and a host tier at sp=2 are in
``tests/test_torch_sp_kvbm.py``, the launcher and the worker in
``tests/test_torch_sp_launch.py``.

``ring_prefill_threshold``: the value each engine engages (0 = the cost
model's break-even on the CPU row, equal to JAX's; -1 = none) and the
raised ``prefill_chunk`` / ``max_tokens_per_step``; a prompt below it
bypasses the ring, and at -1 no ring counter moves and the stream is
sp=1's (identical greedy tokens).
"""

from __future__ import annotations

import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.obs.ring_prefill import get_ring_prefill_metrics
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_kvbm import engine_kw, proto_of, req, run
from tests.test_torch_kvbm import tiny32  # noqa: F401


def _port(tiny32, **kw):  # noqa: F811
    extra = dict(dist_backend="gloo", warmup_mode="off") if kw.get("sp", 1) > 1 else {}
    return teng.EngineCore(TEngineConfig(**engine_kw(**kw), **extra), params=tiny32[1],
                           device="cpu")


def _counts() -> tuple:
    rpm = get_ring_prefill_metrics()
    return rpm.invocations.get(), rpm.tokens.get(), rpm.bypassed.get()


def _rang(core) -> bool:
    return any(p.sp_prefill for p in core.runner.programs.values())


@pytest.mark.parametrize("threshold", [0, 1000, -1])
def test_threshold_resolves_and_gates_as_jax(tiny32, threshold):  # noqa: F811
    """The engaged threshold and the raised chunk limits equal JAX's
    (``max_model_len=1024``: the CPU row's break-even for tiny-llama is
    below it); a 32-token prompt is bypassed below the threshold and moves
    nothing at -1, where its stream is sp=1's; no ring program is made."""
    kw = dict(sp=2, ring_prefill_threshold=threshold, max_model_len=1024)
    jcore = jeng.EngineCore(JEngineConfig(**engine_kw(**kw)), params=tiny32[0])
    prompt = list(range(40, 72))
    one = _port(tiny32, max_model_len=1024)
    core = _port(tiny32, **kw)
    try:
        want = jcore.runner.ring_threshold
        assert core.runner.ring_threshold == want
        if threshold == 0:
            assert 32 < want < 1024 and want % 4 == 0
            assert get_ring_prefill_metrics().threshold_tokens.get() == want
        else:
            assert want == (None if threshold < 0 else threshold)
        for key in ("prefill_chunk", "max_tokens_per_step"):
            assert getattr(core.engine_cfg, key) == getattr(jcore.engine_cfg, key)
        before = _counts()
        got = run(core, [req(proto_of(core), prompt, "p", 4)])
    finally:
        core.close()
    after = _counts()
    assert not _rang(core)
    if threshold < 0:
        assert after == before
        assert got == run(one, [req(proto_of(one), prompt, "p", 4)])
    else:
        assert after[:2] == before[:2] and after[2] == before[2] + 1
