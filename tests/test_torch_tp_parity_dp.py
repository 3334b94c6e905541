"""Data parallelism inside the engine, on the CPU: the port's engine as
gloo ranks (``dp=2``: two; ``dp=2, tp=2``: four, each data replica
attending its half of the batch rows) against JAX's engine of the same config on the
conftest's fake devices, tiny-llama at f32 with bridged weights (the
tests/test_torch_tp.py setting). Greedy streams must be identical; every
rank runs the same forward steps, and the data replica past the first
gathers no logits.
"""

from __future__ import annotations

import pytest

from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _run
from tests.test_torch_tp import TINY32, _cfg, _jax_streams, _reqs, tiny32  # noqa: F401


def streams_and_ranks(tiny32, setting: dict) -> tuple[dict, set, list, dict]:  # noqa: F811
    """The port's greedy streams of tests/test_torch_tp.py's requests at
    ``setting`` (pipelined), the finished ids, every rank's stats, and
    JAX's streams at the same setting."""
    jp, full = tiny32
    kw = _cfg(TINY32)
    core = teng.EngineCore(TEngineConfig(**kw, **setting, dist_backend="gloo",
                                         warmup_mode="off"), params=full, device="cpu")
    try:
        got, fin = _run(core, _reqs(tproto), pipelined=True)
        ranks = core.tp_stats()
    finally:
        core.close()
    return got, fin, ranks, _jax_streams(jp, **kw, **setting)


@pytest.mark.parametrize("setting", [dict(dp=2), dict(dp=2, tp=2)], ids=["dp2", "dp2-tp2"])
def test_streams_equal_jax_same_config(tiny32, setting):  # noqa: F811
    got, fin, ranks, want = streams_and_ranks(tiny32, setting)
    assert fin == set(got) and got == want
    n = setting.get("dp", 1) * setting.get("tp", 1)
    assert [r["rank"] for r in ranks] == list(range(n))
    assert len({r["forward_steps"] for r in ranks}) == 1 and ranks[0]["forward_steps"] > 0
    if setting.get("dp", 1) > 1:
        tp = setting.get("tp", 1)
        # replica 1 skips the logits' vocab gather: fewer collectives at tp > 1
        lead, other = ranks[0]["collectives"], ranks[tp]["collectives"]
        assert (other < lead) if tp > 1 else (other == lead)
        assert [r["data_rank"] for r in ranks] == [d for d in range(2) for _ in range(tp)]
