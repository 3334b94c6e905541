"""Pipeline-parallel engines at parity with one rank, on the CPU: fused
decode windows (W = 4) at pp=2 and dp=2 x pp=2 (four gloo ranks: two
replicas of two stages) give the streams of the port's pp=1 engine
(tiny-llama at f32 with bridged weights, tests/test_torch_tp.py's
``tiny32``), and every rank ran the schedule; a stage that fails fails
the leader.

Tolerance: identical greedy tokens.
"""

from __future__ import annotations

import pytest

from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.parallel.collectives import TPFailure
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _run
from tests.test_torch_pp_engine import _cfg, _port, _reqs, check_stages
from tests.test_torch_tp import TINY32, tiny32  # noqa: F401


@pytest.mark.parametrize("mesh", [dict(pp=2, decode_window=4), dict(dp=2, pp=2)],
                         ids=["window4", "dp2xpp2"])
def test_pp_engine_equals_pp1(tiny32, mesh):  # noqa: F811
    _, full = tiny32
    one = teng.EngineCore(TEngineConfig(**_cfg(TINY32, decode_window=mesh.get(
        "decode_window", 1))), params=full, device="cpu")
    want, _ = _run(one, _reqs(tproto))
    core = _port(full, **mesh)
    try:
        got, fin = _run(core, _reqs(tproto), pipelined=True)
        ranks = core.tp_stats()
    finally:
        core.close()
    assert fin == set(got) and got == want
    check_stages(ranks, dp=mesh.get("dp", 1))


def test_a_stage_that_fails_fails_the_leader_with_its_traceback(tiny32):  # noqa: F811
    """A later stage that raises (here on an op it does not know) sends
    its traceback and exits; the leader's next step raises at once, with
    the traceback and the exit code, instead of hanging in a hop; close
    still returns."""
    _, full = tiny32
    core = _port(full, pp=2)
    procs = list(core._tp_followers.procs)
    try:
        core.runner.tp.post("no-such-op")
        core.add_request(_reqs(tproto)[0])
        with pytest.raises(TPFailure, match=r"(?s)exit code 1.*no-such-op"):
            core.step()
    finally:
        core.close()
    assert not any(p.is_alive() for p in procs)
