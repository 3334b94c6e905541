"""Fused decode windows at tp > 1, on the CPU: the port's tp=2 engine
(two gloo ranks) at ``decode_window=4``, every rank running the window's
four forwards on the leader's sampled tokens, against JAX's tp=2 engine
at ``decode_window=4`` on the conftest's fake devices (tiny-llama at f32
with bridged weights, the tests/test_torch_tp.py setting): identical
greedy streams.
"""

from __future__ import annotations

from tests.test_torch_tp import tiny32  # noqa: F401
from tests.test_torch_tp_parity_dp import streams_and_ranks


def test_window4_at_tp2_equals_jax_window4_at_tp2(tiny32):  # noqa: F811
    got, fin, ranks, want = streams_and_ranks(tiny32, dict(tp=2, decode_window=4))
    assert fin == set(got) and got == want
    assert [r["rank"] for r in ranks] == [0, 1]
    assert len({r["forward_steps"] for r in ranks}) == 1 and ranks[0]["forward_steps"] > 0
