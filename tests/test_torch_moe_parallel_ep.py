"""The port's MoE engine at tp = 2 x ep = 2 (four gloo processes on the
CPU: the dropless dispatch over experts and width) against the JAX
package's ``EngineCore`` on the same mesh, as
``tests/test_torch_moe_parallel_engine.py`` holds tp = 2 and ep = 2:
identical greedy streams at f32."""

from __future__ import annotations

import pytest

from tests.test_torch_moe_parallel_engine import engine_case, moe32  # noqa: F401


@pytest.mark.parametrize("mesh,shared,quantization", [
    (dict(tp=2, ep=2), 1, "none"),
], ids=["tp2_ep2"])
def test_moe_engine_streams_equal_jax_across_model_and_expert(moe32, mesh,  # noqa: F811
                                                              shared, quantization):
    engine_case(moe32, mesh, shared, quantization)
