"""The port's MoE engines with int8 weights across ranks against the JAX
package's ``EngineCore`` on the same mesh, as
``tests/test_torch_moe_parallel_engine.py`` holds the float ones:
identical greedy streams at f32. At tp = 2 on tiny-moe (its shared
expert quantized, the expert stacks not); at ep = 2 on tiny-moe without
its shared expert, where JAX serves int8 (with one, JAX's dropless
dispatch refuses the quantized shared expert, and the port refuses it by
name: ``tests/test_torch_moe_parallel_misc.py``)."""

from __future__ import annotations

import pytest

from tests.test_torch_moe_parallel_engine import engine_case, moe32  # noqa: F401


@pytest.mark.parametrize("mesh,shared,quantization", [
    (dict(tp=2), 1, "int8"),
    (dict(ep=2), 0, "int8"),
], ids=["tp2_int8", "ep2_int8_no_shared"])
def test_moe_int8_engine_streams_equal_jax_at_the_same_mesh(moe32, mesh,  # noqa: F811
                                                            shared, quantization):
    engine_case(moe32, mesh, shared, quantization)
