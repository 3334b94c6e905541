"""The pp=2 engine at 4 microbatches a step against JAX's
``EngineCore(pp=2, pp_microbatches=4)`` and the port's pp=1
(tests/test_torch_pp_engine.py's case, in a file of its own so that each
file's engines stay few).
"""

from __future__ import annotations

from tests.test_torch_pp_engine import engine_case, port_pp1  # noqa: F401
from tests.test_torch_tp import tiny32  # noqa: F401


def test_pp2_streams_equal_jax_pp2_at_4_microbatches(tiny32, port_pp1):  # noqa: F811
    engine_case(tiny32, port_pp1, 4)
