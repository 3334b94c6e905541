"""The port's engine at sp=2 x ep=2 on tiny-moe, against the JAX package's ``EngineCore``
on the same mesh and the port at sp=1 (a case of
``tests/test_torch_sp_mesh.py``, which holds the requests, the reference
and the checks; a file of its own for time).

Tolerance: identical greedy streams (f32).
"""

from __future__ import annotations

from tests.test_torch_moe_parallel_engine import NAMES, moe32  # noqa: F401
from tests.test_torch_sp_mesh import mesh_case


def test_moe_sp2_ep2_streams_equal_jax_and_sp1(moe32):  # noqa: F811
    """tiny-moe with its shared expert: each seq rank's MoE group (its two
    expert ranks) sums the tokens of its own chunk in a ring step."""
    mesh_case(moe32[1], NAMES[1], dict(sp=2, ep=2), 4)
