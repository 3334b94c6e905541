"""The port's engine at sp=4, against the JAX package's ``EngineCore``
on the same mesh and the port at sp=1 (a case of
``tests/test_torch_sp_mesh.py``, which holds the requests, the reference
and the checks; a file of its own for time).

Tolerance: identical greedy streams (f32).
"""

from __future__ import annotations

from tests.test_torch_sp_mesh import mesh_case
from tests.test_torch_tp import TINY32, tiny32  # noqa: F401


def test_sp4_streams_equal_jax_and_sp1(tiny32):  # noqa: F811
    """Four seq ranks: three hops a layer of each ring step, the chunk of
    a 32-token bucket 8 positions a rank."""
    mesh_case(tiny32, TINY32, dict(sp=4), 4)
