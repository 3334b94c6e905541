"""The port's engine at sp=2 x dp=2, against the JAX package's ``EngineCore``
on the same mesh and the port at sp=1 (a case of
``tests/test_torch_sp_mesh.py``, which holds the requests, the reference
and the checks; a file of its own for time).

Tolerance: identical greedy streams (f32).
"""

from __future__ import annotations

from tests.test_torch_sp_mesh import mesh_case
from tests.test_torch_tp import TINY32, tiny32  # noqa: F401


def test_sp2_dp2_streams_equal_jax_and_sp1(tiny32):  # noqa: F811
    """Two data replicas of two seq ranks: each replica rings the whole
    batch over its own seq group (JAX shards the batch over "data"; the
    port's replicas attend every row, as at tp = 1)."""
    mesh_case(tiny32, TINY32, dict(sp=2, dp=2), 4)
