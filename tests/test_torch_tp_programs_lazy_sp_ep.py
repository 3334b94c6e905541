"""``warmup_mode="lazy"`` at sp=2 (a ring prefill step included) and ep=2
(tiny-moe), on the CPU: as tests/test_torch_tp_programs_lazy.py holds
dp=2 x tp=2 and pp=2, the engine builds and serves, its greedy streams
equal the same mesh's ``warmup_mode="off"`` streams, every rank made the
leader's programs in its order, and the coverage gauge climbs from 0.
"""

from __future__ import annotations

import pytest

from tests import torch_tp_programs as tpp
from tests.torch_tp_programs import one_thread  # noqa: F401

MESHES = {"sp2": dict(model="tiny-llama", sp=2, ring_prefill_threshold=32),
          "ep2": dict(model="tiny-moe", ep=2)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def lazy_and_off(request, one_thread):  # noqa: F811
    yield from tpp.lazy_and_off(request.param, MESHES[request.param])


def test_lazy_at_more_than_one_rank_serves_as_warmup_off(lazy_and_off):
    name, lazy, off = lazy_and_off
    tpp.check_serves_as_warmup_off(name, lazy, off)
    assert len(lazy["ranks"]) == 2
    if name == "sp2":   # a ring step was made and run on both seq ranks
        assert all(r["ring_steps"] > 0 for r in lazy["ranks"])
    else:               # each expert rank holds half the experts
        assert [r["local_experts"] for r in lazy["ranks"]] == [4, 4]


def test_lazy_coverage_gauge_climbs(lazy_and_off):
    tpp.check_coverage_climbs(*lazy_and_off)
