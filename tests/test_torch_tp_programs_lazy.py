"""``warmup_mode="lazy"`` at more than one rank, on the CPU (gloo,
processes as ranks), at dp=2 x tp=2 and pp=2 (sp=2 and ep=2:
tests/test_torch_tp_programs_lazy_sp_ep.py): the engine builds and serves,
its greedy streams equal the same mesh's ``warmup_mode="off"`` streams
token for token (the same programs on the same random weights from the
seed: exact at any dtype), every rank made the leader's programs in its
order, and the compile ledger's coverage gauge climbs from 0 as serving
makes programs. Each mesh's two engines are built one after the other
(one tensor-parallel engine a process), once for the module.
"""

from __future__ import annotations

import pytest

from tests import torch_tp_programs as tpp
from tests.torch_tp_programs import one_thread  # noqa: F401

MESHES = {"dp2-tp2": dict(model="tiny-llama", dp=2, tp=2),
          "pp2": dict(model="tiny-llama", pp=2)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def lazy_and_off(request, one_thread):  # noqa: F811
    yield from tpp.lazy_and_off(request.param, MESHES[request.param])


def test_lazy_at_more_than_one_rank_serves_as_warmup_off(lazy_and_off):
    name, lazy, off = lazy_and_off
    tpp.check_serves_as_warmup_off(name, lazy, off)
    assert len(lazy["ranks"]) == (4 if name == "dp2-tp2" else 2)
    if name == "pp2":   # each stage ran its half of the layers
        assert [r["layers"] for r in lazy["ranks"]] == [[0, 1], [1, 2]]


def test_lazy_coverage_gauge_climbs(lazy_and_off):
    tpp.check_coverage_climbs(*lazy_and_off)
