"""Shared by tests/test_torch_tp_programs_lazy*.py: a mesh's engine served
with ``warmup_mode`` lazy or off on the CPU (gloo, processes as ranks),
and the checks of the lazy engine against its off twin."""

from __future__ import annotations

import os

import pytest
import torch

from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.obs.compile_ledger import get_compile_ledger, get_compile_metrics
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _req, _run

SHAPE = dict(block_size=4, num_blocks=128, max_batch_size=4, max_model_len=64,
             prefill_chunk=32, decode_bucket=(4,), allow_random_weights=True)
#: prompt ids inside both models' vocabularies; the 40-token one rings at sp=2
PROMPTS = [[1, 5, 9, 20, 33], list(range(3, 43)), [7] * 11 + [100, 200, 250]]


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread on every rank (spawned followers read
    ``OMP_NUM_THREADS``): the tiny models' steps take milliseconds, and
    ranks that each take every core only contend."""
    env, n = os.environ.get("OMP_NUM_THREADS"), torch.get_num_threads()
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def serve(mesh: dict, mode: str) -> dict:
    """An engine of ``mesh`` at ``warmup_mode=mode``: its warmup summary,
    the coverage gauge before and after it served ``PROMPTS``, its streams
    and its ranks' stats. Closed before it returns (one tensor-parallel
    engine a process)."""
    led = get_compile_ledger()
    led.reset()
    core = teng.EngineCore(TEngineConfig(**SHAPE, **mesh, dist_backend="gloo",
                                         warmup_mode=mode), device="cpu")
    try:
        out = {"summary": core.warmup(), "gauge0": get_compile_metrics().warmup_coverage.get()}
        reqs = [_req(tproto, p, f"r{i}", 6) for i, p in enumerate(PROMPTS)]
        out["streams"], out["fin"] = _run(core, reqs, pipelined=True)
        out["gauge1"] = get_compile_metrics().warmup_coverage.get()
        out["coverage"] = led.coverage()
        out["ranks"] = core.tp_stats()
    finally:
        core.close()
        led.reset()
    return out


def lazy_and_off(name: str, mesh: dict):
    """The module fixture's body: the mesh served lazy, then off."""
    yield name, serve(mesh, "lazy"), serve(mesh, "off")
    get_compile_ledger().configure("lazy")


def check_serves_as_warmup_off(name: str, lazy: dict, off: dict) -> None:
    """The lazy engine served every prompt, as the off engine did, token
    for token; it reports eager programs on the CPU; every rank made the
    leader's programs in its order."""
    assert lazy["fin"] == set(lazy["streams"]) and all(lazy["streams"].values())
    assert lazy["streams"] == off["streams"], name
    s = lazy["summary"]
    assert s["mode"] == "lazy" and s["buckets"] > 0 and s["graphs"] is False
    assert "on the CPU" in s["graph_reason"]
    keys = [[k for k, _ in r["programs"]] for r in lazy["ranks"]]
    assert keys[0] and all(k == keys[0] for k in keys), name


def check_coverage_climbs(name: str, lazy: dict, off: dict) -> None:
    assert lazy["gauge0"] == 0.0 < lazy["gauge1"] == pytest.approx(lazy["coverage"]), name
    assert off["coverage"] == 0.0
