"""The chaos harness's recovery scenarios on the port's mocker fleets: a
worker retired under load (its retained sessions evacuated to the KV
store process and resumed warm on the survivor) and a worker killed
mid-decode (its stream resumed from its stream checkpoint on a fresh
replica, token for token an unkilled control's). They are the two
scenarios whose fleets run the KV store (``FleetConfig(kv_store=True)``)
under a 3 s lease; ``slow`` stands where ``tests/test_chaos.py`` has it.
``tests/test_torch_chaos.py`` runs the harness's other scenarios.
"""

from __future__ import annotations

import os

import pytest

from dynamo_tpu import chaos as jchaos
from dynamo_tpu_torch import chaos as tchaos
from dynamo_tpu_torch.chaos.harness import run_scenario

pytestmark = pytest.mark.chaos


@pytest.fixture
def seed():
    """The chaos tests' seed (``DYN_CHAOS_SEED`` overrides it); both
    packages' in-process chaos engines are reset afterwards."""
    yield int(os.environ.get(tchaos.SEED_ENV, "42"))
    tchaos.reset()
    jchaos.reset()


def test_scenario_retire_under_load_smoke(seed):
    """Tier-1: a worker drained mid-traffic; no stream lost, its sessions
    resume warm on the survivor, the drain report says done."""
    res = run_scenario("retire_under_load_smoke", seed=seed)
    assert res.report.passed, res.report.failures
    assert res.report.details["streams"]["lost"] == 0
    assert res.report.details["warm_resume"]["session_remote_resumes"] >= 2


@pytest.mark.slow
def test_scenario_retire_under_load(seed):
    res = run_scenario("retire_under_load", seed=seed)
    assert res.report.passed, res.report.failures
    assert res.report.details["streams"]["lost"] == 0


def test_scenario_worker_kill_mid_decode_smoke(seed):
    """Tier-1: the only worker SIGKILLed mid-decode by ``mocker.step``; the
    stream resumes from its checkpoint on a fresh replica, token for token
    the unkilled control's, within one interval of recompute. The fresh
    replica registers after the model's last instance vanished: the
    frontend keeps the migrating stream's pipeline for it."""
    res = run_scenario("worker_kill_mid_decode_smoke", seed=seed)
    assert res.report.passed, res.report.failures
    assert res.report.details["streams"]["lost"] == 0
    assert res.report.details["ckpt_resume"]["stream_ckpt_resumes"] >= 1


@pytest.mark.slow
def test_scenario_worker_kill_mid_decode(seed):
    res = run_scenario("worker_kill_mid_decode", seed=seed)
    assert res.report.passed, res.report.failures
    assert res.report.details["streams"]["lost"] == 0
