"""The KVBM tiers and stream checkpoints of a tensor-parallel engine, on
the CPU: the port's tp=2 engine (two gloo ranks) against JAX's
tp=2 engine on the conftest's fake devices, tiny-llama at f32 with bridged
weights (tests/test_torch_kvbm.tiny32). The port's leader moves whole
blocks through its ranks (``kvbm/transfer.TPTransferEngine``) and decides
what tests/test_torch_kvbm.py and test_torch_stream_ckpt.py hold at tp=1
(sessions: tests/test_torch_tp_parity_session.py): every stream, count and record
must equal JAX's (records but their ``ts``).
"""

from __future__ import annotations

import contextlib

import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.kvbm import remote as jremote
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.kvbm import remote as tremote
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_kvbm import engine_kw, offload_onboard, tiny32  # noqa: F401
from tests.test_torch_kvbm_remote import StoreFixture
from tests.test_torch_stream_ckpt import _checkpointed_run


def tp2_core(params, side: int, **kw):
    """JAX's (side 0) or the port's (side 1) EngineCore at tp=2."""
    if side == 0:
        return jeng.EngineCore(JEngineConfig(**engine_kw(**kw), tp=2), params=params[0])
    return teng.EngineCore(TEngineConfig(**engine_kw(**kw), tp=2, dist_backend="gloo",
                                         warmup_mode="off"), params=params[1], device="cpu")


@contextlib.contextmanager
def tp2_cores(params, **kw):
    """(JAX EngineCore, torch EngineCore) at tp=2 of one config and
    weights; the port's followers stop on exit."""
    jcore, tcore = tp2_core(params, 0, **kw), tp2_core(params, 1, **kw)
    try:
        yield jcore, tcore
    finally:
        tcore.close()


def tp1_cores(params, **kw):
    return (jeng.EngineCore(JEngineConfig(**engine_kw(**kw)), params=params[0]),
            teng.EngineCore(TEngineConfig(**engine_kw(**kw)), params=params[1], device="cpu"))


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_offload_onboard_tp2_matches_jax_tp2(tiny32, kv):  # noqa: F811
    """A prompt's blocks evicted to the host tier by fillers and onboarded
    for the prompt again: JAX tp=2's streams, offloaded and onboarded
    counts and prefill tokens; the tier holds whole blocks (every kv
    head), and the second run equals the first."""
    with tp2_cores(tiny32, num_blocks=13, kv_dtype=kv, host_kv_blocks=64) as (jcore, tcore):
        jres, tres = offload_onboard(jcore), offload_onboard(tcore)
        host = tcore.kvbm.tiers[0]
        assert host.spec.num_kv_heads == 2 and tcore.runner.spec.num_kv_heads == 1
        moved = tcore.kvbm.transfer.stats.snapshot()
    assert tres == jres
    assert tres["offloaded"] > 0 and tres["onboarded"] > 0 and tres["second"] == tres["first"]
    assert moved["gather_bytes"] > 0 and moved["scatter_bytes"] > 0


def test_stream_ckpt_tp2_matches_jax_tp2(tiny32):  # noqa: F811
    """stream_ckpt_blocks=1 with the global prefix cache on: the tp=2
    engines write the same records (the blocks gathered from both ranks
    reach the store before each record) and reap them at the end, with
    equal streams."""
    res = []
    stores = [StoreFixture(jremote), StoreFixture(tremote)]
    try:
        for side, store in enumerate(stores):
            kw = dict(num_blocks=32, remote_kv_addr=store.addr, stream_ckpt_blocks=1,
                      global_prefix_cache=True)
            core = tp2_core(tiny32, side, **kw)
            try:
                res.append(_checkpointed_run(core, store.addr, "ck1", f"{side + 7:032x}",
                                             seed=1234))
                published = core.kvbm.stats.published_blocks
            finally:
                if side:
                    core.close()
    finally:
        for s in stores:
            s.close()
    jres, tres = res
    assert tres == jres
    assert tres["records"] and tres["ordered"] and tres["reaped"] and published > 0
