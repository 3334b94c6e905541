"""The port's sp=2 engine with W=4 windows and with an int8 cache, each
behind ring prefills and over a host tier, against the JAX package's
``EngineCore(sp=2)`` on the CPU (tiny-llama at f32 with bridged weights:
``tests/test_torch_kvbm.py``'s ``tiny32``; seq ranks as gloo processes).

tests/test_kvbm.py's round trip (a prompt, fillers that evict it, the
prompt again) gives JAX sp=2's streams and counts; at f32 also the port's
sp=1 (W=1) streams. Over an int8 cache a ring prefill attends the raw K
and V, a chunked one the quantized cache (as in JAX), so there the oracle
is JAX's ring, not sp=1. Blocks move between the host tier and the seq
ranks' caches whole: extracted from seq rank 0's, injected into every
one's.

Tolerance: identical greedy streams.
"""

from __future__ import annotations

import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from tests.test_torch_kvbm import engine_kw, offload_onboard
from tests.test_torch_kvbm import tiny32  # noqa: F401
from tests.test_torch_sp_misc import _port, _rang


@pytest.mark.parametrize("kv", ["", "int8"])
def test_ring_then_windows_over_a_host_tier_match_jax(tiny32, kv):  # noqa: F811
    """Every prompt rings (threshold 1); at f32 the engine decodes in W=4
    windows. The round trip's streams, offloaded and onboarded blocks and
    re-prefilled tokens equal JAX sp=2's at the same settings; at f32 the
    streams also equal the port's sp=1 at W=1, and the prompt again equals
    the first time through the host tier."""
    kw = dict(sp=2, ring_prefill_threshold=1, num_blocks=13, kv_dtype=kv or "bfloat16",
              host_kv_blocks=64, decode_window=1 if kv else 4)
    jres = offload_onboard(jeng.EngineCore(JEngineConfig(**engine_kw(**kw)),
                                           params=tiny32[0]))
    core = _port(tiny32, **kw)
    try:
        tres = offload_onboard(core)
        rang = _rang(core)
        windows = [p.shape[3] for p in core.runner.programs.values()]
    finally:
        core.close()
    assert rang and tres == jres
    assert tres["offloaded"] > 0 and tres["onboarded"] > 0 and tres["second"] == tres["first"]
    if not kv:
        assert 4 in windows
        ref = offload_onboard(_port(tiny32, num_blocks=13, host_kv_blocks=64))
        assert (tres["first"], tres["second"]) == (ref["first"], ref["second"])
