"""Sessions of a tensor-parallel engine, on the CPU: the port's tp=2
engine (two gloo ranks) against JAX's tp=2 engine on the conftest's fake
devices, tiny-llama at f32 with bridged weights — tests/test_torch_session.py's
demotion to the host tier and evacuation to the remote store, the chains
moved as whole blocks through the ranks (``kvbm/transfer.TPTransferEngine``).
Streams, counts and resumes must equal JAX's.
"""

from __future__ import annotations

from dynamo_tpu.kvbm import remote as jremote
from dynamo_tpu_torch.kvbm import remote as tremote
from tests.test_torch_kvbm import tiny32  # noqa: F401
from tests.test_torch_kvbm_remote import StoreFixture
from tests.test_torch_session import _demote, _evacuate
from tests.test_torch_tp_parity_kvbm import tp1_cores, tp2_core, tp2_cores


def test_sessions_tp2_match_jax_tp2(tiny32):  # noqa: F811
    """An expired session's chain demoted to the host tier through the
    ranks and re-imported for turn 2 after the device copies are evicted
    (equal to a cold recompute); then a retained turn evacuated to the
    remote store by a tp=2 engine resumes on a tp=1 engine of the same
    store. Both as JAX's tp=2 engine does."""
    kw = dict(num_blocks=64, max_batch_size=2, max_model_len=128, session_ttl=0.01,
              session_tiers=True, host_kv_blocks=32)
    cold_kw = dict(num_blocks=64, max_batch_size=2, max_model_len=128)
    with tp2_cores(tiny32, **kw) as (jcore, tcore):
        jcold, tcold = tp1_cores(tiny32, **cold_kw)
        tres, jres = _demote(tcore, tcold), _demote(jcore, jcold)
    assert tres == jres
    assert tres["staged"] > 0 and tres["onboarded"] > 0 and tres["out2"] == tres["cold"]
    res = []
    for side, mod in enumerate((jremote, tremote)):
        store = StoreFixture(mod)
        try:
            kw = dict(num_blocks=64, max_batch_size=2, max_model_len=128, session_ttl=600.0,
                      remote_kv_addr=store.addr)
            first = tp2_core(tiny32, side, **kw)
            try:
                second = tp1_cores(tiny32, **kw)[side]
                res.append(_evacuate([first, second], tp1_cores(tiny32, **cold_kw)[side]))
            finally:
                if side:
                    first.close()
        finally:
            store.close()
    jres, tres = res
    assert tres == jres
    assert tres["evacuated"]["sessions"] == 1 and tres["remote_resumes"] == 1
    assert tres["out2"] == tres["cold"] and tres["free_back"]
