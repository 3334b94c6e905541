"""KV blocks across packages, on the CPU: ``export_blocks`` from a JAX
engine into a torch engine's ``import_blocks``, and from a torch engine
into a JAX engine's, at one kv dtype and across the model-precision cache
and int8 (tiny-llama at f32 with bridged weights, so the model-precision
cache is f32). The receiving engine prefills only the prompt's last block
and continues as the same package's engine of the same kv dtype does
after importing the same blocks; at one kv dtype, as the exporting engine
itself continued. Int4 crosses only from int4 content: its tokens are not
bf16's (ROADMAP, "Gaps in the reference").
"""

from __future__ import annotations

import pytest

from dynamo_tpu_torch.tokens import TokenBlockSequence

from tests.test_torch_kvbm import cores, proto_of, req, run, tiny32  # noqa: F401

PROMPT = [(17 * j + 5) % 500 for j in range(24)]  # 6 blocks of 4
HASHES = TokenBlockSequence.from_tokens(PROMPT, 4).sequence_hashes()


def _source(core) -> tuple[list[int], list]:
    """The exporting engine's own greedy stream of PROMPT, then the
    exported blocks of the prompt's chain, held over a pin (as a pending
    transfer holds them) that leaves the pool as it found it."""
    base = run(core, [req(proto_of(core), PROMPT, "src", 8)])["src"]
    free0 = core.pool.num_free
    pins = core.pin_blocks(HASHES)
    assert len(pins) == len(HASHES) and core.pool.num_free == free0 - len(HASHES)
    plan = core.export_blocks(HASHES)
    core.unpin_blocks(pins)
    assert core.pool.num_free == free0
    assert [h for h, _, _ in plan] == HASHES
    assert [p for _, p, _ in plan] == [None] + HASHES[:-1]
    return base, plan


def _receive(core, plan) -> dict:
    n = core.import_blocks(plan)
    pre = core.metrics.num_prefill_tokens
    out = run(core, [req(proto_of(core), PROMPT, "dst", 8)])["dst"]
    return {"imported": n, "tokens": out, "prefill": core.metrics.num_prefill_tokens - pre}


@pytest.mark.parametrize("src,dst", [("bfloat16", "bfloat16"), ("bfloat16", "int8"),
                                     ("int8", "bfloat16"), ("int8", "int8"),
                                     ("int4", "int4")])
def test_blocks_cross_jax_to_torch_and_back(tiny32, src, dst):
    kw = dict(num_blocks=64)
    jsrc, tsrc = cores(tiny32, **kw, kv_dtype=src)
    jbase, jplan = _source(jsrc)
    tbase, tplan = _source(tsrc)
    assert tbase == jbase
    # JAX → torch, held to JAX → JAX
    jdst, tdst = cores(tiny32, **kw, kv_dtype=dst)
    t_from_j, j_from_j = _receive(tdst, jplan), _receive(jdst, jplan)
    assert t_from_j == j_from_j
    # torch → JAX, held to torch → torch
    jdst, tdst = cores(tiny32, **kw, kv_dtype=dst)
    j_from_t, t_from_t = _receive(jdst, tplan), _receive(tdst, tplan)
    assert j_from_t == t_from_t
    for res in (t_from_j, j_from_t):
        # all 6 blocks import; admission matches 5 of them (the last prompt
        # token must be computed), so only the last block is prefilled
        assert res["imported"] == 6 and res["prefill"] == 4
        if src == dst:
            assert res["tokens"] == jbase
