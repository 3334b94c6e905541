"""An id past the vocabulary at tp=2 (ROADMAP Queue 3 item 12): JAX's
global embedding gather clamps it to the last row, and so must the port's
vocab-parallel lookup, whose ranks' pieces each miss it. tiny-llama at f32
with bridged weights (the tests/test_torch_tp.py setting), a prompt of ids
at, past and far past the vocabulary of 512: the port's tp=2 greedy
stream equals JAX's tp=2 engine's and the port's tp=1 stream, token for
token (f32: identical greedy streams)."""

from __future__ import annotations

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _run
from tests.test_torch_tp import TCFG, TINY32, _cfg, tiny32  # noqa: F401

PROMPT = [5, 511, 512, 600, 9000, 7, 513]


def _req(proto, prompt: list[int], rid: str, max_tokens: int):
    r = proto.PreprocessedRequest(
        token_ids=prompt,
        stop_conditions=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=proto.SamplingOptions(temperature=0.0))
    r.request_id = rid
    return r


def test_ids_past_the_vocabulary_embed_as_its_last_row_at_tp2(tiny32):  # noqa: F811
    jp, full = tiny32
    assert TCFG.vocab_size == 512
    kw = _cfg(TINY32)
    want, _ = _run(jeng.EngineCore(JEngineConfig(**kw, tp=2), params=jp),
                   [_req(jproto, PROMPT, "oov", 8)])
    core = teng.EngineCore(TEngineConfig(**kw, tp=2, dist_backend="gloo", warmup_mode="off"),
                           params=full, device="cpu")
    try:
        got, _ = _run(core, [_req(tproto, PROMPT, "oov", 8)], pipelined=True)
    finally:
        core.close()
    one, _ = _run(teng.EngineCore(TEngineConfig(**kw, warmup_mode="off"), params=full,
                                  device="cpu"), [_req(tproto, PROMPT, "oov", 8)])
    assert len(got["oov"]) == 8
    assert got == want
    assert got == one
