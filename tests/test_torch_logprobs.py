"""The port's logprob analysis (``dynamo_tpu_torch/utils/logprob_analysis.py``)
against the JAX package's: ``tests/test_logprobs.py``'s analysis cases run
on the port's functions, and the same responses (chat, chat streams,
completions, engine outputs, recorded files) give equal ``SequenceStats``
and summaries.
"""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest

import tests.test_logprobs as jtests
from dynamo_tpu.utils import logprob_analysis as jla
from dynamo_tpu_torch.protocols.common import LLMEngineOutput
from dynamo_tpu_torch.utils import logprob_analysis as tla

NAMES = ("SequenceStats", "analyze_recording", "from_chat_response", "from_chat_stream",
         "from_completion_response", "from_engine_outputs")


def rebind(fn):
    g = dict(fn.__globals__)
    g.update({n: getattr(tla, n) for n in NAMES})
    g["LLMEngineOutput"] = LLMEngineOutput
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)


@pytest.mark.parametrize("case", ["test_sequence_stats", "test_window_perplexity_localizes_spike",
                                  "test_from_stream_and_completion_and_engine",
                                  "test_analyze_recording"])
def test_jax_case_on_the_port(case, tmp_path):
    fn = rebind(getattr(jtests, case))
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()


def responses(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        lps = [float(x) for x in -rng.exponential(1.0, int(rng.integers(0, 40)))]
        out.append({"id": f"c{i}", "object": "chat.completion", "choices": [{
            "logprobs": {"content": [{"token": f"t{j}", "logprob": lp}
                                     for j, lp in enumerate(lps)]}}]})
        toks = [f"w{j}" for j in range(len(lps))]
        tl = [None if j % 7 == 3 else lp for j, lp in enumerate(lps)]
        out.append({"id": f"x{i}", "object": "text_completion", "choices": [{
            "logprobs": {"tokens": toks, "token_logprobs": tl,
                         "text_offset": list(range(len(toks)))}}]})
    return out


def stats_dict(s) -> dict:
    return {"request_id": s.request_id, "tokens": [dataclasses.asdict(t) for t in s.tokens],
            "summary": s.summary(), "window": s.window_perplexity(window=4),
            "low": [dataclasses.asdict(t) for t in s.low_confidence(threshold=-2.0)]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_responses_give_equal_stats(seed, tmp_path):
    resps = responses(seed)
    for r in resps:
        fn = "from_chat_response" if r["object"] == "chat.completion" else "from_completion_response"
        assert stats_dict(getattr(tla, fn)(r, "rid")) == stats_dict(getattr(jla, fn)(r, "rid"))
    chats = [r for r in resps if r["object"] == "chat.completion"]
    assert stats_dict(tla.from_chat_stream(chats)) == stats_dict(jla.from_chat_stream(chats))
    outs = [types.SimpleNamespace(log_probs=[-0.1 * k for k in range(n)]) for n in (0, 3, 5)]
    assert stats_dict(tla.from_engine_outputs(outs, "e")) == stats_dict(
        jla.from_engine_outputs(outs, "e"))
    path = tmp_path / "rec.jsonl"
    path.write_text("\n".join(json.dumps({"t": 0.0, "payload": r}) for r in resps) + "\n")
    assert tla.analyze_recording(str(path)) == jla.analyze_recording(str(path))
