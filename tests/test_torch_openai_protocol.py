"""The port's OpenAI API models (dataclasses with their own validation)
against the JAX package's pydantic models, and the port's preprocessor
against the JAX one.

Requests: each payload of a table, and of a hypothesis property over
JSON-shaped values, must be accepted or rejected alike, and an accepted
one must give equal values (``model_dump`` with and without
``exclude_none``). Responses: serialized JSON must be equal, with
non-finite floats as ``null``. Preprocessing: equal ``PreprocessedRequest``
wire dicts, ``guided_json``, stops and the XXH3 placeholder ids of image
spans included, on the byte tokenizer and on tiny-real-llama's BPE
vocabulary.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.preprocessor.preprocessor import ModelDefaults as JDefaults
from dynamo_tpu.preprocessor.preprocessor import OpenAIPreprocessor as JPre
from dynamo_tpu.protocols import openai as J
from dynamo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from dynamo_tpu.tokenizer import load_tokenizer as jload_tokenizer
from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults as TDefaults
from dynamo_tpu_torch.preprocessor.preprocessor import OpenAIPreprocessor as TPre
from dynamo_tpu_torch.protocols import openai as T
from dynamo_tpu_torch.protocols.sse import encode_sse_json
from dynamo_tpu_torch.tokenizer import ByteTokenizer as TByteTokenizer
from dynamo_tpu_torch.tokenizer import load_tokenizer as tload_tokenizer

CKPT = Path(__file__).resolve().parent / "data" / "tiny-real-llama"


def _same(a, b) -> bool:
    """Equality with NaN equal to NaN and int/float kept apart."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def both(cls: str, payload) -> tuple:
    out = []
    for mod in (J, T):
        try:
            m = getattr(mod, cls)(**payload)
        except (ValueError, TypeError):
            out.append(None)
            continue
        out.append((m.model_dump(), m.model_dump(exclude_none=True)))
    return tuple(out)


def check(cls: str, payload) -> bool:
    """Asserts the two packages agree on ``payload``; returns acceptance."""
    jres, tres = both(cls, payload)
    assert (jres is None) == (tres is None), (cls, payload, jres, tres)
    if jres is not None:
        assert _same(tres[0], jres[0]), (cls, payload, tres[0], jres[0])
        assert _same(tres[1], jres[1]), (cls, payload, tres[1], jres[1])
    return jres is not None


MSG = [{"role": "user", "content": "hi"}]
TABLE = [
    ("ChatCompletionRequest", {"model": "m", "messages": MSG}),
    ("ChatCompletionRequest", {"model": "m"}),
    ("ChatCompletionRequest", {"messages": MSG}),
    ("ChatCompletionRequest", {"model": 5, "messages": MSG}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "temperature": "0.5"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "temperature": "warm"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "n": "2"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "n": 2.0}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "n": 2.5}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "n": None}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "n": True}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "stream": "yes"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "stream": 2}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "stream": " true"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "user": 7}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "stop": "x"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "stop": ["x", "y"]}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "stop": ["x", 1]}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "logprobs": "1"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "top_logprobs": "3"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "tool_choice": "auto"}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "tool_choice": {"a": 1}}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "tool_choice": 1}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "tools": [{"type": "function"}]}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "tools": ["f"]}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "nvext": {"use_raw_prompt": "on"}}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "nvext": {"annotations": "x"}}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "nvext": 3}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "response_format":
                               {"type": "json_schema", "json_schema": {"schema": {}}}}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "extra": None, "deadline_ms": 5}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "self": 1, "_extra": 2,
                               "model_config": 3}),
    ("ChatCompletionRequest", {"model": "m", "messages": MSG, "stream_options": None,
                               "max_tokens": "16", "seed": -1, "top_k": 1e3}),
    ("ChatCompletionRequest", {"model": "m", "messages": [{"role": "user", "content": [
        {"type": "text", "text": "a"}, {"type": "image_url", "image_url": {"url": "x"}}]}]}),
    ("ChatCompletionRequest", {"model": "m", "messages": [{"role": "user", "content": ["a"]}]}),
    ("ChatCompletionRequest", {"model": "m", "messages": [{"content": "no role"}]}),
    ("ChatCompletionRequest", {"model": "m", "messages": [{"role": "tool", "content": None,
                                                          "tool_call_id": "c1", "x": None}]}),
    ("ChatCompletionRequest", {"model": "m", "messages": "hi"}),
    ("CompletionRequest", {"model": "m", "prompt": "text"}),
    ("CompletionRequest", {"model": "m", "prompt": ["a", "b"]}),
    ("CompletionRequest", {"model": "m", "prompt": [1, 2, 3]}),
    ("CompletionRequest", {"model": "m", "prompt": [1.0, "2", True]}),
    ("CompletionRequest", {"model": "m", "prompt": [[1, 2], [3]]}),
    ("CompletionRequest", {"model": "m", "prompt": [[1.5]]}),
    ("CompletionRequest", {"model": "m", "prompt": ["a", 1]}),
    ("CompletionRequest", {"model": "m", "prompt": []}),
    ("CompletionRequest", {"model": "m", "prompt": 7}),
    ("CompletionRequest", {"model": "m", "prompt": "x", "logprobs": "0", "echo": "false"}),
    ("CompletionRequest", {"model": "m", "prompt": "x", "logprobs": 0.5}),
    ("CompletionRequest", {"model": "m", "prompt": "x", "suffix": 1}),
    ("EmbeddingRequest", {"model": "m", "input": "x"}),
    ("EmbeddingRequest", {"model": "m", "input": [[1], [2, 3]], "encoding_format": "base64"}),
    ("EmbeddingRequest", {"model": "m", "input": "x", "encoding_format": "FLOAT"}),
    ("EmbeddingRequest", {"model": "m", "input": "x", "encoding_format": None}),
    ("EmbeddingRequest", {"model": "m", "input": "x", "dimensions": "4"}),
    ("EmbeddingRequest", {"model": "m", "input": {"a": 1}}),
    ("ResponsesRequest", {"model": "m", "input": "x", "unknown": 1}),
    ("ResponsesRequest", {"input": [{"role": "user", "content": "x"}], "stream": "0"}),
    ("ResponsesRequest", {"input": ["x"]}),
    ("ResponsesRequest", {"max_output_tokens": "12", "temperature": "1e-1"}),
]


@pytest.mark.parametrize("i", range(len(TABLE)))
def test_request_table_matches_pydantic(i):
    cls, payload = TABLE[i]
    check(cls, payload)


# JSON-shaped values, weighted to the edges of lax coercion
_NUM_STRS = ["2", " 2 ", "2.0", "2.5", "1_000", "+3", "-0", "1e3", "0.5", ".5", "1.",
             "inf", "-Infinity", "nan", "true", "False", "yes", "off", "t", "1", "0",
             "", "abc", "0x10", "1__0", "２"]
_scalar = st.one_of(
    st.none(), st.booleans(), st.integers(-5, 5), st.integers(-2 ** 70, 2 ** 70),
    st.floats(allow_nan=True, allow_infinity=True), st.sampled_from([0.0, 1.0, 2.0, -1.0, 1e19]),
    st.sampled_from(_NUM_STRS), st.text(max_size=6))
_json = st.recursive(_scalar, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(st.text(max_size=4), inner, max_size=3)),
    max_leaves=8)
_message = st.fixed_dictionaries({"role": st.one_of(st.just("user"), _scalar)},
                                 optional={"content": _json, "name": _json,
                                           "tool_calls": _json, "tool_call_id": _json})
_FIELDS = {
    "ChatCompletionRequest": dict(J.ChatCompletionRequest.model_fields),
    "CompletionRequest": dict(J.CompletionRequest.model_fields),
    "EmbeddingRequest": dict(J.EmbeddingRequest.model_fields),
    "ResponsesRequest": dict(J.ResponsesRequest.model_fields),
}


@st.composite
def _payload(draw, cls):
    out = {}
    for name in _FIELDS[cls]:
        if name == "model" and draw(st.booleans()):
            out[name] = "m"
        elif name == "messages" and draw(st.booleans()):
            out[name] = draw(st.lists(_message, max_size=2))
        elif name in ("prompt", "input") and draw(st.booleans()):
            out[name] = draw(st.one_of(
                st.text(max_size=4), st.lists(st.integers(0, 9), max_size=3),
                st.lists(st.one_of(st.integers(0, 9), st.floats(0, 9), st.sampled_from(_NUM_STRS),
                                   st.text(max_size=2)), max_size=3),
                st.lists(st.lists(st.one_of(st.integers(0, 9), st.floats(0, 9)), max_size=2),
                         max_size=2)))
        elif draw(st.integers(0, 3)) == 0:
            out[name] = draw(_json)
    for k, v in draw(st.dictionaries(st.sampled_from(["extra", "x_y", "deadline_ms"]), _json,
                                     max_size=2)).items():
        out[k] = v
    return out


@pytest.mark.parametrize("cls", list(_FIELDS))
@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck))
@given(data=st.data())
def test_requests_accept_and_coerce_like_pydantic(cls, data):
    check(cls, data.draw(_payload(cls)))


def test_table_has_both_outcomes():
    outcomes = {check(cls, p) for cls, p in TABLE}
    assert outcomes == {True, False}


# ---------------------------------------------------------------------------
# Responses
# ---------------------------------------------------------------------------

def _responses(mod):
    lp = {"content": [{"token": "a", "logprob": float("-inf"), "bytes": [97],
                       "top_logprobs": []},
                      {"token": "é", "logprob": -1e-7, "bytes": [195, 169], "top_logprobs": []},
                      {"token": "b", "logprob": float("nan"), "x": None}]}
    msg = mod.ChatMessage(role="assistant", content="héllo ", tool_calls=None,
                          reasoning_content="why")
    return [
        mod.ChatCompletionResponse(id="c", created=1, model="m", choices=[
            mod.ChatChoice(message=msg, finish_reason="stop", logprobs=lp)],
            usage=mod.Usage(prompt_tokens=3, completion_tokens=2, total_tokens=5)),
        mod.ChatCompletionChunk(id="c", created=1, model="m", choices=[mod.ChatChunkChoice(
            delta=mod.ChatChoiceDelta(content="x"), logprobs=lp)]),
        mod.ChatCompletionChunk(id="c", created=1, model="m", choices=[], usage=mod.Usage()),
        mod.CompletionResponse(id="c", created=1, model="m", choices=[mod.CompletionChoice(
            text="t", logprobs={"tokens": ["t"], "token_logprobs": [float("-inf")],
                                "text_offset": [0], "top_logprobs": None})]),
        mod.EmbeddingResponse(model="m", data=[mod.EmbeddingData(index=0, embedding=[
            0.5, float("inf"), 1e-45]), mod.EmbeddingData(index=1, embedding="AAAA")]),
        mod.ResponsesResponse(id="r", created_at=1, model="m", output=[mod.ResponseMessage(
            id="msg", content=[mod.ResponseOutputText(text="hi")])],
            usage=mod.ResponsesUsage(input_tokens=1, output_tokens=2, total_tokens=3)),
        mod.ModelList(data=[mod.ModelInfo(id="m", created=1)]),
        mod.ErrorResponse(error=mod.ErrorInfo(message="bad", code=400)),
    ]


@pytest.mark.parametrize("i", range(8))
@pytest.mark.parametrize("exclude_none", [False, True])
def test_responses_serialize_like_pydantic(i, exclude_none):
    j, t = _responses(J)[i], _responses(T)[i]
    jtext, ttext = (m.model_dump_json(exclude_none=exclude_none) for m in (j, t))
    assert "Infinity" not in ttext and "NaN" not in ttext
    assert json.loads(ttext) == json.loads(jtext)
    assert _same(t.model_dump(exclude_none=exclude_none), j.model_dump(exclude_none=exclude_none))
    assert json.loads(encode_sse_json(t)[6:]) == json.loads(jtext if exclude_none else
                                                            j.model_dump_json(exclude_none=True))


def test_extra_fields_read_back_and_dump():
    t = T.ChatCompletionRequest(model="m", messages=MSG, session_id="s", stop_list=1)
    j = J.ChatCompletionRequest(model="m", messages=MSG, session_id="s", stop_list=1)
    assert t.session_id == j.session_id == "s"
    assert t.stop_list() == j.stop_list() == []  # an extra never shadows a method
    assert t.model_dump(exclude_none=True) == j.model_dump(exclude_none=True)
    with pytest.raises(AttributeError):
        T.ResponsesRequest(extra=1).extra  # noqa: B018 - extra="ignore" drops it


# ---------------------------------------------------------------------------
# The preprocessor twin
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["byte", "bpe"])
def preprocessors(request):
    if request.param == "byte":
        jt, tt = JByteTokenizer(), TByteTokenizer()
    else:
        jt, tt = jload_tokenizer(str(CKPT)), tload_tokenizer(str(CKPT))
    mk = lambda cls, d, tok: cls("m", tok, d(max_model_len=300, default_max_tokens=40,  # noqa: E731
                                             temperature=0.7))
    return mk(JPre, JDefaults, jt), mk(TPre, TDefaults, tt)


def _image(rows: int, width: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, width)).astype(np.float32)


CHATS = [
    dict(messages=[{"role": "user", "content": "hello there"}]),
    dict(messages=[{"role": "system", "content": "be terse"}, {"role": "user", "content": "x"}],
         max_completion_tokens=7, stop=["\n\n", "END"], top_p=0.9, seed=4, n=2,
         response_format={"type": "json_object"}, ignore_eos=True, min_tokens=2),
    dict(messages=[{"role": "user", "content": "q"}], tools=[{"type": "function"}],
         response_format={"type": "json_schema", "json_schema": {"schema": {
             "type": "object", "properties": {"a": {"type": "boolean"}}, "required": ["a"]}}},
         max_tokens=1000),
    dict(messages=[{"role": "user", "content": "raw prompt"}],
         nvext={"use_raw_prompt": True, "annotations": ["formatted_prompt"]}),
    dict(messages=[{"role": "user", "content": [{"type": "text", "text": "a ␟IMG␟ b"}]}],
         response_format={"type": "text"}, frequency_penalty=0.5, presence_penalty=0.1),
]
# image rows x width: byte lengths across XXH3's size classes (4 B ... 4 KiB+)
IMAGE_SHAPES = [(1, 1), (1, 4), (2, 16), (1, 60), (1, 61), (4, 64), (3, 500)]


@pytest.mark.parametrize("i", range(len(CHATS)))
def test_preprocess_chat_matches_jax(preprocessors, i):
    jp, tp = preprocessors
    jr = jp.preprocess_chat(J.ChatCompletionRequest(model="m", **CHATS[i]), "rid")
    tr = tp.preprocess_chat(T.ChatCompletionRequest(model="m", **CHATS[i]), "rid")
    assert tr.to_dict() == jr.to_dict()


@pytest.mark.parametrize("shape", IMAGE_SHAPES)
def test_preprocess_image_spans_match_jax(preprocessors, shape):
    """Two images in one message (and text around them): the spans' rows,
    positions and XXH3 placeholder ids equal JAX's (xxhash)."""
    jp, tp = preprocessors
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "first ␟IMG␟"}, {"type": "image_url", "image_url": {"url": "d"}},
        {"type": "text", "text": " then"}, {"type": "image_url", "image_url": {"url": "d"}}]},
        {"role": "user", "content": "and text"}]
    imgs = [_image(*shape, seed=1), _image(*shape, seed=2)]
    jr = jp.preprocess_chat(J.ChatCompletionRequest(model="m", messages=msgs), "rid",
                            images=imgs)
    tr = tp.preprocess_chat(T.ChatCompletionRequest(model="m", messages=msgs), "rid",
                            images=imgs)
    assert tr.to_dict() == jr.to_dict()
    assert [s["pos"] for s in tr.mm_embeddings] == [s["pos"] for s in jr.mm_embeddings]
    for bad in ([], imgs[:1]):
        msg = {}
        for pre, mod in ((jp, J), (tp, T)):
            with pytest.raises(ValueError) as e:
                pre.preprocess_chat(mod.ChatCompletionRequest(model="m", messages=msgs), "r",
                                    images=bad)
            msg[mod] = str(e.value)
        assert msg[T] == msg[J]


@pytest.mark.parametrize("prompt", ["once upon", ["a", "b"], [5, 6, 7], [[1, 2]]])
def test_preprocess_completion_matches_jax(preprocessors, prompt):
    jp, tp = preprocessors
    kw = dict(model="m", prompt=prompt, max_tokens=12, stop="zz", logprobs=0, seed=1)
    jr = jp.preprocess_completion(J.CompletionRequest(**kw), "rid")
    tr = tp.preprocess_completion(T.CompletionRequest(**kw), "rid")
    assert tr.to_dict() == jr.to_dict()
