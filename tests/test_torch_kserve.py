"""The port's KServe v2 REST routes (``dynamo_tpu_torch/frontend/kserve.py``
on the port's HTTP server) against the JAX package's (aiohttp), both in
front of an f32 engine serving the trained ``tests/data/tiny-real-llama``
checkpoint (a tiny llama; each package's own loader, so the text is
words and streams come in several deltas), driven by one stdlib client
with the same requests.

For each of the seven routes of ``tests/test_kserve.py`` (health live and
ready, model metadata and readiness, unary infer, generate, generate
stream), the well-formed and the malformed requests: statuses, content
types, JSON bodies (the infer ``id`` masked) and error texts are equal,
and the SSE bodies of ``/generate_stream`` are equal byte for byte. The
greedy text of each v2 route equals the port's ``/v1/completions`` text,
and the two services count the same ``frontend_requests_total`` for the
kserve route. HEAD of a GET route and another method on a route answer
alike.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import threading
from pathlib import Path

import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.frontend.model_manager import ModelManager as JModelManager
from dynamo_tpu.frontend.service import HttpService as JHttpService
from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.preprocessor.preprocessor import ModelDefaults as JDefaults
from dynamo_tpu.tokenizer import load_tokenizer as jload_tokenizer
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.frontend.model_manager import ModelManager as TModelManager
from dynamo_tpu_torch.frontend.service import HttpService as THttpService
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults as TDefaults
from dynamo_tpu_torch.tokenizer import load_tokenizer as tload_tokenizer
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import _tcfg

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "tests" / "data" / "tiny-real-llama"
REAL32 = "tiny-real-llama-f32-kserve"
MODEL = "tiny-real-llama"


@pytest.fixture(scope="module")
def stack():
    """Both packages' engine + service on one event loop in a thread:
    (JAX port, torch port)."""
    jcfg = dataclasses.replace(JModelConfig.from_hf_config(str(CKPT)),
                               dtype="float32", name=REAL32)
    JAX_PRESETS[REAL32] = jcfg
    TORCH_PRESETS[REAL32] = _tcfg(jcfg)
    kw = dict(model=REAL32, block_size=4, num_blocks=256, max_batch_size=4,
              max_model_len=256, prefill_chunk=32, decode_bucket=(4,))
    jengine = jeng.build_engine(JEngineConfig(**kw), params=jloader.load_params(jcfg, CKPT))
    tengine = teng.build_engine(
        TEngineConfig(**kw), device="cpu",
        params=tloader.load_params(TORCH_PRESETS[REAL32], CKPT, device="cpu"))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    jm, tm = JModelManager(), TModelManager()
    jm.register(MODEL, jload_tokenizer(str(CKPT)), jengine.generate,
                defaults=JDefaults(max_model_len=256, default_max_tokens=16))
    tm.register(MODEL, tload_tokenizer(str(CKPT)), tengine.generate,
                defaults=TDefaults(max_model_len=256, default_max_tokens=16))
    jsvc, tsvc = JHttpService(jm), THttpService(tm)
    jport, tport = run(jsvc.start(port=0)), run(tsvc.start(port=0))
    try:
        yield jport, tport
    finally:
        for coro in (jsvc.stop(), tsvc.stop(), jengine.shutdown(), tengine.shutdown()):
            run(coro)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        del JAX_PRESETS[REAL32], TORCH_PRESETS[REAL32]


def call(port: int, method: str, path: str, body=None) -> tuple[int, str, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        if body is None:
            conn.request(method, path)
        else:
            data = body if isinstance(body, bytes) else json.dumps(body).encode()
            conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type", ""), r.read()
    finally:
        conn.close()


def masked(data: bytes, ctype: str):
    """A JSON body with the infer response's generated ``id`` masked."""
    if not ctype.startswith("application/json"):
        return data
    obj = json.loads(data)
    if isinstance(obj, dict) and "id" in obj and "outputs" in obj:
        obj["id"] = "<id>"
    return obj


def both(stack, method: str, path: str, body=None):
    jport, tport = stack
    j, t = call(jport, method, path, body), call(tport, method, path, body)
    assert t[0] == j[0], (path, body, t, j)
    assert t[1].split(";")[0] == j[1].split(";")[0], (path, t[1], j[1])
    if method != "HEAD":
        assert masked(t[2], t[1]) == masked(j[2], j[1]), (path, body, t[2][:500], j[2][:500])
    return t


TEXT = {"name": "text_input", "datatype": "BYTES", "shape": [1], "data": ["one two three"]}
PARAMS = {"max_tokens": 12, "temperature": 0, "ignore_eos": True}
M = f"/v2/models/{MODEL}"


@pytest.mark.parametrize("method,path", [
    ("GET", "/v2/health/live"), ("GET", "/v2/health/ready"), ("GET", M),
    ("GET", "/v2/models/nope"), ("GET", f"{M}/ready"), ("GET", "/v2/models/nope/ready"),
    ("HEAD", f"{M}/ready"), ("HEAD", "/v2/health/live"), ("GET", f"{M}/infer"),
    ("POST", f"{M}/ready"), ("GET", "/v2/models"), ("GET", f"{M}/ready/x"),
])
def test_health_metadata_and_routing_equal_jaxs(stack, method, path):
    both(stack, method, path)


INFER_CASES = {
    "ok": {"inputs": [TEXT], "parameters": PARAMS},
    "ok_with_id": {"id": "req-7", "inputs": [TEXT], "parameters": PARAMS},
    "shape_1x1": {"inputs": [{**TEXT, "shape": [1, 1]}], "parameters": PARAMS},
    "stream_false": {"inputs": [TEXT, {"name": "stream", "datatype": "BOOL", "shape": [1],
                                       "data": [False]}], "parameters": PARAMS},
    "wrong_datatype": {"inputs": [{**TEXT, "datatype": "FP32"}]},
    "wrong_shape": {"inputs": [{**TEXT, "shape": [2], "data": ["a", "b"]}]},
    "two_elements": {"inputs": [{**TEXT, "data": ["a", "b"]}]},
    "missing_tensor": {"inputs": []},
    "no_inputs": {},
    "unexpected_tensor": {"inputs": [TEXT, {"name": "image", "datatype": "BYTES",
                                            "shape": [1], "data": ["x"]}]},
    "tensor_not_object": {"inputs": ["text_input"]},
    "streaming_refused": {"inputs": [TEXT, {"name": "streaming", "datatype": "BOOL",
                                            "shape": [1], "data": [True]}]},
    "streaming_not_bool": {"inputs": [TEXT, {"name": "streaming", "datatype": "BYTES",
                                             "shape": [1], "data": ["yes"]}]},
    "bad_parameter": {"inputs": [TEXT], "parameters": {"temperature": "hot"}},
    "parameters_not_object": {"inputs": [TEXT], "parameters": [1, 2]},
    "body_not_object": [1, 2],
    "invalid_json": b"{not json",
}


@pytest.mark.parametrize("case", list(INFER_CASES))
def test_infer_equals_jaxs(stack, case):
    status, _, data = both(stack, "POST", f"{M}/infer", INFER_CASES[case])
    if case.startswith("ok"):
        assert status == 200 and json.loads(data)["outputs"][0]["data"][0]
    else:
        assert status == (200 if case in ("shape_1x1", "stream_false") else 400), data


GENERATE_CASES = {
    "ok": {"text_input": "one two three", "parameters": PARAMS},
    "stop": {"text_input": "one two three", "parameters": {**PARAMS, "stop": ["e"]}},
    "defaults": {"text_input": "abc", "parameters": {"max_tokens": 5}},
    "missing_text": {"parameters": PARAMS},
    "body_not_object": "text",
    "bad_parameter": {"text_input": "x", "parameters": {"max_tokens": "many"}},
    "invalid_json": b"[",
}


@pytest.mark.parametrize("route", ["generate", "generate_stream"])
@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_and_stream_equal_jaxs(stack, route, case):
    status, ctype, data = both(stack, "POST", f"{M}/{route}", GENERATE_CASES[case])
    if route == "generate_stream" and status == 200:
        assert ctype.startswith("text/event-stream")
        events = [json.loads(e[6:]) for e in data.decode().split("\n\n") if e]
        assert len(events) > 1 and "finish_reason" in events[-1]


def test_unknown_model_on_every_route(stack):
    for route, body in (("infer", INFER_CASES["ok"]), ("generate", GENERATE_CASES["ok"]),
                        ("generate_stream", GENERATE_CASES["ok"])):
        status, _, _ = both(stack, "POST", f"/v2/models/nope/{route}", body)
        assert status == 404


def test_every_route_gives_the_openai_text(stack):
    _, tport = stack
    prompt = "one two three four"
    s, _, data = call(tport, "POST", "/v1/completions", {
        "model": MODEL, "prompt": prompt, "max_tokens": 12, "temperature": 0,
        "ignore_eos": True})
    assert s == 200
    want = json.loads(data)["choices"][0]["text"]
    _, _, infer = call(tport, "POST", f"{M}/infer", {
        "inputs": [{**TEXT, "data": [prompt]}], "parameters": PARAMS})
    _, _, gen = call(tport, "POST", f"{M}/generate", {"text_input": prompt,
                                                      "parameters": PARAMS})
    _, _, stream = call(tport, "POST", f"{M}/generate_stream", {"text_input": prompt,
                                                                "parameters": PARAMS})
    deltas = "".join(json.loads(e[6:])["text_output"]
                     for e in stream.decode().split("\n\n") if e)
    assert json.loads(infer)["outputs"][0]["data"] == [want]
    assert json.loads(gen)["text_output"] == want
    assert deltas == want and want


def test_kserve_requests_are_counted_alike(stack):
    def counts(port) -> dict[str, float]:
        _, _, data = call(port, "GET", "/metrics")
        return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                for ln in data.decode().splitlines()
                if ln.startswith("dynamo_frontend_requests_total") and 'route="kserve"' in ln}

    jport, tport = stack
    before = counts(jport), counts(tport)
    for body in (INFER_CASES["ok"], INFER_CASES["wrong_shape"], INFER_CASES["invalid_json"]):
        both(stack, "POST", f"{M}/infer", body)
    delta = [{k: v - b.get(k, 0.0) for k, v in counts(port).items()}
             for port, b in zip((jport, tport), before)]
    assert delta[1] == delta[0]
    assert sorted(v for v in delta[1].values() if v) == [1.0, 2.0]   # one 200, two 400s
