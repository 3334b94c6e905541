"""The port's OpenAI HTTP frontend against the JAX package's, on identical
engine deltas.

One canned engine per model (ByteTokenizer ids of a fixed text in deltas
of 7, with fixed log-probs, one of them -inf), registered alike in the JAX
``HttpService`` (aiohttp) and the port's (its stdlib server). The same
stdlib client sends the same table of requests to both, and compares the
status, ``Content-Type``, ``Retry-After``, ``Allow`` and the JSON body or
the list of SSE events (HEAD and OPTIONS of every GET route included), after masking ``id``, ``created`` / ``created_at`` and trace
ids. The preprocessed request each engine received (token ids, sampling
and stop options, eos ids, multimodal spans, annotations without the
trace) must be equal too.

A 400 that carries a validation message compares only its prefix
(``invalid request: `` ... ``validation error``): pydantic's wording is
not the port's, which is held to pydantic's acceptance and values in
``tests/test_torch_openai_protocol.py``.
"""

from __future__ import annotations

import asyncio
import base64
import http.client
import json
import threading

import numpy as np
import pytest

from dynamo_tpu.frontend.model_manager import ModelManager as JModelManager
from dynamo_tpu.frontend.service import HttpService as JHttpService
from dynamo_tpu.parsers import REASONING_PARSERS, TOOL_PARSERS
from dynamo_tpu.preprocessor.preprocessor import ModelDefaults as JDefaults
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.qos import QosConfig as JQosConfig
from dynamo_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from dynamo_tpu_torch.frontend.model_manager import ModelManager as TModelManager
from dynamo_tpu_torch.frontend.service import HttpService as THttpService
from dynamo_tpu_torch.parsers import REASONING_PARSERS as T_REASONING_PARSERS
from dynamo_tpu_torch.parsers import TOOL_PARSERS as T_TOOL_PARSERS
from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults as TDefaults
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.qos import QosConfig as TQosConfig
from dynamo_tpu_torch.tokenizer import ByteTokenizer as TByteTokenizer

TOOL_TEXTS = {
    "hermes": 'Let me look. <tool_call>{"name": "get_weather", '
              '"arguments": {"city": "Paris"}}</tool_call>',
    "nemotron_deci": '<TOOLCALL>[{"name": "get_weather", "arguments": '
                     '{"city": "Paris"}}]</TOOLCALL>',
    "llama3_json": '<|python_tag|>{"name": "calc", "parameters": {"expr": "1+1"}}',
    "mistral": '[TOOL_CALLS] [{"name": "search", "arguments": {"q": "tpu"}}]',
    "phi4": 'functools[{"name": "f", "arguments": {"x": [1, 2]}}] done',
    "deepseek_v3_1": '<｜tool▁calls▁begin｜><｜tool▁call▁begin｜>get_weather'
                     '<｜tool▁sep｜>{"city": "Paris"}<｜tool▁call▁end｜>'
                     '<｜tool▁calls▁end｜>',
    "pythonic": 'Sure: [get_weather(city="SF", days=3), get_time()]',
    "harmony": ('<|channel|>analysis<|message|>need the weather tool<|end|>'
                '<|channel|>commentary to=functions.get_weather '
                '<|constrain|>json<|message|>{"city": "Paris"}<|call|>'
                '<|channel|>final<|message|>Checking!<|return|>'),
    "default": '<TOOLCALL>[{"name": "lookup", "arguments": {"k": 1}}]</TOOLCALL>',
}
REASONING_TEXTS = {
    "basic": "<think>check the map first</think>The capital is Paris.",
    "deepseek_r1": "check the map first</think>The capital is Paris.",
    "qwen3": "<think>one, two</think>three",
    "nemotron_deci": "<think>plan</think>answer",
    "kimi": "◁think▷weigh it◁/think▷ok",
    "step3": "steps here</think>result",
    "mistral": "[THINK]hmm[/THINK]Fine.",
    "granite": "Here is my thought process: think Here is my response: done",
    "gpt_oss": ("<|channel|>analysis<|message|>user wants weather<|end|>"
                "<|start|>assistant<|channel|>final<|message|>It is sunny.<|return|>"),
}
PLAIN = "Hello there: a canned answer, with ünïcode and 7 bytes a delta."
TOOLS = [{"type": "function", "function": {"name": "get_weather", "parameters": {}}}]
IMAGE = "data:image/png;base64," + base64.b64encode(b"\x89PNG fake image bytes").decode()
EMBED_DIM = 8
IMAGE_ROWS = 3


def test_registries_are_the_same():
    assert set(T_TOOL_PARSERS) == set(TOOL_PARSERS) == set(TOOL_TEXTS)
    assert set(T_REASONING_PARSERS) == set(REASONING_PARSERS) == set(REASONING_TEXTS)
    assert {k: repr(v) for k, v in T_TOOL_PARSERS.items()} == {
        k: repr(v) for k, v in TOOL_PARSERS.items()}


def _lp(i: int) -> float:
    return float("-inf") if i == 3 else -0.125 * (i % 5)


def canned_generate(proto, text: str, seen: dict):
    ids = JByteTokenizer().encode(text)

    async def generate(pre):
        seen[pre.request_id] = pre
        for i in range(0, len(ids), 7):
            part = ids[i: i + 7]
            yield proto.LLMEngineOutput(
                token_ids=part, log_probs=[_lp(i + j) for j in range(len(part))],
                finish_reason=proto.FinishReason.STOP if i + 7 >= len(ids) else None)

    return generate


async def _embed(token_lists):
    return np.stack([np.cos(np.arange(EMBED_DIM) * (1 + sum(t) % 7)).astype(np.float32)
                     for t in token_lists])


async def _image_encoder(images):
    return [np.full((IMAGE_ROWS, EMBED_DIM), float(len(b)), np.float32) for b in images]


async def _broken_encoder(images):
    raise RuntimeError("encode pool down")


def _register(mm, proto, tok, defaults_cls, seen):
    def reg(name, text, **kw):
        mm.register(name, tok, canned_generate(proto, text, seen),
                    defaults=defaults_cls(max_model_len=512, default_max_tokens=64), **kw)

    reg("m", PLAIN, embed=_embed, image_encoder=_image_encoder,
        stats=lambda: {"num_waiting": 1, "num_running": 1, "kv_usage": 0.1})
    reg("noenc", PLAIN)
    reg("broken", PLAIN, image_encoder=_broken_encoder)
    reg("busy", PLAIN, stats=lambda: {"num_waiting": 40, "num_running": 8, "kv_usage": 0.5})
    reg("full", PLAIN, stats=lambda: {"num_waiting": 200, "num_running": 8, "kv_usage": 0.5})
    for name, text in TOOL_TEXTS.items():
        reg(f"tool-{name}", text, tool_parser=name,
            reasoning_parser="gpt_oss" if name == "harmony" else None)
    for name, text in REASONING_TEXTS.items():
        reg(f"think-{name}", text, reasoning_parser=name)


@pytest.fixture(scope="module")
def servers():
    """Both services on one event loop in a thread: (JAX port, torch port,
    JAX preprocessed requests, torch preprocessed requests)."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    jseen, tseen = {}, {}
    jm, tm = JModelManager(), TModelManager()
    _register(jm, jproto, JByteTokenizer(), JDefaults, jseen)
    _register(tm, tproto, TByteTokenizer(), TDefaults, tseen)
    qos = dict(rate_limit_rps=0.25, rate_burst=1.0)
    jsvc = JHttpService(jm, qos=JQosConfig(**qos))
    tsvc = THttpService(tm, qos=TQosConfig(**qos))

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(30)

    jport, tport = run(jsvc.start(port=0)), run(tsvc.start(port=0))
    yield jport, tport, jseen, tseen
    run(jsvc.stop())
    run(tsvc.stop())
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)
    loop.close()


def call(port: int, method: str, path: str, body=None, headers=None, raw: bytes | None = None):
    """One request on a fresh connection: (status, headers, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        data = raw if raw is not None else (None if body is None else json.dumps(body))
        conn.request(method, path, body=data, headers=hdrs)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


_MASK = {"id", "created", "created_at"}


def mask(obj):
    if isinstance(obj, dict):
        out = {k: ("<masked>" if k in _MASK else mask(v)) for k, v in obj.items()}
        msg = out.get("error", {}).get("message") if isinstance(out.get("error"), dict) else None
        if isinstance(msg, str) and msg.startswith("invalid request: ") and (
                "validation error" in msg or "must be a mapping" in msg):
            out["error"] = {**out["error"], "message": "invalid request: <validation>"}
        return out
    if isinstance(obj, list):
        return [mask(v) for v in obj]
    return obj


def normalize(status, headers, body):
    ctype = headers.get("content-type", "")
    if ctype.startswith("text/event-stream"):
        events = []
        for block in body.decode().split("\n\n"):
            if block.startswith("data: "):
                data = block[6:]
                events.append(data if data == "[DONE]" else mask(json.loads(data)))
        content = events
    elif ctype.startswith("application/json") and body:  # a HEAD answer has none
        content = mask(json.loads(body))
    else:
        content = body.decode()
    return {"status": status, "content-type": ctype,
            "retry-after": headers.get("retry-after"), "allow": headers.get("allow"),
            "body": content}


def _pre_view(pre) -> dict:
    d = pre.to_dict()
    d["annotations"] = {k: v for k, v in d["annotations"].items()
                        if k not in ("obs.traceparent", "qos.deadline_ts")}
    d.pop("request_id")
    return d


def _chat(model="m", **kw):
    return {"model": model, "messages": [{"role": "user", "content": "hi there"}], **kw}


def _cmpl(model="m", **kw):
    return {"model": model, "prompt": "once upon a time", **kw}


CASES: dict[str, dict] = {}
# route x stream x n x logprobs (with usage on streams)
for route in ("chat", "completions"):
    for stream in (False, True):
        for n in (1, 2):
            for lp in (False, True):
                kw = {"stream": stream, "n": n, "max_tokens": 16}
                if stream:
                    kw["stream_options"] = {"include_usage": True}
                if lp:
                    kw["logprobs"] = True if route == "chat" else 0
                CASES[f"{route}-stream{int(stream)}-n{n}-lp{int(lp)}"] = dict(
                    path=f"/v1/{'chat/completions' if route == 'chat' else 'completions'}",
                    body=_chat(**kw) if route == "chat" else _cmpl(**kw))
for name in TOOL_TEXTS:
    for stream in (False, True):
        CASES[f"tool-{name}-stream{int(stream)}"] = dict(
            path="/v1/chat/completions",
            body=_chat(f"tool-{name}", tools=TOOLS, stream=stream, logprobs=True))
CASES["tool-hermes-no-tools"] = dict(path="/v1/chat/completions", body=_chat("tool-hermes"))
for name in REASONING_TEXTS:
    for stream in (False, True):
        CASES[f"think-{name}-stream{int(stream)}"] = dict(
            path="/v1/chat/completions", body=_chat(f"think-{name}", stream=stream))
CASES.update({
    "think-responses": dict(path="/v1/responses",
                            body={"model": "think-basic", "input": "hi"}),
    "json-object": dict(path="/v1/chat/completions",
                        body=_chat(response_format={"type": "json_object"})),
    "json-schema": dict(path="/v1/chat/completions", body=_chat(response_format={
        "type": "json_schema", "json_schema": {"name": "x", "schema": {
            "type": "object", "properties": {"a": {"type": "integer"}}}}})),
    "json-text": dict(path="/v1/completions",
                      body=_cmpl(response_format={"type": "text"}, stream=True)),
    "completions-token-prompt": dict(path="/v1/completions",
                                     body=_cmpl(prompt=[5, 6, 7.0, "8"], max_tokens=4)),
    "completions-stop": dict(path="/v1/completions",
                             body=_cmpl(stop=["canned"], stream=True, logprobs=0)),
    "chat-stop-and-coercion": dict(path="/v1/chat/completions", body=_chat(
        stop="answer", temperature="0.5", n="1", max_tokens=8.0, seed=3, top_k="4",
        ignore_eos="true", min_tokens=1, extra_field={"x": None})),
    "chat-session-priority": dict(path="/v1/chat/completions", body=_chat(
        session_id="s-1", nvext={"annotations": ["x"]}), headers={"x-priority": "interactive"}),
    "image": dict(path="/v1/chat/completions", body=_chat(messages=[{"role": "user", "content": [
        {"type": "text", "text": "look:"}, {"type": "image_url", "image_url": {"url": IMAGE}},
        {"type": "text", "text": "and again"},
        {"type": "image_url", "image_url": {"url": IMAGE}}]}], stream=True)),
    "image-no-encoder": dict(path="/v1/chat/completions", body=_chat("noenc", messages=[
        {"role": "user", "content": [{"type": "image_url", "image_url": {"url": IMAGE}}]}])),
    "image-remote-url": dict(path="/v1/chat/completions", body=_chat(messages=[
        {"role": "user", "content": [{"type": "image_url",
                                      "image_url": {"url": "http://example.invalid/a.png"}}]}])),
    "image-bad-base64": dict(path="/v1/chat/completions", body=_chat(messages=[
        {"role": "user", "content": [{"type": "image_url",
                                      "image_url": {"url": "data:image/png;base64,@@@"}}]}])),
    "image-encoder-down": dict(path="/v1/chat/completions", body=_chat("broken", messages=[
        {"role": "user", "content": [{"type": "image_url", "image_url": {"url": IMAGE}}]}])),
    "responses-text": dict(path="/v1/responses", body={
        "model": "m", "input": "hi", "instructions": "be brief", "max_output_tokens": 8}),
    "responses-list": dict(path="/v1/responses", body={
        "model": "m", "input": [{"role": "user", "content": "hello"}], "temperature": 0}),
    "responses-stream": dict(path="/v1/responses",
                             body={"model": "m", "input": "hi", "stream": True}),
    "responses-bad-input": dict(path="/v1/responses", body={"model": "m", "input": 5}),
    "responses-unknown-model": dict(path="/v1/responses", body={"model": "nope", "input": "x"}),
    "embeddings-float": dict(path="/v1/embeddings",
                             body={"model": "m", "input": ["one", "two words"]}),
    "embeddings-base64": dict(path="/v1/embeddings", body={
        "model": "m", "input": "one", "encoding_format": "base64"}),
    "embeddings-tokens": dict(path="/v1/embeddings", body={"model": "m", "input": [1, 2, 3]}),
    "embeddings-token-lists": dict(path="/v1/embeddings",
                                   body={"model": "m", "input": [[1, 2], [3]]}),
    "embeddings-dimensions": dict(path="/v1/embeddings",
                                  body={"model": "m", "input": "x", "dimensions": 4}),
    "embeddings-empty": dict(path="/v1/embeddings", body={"model": "m", "input": []}),
    "embeddings-too-many": dict(path="/v1/embeddings",
                                body={"model": "m", "input": ["a"] * 65}),
    "embeddings-too-long": dict(path="/v1/embeddings",
                                body={"model": "m", "input": [[1] * 600]}),
    "embeddings-bad-format": dict(path="/v1/embeddings", body={
        "model": "m", "input": "x", "encoding_format": "hex"}),
    "embeddings-unsupported": dict(path="/v1/embeddings", body={"model": "noenc", "input": "x"}),
    "embeddings-unknown-model": dict(path="/v1/embeddings", body={"model": "nope", "input": "x"}),
    "bad-json": dict(path="/v1/chat/completions", raw=b"{not json"),
    "not-a-mapping": dict(path="/v1/completions", body=[1, 2]),
    "missing-messages": dict(path="/v1/chat/completions", body={"model": "m"}),
    "bad-n-type": dict(path="/v1/chat/completions", body=_chat(n=2.5)),
    "bad-stop-type": dict(path="/v1/completions", body=_cmpl(stop=[1])),
    "n-zero": dict(path="/v1/completions", body=_cmpl(n=0)),
    "n-too-big": dict(path="/v1/completions", body=_cmpl(n=17)),
    "n-stream": dict(path="/v1/chat/completions", body=_chat(n=2, stream=True)),
    "top-logprobs": dict(path="/v1/chat/completions", body=_chat(logprobs=True, top_logprobs=2)),
    "completion-logprobs-2": dict(path="/v1/completions", body=_cmpl(logprobs=2)),
    "unknown-model": dict(path="/v1/chat/completions", body=_chat("nope")),
    "shed-batch": dict(path="/v1/chat/completions", body=_chat("busy"),
                       headers={"x-priority": "batch"}),
    "degrade-standard": dict(path="/v1/completions", body=_cmpl("busy", max_tokens=1000)),
    "full-503": dict(path="/v1/chat/completions", body=_chat("full")),
    "deadline-expired": dict(path="/v1/chat/completions", body=_chat(),
                             headers={"x-deadline-ms": "-5"}),
    "rate-limited": dict(path="/v1/completions", body=_cmpl(), repeat=2),
    "health": dict(method="GET", path="/health"),
    "live": dict(method="GET", path="/live"),
    "models": dict(method="GET", path="/v1/models"),
    "engine-stats": dict(method="GET", path="/engine_stats"),
    "clear-kv": dict(path="/clear_kv_blocks"),
    "traces-bad-format": dict(method="GET", path="/debug/traces?format=xml"),
    "no-route": dict(method="GET", path="/v2/nothing"),
    "wrong-method": dict(method="GET", path="/v1/chat/completions"),
    "head-on-post-route": dict(method="HEAD", path="/v1/completions"),
})
#: every GET route of the service; HEAD answers as GET without a body,
#: OPTIONS (any other method) with 405 and ``Allow: GET,HEAD``
GET_ROUTES = ("/health", "/live", "/v1/models", "/metrics", "/engine_stats",
              "/debug/traces", "/debug/sched", "/debug/mem")
for _path in GET_ROUTES:
    for _method in ("HEAD", "OPTIONS"):
        CASES[f"{_method.lower()}-{_path.strip('/').replace('/', '-')}"] = dict(
            method=_method, path=_path)


@pytest.mark.parametrize("name", list(CASES))
def test_port_answers_like_jax(servers, name):
    jport, tport, jseen, tseen = servers
    case = CASES[name]
    got = {}
    for side, port in (("jax", jport), ("torch", tport)):
        headers = {"x-client-id": f"{name}", "x-request-id": f"req-{name}",
                   **case.get("headers", {})}
        for _ in range(case.get("repeat", 1)):
            res = call(port, case.get("method", "POST"), case["path"], body=case.get("body"),
                       headers=headers, raw=case.get("raw"))
        got[side] = normalize(*res)
    assert got["torch"] == got["jax"]
    # the engines were handed the same preprocessed requests
    jpre = {k: _pre_view(v) for k, v in jseen.items() if k.startswith(f"req-{name}")}
    tpre = {k: _pre_view(v) for k, v in tseen.items() if k.startswith(f"req-{name}")}
    assert tpre == jpre


def test_cases_cover_every_status(servers):
    """The table reaches every status the service answers."""
    jport, _, _, _ = servers
    statuses = set()
    for name, case in CASES.items():
        if case.get("repeat") or name in ("rate-limited",):
            statuses.add(429)
            continue
        statuses.add(call(jport, case.get("method", "POST"), case["path"],
                          body=case.get("body"), raw=case.get("raw"),
                          headers={"x-client-id": f"cover-{name}",
                                   **case.get("headers", {})})[0])
    assert statuses >= {200, 400, 404, 405, 429, 501, 502, 503, 504}


def test_head_carries_the_get_head_without_a_body(servers):
    """HEAD of a GET route: the GET answer's status, Content-Type and
    Content-Length, and no body, on a connection that stays usable (a GET
    pipelined behind it reads its own answer), on both servers."""
    jport, tport, _, _ = servers
    for port in (jport, tport):
        for path in ("/health", "/v1/models"):
            get_status, get_headers, get_body = call(port, "GET", path)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            try:
                conn.request("HEAD", path)
                r = conn.getresponse()
                head = r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
                conn.request("GET", path)
                again = conn.getresponse()
                again_body = again.read()
            finally:
                conn.close()
            assert head[0] == get_status == 200 and head[2] == b""
            assert head[1]["content-type"] == get_headers["content-type"]
            assert int(head[1]["content-length"]) == len(get_body)
            assert again.status == 200 and again_body == get_body


def _raw_exchange(port: int, data: bytes) -> bytes:
    """Send ``data`` on a fresh connection and read until the server closes
    it (a server that kept it open fails the read's timeout)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(data)
        out = b""
        while chunk := sock.recv(65536):
            out += chunk
    return out


def test_handler_raising_after_prepare_cuts_the_stream():
    """A handler that sends its head and one SSE chunk, then raises: aiohttp
    and the port both leave the chunked body cut after that chunk (no
    terminating chunk, no 500 written into the body) and close the
    connection, so a request pipelined behind it gets no answer."""
    from aiohttp import web as aioweb

    from dynamo_tpu_torch.frontend import http as tweb

    def handler(mod):
        async def h(request):
            resp = mod.StreamResponse(status=200, headers={"Content-Type": "text/event-stream"})
            await resp.prepare(request)
            await resp.write(b"data: one\n\n")
            raise RuntimeError("failed mid-stream")
        return h

    async def health(request):
        return aioweb.json_response({"status": "ok"})

    async def go():
        app = aioweb.Application()
        app.router.add_get("/s", handler(aioweb))
        app.router.add_get("/health", health)
        runner = aioweb.AppRunner(app)
        await runner.setup()
        site = aioweb.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        jport = site._server.sockets[0].getsockname()[1]
        srv = tweb.HttpServer()
        srv.add_get("/s", handler(tweb))
        srv.add_get("/health", lambda request: asyncio.sleep(0, tweb.json_response({})))
        tport = await srv.start()
        data = (b"GET /s HTTP/1.1\r\nHost: x\r\n\r\n"
                b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")
        loop = asyncio.get_running_loop()
        try:
            return [await loop.run_in_executor(None, _raw_exchange, port, data)
                    for port in (jport, tport)]
        finally:
            await srv.stop()
            await runner.cleanup()

    got = []
    for raw in asyncio.run(go()):
        head, _, body = raw.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        hdrs = {k.lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
        got.append((lines[0], hdrs["content-type"], hdrs["transfer-encoding"], body))
    assert got[0] == got[1] == (
        "HTTP/1.1 200 OK", "text/event-stream", "chunked", b"b\r\ndata: one\n\n\r\n")


def test_keep_alive_and_chunked_request_body(servers):
    """Several requests on one connection, one of them with a chunked body
    and one streamed; the port's server keeps the connection open."""
    _, tport, _, _ = servers
    conn = http.client.HTTPConnection("127.0.0.1", tport, timeout=30)
    try:
        for i in range(3):
            body = json.dumps(_cmpl(max_tokens=4, stream=i == 1)).encode()
            if i == 2:
                conn.putrequest("POST", "/v1/completions")
                conn.putheader("Content-Type", "application/json")
                conn.putheader("Transfer-Encoding", "chunked")
                conn.putheader("x-client-id", "keepalive-2")
                conn.endheaders()
                for piece in (body[:10], body[10:]):
                    conn.send(b"%x\r\n%b\r\n" % (len(piece), piece))
                conn.send(b"0\r\n\r\n")
            else:
                conn.request("POST", "/v1/completions", body=body,
                             headers={"Content-Type": "application/json",
                                      "x-client-id": f"keepalive-{i}"})
            r = conn.getresponse()
            data = r.read()
            assert r.status == 200, data
            assert r.getheader("connection") != "close"
            if i == 1:
                assert r.getheader("transfer-encoding") == "chunked"
                assert data.endswith(b"data: [DONE]\n\n")
            else:
                assert json.loads(data)["choices"][0]["text"]
        sock = conn.sock
        assert sock is not None  # the same socket served all three
    finally:
        conn.close()


def test_body_limit_and_metrics(servers):
    """A body past 1 MiB is refused with 413 (aiohttp's default limit);
    /metrics counts requests by route and status."""
    jport, tport, _, _ = servers
    big = json.dumps(_cmpl(prompt="x" * (1024 ** 2 + 10))).encode()
    for port in (jport, tport):
        status, headers, _ = call(port, "POST", "/v1/completions", raw=big,
                                  headers={"x-client-id": "big"})
        assert status == 413
    assert call(tport, "POST", "/v1/chat/completions", body=_chat(),
                headers={"x-client-id": "metrics"})[0] == 200
    status, headers, body = call(tport, "GET", "/metrics")
    assert status == 200 and headers["content-type"] == "text/plain; charset=utf-8"
    text = body.decode()
    assert 'dynamo_frontend_requests_total{route="chat",status="200"}' in text
    assert "dynamo_frontend_time_to_first_token_seconds_bucket" in text
    for route in ("/debug/sched", "/debug/mem"):
        (status, _, body), (jstatus, _, jbody) = call(tport, "GET", route), call(jport, "GET", route)
        assert status == jstatus == 200
        assert sorted(json.loads(body)) == sorted(json.loads(jbody))
    status, headers, body = call(tport, "GET", "/debug/traces?format=jsonl")
    assert status == 200 and headers["content-type"] == "application/x-ndjson; charset=utf-8"
    assert any(json.loads(ln)["name"] == "request" for ln in body.decode().splitlines())


def test_tls_serving(tmp_path):
    """HTTPS through an ``ssl.SSLContext`` (a certificate made for the run),
    and a half-configured pair refused before anything starts."""
    import datetime
    import ssl

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key()).serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName([x509.DNSName("localhost")]),
                           critical=False)
            .sign(key, hashes.SHA256()))
    cert_path, key_path = tmp_path / "cert.pem", tmp_path / "key.pem"
    cert_path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_path.write_bytes(key.private_bytes(serialization.Encoding.PEM,
                                           serialization.PrivateFormat.PKCS8,
                                           serialization.NoEncryption()))
    models = TModelManager()
    models.register("m", TByteTokenizer(), canned_generate(tproto, PLAIN, {}),
                    defaults=TDefaults())

    async def go():
        svc = THttpService(models)
        with pytest.raises(ValueError):
            await svc.start(port=0, tls_cert=str(cert_path))
        port = await svc.start(port=0, tls_cert=str(cert_path), tls_key=str(key_path))
        try:
            ctx = ssl.create_default_context(cafile=str(cert_path))

            def get():
                conn = http.client.HTTPSConnection("localhost", port, context=ctx, timeout=30)
                conn.request("POST", "/v1/completions", body=json.dumps(_cmpl(stream=True)),
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                out = r.status, r.read()
                conn.close()
                return out

            status, body = await asyncio.get_running_loop().run_in_executor(None, get)
        finally:
            await svc.stop()
        assert status == 200 and body.endswith(b"data: [DONE]\n\n")
        assert b"Hello t" in body

    asyncio.run(go())
