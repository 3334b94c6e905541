"""End to end over HTTP on the CPU: the JAX engine behind the JAX
``HttpService`` and the port's engine behind the port's, both serving the
trained ``tests/data/tiny-real-llama`` checkpoint at f32 (each package's
own loader). Greedy ``/v1/completions`` and ``/v1/chat/completions``,
streamed and not, give the same text, finish reason and usage, and
sampled-token log-probs within 1e-4 (both forwards are f32, summed in
other orders, as tests/test_torch_llama.py holds them).

A client that leaves mid-stream makes the port's engine abort the request
and free its blocks: both when it closes the socket and when it only
half-closes it (a FIN, which leaves an asyncio transport half-open and
its ``is_closing()`` False: only the reader's EOF shows it). And
``launch.run in=http --device cpu`` starts and answers ``/health``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
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
REAL32 = "tiny-real-llama-f32-http"
MODEL = "tiny-real-llama"
LP_TOL = 1e-4


@pytest.fixture(scope="module")
def stack():
    """Both packages' engine + service on one event loop in a thread:
    (JAX port, torch port, torch engine, run(coro) on that loop)."""
    jcfg = dataclasses.replace(JModelConfig.from_hf_config(str(CKPT)),
                               dtype="float32", name=REAL32)
    JAX_PRESETS[REAL32] = jcfg
    TORCH_PRESETS[REAL32] = _tcfg(jcfg)
    kw = dict(model=REAL32, block_size=4, num_blocks=512, max_batch_size=4,
              max_model_len=1024, prefill_chunk=32, decode_bucket=(4,))
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
                defaults=JDefaults(max_model_len=1024, default_max_tokens=16))
    tm.register(MODEL, tload_tokenizer(str(CKPT)), tengine.generate,
                defaults=TDefaults(max_model_len=1024, default_max_tokens=16),
                stats=tengine.stats)
    jsvc, tsvc = JHttpService(jm), THttpService(tm)
    jport, tport = run(jsvc.start(port=0)), run(tsvc.start(port=0))
    try:
        yield jport, tport, tengine, run
    finally:
        for coro in (jsvc.stop(), tsvc.stop(), jengine.shutdown(), tengine.shutdown()):
            run(coro)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        del JAX_PRESETS[REAL32], TORCH_PRESETS[REAL32]


def post(port: int, path: str, body: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def summarize(chat: bool, stream: bool, data: bytes) -> dict:
    """Text, finish reason, usage and log-probs of one answer."""
    if not stream:
        d = json.loads(data)
        ch = d["choices"][0]
        text = ch["message"]["content"] if chat else ch["text"]
        lp = ch.get("logprobs") or {}
        lps = ([e["logprob"] for e in lp.get("content", [])] if chat
               else lp.get("token_logprobs", []))
        return {"text": text, "finish": ch["finish_reason"], "usage": d["usage"], "lps": lps}
    events = [e[6:] for e in data.decode().split("\n\n") if e.startswith("data: ")]
    assert events[-1] == "[DONE]"
    text, finish, usage, lps = "", None, None, []
    for e in map(json.loads, events[:-1]):
        if e.get("usage"):
            usage = e["usage"]
        for ch in e["choices"]:
            text += (ch["delta"].get("content") or "") if chat else ch["text"]
            finish = ch.get("finish_reason") or finish
            lp = ch.get("logprobs") or {}
            lps += ([x["logprob"] for x in lp.get("content", [])] if chat
                    else lp.get("token_logprobs", []))
    return {"text": text, "finish": finish, "usage": usage, "lps": lps}


@pytest.mark.parametrize("chat", [False, True], ids=["completions", "chat"])
@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
def test_greedy_over_http_matches_jax(stack, chat, stream):
    jport, tport, _, _ = stack
    common = {"model": MODEL, "max_tokens": 12, "temperature": 0, "stream": stream,
              "stream_options": {"include_usage": True}}
    if chat:
        body = {**common, "logprobs": True,
                "messages": [{"role": "user", "content": "one two three four"}]}
        path = "/v1/chat/completions"
    else:
        body = {**common, "logprobs": 0, "prompt": "one two three four"}
        path = "/v1/completions"
    got = {}
    for side, port in (("jax", jport), ("torch", tport)):
        status, data = post(port, path, body)
        assert status == 200, data
        got[side] = summarize(chat, stream, data)
    j, t = got["jax"], got["torch"]
    assert t["text"] == j["text"] and t["finish"] == j["finish"] == "length"
    assert t["usage"] == j["usage"] and t["usage"]["completion_tokens"] == 12
    assert len(t["lps"]) == len(j["lps"]) == 12
    assert max(abs(a - b) for a, b in zip(t["lps"], j["lps"])) < LP_TOL
    if not chat:
        assert t["text"].startswith(" five six seven eight")


def _read_chunks(sock: socket.socket, n: int) -> bytes:
    """Read until ``n`` SSE events of the response body have arrived."""
    buf = b""
    while buf.count(b"data: ") < n:
        part = sock.recv(65536)
        assert part, buf
        buf += part
    return buf


@pytest.mark.parametrize("how", ["close", "half-close"])
def test_client_disconnect_aborts_the_request(stack, how):
    """The client leaves after 4 chunks of a 1000-token stream (about 5 s
    of decoding here): within 1 s the port's engine holds no seq and the
    pool's free blocks are back."""
    _, tport, tengine, _ = stack
    core = tengine.core
    deadline = time.monotonic() + 30
    while core.sched.has_work() and time.monotonic() < deadline:
        time.sleep(0.01)
    free0 = core.pool.num_free
    body = json.dumps({"model": MODEL, "prompt": "one two three four", "max_tokens": 1000,
                       "temperature": 0, "ignore_eos": True, "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", tport), timeout=30)
    try:
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%b" % (len(body), body))
        _read_chunks(sock, 4)
        assert core.sched.num_running == 1
        t_cut = time.monotonic()
        if how == "close":
            sock.close()
        else:
            sock.shutdown(socket.SHUT_WR)  # FIN; the socket stays open, unread
        while core.sched.has_work() and time.monotonic() - t_cut < 1.0:
            time.sleep(0.005)
        waited = time.monotonic() - t_cut
        assert not core.sched.has_work(), f"the seq still runs {waited:.2f}s after the cut"
        while core.pool.num_free != free0 and time.monotonic() - t_cut < 1.0:
            time.sleep(0.005)
        assert core.pool.num_free == free0
    finally:
        sock.close()


def test_launcher_serves_http_on_cpu():
    env = {**os.environ, "DYN_LOG": "info"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=http", "out=torch",
         "--model", str(CKPT), "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--block-size", "4", "--num-blocks", "64", "--max-model-len", "128",
         "--max-batch-size", "2", "--tool-call-parser", "hermes"],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stderr], daemon=True).start()
    try:
        port = None
        while port is None:
            line = lines.get(timeout=120)
            if "serving" in line and "http://" in line:
                port = int(line.rsplit(":", 1)[1].split("/")[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/health")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["models"] == [str(CKPT)]
        conn.close()
        status, data = post(port, "/v1/completions", {
            "model": str(CKPT), "prompt": "one two three four", "max_tokens": 4,
            "temperature": 0})
        assert status == 200 and json.loads(data)["choices"][0]["text"] == " five six seven eight"
    finally:
        proc.terminate()
        proc.wait(30)


def test_launcher_refuses_the_vision_encoder():
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=http", "out=torch",
         "--model", str(CKPT), "--device", "cpu", "--mm-image-tokens", "16"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "vision encoder" in res.stderr
