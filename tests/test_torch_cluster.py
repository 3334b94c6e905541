"""The port's distributed deployment as processes, on the CPU: a coordinator,
two ``--engine torch --device cpu`` workers serving tests/data/tiny-real-llama
at f32 and the port's frontend with ``--router-mode kv`` (the shape of
tests/test_e2e_mockers.py). Greedy answers are held to the JAX package's
in-process engine and HTTP service on the same checkpoint at f32 (text,
usage, log-probs within 1e-4); then prefix affinity, a client disconnect
aborting the worker's stream, and a worker killed mid-stream, its streams
finished on the other worker through Migration.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import socket
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from tests.test_torch_http_e2e import post, summarize
from tests.utils_process import ManagedProcess, free_port

ROOT = Path(__file__).resolve().parent.parent
CKPT = "tests/data/tiny-real-llama"
REAL32 = "tiny-real-llama-f32-cluster"
LP_TOL = 1e-4
# a short lease, so that a killed worker leaves discovery inside the test
ENV = {"DYN_LEASE_TTL_S": "3", "DYN_LOG": "info"}
WORKER_ARGS = ["--engine", "torch", "--device", "cpu", "--model", CKPT, "--dtype", "float32",
               "--block-size", "4", "--num-blocks", "256", "--max-model-len", "512",
               "--max-batch-size", "8", "--prefill-chunk", "32"]


def get_json(url: str, timeout: float = 30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's engine and HTTP service on the checkpoint at f32,
    on a loop thread of their own: run(coro) and the service's port."""
    from dynamo_tpu.engine import engine as jeng
    from dynamo_tpu.frontend.model_manager import ModelManager
    from dynamo_tpu.frontend.service import HttpService
    from dynamo_tpu.models import loader as jloader
    from dynamo_tpu.models.config import MODEL_PRESETS, ModelConfig
    from dynamo_tpu.preprocessor.preprocessor import ModelDefaults
    from dynamo_tpu.tokenizer import load_tokenizer
    from dynamo_tpu.utils.config import EngineConfig

    ckpt = ROOT / CKPT
    jcfg = dataclasses.replace(ModelConfig.from_hf_config(str(ckpt)), dtype="float32",
                               name=REAL32)
    MODEL_PRESETS[REAL32] = jcfg
    engine = jeng.build_engine(EngineConfig(
        model=REAL32, block_size=4, num_blocks=256, max_batch_size=8, max_model_len=512,
        prefill_chunk=32), params=jloader.load_params(jcfg, ckpt))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    mm = ModelManager()
    mm.register(CKPT, load_tokenizer(str(ckpt)), engine.generate,
                defaults=ModelDefaults(max_model_len=512))
    svc = HttpService(mm)
    port = run(svc.start(port=0))
    try:
        yield port
    finally:
        run(svc.stop())
        run(engine.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        del MODEL_PRESETS[REAL32]


@pytest.fixture(scope="module")
def cluster():
    coord_port, http_port = free_port(), free_port()
    coordinator = ManagedProcess(
        ["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
         "--port", str(coord_port)], name="coordinator", env=ENV).start()
    coordinator.wait_for_line("COORDINATOR_READY", 30)
    url = f"tcp://127.0.0.1:{coord_port}"
    workers = [ManagedProcess(["-m", "dynamo_tpu_torch.components.worker",
                               "--coordinator", url, *WORKER_ARGS],
                              name=f"worker{i}", env=ENV).start() for i in range(2)]
    frontend = None
    try:
        ids = [w.wait_for_line("WORKER_READY", 60).split("instance=")[1].strip()
               for w in workers]
        frontend = ManagedProcess(
            ["-m", "dynamo_tpu_torch.components.frontend", "--coordinator", url,
             "--host", "127.0.0.1", "--port", str(http_port), "--router-mode", "kv"],
            name="frontend", env=ENV).start()
        frontend.wait_for_line("FRONTEND_READY", 30)
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.time() + 30
        while time.time() < deadline:
            st = get_json(base + "/engine_stats").get(CKPT, {})
            if len(st.get("instances", [])) == 2 and len(st.get("workers", {})) == 2:
                break
            time.sleep(0.1)
        yield {"base": base, "port": http_port, "workers": workers,
               "ids": [i.lstrip("0") for i in ids], "frontend": frontend,
               "coordinator": coordinator}
    finally:
        if frontend is not None:
            frontend.stop()
        for w in workers:
            w.stop()
        coordinator.stop()


def stats(cluster) -> dict:
    return get_json(cluster["base"] + "/engine_stats")[CKPT]


def test_model_discovered(cluster):
    models = get_json(cluster["base"] + "/v1/models")["data"]
    assert [m["id"] for m in models] == [CKPT]
    st = stats(cluster)
    assert sorted(st["instances"]) == sorted(cluster["ids"])
    for wid in cluster["ids"]:
        att = st["workers"][wid]["attention"]
        assert att["layers"] == 2 and att["max_memory_allocated"] == 0


PROMPTS = ["one two three four", "the cat sat on the", "1 2 3 4 5 6 7",
           "a b c d e f g h i j", "once upon a time there was"]


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
def test_greedy_completions_equal_jax(cluster, jax_ref, stream):
    """Each prompt through the cluster gives the JAX service's answer."""
    for prompt in PROMPTS:
        body = {"model": CKPT, "prompt": prompt, "max_tokens": 12, "temperature": 0,
                "logprobs": 0, "stream": stream, "stream_options": {"include_usage": True}}
        got = {}
        for side, port in (("jax", jax_ref), ("torch", cluster["port"])):
            status, data = post(port, "/v1/completions", body)
            assert status == 200, data
            got[side] = summarize(False, stream, data)
        j, t = got["jax"], got["torch"]
        assert (t["text"], t["finish"], t["usage"]) == (j["text"], j["finish"], j["usage"])
        assert len(t["lps"]) == len(j["lps"]) == 12
        assert max(abs(a - b) for a, b in zip(t["lps"], j["lps"])) < LP_TOL


def poll(cond, timeout: float = 30.0):
    """``cond()``'s first true result, polled every 50 ms; None after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got or time.monotonic() > deadline:
            return got or None
        time.sleep(0.05)


def settled(cluster, worker: str, indexed: int) -> dict | None:
    """The stats once the router holds ``indexed`` blocks of ``worker``'s
    KV events and predicts no request in flight, and both workers publish
    an idle engine (no waiting or running request); else None."""
    st = stats(cluster)
    router = st["router"]
    if router["indexed_blocks"].get(worker, 0) < indexed:
        return None
    if any(router["active_blocks"].values()):
        return None
    if any(m["num_waiting"] or m["num_running"] for m in st["workers"].values()):
        return None
    return st


def test_prefix_affinity(cluster):
    """A group of requests sharing a long prefix lands on the worker that
    served its first request (the frontend's router reports it), and that
    worker's device prefix hits rise. Each wait polls the router's and the
    workers' published state: the first request's blocks indexed on its
    worker, no request predicted in flight, both engines idle."""
    from dynamo_tpu_torch.tokenizer import load_tokenizer

    prefix = " ".join(f"w{i}" for i in range(60))
    first_prompt = prefix + " first"
    blocks = len(load_tokenizer(CKPT).encode(first_prompt, add_bos=True)) // 4
    before = stats(cluster)
    r0 = dict(before["router"]["routed"])
    indexed0 = dict(before["router"]["indexed_blocks"])
    post(cluster["port"], "/v1/completions",
         {"model": CKPT, "prompt": first_prompt, "max_tokens": 4, "temperature": 0})
    routed = stats(cluster)["router"]["routed"]
    first = [w for w, n in routed.items() if n > r0.get(w, 0)]
    assert len(first) == 1
    mid = poll(lambda: settled(cluster, first[0], indexed0.get(first[0], 0) + blocks))
    assert mid is not None, "the first request's blocks were never indexed on its worker"
    r1 = dict(mid["router"]["routed"])
    hits0 = mid["workers"][first[0]]["prefix_hit_blocks"]
    for i in range(5):
        status, _ = post(cluster["port"], "/v1/completions",
                         {"model": CKPT, "prompt": prefix + f" then {i}", "max_tokens": 4,
                          "temperature": 0})
        assert status == 200

    def repeats_published():
        # both engines idle, and the repeats' hits in the published metrics
        st = settled(cluster, first[0], 0)
        if st and st["workers"][first[0]]["prefix_hit_blocks"] >= hits0 + 5 * 10:
            return st
        return None

    after = poll(repeats_published, timeout=10) or stats(cluster)
    delta = {w: n - r1.get(w, 0) for w, n in after["router"]["routed"].items()}
    assert delta.get(first[0], 0) == 5, delta
    assert after["workers"][first[0]]["prefix_hit_blocks"] >= hits0 + 5 * 10


def test_client_disconnect_aborts_worker_stream(cluster):
    """The client leaves after 4 chunks of a 400-token stream: the serving
    worker's engine stops it (nothing running within 2 s), far short of its
    budget."""
    body = json.dumps({"model": CKPT, "prompt": "one two three four", "max_tokens": 400,
                       "temperature": 0, "ignore_eos": True, "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", cluster["port"]), timeout=30)
    try:
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%b" % (len(body), body))
        buf = b""
        while buf.count(b"data: ") < 4:
            part = sock.recv(65536)
            assert part, buf
            buf += part
    finally:
        sock.close()
    t_cut = time.monotonic()
    while time.monotonic() - t_cut < 5:
        w = stats(cluster)["workers"]
        if all(m["num_running"] == 0 for m in w.values()):
            break
        time.sleep(0.05)
    assert time.monotonic() - t_cut < 2.0, "the worker's stream ran on after the client left"
    decode = sum(m["decode_tokens"] for m in stats(cluster)["workers"].values())
    assert decode < 10_000  # every earlier request together stays far below


def _stream(port: int, prompt: str, max_tokens: int, out: dict, key: str) -> None:
    status, data = post(port, "/v1/completions", {
        "model": CKPT, "prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
        "logprobs": 0, "ignore_eos": True, "stream": True})
    out[key] = (status, summarize(False, True, data))


def test_worker_death_migrates_streams(cluster, jax_ref):
    """SIGKILL a worker serving some of 4 in-flight streams after their
    first tokens: every stream finishes (the victim's on the other worker
    through Migration) and equals the JAX answer (or first differs at a
    near-tie); the dead instance leaves discovery within its lease; later
    requests succeed; the survivor drains on SIGTERM and exits 0."""
    prompts = [f"{p} and then" for p in PROMPTS[:4]]
    got: dict = {}
    threads = [threading.Thread(target=_stream, args=(cluster["port"], p, 48, got, p))
               for p in prompts]
    r0 = dict(stats(cluster)["router"]["routed"])
    for t in threads:
        t.start()
    # the victim: the worker that took these streams
    victim = None
    deadline = time.monotonic() + 20
    while victim is None and time.monotonic() < deadline:
        st = stats(cluster)
        running = {w: m.get("num_running", 0) + m.get("num_waiting", 0)
                   for w, m in st["workers"].items()}
        moved = {w: n - r0.get(w, 0) for w, n in st["router"]["routed"].items()}
        busy = [w for w in running if running[w] > 0 and moved.get(w, 0) > 0]
        if busy and st["workers"][busy[0]]["decode_tokens"] > 0:
            victim, on_victim = busy[0], moved[busy[0]]
        time.sleep(0.02)
    assert victim is not None
    idx = cluster["ids"].index(victim)
    cluster["workers"][idx].kill_hard()
    t_kill = time.monotonic()
    gone: dict = {}

    def watch_discovery() -> None:
        # when the frontend stops discovering the victim, read beside the
        # streams' recovery
        while time.monotonic() - t_kill < 15:
            if victim not in stats(cluster)["instances"]:
                gone["after_s"] = time.monotonic() - t_kill
                return
            time.sleep(0.05)

    watcher = threading.Thread(target=watch_discovery)
    watcher.start()
    for t in threads:
        t.join(60)
    for p in prompts:
        status, t = got[p]
        assert status == 200 and t["finish"] == "length"
        status, data = post(jax_ref, "/v1/completions", {
            "model": CKPT, "prompt": p, "max_tokens": 48, "temperature": 0, "logprobs": 0,
            "ignore_eos": True})
        j = summarize(False, False, data)
        assert len(t["lps"]) == 48
        if t["text"] != j["text"]:
            k = next(i for i, (a, b) in enumerate(zip(t["lps"], j["lps"])) if abs(a - b) > LP_TOL)
            assert abs(t["lps"][k] - j["lps"][k]) < LP_TOL, (p, k)
    with urllib.request.urlopen(cluster["base"] + "/metrics", timeout=30) as r:
        metrics = r.read().decode()
    attempts = sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                   if ln.startswith("dynamo_migration_attempts_total"))
    assert attempts >= on_victim > 0, "the victim's streams did not go through Migration"
    # the dead instance leaves discovery within its lease TTL (3 s), with
    # the coordinator's 0.25 s expiry sweep and the watch's delivery
    watcher.join(20)
    assert gone, "the dead instance is still discovered"
    assert gone["after_s"] < 3 + 2, gone
    for i in range(4):
        status, data = post(cluster["port"], "/v1/completions", {
            "model": CKPT, "prompt": f"after death {i}", "max_tokens": 6, "temperature": 0})
        assert status == 200 and json.loads(data)["choices"][0]["finish_reason"] == "length"
    # the survivor drains on SIGTERM and exits 0
    survivor = cluster["workers"][1 - idx]
    survivor.stop(grace=15)
    assert survivor.proc.returncode == 0
    assert "WORKER_DRAINED" in survivor.logs()
