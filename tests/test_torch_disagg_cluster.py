"""Disaggregated serving as processes, on the CPU: a coordinator, a
``--disagg prefill`` worker, a ``--disagg decode`` worker pulling its
prompts' KV from it, both ``--engine torch --device cpu`` on
tests/data/tiny-real-llama at f32, and the frontend with
``--router-mode kv`` (the shape of tests/test_disagg.py's slow e2e case).
Greedy answers are held to the JAX package's aggregated in-process engine
and HTTP service (text, usage, log-probs within 1e-4); the decode worker
pulls blocks over the shard server and the prefill worker releases its
staging pins; with the prefill worker killed, the decode worker answers
the same through local prefill. Every wait polls published state with a
deadline.
"""

from __future__ import annotations

import json
import time
import urllib.request

import pytest

from tests.test_torch_cluster import CKPT, LP_TOL, get_json, jax_ref  # noqa: F401
from tests.test_torch_http_e2e import post, summarize
from tests.utils_process import ManagedProcess, free_port

# the default lease TTL (20 s): nothing here waits for a dead worker to
# leave discovery, and a short lease can expire while a loaded machine
# starts a worker
ENV = {"DYN_LOG": "info"}
WORKER_ARGS = ["--engine", "torch", "--device", "cpu", "--model", CKPT, "--dtype", "float32",
               "--block-size", "4", "--num-blocks", "256", "--max-model-len", "512",
               "--max-batch-size", "8", "--prefill-chunk", "32", "--kv-transfer-ttl", "4"]
#: prompts of 3 to 21 blocks of 4: the longest prefill in two chunks, so
#: its handoff streams in waves
PROMPTS = ["one two three four five six seven eight nine ten",
           "the cat sat on the mat and the dog sat on the log and the bird sat on the "
           "branch of the old tree by the river",
           "1 2 3 4 5 6 7 8 9 10 11 12 13",
           "a b c d e f g h i j k l m n o p"]


def poll(cond, timeout: float = 30.0):
    """``cond()``'s first true result, polled every 50 ms; None after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got or time.monotonic() > deadline:
            return got or None
        time.sleep(0.05)


@pytest.fixture(scope="module")
def disagg():
    coord_port, http_port, status_port = free_port(), free_port(), free_port()
    coordinator = ManagedProcess(
        ["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
         "--port", str(coord_port)], name="coordinator", env=ENV).start()
    coordinator.wait_for_line("COORDINATOR_READY", 30)
    url = f"tcp://127.0.0.1:{coord_port}"
    prefill = ManagedProcess(
        ["-m", "dynamo_tpu_torch.components.worker", "--coordinator", url, *WORKER_ARGS,
         "--component", "prefill", "--disagg", "prefill"], name="prefill",
        env={**ENV, "DYN_SYSTEM_ENABLED": "true", "DYN_SYSTEM_PORT": str(status_port)}).start()
    decode = ManagedProcess(
        ["-m", "dynamo_tpu_torch.components.worker", "--coordinator", url, *WORKER_ARGS,
         "--disagg", "decode", "--prefill-endpoint", "dyn://dynamo.prefill.generate"],
        name="decode", env=ENV).start()
    frontend = None
    try:
        prefill.wait_for_line("WORKER_READY", 60)
        decode_id = decode.wait_for_line("WORKER_READY", 60).split("instance=")[1].strip()
        frontend = ManagedProcess(
            ["-m", "dynamo_tpu_torch.components.frontend", "--coordinator", url,
             "--host", "127.0.0.1", "--port", str(http_port), "--router-mode", "kv"],
            name="frontend", env=ENV).start()
        frontend.wait_for_line("FRONTEND_READY", 30)
        base = f"http://127.0.0.1:{http_port}"
        assert poll(lambda: get_json(base + "/engine_stats").get(CKPT, {}).get("workers")), \
            "the frontend never saw the decode worker's stats"
        yield {"base": base, "port": http_port, "decode_id": decode_id.lstrip("0"),
               "prefill": prefill, "decode": decode,
               "prefill_health": f"http://127.0.0.1:{status_port}/health"}
    finally:
        if frontend is not None:
            frontend.stop()
        decode.stop()
        prefill.stop()
        coordinator.stop()


def decode_stats(d) -> dict:
    return get_json(d["base"] + "/engine_stats")[CKPT]["workers"][d["decode_id"]]


def prefill_stats(d) -> dict:
    with urllib.request.urlopen(d["prefill_health"], timeout=30) as r:
        return json.loads(r.read())["engine"]


def test_only_the_decode_worker_is_discovered(disagg):
    """The prefill worker registers no model card: the frontend serves the
    model from the decode worker alone."""
    models = get_json(disagg["base"] + "/v1/models")["data"]
    assert [m["id"] for m in models] == [CKPT]
    st = get_json(disagg["base"] + "/engine_stats")[CKPT]
    assert [i.lstrip("0") for i in st["instances"]] == [disagg["decode_id"]]


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
def test_greedy_completions_through_the_handoff_equal_jax(disagg, jax_ref, stream):
    """Each prompt, prefilled on the prefill worker and decoded on the
    decode worker from the pulled KV, gives the JAX service's answer. Every
    request prefilled remotely (none fell back), the decode worker pulled
    blocks, the prefill worker ran the forward steps, and once the decode
    side's release acks land no staging pin is left."""
    d0, p0 = decode_stats(disagg), prefill_stats(disagg)
    # other prompts for the second case: blocks the decode worker holds
    # already are pulled but not injected again
    for prompt in (["so " + p for p in PROMPTS] if stream else PROMPTS):
        body = {"model": CKPT, "prompt": prompt, "max_tokens": 12, "temperature": 0,
                "logprobs": 0, "stream": stream, "stream_options": {"include_usage": True}}
        got = {}
        for side, port in (("jax", jax_ref), ("torch", disagg["port"])):
            status, data = post(port, "/v1/completions", body)
            assert status == 200, data
            got[side] = summarize(False, stream, data)
        j, t = got["jax"], got["torch"]
        assert (t["text"], t["finish"], t["usage"]) == (j["text"], j["finish"], j["usage"])
        assert len(t["lps"]) == len(j["lps"]) == 12
        assert max(abs(a - b) for a, b in zip(t["lps"], j["lps"])) < LP_TOL

    def handed_off():
        d, p = decode_stats(disagg), prefill_stats(disagg)
        done = (d["disagg"]["remote_prefills"] - d0["disagg"]["remote_prefills"] == len(PROMPTS)
                and p["kv_transfer"]["staged_pins"] == 0)
        return (d, p) if done else None

    got = poll(handed_off)
    assert got is not None, (decode_stats(disagg), prefill_stats(disagg))
    d1, p1 = got
    assert d1["disagg"]["local_fallbacks"] == d0["disagg"]["local_fallbacks"]
    pulled = d1["kv_transfer"]["pull"]["blocks"] - d0["kv_transfer"]["pull"]["blocks"]
    # (len - 1) // 4 blocks a prompt at most: the tail block is recomputed
    assert 0 < pulled <= sum(50 for _ in PROMPTS)
    assert d1["kv_transfer"]["injects"] > d0["kv_transfer"]["injects"]
    assert p1["attention"]["forward_steps"] > p0["attention"]["forward_steps"]
    assert p1["kv_transfer"]["extract_blocks"] - p0["kv_transfer"]["extract_blocks"] == pulled


def test_prefill_worker_killed_falls_back_to_local_prefill(disagg, jax_ref):
    """SIGKILL the prefill worker by its PID: the next request gives the
    same answer through the decode worker's own prefill."""
    prompt = PROMPTS[1]
    body = {"model": CKPT, "prompt": prompt, "max_tokens": 12, "temperature": 0}
    status, data = post(jax_ref, "/v1/completions", body)
    assert status == 200
    want = summarize(False, False, data)
    d0 = decode_stats(disagg)
    disagg["prefill"].kill_hard()
    disagg["prefill"].proc.wait(10)
    status, data = post(disagg["port"], "/v1/completions", body)
    assert status == 200, data
    got = summarize(False, False, data)
    assert (got["text"], got["finish"], got["usage"]) == (want["text"], want["finish"],
                                                          want["usage"])
    d1 = poll(lambda: (lambda d: d if d["disagg"]["local_fallbacks"]
                       > d0["disagg"]["local_fallbacks"] else None)(decode_stats(disagg)))
    assert d1 is not None, decode_stats(disagg)
    assert d1["disagg"]["remote_prefills"] == d0["disagg"]["remote_prefills"]
