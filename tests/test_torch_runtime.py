"""The port's distributed runtime against the JAX package's.

The cases of tests/test_runtime.py run with the workers' runtimes of one
package and the calling client of the other (both directions); the cases
of tests/test_pipeline.py and tests/test_tasks.py run on the port's
pipeline, Migration and TaskTracker. Each JAX case is re-bound to the
port's classes (its module globals swapped), so the twin asserts what the
JAX test asserts. A scripted-failure table then holds the port's Migration
to JAX's re-issued requests field by field.
"""

from __future__ import annotations

import asyncio
import contextlib
import types

import pytest

import dynamo_tpu.frontend.migration as jax_mig
import dynamo_tpu.kvbm.stream_ckpt as jax_ckpt
import dynamo_tpu.protocols.common as jax_common
import dynamo_tpu.qos.deadline as jax_deadline
import dynamo_tpu.runtime.client as jax_rclient
import dynamo_tpu.runtime.pipeline as jax_pipe
import dynamo_tpu.runtime.protocols as jax_rproto
import dynamo_tpu.runtime.runtime as jax_runtime
import dynamo_tpu.runtime.tasks as jax_tasks
import dynamo_tpu.transports.client as jax_tclient
import dynamo_tpu.transports.coordinator as jax_coord
import dynamo_tpu.utils.config as jax_config
import dynamo_tpu_torch.frontend.migration as torch_mig
import dynamo_tpu_torch.kvbm.stream_ckpt as torch_ckpt
import dynamo_tpu_torch.protocols.common as torch_common
import dynamo_tpu_torch.qos.deadline as torch_deadline
import dynamo_tpu_torch.runtime.client as torch_rclient
import dynamo_tpu_torch.runtime.pipeline as torch_pipe
import dynamo_tpu_torch.runtime.protocols as torch_rproto
import dynamo_tpu_torch.runtime.runtime as torch_runtime
import dynamo_tpu_torch.runtime.tasks as torch_tasks
import dynamo_tpu_torch.runtime.barrier as torch_barrier
import dynamo_tpu_torch.transports.client as torch_tclient
import dynamo_tpu_torch.transports.coordinator as torch_coord
import dynamo_tpu_torch.utils.config as torch_config
from tests import test_pipeline as jax_pipeline_tests
from tests import test_runtime as jax_runtime_tests
from tests import test_tasks as jax_tasks_tests


def rebind(fn, **names):
    """``fn`` with ``names`` swapped into its module globals."""
    g = dict(fn.__globals__)
    g.update(names)
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def server_names(pkg: str) -> dict:
    coord, rt, cfg = ((torch_coord, torch_runtime, torch_config) if pkg == "torch"
                      else (jax_coord, jax_runtime, jax_config))
    return {"CoordinatorServer": coord.CoordinatorServer,
            "DistributedRuntime": rt.DistributedRuntime,
            "RuntimeConfig": cfg.RuntimeConfig}


def client_names(pkg: str) -> dict:
    rc, rt, proto = ((torch_rclient, torch_runtime, torch_rproto) if pkg == "torch"
                     else (jax_rclient, jax_runtime, jax_rproto))
    return {"DistributedRuntime": rt.DistributedRuntime,
            "EndpointClient": rc.EndpointClient,
            "EndpointId": proto.EndpointId,
            "PushRouter": rc.PushRouter,
            "RouterMode": rc.RouterMode,
            "StreamError": rc.StreamError,
            "NoInstancesError": rc.NoInstancesError}


RUNTIME_CASES = [n for n in dir(jax_runtime_tests) if n.startswith("test_")]
# (workers' package, caller's package)
DIRECTIONS = [("torch", "jax"), ("jax", "torch")]


@pytest.mark.parametrize("served,caller", DIRECTIONS,
                         ids=[f"{s}_served-{c}_calls" for s, c in DIRECTIONS])
@pytest.mark.parametrize("case", RUNTIME_CASES)
async def test_runtime_across_packages(case, served, caller):
    """One case of tests/test_runtime.py with the coordinator and the
    serving runtimes of ``served`` and the client of ``caller``. Cases
    with no client (the status server, no instances) run on ``served``
    alone."""
    cluster = contextlib.asynccontextmanager(
        rebind(jax_runtime_tests.cluster.__wrapped__, **server_names(served)))
    make_client = rebind(jax_runtime_tests.make_client, **client_names(caller))
    names = {**client_names(caller), "cluster": cluster, "make_client": make_client}
    if case in ("test_system_status_server", "test_no_instances_error"):
        names.update(server_names(served))
        if case == "test_no_instances_error":
            names.update({k: v for k, v in client_names(served).items()
                          if k != "DistributedRuntime"})
    if case == "test_leader_worker_barrier":
        # the port's barrier over the caller's coordinator clients and the
        # served package's coordinator (the case imports both inside)
        names.update(server_names(served))
        with swapped_modules({
                "dynamo_tpu.runtime.barrier": torch_barrier,
                "dynamo_tpu.transports.client": (torch_tclient if caller == "torch"
                                                 else jax_tclient)}):
            await rebind(getattr(jax_runtime_tests, case), **names)()
        return
    await rebind(getattr(jax_runtime_tests, case), **names)()


@contextlib.contextmanager
def swapped_modules(mods: dict):
    """``sys.modules`` entries swapped for a case's deferred imports."""
    import sys

    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_status_server_answers_equal_jax():
    """The port's status server over frontend/http.py answers /health,
    /live and /metrics as the JAX one over aiohttp does (uptime masked)."""
    import json
    import urllib.request

    async def answers(pkg):
        names = server_names(pkg)
        server = names["CoordinatorServer"]()
        await server.start()
        rt = await names["DistributedRuntime"].create(names["RuntimeConfig"](
            coordinator_url=server.url, system_enabled=True, system_port=0))
        out = {}
        try:
            rt.status_server.add_provider("engine", lambda: {
                "kv_usage": 0.25, "num_running": 3, "ready": True, "nested": {"x": 1}})
            base = f"http://127.0.0.1:{rt.status_server.port}"
            loop = asyncio.get_running_loop()

            def get(path):
                try:
                    with urllib.request.urlopen(base + path, timeout=5) as r:
                        return r.status, r.headers.get("content-type"), r.read()
                except urllib.error.HTTPError as e:
                    return e.code, e.headers.get("content-type"), e.read()

            for path in ("/health", "/live", "/metrics", "/nope"):
                status, ctype, body = await loop.run_in_executor(None, get, path)
                if path == "/health":
                    body = json.loads(body)
                    body.pop("uptime_s")
                out[path] = (status, ctype, body)
            rt.status_server.ready = False
            status, _, body = await loop.run_in_executor(None, get, "/health")
            out["notready"] = (status, json.loads(body)["status"])
        finally:
            await rt.shutdown()
            await server.stop()
        return out

    got, ref = asyncio.run(answers("torch")), asyncio.run(answers("jax"))
    # aiohttp's 404 body and the port's are both "404: Not Found"
    assert got == ref


# ---------------------------------------------------------------------------
# Pipeline, Migration, TaskTracker
# ---------------------------------------------------------------------------

def _pipeline_names() -> dict:
    names = {
        "Migration": torch_mig.Migration,
        "CKPT_DRAWS_KEY": torch_ckpt.CKPT_DRAWS_KEY,
        "CKPT_GENERATED_KEY": torch_ckpt.CKPT_GENERATED_KEY,
        "CKPT_KEY_DATA_KEY": torch_ckpt.CKPT_KEY_DATA_KEY,
        "CKPT_KEY_DRAWS_KEY": torch_ckpt.CKPT_KEY_DRAWS_KEY,
        "FinishReason": torch_common.FinishReason,
        "PreprocessedRequest": torch_common.PreprocessedRequest,
        "StopConditions": torch_common.StopConditions,
        "DEADLINE_KEY": torch_deadline.DEADLINE_KEY,
        "StreamError": torch_rclient.StreamError,
    }
    for n in ("FnSink", "MapOutput", "MapRequest", "Operator", "Pipeline", "link"):
        names[n] = getattr(torch_pipe, n)
    tag = jax_pipeline_tests.Tag
    names["Tag"] = type("Tag", (torch_pipe.Operator,),
                        {k: v for k, v in vars(tag).items()
                         if k not in ("__dict__", "__weakref__")})
    return names


PIPELINE_CASES = [n for n in dir(jax_pipeline_tests) if n.startswith("test_")]


@pytest.mark.parametrize("case", PIPELINE_CASES)
async def test_pipeline_twin(case, monkeypatch):
    fn = rebind(getattr(jax_pipeline_tests, case), **_pipeline_names())
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        await fn(monkeypatch)
    else:
        await fn()


TASK_CASES = [n for n in dir(jax_tasks_tests) if n.startswith("test_")]


@pytest.mark.parametrize("case", TASK_CASES)
async def test_tasks_twin(case):
    await rebind(getattr(jax_tasks_tests, case),
                 ComputePool=torch_tasks.ComputePool,
                 RetryPolicy=torch_tasks.RetryPolicy,
                 TaskTracker=torch_tasks.TaskTracker)()


# Scripted failures: attempt k of a worker yields SCRIPT[k]'s tokens, then
# raises (or finishes, on the last). The re-issued requests must be equal.
SCRIPTS = {
    "one_break": [[7, 8], [9]],
    "two_breaks": [[1, 2, 3], [4, 5], [6]],
    "break_before_tokens": [[], [1], [2, 3]],
    "limit_exhausted": [[1], [2], [3], [4], [5]],
}


async def _migrate(pkg: str, script: list[list[int]], with_ckpt: bool, expired: bool):
    mig, common, rclient, deadline = (
        (torch_mig, torch_common, torch_rclient, torch_deadline) if pkg == "torch"
        else (jax_mig, jax_common, jax_rclient, jax_deadline))
    issued: list[dict] = []

    async def worker(req):
        k = len(issued)
        issued.append(req.to_dict())
        yield {"token_ids": script[k]}
        if k == len(script) - 1:
            yield {"token_ids": [], "finish_reason": "stop"}
            return
        raise rclient.StreamError(f"worker died on attempt {k}")

    async def lookup(rid):
        return {"rid": rid, "generated": [1], "key": [3, 4], "draws": 1}

    m = mig.Migration(inner=worker, migration_limit=3,
                      lookup_ckpt=lookup if with_ckpt else None)
    req = common.PreprocessedRequest(
        token_ids=[11, 12, 13], stop_conditions=common.StopConditions(max_tokens=20),
        annotations={"qos.priority": "interactive"})
    req.request_id = "scripted"
    if expired:
        req.annotations[deadline.DEADLINE_KEY] = 1000.0  # long past
    items = []
    try:
        async for item in m.generate(req):
            items.append(item)
        err = None
    except Exception as exc:  # noqa: BLE001 - compared by type name and text
        err = (type(exc).__name__, str(exc))
    return issued, items, err


@pytest.mark.parametrize("expired", [False, True], ids=["live", "deadline_passed"])
@pytest.mark.parametrize("with_ckpt", [False, True], ids=["reprompt", "ckpt"])
@pytest.mark.parametrize("script", list(SCRIPTS))
async def test_migration_reissues_equal_jax(script, with_ckpt, expired, monkeypatch):
    real_sleep = asyncio.sleep
    monkeypatch.setattr(asyncio, "sleep", lambda s: real_sleep(0))
    got = await _migrate("torch", SCRIPTS[script], with_ckpt, expired)
    ref = await _migrate("jax", SCRIPTS[script], with_ckpt, expired)
    assert got == ref
    assert got[0], "the first dispatch is always made"
