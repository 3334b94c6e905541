"""The port's recipe launcher (``dynamo_tpu_torch/launch/recipe.py``)
against the JAX package's: every recipe's plan equals JAX's ``build_plan``
with the module prefix ``dynamo_tpu.`` → ``dynamo_tpu_torch.`` and the
workers' ``--engine jax`` → ``--engine torch`` (and under an engine
override), every planned argv parses with the port's component CLIs,
``--device`` reaches only the torch workers and the encoder, and ``up``
brings a mocker topology up on free ports, serves it, and stops every
child on one SIGINT.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from dynamo_tpu.launch import recipe as jrecipe
from dynamo_tpu_torch.chaos.harness import free_port
from dynamo_tpu_torch.launch import recipe as trecipe

ROOT = Path(__file__).resolve().parent.parent
RECIPES = sorted((ROOT / "recipes").rglob("*.yaml"))
NULL_PARSERS = """
apiVersion: dynamo-tpu/v1
kind: TpuServeDeployment
metadata: {name: x}
spec:
  model: tiny-llama
  parsers:
  frontend: {port: 8080}
  workers:
    - name: w
      engine: {blockSize: 4}
"""


def mapped(plan, engine_map: dict[str, str]) -> list[dict]:
    """JAX's plan in the port's terms."""
    out = []
    for p in plan.processes:
        d = dataclasses.asdict(p)
        d["module"] = d["module"].replace("dynamo_tpu.", "dynamo_tpu_torch.", 1)
        args = list(d["args"])
        for i, a in enumerate(args[:-1]):
            if a == "--engine":
                args[i + 1] = engine_map.get(args[i + 1], args[i + 1])
        d["args"] = args
        out.append(d)
    return out


def port(plan) -> list[dict]:
    return [dataclasses.asdict(p) for p in plan.processes]


def docs() -> list[tuple[str, dict, dict]]:
    out = [(f"{p.parent.name}/{p.name}", jrecipe.load_spec(p), trecipe.load_spec(p))
           for p in RECIPES]
    return out


@pytest.mark.parametrize("override", [None, "mocker", "engine"])
def test_every_plan_equals_jaxs(override, tmp_path):
    null = tmp_path / "null-parsers.yaml"
    null.write_text(NULL_PARSERS)
    cases = docs() + [("null-parsers", jrecipe.load_spec(null), trecipe.load_spec(null))]
    assert len(cases) >= 6
    for name, jdoc, tdoc in cases:
        assert tdoc == jdoc, name
        j_override = {"engine": "jax"}.get(override, override)
        t_override = {"engine": "torch"}.get(override, override)
        jplan = jrecipe.build_plan(jdoc, engine_override=j_override)
        tplan = trecipe.build_plan(tdoc, engine_override=t_override)
        assert (tplan.name, tplan.coordinator_url) == (jplan.name, jplan.coordinator_url)
        assert port(tplan) == mapped(jplan, {"jax": "torch"}), name
        assert trecipe.format_plan(tplan) == jrecipe.format_plan(jplan).replace(
            "dynamo_tpu.", "dynamo_tpu_torch.").replace("--engine jax", "--engine torch")


def test_every_planned_argv_parses_with_the_ports_clis():
    from dynamo_tpu_torch.components import encode, frontend, worker

    parsers = {"dynamo_tpu_torch.components.worker": worker.parse_args,
               "dynamo_tpu_torch.components.encode": encode.parse_args,
               "dynamo_tpu_torch.components.frontend": frontend.parse_args}
    seen = set()
    for path in RECIPES:
        for p in trecipe.build_plan(trecipe.load_spec(path), device="cpu").processes:
            if p.module in parsers:
                parsers[p.module](p.args)   # SystemExit on an unknown flag
                seen.add(p.module)
    assert seen == set(parsers)


def test_device_reaches_the_torch_workers_and_the_encoder():
    doc = trecipe.load_spec(ROOT / "recipes/llama-3-8b/multimodal.yaml")
    plain = {p.name: p.args for p in trecipe.build_plan(doc).processes}
    on_cpu = {p.name: p.args for p in trecipe.build_plan(doc, device="cpu").processes}
    for name in plain:
        extra = on_cpu[name][len(plain[name]):]
        assert on_cpu[name][:len(plain[name])] == plain[name]
        assert extra == (["--device", "cpu"] if name in ("worker", "encoder") else []), name
    mock = {p.name: p.args for p in trecipe.build_plan(
        doc, engine_override="mocker", device="cpu").processes}
    assert "--device" not in mock["worker"] and "--device" in mock["encoder"]


def test_the_tokenizer_key_reaches_the_workers(tmp_path):
    """The port's own ``tokenizer`` key: absent from every shipped recipe
    (their plans equal JAX's), it plans the workers' ``--tokenizer``."""
    assert not any("tokenizer" in p.read_text() for p in RECIPES)
    r = tmp_path / "t.yaml"
    r.write_text(NULL_PARSERS + "  tokenizer: /tok\n")
    w = next(p for p in trecipe.build_plan(trecipe.load_spec(r)).processes if p.name == "w")
    assert w.args[w.args.index("--tokenizer") + 1] == "/tok"


def test_bad_spec_refused(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("kind: SomethingElse\n")
    with pytest.raises(ValueError, match="expected kind"):
        trecipe.load_spec(bad)
    bad.write_text("kind: TpuServeDeployment\nspec: {model: x}\n")
    with pytest.raises(ValueError, match="missing spec/metadata"):
        trecipe.load_spec(bad)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie (exited, not yet reaped by its parent) counts as gone
    try:
        return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except OSError:
        return False


def test_recipe_up_serves_a_mocker_topology_and_stops_on_sigint(tmp_path):
    coord, http = free_port(), free_port()
    recipe = tmp_path / "tiny.yaml"
    recipe.write_text(f"""
apiVersion: dynamo-tpu/v1
kind: TpuServeDeployment
metadata: {{name: tiny-up}}
spec:
  model: tiny-llama
  coordinator: {{port: {coord}}}
  frontend: {{port: {http}, routerMode: kv}}
  workers:
    - name: worker
      replicas: 1
      engine: {{blockSize: 4, numBlocks: 128, maxModelLen: 512}}
""")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.recipe", "up", str(recipe),
         "--engine", "mocker", "--start-timeout", "60"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    pids: list[int] = []
    try:
        deadline = time.time() + 90
        for line in proc.stdout:  # type: ignore[union-attr]
            if "RECIPE_UP" in line:
                pids = [int(x) for x in line.split("pids=", 1)[1].split()]
                break
            assert time.time() < deadline and proc.poll() is None, "no RECIPE_UP"
        assert len(pids) == 3, pids
        req = urllib.request.Request(
            f"http://127.0.0.1:{http}/v1/completions",
            data=json.dumps({"model": "tiny-llama", "prompt": "hi", "max_tokens": 4,
                             "ignore_eos": True}).encode(),
            headers={"content-type": "application/json"})
        deadline = time.time() + 30
        while True:
            try:
                with urllib.request.urlopen(req, timeout=5) as resp:
                    body = json.load(resp)
                break
            except OSError:
                assert time.time() < deadline, "the frontend never served the model"
                time.sleep(0.3)
        assert body["choices"][0]["finish_reason"] == "length"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(30) == 0
        assert not [p for p in pids if _alive(p)]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_recipe_up_reports_a_childs_refusal(tmp_path):
    """The JAX recipes' ``grpcPort`` plans ``--grpc-port``; the port's
    frontend refuses it by name, and ``up`` fails with that refusal."""
    coord, http = free_port(), free_port()
    recipe = tmp_path / "grpc.yaml"
    recipe.write_text(f"""
apiVersion: dynamo-tpu/v1
kind: TpuServeDeployment
metadata: {{name: grpc-up}}
spec:
  model: tiny-llama
  coordinator: {{port: {coord}}}
  frontend: {{port: {http}, grpcPort: {free_port()}}}
""")
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.recipe", "up", str(recipe),
         "--start-timeout", "60"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "frontend exited" in res.stderr and "KServe gRPC" in res.stderr, res.stderr[-2000:]
