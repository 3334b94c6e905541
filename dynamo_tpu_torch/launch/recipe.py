"""Recipe launcher: declarative serving topologies → running processes.

Copy of ``dynamo_tpu/launch/recipe.py`` over the port's own YAML reader
(``utils/yaml_lite.py``). A ``TpuServeDeployment`` YAML names the model,
the frontend(s), an optional encoder pool and kv-store, and worker pools
with their mesh geometry; each maps onto one of the port's component CLIs
(``dynamo_tpu_torch.components.*``).

The plan is the JAX package's plan with the module prefix
``dynamo_tpu_torch.`` and the workers' default engine ``torch``; one key
is the port's own: ``tokenizer`` (on the spec or a worker) plans the
workers' ``--tokenizer``, for a checkpoint without a tokenizer of its own
(a GGUF file). Two consumers:

- ``plan``: print the process commands a deployment implies.
- ``up``: run the whole topology locally (one host): coordinator →
  kv-store → encoder → workers → frontend → aggregator → planner,
  readiness-gated, every child stopped on SIGINT or SIGTERM. ``--engine
  mocker`` overrides every worker's engine for card-free runs; ``--device
  cpu`` runs the torch workers and the encoder on the CPU (without it they
  run on the CUDA card). A child that exits before its ready line (a flag
  the port refuses by name, such as the frontend's ``--grpc-port``) fails
  ``up`` with its last lines.

    python -m dynamo_tpu_torch.launch.recipe plan recipes/llama-3-70b/disagg-v5e-64.yaml
    python -m dynamo_tpu_torch.launch.recipe up recipes/llama-3-8b/agg.yaml --engine mocker
"""

from __future__ import annotations

import argparse
import collections
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from dynamo_tpu_torch.utils import yaml_lite
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("recipe")

KIND = "TpuServeDeployment"
PKG = "dynamo_tpu_torch"


@dataclass
class Process:
    """One planned process: a component module + argv."""

    name: str
    module: str
    args: list[str]
    replicas: int = 1
    ready_line: str | None = None
    # Processes sharing a group are spawned together before any readiness
    # wait: the ranks of one multi-host engine wait for each other.
    group: str | None = None

    def argv(self) -> list[str]:
        return [sys.executable, "-m", self.module, *self.args]


@dataclass
class Plan:
    name: str
    coordinator_url: str
    processes: list[Process] = field(default_factory=list)


def _engine_args(engine: dict[str, Any]) -> list[str]:
    flags = {
        "blockSize": "--block-size", "numBlocks": "--num-blocks",
        "maxBatchSize": "--max-batch-size", "maxModelLen": "--max-model-len",
        "decodeWindow": "--decode-window", "hostKvBlocks": "--host-kv-blocks",
        "diskKvPath": "--disk-kv-path", "remoteKvAddr": "--remote-kv-addr",
    }
    # Boolean switches: present-and-truthy emits the bare flag.
    switches = {"globalPrefixCache": "--global-prefix-cache"}
    out: list[str] = []
    for key, flag in flags.items():
        if key in engine:
            out += [flag, str(engine[key])]
    for key, flag in switches.items():
        if engine.get(key):
            out.append(flag)
    return out


def _mesh_args(mesh: dict[str, Any]) -> list[str]:
    out: list[str] = []
    for axis in ("tp", "pp", "dp", "ep", "sp"):
        if axis in mesh:
            out += [f"--{axis}", str(mesh[axis])]
    return out


def load_spec(path: str | Path) -> dict:
    with open(path) as f:
        doc = yaml_lite.safe_load(f.read())
    if not isinstance(doc, dict) or doc.get("kind") != KIND:
        raise ValueError(f"{path}: expected kind {KIND}")
    if "spec" not in doc or "metadata" not in doc:
        raise ValueError(f"{path}: missing spec/metadata")
    return doc


def build_plan(doc: dict, engine_override: str | None = None,
               coordinator_port: int = 4222, device: str | None = None) -> Plan:
    """Pure mapping: deployment spec → process list. ``device`` (e.g.
    ``"cpu"``) goes to every torch worker and the encoder as ``--device``."""
    spec = doc["spec"]
    name = doc["metadata"]["name"]
    coord = spec.get("coordinator", {})
    url = coord.get("external") or f"tcp://127.0.0.1:{coord.get('port', coordinator_port)}"
    plan = Plan(name=name, coordinator_url=url)
    dev_args = ["--device", device] if device else []

    if not coord.get("external"):
        plan.processes.append(Process(
            name="coordinator", module=f"{PKG}.transports.coordinator",
            args=["--host", "0.0.0.0", "--port", str(coord.get("port", coordinator_port))],
            ready_line="COORDINATOR_READY"))

    if "kvStore" in spec:
        ks = spec["kvStore"]
        plan.processes.append(Process(
            name="kv-store", module=f"{PKG}.components.kv_store",
            args=["--coordinator", url,
                  "--capacity-gib", str(ks.get("capacityGib", 4)),
                  "--port", str(ks.get("port", 0))],
            ready_line="KV_STORE_READY"))

    if "encoder" in spec:
        enc = spec["encoder"] or {}
        plan.processes.append(Process(
            name="encoder", module=f"{PKG}.components.encode",
            args=["--coordinator", url,
                  "--image-tokens", str(enc.get("imageTokens", 8)),
                  "--lm-hidden", str(enc.get("lmHidden", 64)),
                  "--image-size", str(enc.get("imageSize", 64))] + dev_args,
            replicas=int(enc.get("replicas", 1)),
            ready_line="ENCODE_READY"))

    model = spec["model"]
    for w in spec.get("workers", []):
        engine = engine_override or w.get("engine_kind", "torch")
        args = ["--coordinator", url, "--model", model, "--engine", engine]
        if w.get("servedModelName") or spec.get("servedModelName"):
            args += ["--served-model-name",
                     w.get("servedModelName") or spec["servedModelName"]]
        if w.get("tokenizer") or spec.get("tokenizer"):
            # the port's own key (no shipped recipe has it): a tokenizer
            # directory for a checkpoint without one, such as a GGUF file
            args += ["--tokenizer", w.get("tokenizer") or spec["tokenizer"]]
        parsers = w.get("parsers") or spec.get("parsers") or {}
        if parsers.get("toolCall"):
            args += ["--tool-call-parser", parsers["toolCall"]]
        if parsers.get("reasoning"):
            args += ["--reasoning-parser", parsers["reasoning"]]
        role = w.get("role", "none")
        if role in ("prefill", "decode"):
            args += ["--disagg", role]
            if role == "prefill":
                args += ["--component", "prefill"]
        args += _mesh_args(w.get("mesh", {}))
        args += _engine_args(w.get("engine", {}))
        if engine == "torch":
            args += dev_args
        nodes = int(w.get("nodes", 1))
        if engine_override and engine_override != "torch":
            # Card-free override (mocker): a simulator doesn't shard — one
            # process stands in for the whole multi-host engine.
            nodes = 1
        if nodes > 1:
            # Multi-host: one process per (replica, rank); rank 0 leads.
            # Each replica rendezvouses in its own group.
            for rep in range(int(w.get("replicas", 1))):
                group = f"{name}.{w['name']}.r{rep}"
                for rank in range(nodes):
                    plan.processes.append(Process(
                        name=f"{w['name']}-r{rep}-rank{rank}",
                        module=f"{PKG}.components.worker",
                        args=args + ["--num-nodes", str(nodes),
                                     "--node-rank", str(rank),
                                     "--multihost-group", group],
                        replicas=1, group=group,
                        ready_line="WORKER_READY" if rank == 0 else None))
        else:
            plan.processes.append(Process(
                name=w["name"], module=f"{PKG}.components.worker",
                args=args, replicas=int(w.get("replicas", 1)),
                ready_line="WORKER_READY"))

    fe = spec.get("frontend", {})
    fe_args = ["--coordinator", url,
               "--port", str(fe.get("port", 8080)),
               "--router-mode", fe.get("routerMode", "kv")]
    if "encoder" in spec:
        fe_args += ["--encoder-endpoint", "dyn://dynamo.encoder.encode"]
    if "grpcPort" in fe:
        fe_args += ["--grpc-port", str(fe["grpcPort"])]
    if "migrationLimit" in fe:
        fe_args += ["--migration-limit", str(fe["migrationLimit"])]
    qos = fe.get("qos", {})
    if qos.get("enabled") is False:
        fe_args += ["--no-qos"]
    for key, flag in (("defaultPriority", "--qos-default-priority"),
                      ("rateLimitRps", "--qos-rate-limit-rps"),
                      ("rateBurst", "--qos-rate-burst"),
                      ("degradeQueueDepth", "--qos-degrade-queue-depth"),
                      ("shedQueueDepth", "--qos-shed-queue-depth"),
                      ("maxQueueDepth", "--qos-max-queue-depth"),
                      ("clampMaxTokens", "--qos-clamp-max-tokens"),
                      ("defaultDeadlineMs", "--qos-default-deadline-ms")):
        if key in qos:
            fe_args += [flag, str(qos[key])]
    plan.processes.append(Process(
        name="frontend", module=f"{PKG}.components.frontend",
        args=fe_args, replicas=int(fe.get("replicas", 1)),
        ready_line="FRONTEND_READY"))

    agg_port = None
    if spec.get("aggregator", {}).get("enabled"):
        ag = spec["aggregator"]
        agg_port = int(ag.get("port", 9090))
        ag_args = ["--coordinator", url, "--port", str(agg_port)]
        for key, flag in (("scrapeInterval", "--scrape-interval"),
                          ("scrapeTimeout", "--scrape-timeout"),
                          ("stalenessTtl", "--staleness-ttl"),
                          ("sloSpec", "--slo-spec")):
            if key in ag:
                ag_args += [flag, str(ag[key])]
        plan.processes.append(Process(
            name="aggregator", module=f"{PKG}.components.aggregator",
            args=ag_args, ready_line="AGGREGATOR_READY"))

    if spec.get("planner", {}).get("enabled"):
        pl = spec["planner"]
        pl_args = ["--coordinator", url]
        if agg_port is not None:
            # Close the SLA loop: the planner consumes the aggregator's
            # fleet-wide rollup instead of a single frontend.
            pl_args += ["--fleet-url", f"http://127.0.0.1:{agg_port}"]
        for key, flag in (("ttftSla", "--ttft-sla"), ("itlSla", "--itl-sla"),
                          ("minReplicas", "--min-replicas"),
                          ("maxReplicas", "--max-replicas"),
                          ("chipBudget", "--chip-budget"),
                          ("adjustmentInterval", "--adjustment-interval"),
                          ("mode", "--mode")):
            if key in pl:
                pl_args += [flag, str(pl[key])]
        plan.processes.append(Process(
            name="planner", module=f"{PKG}.components.planner",
            args=pl_args))
    return plan


def format_plan(plan: Plan) -> str:
    lines = [f"deployment {plan.name} (coordinator {plan.coordinator_url}):"]
    for p in plan.processes:
        rep = f" x{p.replicas}" if p.replicas > 1 else ""
        lines.append(f"  [{p.name}{rep}] " + " ".join(p.argv()))
    return "\n".join(lines)


class _Child:
    """A spawned process with a drain thread: the pipe is read for the
    process's whole life (a full pipe would block the child mid-serve), the
    ready line is detected without blocking the launcher, and the last
    lines are kept for the error of a child that exits before it is ready."""

    def __init__(self, spec: Process, idx: int):
        self.spec = spec
        self.proc = subprocess.Popen(
            spec.argv(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.name = spec.name if spec.replicas == 1 else f"{spec.name}[{idx}]"
        self.ready = threading.Event()
        self.tail: collections.deque[str] = collections.deque(maxlen=20)
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        for line in self.proc.stdout:  # type: ignore[union-attr]
            self.tail.append(line.rstrip("\n"))
            sys.stdout.write(f"{self.name}: {line}")
            sys.stdout.flush()
            if self.spec.ready_line and self.spec.ready_line in line:
                self.ready.set()

    def wait_ready(self, deadline: float) -> None:
        while not self.ready.wait(timeout=0.25):
            if self.proc.poll() is not None:
                self._thread.join(5)
                raise RuntimeError(f"{self.name} exited rc={self.proc.returncode} "
                                   "before ready:\n" + "\n".join(self.tail))
            if time.monotonic() > deadline:
                raise TimeoutError(f"{self.name} not ready in time")


def run_local(plan: Plan, timeout: float = 600.0) -> None:
    """Launch every process on this host. Processes are readiness-gated in
    plan order, except that a ``group`` (multi-host rank set) is spawned in
    full before its readiness wait."""
    children: list[_Child] = []

    def stop_all() -> None:
        for c in reversed(children):
            if c.proc.poll() is None:
                c.proc.terminate()
        for c in reversed(children):
            try:
                c.proc.wait(10)
            except subprocess.TimeoutExpired:
                c.proc.kill()
                c.proc.wait()

    def spawn(p: Process) -> list[_Child]:
        out = []
        for r in range(p.replicas):
            c = _Child(p, r)
            children.append(c)
            out.append(c)
            log.info("started %s pid=%d", c.name, c.proc.pid)
        return out

    def interrupted(signum, frame):
        raise KeyboardInterrupt(signal.Signals(signum).name)

    # Until the children are up, SIGTERM unwinds like SIGINT, so the finally
    # stops what was started. (A blocked mask would be inherited by the
    # children, whose drain waits on these signals.)
    signal.signal(signal.SIGTERM, interrupted)
    try:
        i = 0
        procs = plan.processes
        while i < len(procs):
            group = procs[i].group
            batch: list[_Child] = []
            if group is None:
                batch += spawn(procs[i])
                i += 1
            else:  # spawn the whole rank group before any wait
                while i < len(procs) and procs[i].group == group:
                    batch += spawn(procs[i])
                    i += 1
            deadline = time.monotonic() + timeout
            for c in batch:
                if c.spec.ready_line:
                    c.wait_ready(deadline)
        pids = " ".join(str(c.proc.pid) for c in children)
        print(f"RECIPE_UP {plan.name} processes={len(children)} pids={pids}", flush=True)
        # Block before waiting: bare sigwait races the handlers.
        signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGINT, signal.SIGTERM})
        signal.sigwait({signal.SIGINT, signal.SIGTERM})
    except KeyboardInterrupt:
        pass
    finally:
        stop_all()
        log.info("stopped %d processes", len(children))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser("dynamo-recipe", description=__doc__)
    ap.add_argument("cmd", choices=["plan", "up"])
    ap.add_argument("recipe")
    ap.add_argument("--engine", default=None,
                    help="override every worker's engine (e.g. mocker)")
    ap.add_argument("--device", default=None,
                    help="torch device of the torch workers and the encoder "
                         "(default: the CUDA card)")
    ap.add_argument("--start-timeout", type=float, default=600.0)
    ns = ap.parse_args(argv)
    configure_logging()
    plan = build_plan(load_spec(ns.recipe), engine_override=ns.engine, device=ns.device)
    if ns.cmd == "plan":
        print(format_plan(plan))
        return
    try:
        run_local(plan, timeout=ns.start_timeout)
    except (RuntimeError, TimeoutError) as exc:
        raise SystemExit(f"recipe {plan.name}: {exc}") from None


if __name__ == "__main__":
    main()
