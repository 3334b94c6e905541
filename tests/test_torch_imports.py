"""Import hygiene of the port: it must run on the card's installation
(Python, PyTorch, Triton, numpy, scipy, einops; no JAX and none of the JAX
package's other dependencies).

In a subprocess whose ``sys.modules`` blocks ``jax``, ``dynamo_tpu`` and
the packages the card's machine lacks (msgpack, yaml, PIL, ml_dtypes and
huggingface_hub among them), every module of ``dynamo_tpu_torch``
(frontend, preprocessor, parsers, launcher, the distributed runtime, the
router, the components and the disaggregated handoff, the mocker and the
chaos harness, the fleet aggregator and the planner, the KServe routes,
the ViT encoder, image decode and encode worker, the GGUF reader, the hub
resolver, the recipe launcher over the port's YAML reader, the recorder
and the logprob analysis included) and ``chip_smoke.py``
import. And no import statement anywhere in their source, a deferred one
inside a function included, names a blocked package. A mocker worker
imports neither torch nor the torch engine's modules.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "dynamo_tpu", "aiohttp", "pydantic", "xxhash", "PIL", "grpc",
           "transformers", "ml_dtypes", "msgpack", "yaml", "huggingface_hub")
#: modules the walk must reach (the KVBM tiers and their codec, the
#: distributed runtime, the router and the components among them)
MUST_IMPORT = ("dynamo_tpu_torch.kvbm.offload", "dynamo_tpu_torch.kvbm.remote",
               "dynamo_tpu_torch.kvbm.pools", "dynamo_tpu_torch.kvbm.transfer",
               "dynamo_tpu_torch.kvbm.stream_ckpt", "dynamo_tpu_torch.kvbm.metrics",
               "dynamo_tpu_torch.engine.session", "dynamo_tpu_torch.utils.msgpack",
               "dynamo_tpu_torch.transports.wire", "dynamo_tpu_torch.transports.coordinator",
               "dynamo_tpu_torch.transports.client", "dynamo_tpu_torch.chaos",
               "dynamo_tpu_torch.chaos.injector", "dynamo_tpu_torch.chaos.plan",
               "dynamo_tpu_torch.chaos.metrics", "dynamo_tpu_torch.runtime.protocols",
               "dynamo_tpu_torch.runtime.tasks", "dynamo_tpu_torch.runtime.runtime",
               "dynamo_tpu_torch.runtime.status", "dynamo_tpu_torch.runtime.client",
               "dynamo_tpu_torch.runtime.pipeline", "dynamo_tpu_torch.runtime.health",
               "dynamo_tpu_torch.runtime.drain", "dynamo_tpu_torch.router.events",
               "dynamo_tpu_torch.router.indexer", "dynamo_tpu_torch.router.scheduler",
               "dynamo_tpu_torch.router.arbiter", "dynamo_tpu_torch.router.sequence",
               "dynamo_tpu_torch.router.publisher", "dynamo_tpu_torch.router.kv_router",
               "dynamo_tpu_torch.frontend.migration", "dynamo_tpu_torch.components.worker",
               "dynamo_tpu_torch.components.frontend", "dynamo_tpu_torch.disagg",
               "dynamo_tpu_torch.disagg.sharded", "dynamo_tpu_torch.disagg.source",
               "dynamo_tpu_torch.disagg.receiver", "dynamo_tpu_torch.disagg.handlers",
               "dynamo_tpu_torch.disagg.metrics", "dynamo_tpu_torch.mocker",
               "dynamo_tpu_torch.mocker.engine", "dynamo_tpu_torch.chaos.harness",
               "dynamo_tpu_torch.chaos.invariants", "dynamo_tpu_torch.components.kv_store",
               "dynamo_tpu_torch.components.router", "dynamo_tpu_torch.obs.fleet",
               "dynamo_tpu_torch.components.aggregator", "dynamo_tpu_torch.components.planner",
               "dynamo_tpu_torch.planner", "dynamo_tpu_torch.planner.load_predictor",
               "dynamo_tpu_torch.planner.interpolator", "dynamo_tpu_torch.planner.planner_core",
               "dynamo_tpu_torch.planner.scrape", "dynamo_tpu_torch.planner.connector",
               "dynamo_tpu_torch.planner.profiler", "dynamo_tpu_torch.frontend.kserve",
               "dynamo_tpu_torch.models.vision", "dynamo_tpu_torch.models.image",
               "dynamo_tpu_torch.components.encode", "dynamo_tpu_torch.models.gguf",
               "dynamo_tpu_torch.models.hub", "dynamo_tpu_torch.launch.recipe",
               "dynamo_tpu_torch.utils.recorder", "dynamo_tpu_torch.utils.logprob_analysis",
               "dynamo_tpu_torch.utils.yaml_lite")
SOURCES = sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it raises ImportError
import dynamo_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, "dynamo_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
leaked = sorted(n for n in sys.modules if n.split(".")[0] in {BLOCKED!r}
                and sys.modules[n] is not None)
assert not leaked, leaked
assert set({MUST_IMPORT!r}) <= set(mods), sorted(set({MUST_IMPORT!r}) - set(mods))
print(len(mods))
"""


def test_every_port_module_imports_without_the_jax_stack():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 40


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_import_statement_names_a_blocked_package():
    bad = {str(p.relative_to(ROOT)): sorted(_imported(p) & set(BLOCKED)) for p in SOURCES}
    assert {k: v for k, v in bad.items() if v} == {}
    assert len(SOURCES) > 40


#: what the worker's ``--engine mocker`` path imports (components/worker.py)
_MOCKER_PROBE = """
import sys
for name in ("jax", "dynamo_tpu"):
    sys.modules[name] = None
import dynamo_tpu_torch.components.worker as w
for m in ("chaos.metrics", "kvbm.metrics", "engine.session", "kvbm.stream_ckpt",
          "obs.compile_ledger", "obs.sched_ledger", "obs.mem_ledger", "runtime.health",
          "runtime.drain", "qos.deadline", "obs.tracer"):
    __import__("dynamo_tpu_torch." + m)
from dynamo_tpu_torch.mocker.engine import MockEngine, MockEngineArgs
ns = w.parse_args(["--engine", "mocker"])
w.check_worker_args(ns)
eng = MockEngine(MockEngineArgs(num_blocks=64, block_size=4, warmup_mode=ns.warmup_mode))
eng.warmup()
heavy = [m for m in ("torch", "numpy", "dynamo_tpu_torch.engine.engine",
                     "dynamo_tpu_torch.engine.cache", "dynamo_tpu_torch.models.llama",
                     "dynamo_tpu_torch.ops.paged_attention", "dynamo_tpu_torch.kvbm.transfer")
         if m in sys.modules]
assert not heavy, heavy
"""


def test_a_mocker_worker_imports_no_torch_engine():
    """The mocker allocates no tensor: a mocker worker (no store) starts
    without torch, numpy or any module of the torch engine."""
    res = subprocess.run([sys.executable, "-c", _MOCKER_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]


def test_the_frontend_loads_its_checkpoint_client_before_it_serves():
    """``make_ckpt_lookup`` (called while the frontend starts) imports the
    store client, which brings torch: a first import inside a migration's
    lookup would stall the frontend's event loop for seconds."""
    probe = ("import sys\n"
             "from dynamo_tpu_torch.components.frontend import make_ckpt_lookup\n"
             "assert 'dynamo_tpu_torch.kvbm.remote' not in sys.modules\n"
             "make_ckpt_lookup(None)\n"
             "assert 'dynamo_tpu_torch.kvbm.remote' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
