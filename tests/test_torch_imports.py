"""Import hygiene of the port: it must run on the card's installation
(Python, PyTorch, Triton, numpy, scipy, einops; no JAX and none of the JAX
package's other dependencies).

In a subprocess whose ``sys.modules`` blocks ``jax``, ``dynamo_tpu`` and
the packages the card's machine lacks, every module of
``dynamo_tpu_torch`` (frontend, preprocessor, parsers and launcher
included) and ``chip_smoke.py`` import. And no import statement anywhere in
their source, a deferred one inside a function included, names a blocked
package.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "dynamo_tpu", "aiohttp", "pydantic", "xxhash", "PIL", "grpc",
           "transformers", "ml_dtypes")
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
