"""The port's model resolution (``dynamo_tpu_torch/models/hub.py``) against
the JAX package's ``resolve_model_path`` over a fake Hugging Face cache
under ``tmp_path``: the same ``HF_HOME`` (or ``HF_HUB_CACHE``) and
``HF_HUB_OFFLINE=1``, so JAX's ``snapshot_download`` reads the cache and
nothing else. Branch and tag refs, a commit revision, a GGUF-only snapshot
(its single file), a snapshot with two GGUF files, presets and local
paths resolve alike; a repo id that is not cached is refused with the same
offline message. JAX runs in a subprocess: ``huggingface_hub`` reads its
cache paths from the environment when it is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dynamo_tpu_torch.models import hub as thub

ROOT = Path(__file__).resolve().parent.parent
SHA_A, SHA_B, SHA_C, SHA_D = ("a" * 40, "b" * 40, "c" * 40, "d" * 40)


def fake_cache(hub_dir: Path) -> None:
    """``models--org--name/{refs,snapshots}`` as ``snapshot_download`` leaves them."""
    def repo(name: str, refs: dict[str, str], files: dict[str, list[str]]) -> None:
        root = hub_dir / ("models--" + name.replace("/", "--"))
        (root / "refs").mkdir(parents=True)
        for ref, sha in refs.items():
            (root / "refs" / ref).write_text(sha)
        for sha, names in files.items():
            snap = root / "snapshots" / sha
            snap.mkdir(parents=True)
            for n in names:
                (snap / n).write_bytes(b"x")

    repo("org/model", {"main": SHA_A, "v1": SHA_B},
         {SHA_A: ["model.safetensors", "config.json"], SHA_B: ["config.json"]})
    repo("org/gguf", {"main": SHA_C}, {SHA_C: ["model-q8_0.gguf", "README.md"]})
    repo("org/two-gguf", {"main": SHA_D}, {SHA_D: ["a.gguf", "b.gguf"]})


CASES = [("org/model", None), ("org/model", "v1"), ("org/model", SHA_B), ("org/gguf", None),
         ("org/two-gguf", None), ("org/missing", None), ("org/model", "v9"),
         ("tiny-llama", None), ("no-such-dir-xyz", None), ("a/b/c", None)]


def resolve_all(resolve) -> list[list]:
    out = []
    for model, rev in CASES:
        try:
            out.append(["ok", resolve(model, rev)])
        except ValueError as exc:
            out.append(["err", str(exc)])
    return out


_JAX = """
import json, sys
from dynamo_tpu.models.hub import resolve_model_path
cases = json.loads(sys.argv[1])
out = []
for model, rev in cases:
    try:
        out.append(["ok", resolve_model_path(model, rev)])
    except ValueError as exc:
        out.append(["err", str(exc)])
print(json.dumps(out))
"""


@pytest.mark.parametrize("var", ["HF_HOME", "HF_HUB_CACHE"])
def test_resolution_equals_jaxs_over_a_fake_cache(tmp_path, monkeypatch, var):
    hub_dir = tmp_path / "hf" / "hub" if var == "HF_HOME" else tmp_path / "cache"
    fake_cache(hub_dir)
    env_value = str(tmp_path / "hf") if var == "HF_HOME" else str(hub_dir)
    for v in ("HF_HOME", "HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, env_value)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    res = subprocess.run([sys.executable, "-c", _JAX, json.dumps(CASES)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = resolve_all(thub.resolve_model_path)
    assert got == want
    # what the cases cover
    assert got[0] == ["ok", str(hub_dir / "models--org--model" / "snapshots" / SHA_A)]
    assert got[3] == ["ok", str(hub_dir / "models--org--gguf" / "snapshots" / SHA_C
                                / "model-q8_0.gguf")]
    assert got[5][0] == "err" and "offline" in got[5][1]


def test_repo_id_shapes_equal_jaxs(tmp_path):
    from dynamo_tpu.models.hub import looks_like_repo_id

    names = ["meta-llama/Llama-3-8B", "Qwen/Qwen3-0.6B", str(tmp_path), "tiny-llama",
             "a/b/c", "./rel/path", "~/x/y", "org/model.gguf", "/abs", "org/"]
    assert [thub.looks_like_repo_id(n) for n in names] == [looks_like_repo_id(n) for n in names]


def test_a_local_gguf_and_a_directory_pass_through(tmp_path):
    f = tmp_path / "m.gguf"
    f.write_bytes(b"GGUF")
    assert thub.resolve_model_path(str(f)) == str(f)
    assert thub.resolve_model_path(str(tmp_path)) == str(tmp_path)


def test_the_launcher_and_the_worker_resolve_through_the_hub(monkeypatch, tmp_path):
    """Both call sites hand the engine the resolved path and keep the
    user-given id as the served name."""
    import argparse

    from dynamo_tpu_torch.launch import run as trun

    hub_dir = tmp_path / "hf" / "hub"
    fake_cache(hub_dir)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    seen = {}
    monkeypatch.setattr(trun, "build_engine", lambda cfg, device=None: seen.setdefault("cfg", cfg))
    ns = trun.parse_args(["in=batch", "out=torch", "--model", "org/gguf", "--device", "cpu"])
    trun.build_local_engine(ns)
    assert seen["cfg"].model.endswith("model-q8_0.gguf")
    assert ns.model == "org/gguf" and ns.tokenizer == seen["cfg"].model
    with pytest.raises(ValueError, match="not in the local HF cache"):
        trun.build_local_engine(argparse.Namespace(**{**vars(ns), "model": "org/missing"}))
