"""The launcher's and the worker's ``--pp`` on the CPU: the launcher
serves the trained checkpoint as two gloo stages and refuses ``--pp``
with ``--tp`` in JAX's words; the worker's flags make a pp engine config
that ``check_supported`` takes.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys

import pytest

from dynamo_tpu_torch.components import worker as tworker
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models.config import MODEL_PRESETS
from tests.test_torch_engine import CKPT, ROOT


def test_launcher_pp2_on_cpu(tmp_path):
    """``--pp 2 --dist-backend gloo --warmup-mode off`` serves the trained
    checkpoint's greedy continuation; ``--pp 2`` with ``--tp 2`` is
    refused in JAX's words."""
    src = tmp_path / "prompts.jsonl"
    src.write_text('{"prompt": "one two three four", "max_tokens": 8}\n')
    base = [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
            "--model", str(CKPT), "--device", "cpu", "--block-size", "4",
            "--num-blocks", "64", "--max-model-len", "128", "--max-batch-size", "2",
            "--pp", "2", "--dist-backend", "gloo", "--warmup-mode", "off",
            "--input-jsonl", str(src)]
    res = subprocess.run(base, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    line = res.stdout.strip().splitlines()[-1]
    assert '" five six seven eight' in line and '"tokens": 8' in line
    res = subprocess.run(base + ["--tp", "2"], cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode != 0 and "pp>1 currently composes only with dp" in res.stderr


def test_worker_pp_flag_makes_a_pp_engine_config():
    """The worker's ``--pp 2`` (with ``--dp 2``) reaches the engine's
    config, which ``check_supported`` takes; with ``--tp 2`` it is refused
    in JAX's words."""
    argv = ["--model", "tiny-llama", "--pp", "2", "--dp", "2", "--dist-backend", "gloo",
            "--warmup-mode", "off"]
    ns = tworker.parse_args(argv)
    tworker.check_worker_args(ns)
    ec = tworker.engine_config(ns, None)
    assert (ec.pp, ec.dp, ec.tp) == (2, 2, 1)
    teng.check_supported(ec, MODEL_PRESETS["tiny-llama"])
    with pytest.raises(ValueError, match="pp>1 currently composes only with dp"):
        teng.check_supported(dataclasses.replace(ec, tp=2), MODEL_PRESETS["tiny-llama"])
