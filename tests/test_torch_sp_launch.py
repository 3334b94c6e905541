"""The launcher's and the worker's ``--sp`` and ``--ring-prefill-threshold``
on the CPU (the launcher's seq ranks as gloo processes)."""

from __future__ import annotations

import subprocess
import sys

from dynamo_tpu_torch.components import worker as tworker
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models.config import MODEL_PRESETS
from tests.test_torch_engine import CKPT, ROOT


def test_launcher_sp2_on_cpu(tmp_path):
    """``--sp 2 --ring-prefill-threshold 1 --dist-backend gloo --warmup-mode
    off`` serves the trained checkpoint's greedy continuation through a
    ring prefill; ``--sp 2`` with ``--pp 2`` is refused in JAX's words."""
    src = tmp_path / "prompts.jsonl"
    src.write_text('{"prompt": "one two three four", "max_tokens": 8}\n')
    base = [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
            "--model", str(CKPT), "--device", "cpu", "--block-size", "4",
            "--num-blocks", "64", "--max-model-len", "128", "--max-batch-size", "2",
            "--sp", "2", "--ring-prefill-threshold", "1", "--dist-backend", "gloo",
            "--warmup-mode", "off", "--input-jsonl", str(src)]
    res = subprocess.run(base, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    line = res.stdout.strip().splitlines()[-1]
    assert '" five six seven eight' in line and '"tokens": 8' in line
    res = subprocess.run(base + ["--pp", "2"], cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode != 0 and "pp>1 currently composes only with dp" in res.stderr


def test_worker_sp_flags_make_an_sp_engine_config():
    """The worker's ``--sp 2 --ring-prefill-threshold 64`` reach the
    engine's config, which ``check_supported`` takes."""
    argv = ["--model", "tiny-llama", "--sp", "2", "--ring-prefill-threshold", "64",
            "--dist-backend", "gloo", "--warmup-mode", "off"]
    ns = tworker.parse_args(argv)
    tworker.check_worker_args(ns)
    ec = tworker.engine_config(ns, None)
    assert (ec.sp, ec.ring_prefill_threshold, ec.tp) == (2, 64, 1)
    teng.check_supported(ec, MODEL_PRESETS["tiny-llama"])
