"""Card memory of a preset's random weights, at the model dtype and after
weight-only int8 quantization, and the KV blocks the engine's sizing rule
would fit beside them.

    python3 weight_memory.py [--model llama-3-8b-lite] [--root DIR]

Draws the weights with ``models.llama.init_params`` (seed 0) on the card,
then quantizes them with ``models.quant.quantize_params_int8`` and frees
the float tree. After each step it empties the allocator's cache and
prints one JSON line: bytes allocated and reserved, their difference
(cached blocks that share a segment with a live tensor, which
``torch.cuda.empty_cache`` cannot give back), the card's free bytes, and
the bf16 KV blocks that 85% of those free bytes would hold (the rule of
``ModelRunner._auto_num_blocks``, without its max_batch_size x
max_model_len cap). ``--root`` imports ``dynamo_tpu_torch`` from another
checkout, so that two trees can be measured in one run on one card.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama-3-8b-lite")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("weight_memory: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from dynamo_tpu_torch.engine.cache import KVCacheSpec
    from dynamo_tpu_torch.models import llama, quant
    from dynamo_tpu_torch.models.config import resolve_model_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    cfg = resolve_model_config(args.model)
    block = KVCacheSpec.for_model(cfg, 1, 16).bytes_per_block()

    def state(step: str, params) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        free = torch.cuda.mem_get_info()[0]
        print(json.dumps({
            "root": args.root, "model": args.model, "step": step,
            "param_bytes": quant.param_bytes(params) if params is not None else 0,
            "allocated": alloc, "reserved": reserved, "stranded": reserved - alloc,
            "free": free, "kv_blocks_85pct_free": int(free * 0.85) // block}), flush=True)

    state("empty", None)
    params = llama.init_params(cfg, seed=0, device="cuda")
    state(f"{cfg.dtype} weights", params)
    qparams = quant.quantize_params_int8(params, cfg)
    del params
    state("int8 weights, float tree freed", qparams)
    return 0


if __name__ == "__main__":
    sys.exit(main())
