"""Device time of the port's paged-attention wrapper, under two timers.

    python3 attention_timing.py [--label NAME] [--cache float,int8,int4] [--q bf16,f32]

Times ``dynamo_tpu_torch.ops.paged_attention.paged_attention`` with bf16
queries (``--q bf16``, the default) or f32 queries (``--q f32``; the
model-precision cache then holds f32) over a model-precision, an int8 and a
packed-int4 cache at the five shapes of ``chip_smoke.py`` phase (a) that
every slice of the port has run (decode,
prefill, ragged, split-K, long context; llama-3-8b-lite attention: KH=8,
H=32, D=128, block 16), then at decode with the two other head widths
(D=64, KH=8, H=64; D=16, KH=2, H=4) and at phase (a)'s 8-token chunk (B=8:
32 query rows a kv head, 2 row groups a CTA in the mma design). Each case
is timed by two timers, 20 calls each, L2 flushed before each call:

- ``ms``: a ~5 ms sleep kernel ahead of the first event keeps the card busy
  while the host enqueues the call, so this is the call's device time (the
  timer of ``chip_smoke.time_ms``);
- ``ms_idle``: the same events with nothing queued ahead of the call (the
  timer of the port's first two slices), which also counts the wrapper's
  host side where that outlasts its kernels.

It uses only what every slice of the port has (the wrapper, its plain
version and ``models.llama._scatter_kv``; f32 q over every cache since the
second slice) and imports the
``dynamo_tpu_torch`` beside it, so a copy placed at the root of an older
checkout (or of a copy with an edited kernel source) times that tree's
kernels. To compare two trees, run it in both on one machine, in the order
old, new, new, old.

Prints the card's name and power limit (nvidia-smi), then one JSON line a
case: ``label``, ``q``, ``cache``, ``route``, ``shape``, ``ms``,
``ms_idle``, ``max_abs_err`` against the plain version,
``err_over_limit``, the worst |err| / (rel |ref| + abs) under the limit of
q's dtype in chip_smoke.py (bf16: 2^-7, 1e-4; f32: 2e-5, 2e-5), and
``out_sha256``, a digest of the output's bytes (two trees that print the
same digest for a case computed the same bits from the same inputs). It fails
only where ``max_abs_err`` exceeds 2e-2, so an older tree is timed whatever
its error; chip_smoke.py holds the limits. Exits non-zero without a CUDA
card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
KINDS = ("float", "int8", "int4")
#: --q names: the query dtype and its error limit (rel, abs)
Q_DTYPES = {"bf16": (torch.bfloat16, (2.0**-7, 1e-4)), "f32": (torch.float32, (2e-5, 2e-5))}


def timed(fn, sleep: bool, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` between two events, L2 flushed before each call;
    with ``sleep`` a ~5 ms sleep kernel is queued ahead of the first event."""
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if sleep:
            torch.cuda._sleep(10_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def case(seed: int, b: int, t: int, nblk: int, q_start, q_len, device: str = "cuda",
         h: int = 32, kh: int = 8, d: int = 128, bs: int = 16):
    """f32 q, K and V and the tables of one shape, from ``seed``: ``--q
    bf16`` times q rounded to bf16, and the bf16 cache and the quantized
    caches' source are K and V rounded to bf16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nb = b * nblk + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = randn(b, t, h, d), randn(nb, bs, kh, d), randn(nb, bs, kh, d)
    perm = torch.randperm(nb - 1, generator=gen, device=device)[: b * nblk] + 1
    bt = perm.reshape(b, nblk).to(torch.int32).contiguous()
    qs = torch.tensor(q_start, dtype=torch.int32, device=device)
    kl = qs + torch.tensor(q_len, dtype=torch.int32, device=device)
    return q, k, v, bt, qs, kl


def quantize(x: torch.Tensor, kind: str, chunk_blocks: int = 128) -> dict:
    """A quantized cache holding ``x`` [NB, BS, KH, D], written through the
    port's ``_scatter_kv`` whole blocks at a time."""
    from dynamo_tpu_torch.models.llama import _scatter_kv

    nb, bs, kh, d = x.shape
    cache = {"q": torch.zeros((nb, bs, kh, d // 2 if kind == "int4" else d),
                              dtype=torch.uint8 if kind == "int4" else torch.int8,
                              device=x.device),
             "s": torch.zeros((nb, kh), dtype=torch.float32, device=x.device)}
    flat = x.reshape(nb * bs, kh, d)
    step = chunk_blocks * bs
    for s0 in range(0, nb * bs, step):
        n = min(step, nb * bs - s0)
        slots = torch.arange(s0, s0 + n, dtype=torch.int32, device=x.device)[None]
        _scatter_kv(cache, flat[s0: s0 + n][None], slots)
    return cache


def shapes(device: str = "cuda") -> dict:
    """name -> (q, k, v, block_tables, q_start, kv_lens), num_splits: the
    five phase-(a) shapes of chip_smoke.py that every slice has run, then
    its decode at the two other head widths."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lens = torch.randint(128, 193, (32,), generator=gen, device=device).tolist()
    return {
        "decode B=32 T=1 kv 128-192": (case(1, 32, 1, 16, [n - 1 for n in lens], [1] * 32,
                                            device), 0),
        "prefill B=32 T=128 kv 128": (case(2, 32, 128, 8, [0] * 32, [128] * 32, device), 0),
        "ragged B=8 T=16 with a zero-length row": (case(
            3, 8, 16, 8, [0, 37, 5, 100, 0, 64, 15, 0], [16, 1, 11, 1, 0, 16, 1, 9],
            device), 0),
        "split-K B=2 T=1 kv 2048 ns=4": (case(4, 2, 1, 128, [2047, 2047], [1, 1], device), 4),
        "long-context B=16 T=1 kv 8192 auto splits": (case(
            5, 16, 1, 512, [8191] * 16, [1] * 16, device), 0),
        "decode D=64 KH=8 H=64 B=32 kv 128-192": (case(
            6, 32, 1, 16, [n - 1 for n in lens], [1] * 32, device, h=64, kh=8, d=64), 0),
        "decode D=16 KH=2 H=4 B=32 kv 128-192": (case(
            7, 32, 1, 16, [n - 1 for n in lens], [1] * 32, device, h=4, kh=2, d=16), 0),
        "chunk B=8 T=8 kv 8-144": (case(
            8, 8, 8, 9, [0, 31, 64, 100, 127, 5, 77, 136], [8] * 8, device), 0),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--label", default=ROOT.name, help="tag of every output line")
    ap.add_argument("--cache", default=",".join(KINDS),
                    help="comma-separated cache kinds to time (float = q's dtype)")
    ap.add_argument("--q", default="bf16",
                    help=f"comma-separated query dtypes to time, of {tuple(Q_DTYPES)}")
    args = ap.parse_args()
    kinds = [k for k in args.cache.split(",") if k]
    if not set(kinds) <= set(KINDS):
        ap.error(f"--cache takes kinds of {KINDS}, got {kinds}")
    q_names = [n for n in args.q.split(",") if n]
    if not set(q_names) <= set(Q_DTYPES):
        ap.error(f"--q takes dtypes of {tuple(Q_DTYPES)}, got {q_names}")
    if not torch.cuda.is_available():
        print("attention_timing: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dynamo_tpu_torch.ops import paged_attention as pa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    for name, ((q32, k32, v32, bt, qs, kl), ns) in shapes().items():
        k, v = k32.bfloat16(), v32.bfloat16()
        for kind in kinds:
            kq, vq = (None, None) if kind == "float" else (quantize(k, kind), quantize(v, kind))
            for q_name in q_names:
                q_dtype, (rel, abs_) = Q_DTYPES[q_name]
                q = q32.to(q_dtype)
                kc, vc = (((k32, v32) if q_dtype == torch.float32 else (k, v))
                          if kind == "float" else (kq, vq))
                call = (q, kc, vc, bt, qs, kl)
                ref = pa.paged_attention_plain(*call, num_splits=1).float()
                out = pa.paged_attention(*call, num_splits=ns)
                diff = (out.float() - ref).abs()
                err = diff.max().item()
                digest = hashlib.sha256(out.cpu().view(torch.uint8).numpy().tobytes())
                row = {"label": args.label, "q": q_name, "cache": kind,
                       "route": getattr(pa, "ROUTES", {}).get((q_dtype, kind)), "shape": name,
                       "ms": timed(lambda: pa.paged_attention(*call, num_splits=ns),
                                   sleep=True),
                       "ms_idle": timed(lambda: pa.paged_attention(*call, num_splits=ns),
                                        sleep=False),
                       "max_abs_err": err,
                       "err_over_limit": (diff / (rel * ref.abs() + abs_)).max().item(),
                       "out_sha256": digest.hexdigest()[:16]}
                print(json.dumps(row), flush=True)
                if not err <= 2e-2:
                    raise AssertionError(f"{q_name} q, {kind} {name}: max_abs_err {err} "
                                         "against the plain version (tol 2e-2)")
                del q, kc, vc, call, ref, out, diff
            del kq, vq
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
