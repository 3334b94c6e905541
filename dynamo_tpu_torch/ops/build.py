"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes what the kernels themselves take. A
source may be compiled in parts (:data:`PARTS`: the same file under
different macros, one translation unit each) that run as ``nvcc``
processes at once and are linked into the one library: the
paged-attention source's 96 template instantiations are six units of 16
(a unit per policy pair) and the C entry point. Libraries land in
``dynamo_tpu_torch/_build/`` (git-ignored), named by a digest of the source,
flags and parts, so an edited source rebuilds and an unchanged one is
reused. Nothing is built at import time: the first launch builds, or a
caller (``chip_smoke.py``) builds everything up front with
:func:`build_all`, every part of every source started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: every kernel source of the package (``csrc/<name>.cu``)
KERNELS = ("paged_attention_mma",)
#: the extra flags of each translation unit a source is compiled as (a
#: source not named here is one unit)
PARTS: dict[str, tuple[tuple[str, ...], ...]] = {
    "paged_attention_mma": tuple((f"-DDYN_MMA_PAIR={n}",) for n in range(6)) + ((),),
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            + repr(PARTS.get(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[list, Path, Path] | None:
    """Start one ``nvcc -c`` for each translation unit of ``name``."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    units = []
    for i, flags in enumerate(PARTS.get(name, ((),))):
        obj = lib.with_suffix(f".{os.getpid()}.{i}.o")
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj),
               str(CSRC_DIR / f"{name}.cu")]
        units.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), obj))
    return units, tmp, lib


def _finish(name: str, job: tuple[list, Path, Path]) -> None:
    """Wait for the units of ``name``, link them into its library."""
    units, tmp, lib = job
    logs, failed = [], False
    for proc, _ in units:
        log, _ = proc.communicate()
        logs.append(log)
        failed |= proc.returncode != 0
    objs = [obj for _, obj in units]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n" + "\n".join(logs))
        link = subprocess.run([nvcc_path(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking csrc/{name}.cu failed:\n{link.stdout}{link.stderr}")
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("".join(logs))  # -Xptxas -v: registers, spills
    os.replace(tmp, lib)                       # atomic: readers never see a partial file


def build_all(names: tuple[str, ...] = KERNELS) -> dict[str, Path]:
    """Build every named kernel library not yet built, every translation
    unit of every source running at once. Returns name → library path."""
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's ``-Xptxas -v`` report from the build of ``name`` ('' if the
    library predates this process's build directory)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_KERNEL_ARGS = (
    (r"QuantCacheILb0ELi(\d+)E", "Int8Cache<{}>"),
    (r"QuantCacheILb1ELi(\d+)E", "Int4Cache<{}>"),
    (r"Bf16CacheILi(\d+)E", "Bf16Cache<{}>"),
    (r"F32CacheILi(\d+)E", "F32Cache<{}>"),
    (r"(QueryBf16|QueryF32)", "{}"),
)


def ptxas_report(name: str) -> list[dict]:
    """One entry per kernel instantiation in ``build_log(name)``: its
    template arguments read from the mangled name (``kernel``), registers
    and spill bytes."""
    rows: list[dict] = []
    for line in build_log(name).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            args = [fmt.format(m.group(1)) for pat, fmt in _KERNEL_ARGS
                    for m in [re.search(pat, mangled)] if m]
            rows.append({"kernel": ", ".join(args) or mangled})
        elif rows and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            rows[-1].update(spill_stores=int(st), spill_loads=int(ld))
        elif rows and "Used" in line and "registers" in line:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return rows


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
