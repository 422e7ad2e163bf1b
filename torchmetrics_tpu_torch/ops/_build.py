"""Build the port's CUDA sources (``torchmetrics_tpu_torch/csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``. Libraries go to ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from torchmetrics_tpu_torch/csrc at first"
        " use and need the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)."
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> float:
    """Compile every named source that is not built yet, one ``nvcc`` per source, all started
    together. Returns the seconds spent; raises with the compiler's output if one fails."""
    t0 = time.perf_counter()
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        (out.parent / f"{out.stem}.log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent process never loads a half-written library
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory, spills) of a built source."""
    path = library_path(name)
    log = path.parent / f"{path.stem}.log"
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
