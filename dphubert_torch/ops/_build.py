"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each source under ``dphubert_torch/csrc/`` compiles to one shared library
with a plain C interface in ``build/kernels/`` at the root of the checkout.
The library's name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source builds anew and an unchanged one is
loaded from the earlier build.  Nothing here
runs at import time: the CPU tests import every module on a machine that
has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "ptxas": str} for the builds made by this process
build_reports: Dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built on the machine with the card"
        )
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _compile(name: str) -> None:
    out = _lib_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_reports[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": proc.stderr,
    }


def build(names: Sequence[str]) -> None:
    """Compile the named sources, one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for future in [pool.submit(_compile, n) for n in names]:
            future.result()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile(name)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
