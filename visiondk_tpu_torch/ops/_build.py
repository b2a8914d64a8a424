"""Build and load the package's CUDA kernels.

Each kernel library is one ``csrc/<name>.cu`` file with a plain C interface
(it may include the shared ``csrc/*.cuh`` headers). At first use it is
compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``visiondk_tpu_torch/_build/lib<name>-<hash>.so`` and loaded with
ctypes. The file name carries a hash of the source, the headers and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside it in
``lib<name>-<hash>.log``.

Nothing is built at import time: the CPU tests import every module, and this
machine may have no ``nvcc``. A failed build raises; there is no fallback.
Two libraries may build at once from two threads (one lock per name).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass(frozen=True)
class Built:
    """A compiled kernel library: where it is, how it was made, how long it took
    (0.0 when an existing build was reused)."""

    lib: ctypes.CDLL
    path: Path
    command: List[str]
    seconds: float
    ptxas_log: str


_loaded: Dict[str, Built] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME / /usr/local/cuda); "
        "the CUDA kernels of visiondk_tpu_torch are built with it at first use"
    )


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` (or reuse the build of the same source) and load it."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        log = out.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
        seconds = 0.0
        if not out.is_file():
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
            )
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {src.name} failed (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
                )
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
        built = Built(
            lib=ctypes.CDLL(str(out)),
            path=out,
            command=cmd,
            seconds=seconds,
            ptxas_log=log.read_text() if log.is_file() else "",
        )
        _loaded[name] = built
        return built
