"""Build the CUDA sources of ``gulon_tpu_torch/csrc`` at first use.

Each source compiles on its own with ``nvcc`` (the shared ``csrc/*.cuh``
headers included) into a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries land in ``gulon_tpu_torch/_build/``,
named by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused. :func:`build` compiles several
sources in parallel. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> (seconds until its nvcc finished in this process, ptxas report)
BUILD_INFO: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of gulon_tpu_torch build on a machine with the "
        "CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (hash of the source, the shared
    ``csrc/*.cuh`` headers and the flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names) -> None:
    """Build the named ``csrc/<name>.cu`` sources that have no library
    yet: one ``nvcc`` process for each, all started together."""
    with _LOCK:
        missing = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
        if not missing:
            return
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        jobs = []  # (name, temporary output, process)
        failed = []
        try:
            for name in missing:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                jobs.append([name, tmp, None])
                jobs[-1][2] = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
            for name, tmp, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on csrc/{name}.cu:\n{err}")
                    continue
                os.replace(tmp, library_path(name))
                BUILD_INFO[name] = (time.perf_counter() - t0, err)
        finally:
            for _, tmp, proc in jobs:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    build([name])
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib
