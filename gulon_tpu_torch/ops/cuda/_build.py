"""Build the CUDA sources of ``gulon_tpu_torch/csrc`` at first use.

Each source compiles on its own with ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries land in ``gulon_tpu_torch/_build/``,
named by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import.
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
# name -> (seconds spent compiling in this process, ptxas report)
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
    """Where ``csrc/<name>.cu`` builds to (hash of source + flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}"
                    )
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            BUILD_INFO[name] = (time.perf_counter() - t0, proc.stderr)
        lib = ctypes.CDLL(str(so))
        _LOADED[name] = lib
        return lib
