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
import re
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
_SERIALIZED = re.compile(r"\((C75\d\d)\).*?function '([^']+)'")


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


def _demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def _short(name: str) -> str:
    """``adc_probe_kernel<1, false, false, true>`` from a demangled name."""
    found = re.search(r"(\w+<[^()]*>)\(", name)
    return found.group(1) if found else name


def ptxas_by_kernel(report: str) -> dict:
    """Registers, spill bytes and warning codes of each entry function in
    an ``nvcc -Xptxas -v`` report."""
    kernels, cur, warned = {}, None, []
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            cur = entry.group(1)
            kernels[cur] = dict(registers=None, spill_stores=0, spill_loads=0, warnings=[])
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and cur:
            kernels[cur]["spill_stores"], kernels[cur]["spill_loads"] = map(int, spill.groups())
        regs = re.search(r"Used (\d+) registers", line)
        if regs and cur:
            kernels[cur]["registers"] = int(regs.group(1))
        serial = _SERIALIZED.search(line)
        if serial:
            warned.append(serial.groups())
    for code, fn in warned:
        kernels.setdefault(fn, dict(registers=None, spill_stores=0, spill_loads=0,
                                    warnings=[]))["warnings"].append(code)
    names = _demangle(list(kernels))
    return {_short(names[k]): v for k, v in kernels.items()}
