"""ctypes bindings to the native word2vec text parser.

The parser is ``native/word2vec_parser.cpp`` at the root of the checkout:
a multithreaded, memory-mapped single-pass float parser, the data-loader
counterpart of the reference's JVM line scanner
(``WordVectors.scala:162-197``). The port builds its own library from
that source with ``g++`` at first use, into ``gulon_tpu_torch/_build/``
(named by a hash of the source and the flags, as the CUDA kernels are),
and never loads or rebuilds a library that ships beside the source. Where
the source or the compiler is missing, :func:`available` is False and
``utils/word2vec.py`` reads with Python instead. Nothing here runs at
import.

:class:`Word2VecStream` is the streaming builds' loader (index mode):
keys and line offsets parse up front, vectors parse on demand in row
ranges or by row ids (``gulon_tpu/utils/native.py:141-222``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "word2vec_parser.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    """Where the parser builds to (hash of the source and the flags)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()
    return BUILD_DIR / f"libgulonio_{digest[:16]}.so"


def _build(path: Path) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not SOURCE.exists():
            _load_failed = True
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        lib.w2v_open.restype = ctypes.c_void_p
        lib.w2v_open.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.w2v_error.restype = ctypes.c_char_p
        lib.w2v_error.argtypes = [ctypes.c_void_p]
        lib.w2v_rows.restype = ctypes.c_int64
        lib.w2v_rows.argtypes = [ctypes.c_void_p]
        lib.w2v_dim.restype = ctypes.c_int32
        lib.w2v_dim.argtypes = [ctypes.c_void_p]
        lib.w2v_vectors.restype = ctypes.POINTER(ctypes.c_float)
        lib.w2v_vectors.argtypes = [ctypes.c_void_p]
        lib.w2v_keys.restype = ctypes.POINTER(ctypes.c_char)
        lib.w2v_keys.argtypes = [ctypes.c_void_p]
        lib.w2v_key_offsets.restype = ctypes.POINTER(ctypes.c_int64)
        lib.w2v_key_offsets.argtypes = [ctypes.c_void_p]
        lib.w2v_close.restype = None
        lib.w2v_close.argtypes = [ctypes.c_void_p]
        lib.w2v_open_index.restype = ctypes.c_void_p
        lib.w2v_open_index.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.w2v_parse_rows.restype = ctypes.c_int64
        lib.w2v_parse_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ]
        lib.w2v_parse_gather.restype = ctypes.c_int64
        lib.w2v_parse_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True iff the native parser can be loaded (building it if needed)."""
    return _load() is not None


def read_word2vec(
    path: str,
    report_fn: Optional[Callable] = None,
    num_threads: int = 0,
):
    """Parse a word2vec text file with the native loader.

    Returns a :class:`gulon_tpu_torch.utils.word2vec.WordVectors`. Raises
    ``ValueError`` on malformed input and ``RuntimeError`` if the native
    library is unavailable.
    """
    from gulon_tpu_torch.utils.word2vec import ReadProgress, WordVectors

    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    handle = lib.w2v_open(path.encode(), num_threads)
    if not handle:
        raise RuntimeError("native parser returned null handle")
    try:
        err = lib.w2v_error(handle)
        if err:
            raise ValueError(err.decode())
        n = lib.w2v_rows(handle)
        d = lib.w2v_dim(handle)
        vectors = np.ctypeslib.as_array(
            lib.w2v_vectors(handle), shape=(n, d)
        ).copy() if n else np.zeros((0, d), np.float32)
        keys = _decode_keys(lib, handle, n)
        total_kb = int(lib.w2v_key_offsets(handle)[n])
        if report_fn is not None:
            report_fn(
                ReadProgress(
                    lines_read=int(n),
                    total_lines=int(n),
                    size_estimate_bytes=int(vectors.nbytes + total_kb),
                )
            )
        return WordVectors(keys, vectors)
    finally:
        lib.w2v_close(handle)


def _decode_keys(lib, handle, n: int) -> np.ndarray:
    offsets = np.ctypeslib.as_array(lib.w2v_key_offsets(handle), shape=(n + 1,))
    key_buf = ctypes.string_at(lib.w2v_keys(handle), int(offsets[-1]))
    keys = np.empty(n, dtype=object)
    for i in range(n):
        keys[i] = key_buf[offsets[i] : offsets[i + 1]].decode("utf-8")
    return keys


def _float_ptr(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class Word2VecStream:
    """Index-mode handle over a word2vec text file: keys parse up front,
    vectors parse on demand in row ranges, the streaming builds' loader
    (counterpart of the reference's chunked ingest,
    ``WordVectors.scala:199-257``).

    The file is memory-mapped and each :meth:`rows` / :meth:`gather` call
    parses just the requested lines, on ``num_threads`` threads (0 = one
    a core), so the vectors never sit in host memory whole. Raises
    ``RuntimeError`` when the parser library cannot load or returns no
    handle and ``ValueError`` on a malformed file; :meth:`rows` and
    :meth:`gather` raise ``ValueError`` on a bad range and on a malformed
    line (naming its data row).
    """

    def __init__(self, path: str, num_threads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._threads = num_threads
        self._handle = lib.w2v_open_index(os.fsencode(path), num_threads)
        if not self._handle:
            raise RuntimeError("native parser returned null handle")
        err = lib.w2v_error(self._handle)
        if err:
            self.close()
            raise ValueError(err.decode())
        self.num_rows = int(lib.w2v_rows(self._handle))
        self.dim = int(lib.w2v_dim(self._handle))
        self.keys = _decode_keys(lib, self._handle, self.num_rows)

    def _check(self, rc: int, bad_range: str) -> None:
        if rc == -2:
            raise ValueError(bad_range)
        if rc >= 0:
            raise ValueError(f"malformed line at data row {rc}")

    def rows(self, start: int, count: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Parse rows ``[start, start + count)`` into ``[count, dim]`` f32:
        into ``out`` when given (C-contiguous f32, at least ``count``
        rows; its first ``count`` rows are returned)."""
        if out is None:
            out = np.empty((count, self.dim), np.float32)
        elif (out.dtype != np.float32 or not out.flags.c_contiguous
              or out.ndim != 2 or out.shape[0] < count or out.shape[1] != self.dim):
            raise ValueError(f"out must be C-contiguous f32 [>= {count}, {self.dim}]")
        rc = self._lib.w2v_parse_rows(
            self._handle, start, count, _float_ptr(out), self._threads
        )
        self._check(rc, f"row range [{start}, {start + count}) invalid")
        return out[:count]

    def gather(self, ids) -> np.ndarray:
        """Parse arbitrary row ids -> ``[len(ids), dim]`` f32."""
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.empty((len(ids), self.dim), np.float32)
        rc = self._lib.w2v_parse_gather(
            self._handle, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ids), _float_ptr(out), self._threads,
        )
        self._check(rc, "row ids out of range")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.w2v_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
