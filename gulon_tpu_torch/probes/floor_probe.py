"""Launch-and-I/O floor probe P4 of the fused ADC scan: the counterpart of
``benchmarks/floor_probe.py``.

Kernel P4 (``csrc/floor_probe.cu``) replaces the TPU probe's
``run_variant``: an empty kernel over the headline shape's operands
(codes ``[8, 401,408]`` int8, queries ``[1024, 112]`` bf16) that writes
zeros to ``[n_rt * rows, 1024]`` f32 values (``n_rt = N / t``, t = 4096)
and, in one variant, int32 ids. The five variants of ``floor_probe.py:
85-89`` switch the operands and outputs on and off (:data:`VARIANTS`).
The TPU copied every operand's tiles whether the body read them or not;
the Hopper kernel reads every byte of each operand it is given itself,
so each variant's time is at least its bytes (:func:`bytes_moved`) over
the memory rate. CUDA tensors launch the kernel (or raise); CPU tensors
take the plain version, which returns the zeros. Operands come from numpy
at seed 0 (:func:`floor_operands`), so no new carrier is needed.
``python -m gulon_tpu_torch.probes.floor_probe`` prints each variant's ms
on the card.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import sys
from typing import Tuple

import numpy as np
import torch

from gulon_tpu_torch.ops.cuda.adc import _LANES
from gulon_tpu_torch.probes import median_ms
from gulon_tpu_torch.utils import tracing
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE
# name -> (codes in, queries in, output rows per row tile: "nblk" = t / 128, ids out)
VARIANTS = {
    "codes+q, out v+i [32]": (True, True, "nblk", True),
    "codes+q, out v only [32]": (True, True, "nblk", False),
    "codes+q, out v [8]": (True, True, 8, False),
    "q only, out v [8]": (False, True, 8, False),
    "codes only, out v [8]": (True, False, 8, False),
}
HEADLINE = dict(n=401_408, m=8, num_q=1024, mdp=112, t=4096)  # floor_probe.py:24-26


def floor_operands(n=HEADLINE["n"], m=HEADLINE["m"], num_q=HEADLINE["num_q"],
                   mdp=HEADLINE["mdp"], *, seed: int = 0, device=None):
    """Codes ``[m, n]`` int8 (uniform in [0, 255) as the TPU drew them, then
    wrapped to int8) and queries ``[Q, mdp]`` bf16 standard normal, from
    numpy."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 255, (m, n), dtype=np.int32).astype(np.int8)
    q = rng.standard_normal((num_q, mdp), dtype=np.float32)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(q).to(device=device, dtype=torch.bfloat16))


def _geometry(variant: str, codes_t, q_pad, tile_rows: int):
    if variant not in VARIANTS:
        raise ValueError(f"unknown floor_probe variant {variant!r}; known: {tuple(VARIANTS)}")
    with_codes, with_q, rows, with_ids = VARIANTS[variant]
    n = codes_t.shape[1]
    if tile_rows % _LANES or n % tile_rows:
        raise ValueError(f"N ({n}) must be a multiple of tile_rows ({tile_rows}), a 128-multiple")
    rows = tile_rows // _LANES if rows == "nblk" else rows
    return with_codes, with_q, (n // tile_rows * rows, q_pad.shape[0]), with_ids


def bytes_moved(variant: str, codes_t, q_pad, *, tile_rows: int = HEADLINE["t"]) -> dict:
    """Bytes the variant reads (each operand it has, once) and writes."""
    with_codes, with_q, shape, with_ids = _geometry(variant, codes_t, q_pad, tile_rows)
    read = (codes_t.numel() * codes_t.element_size() if with_codes else 0) + (
        q_pad.numel() * q_pad.element_size() if with_q else 0)
    written = shape[0] * shape[1] * 4 * (2 if with_ids else 1)
    return dict(read=read, written=written)


_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        from gulon_tpu_torch.ops.cuda import _build

        lib = _build.load("floor_probe")
        fn = lib.gulon_floor_probe
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def plain(variant: str, codes_t, q_pad, *, tile_rows: int = HEADLINE["t"]):
    """The plain version: the zeros the variant writes."""
    _, _, shape, with_ids = _geometry(variant, codes_t, q_pad, tile_rows)
    vals = torch.zeros(shape, dtype=torch.float32, device=codes_t.device)
    if with_ids:
        return vals, torch.zeros(shape, dtype=torch.int32, device=codes_t.device)
    return (vals,)


def floor_probe(
    variant: str, codes_t, q_pad, *, tile_rows: int = HEADLINE["t"], device=None
) -> Tuple[torch.Tensor, ...]:
    """One call of a variant: ``(vals,)`` or ``(vals, ids)``, all zeros.
    Operands go to ``device`` (default: the card)."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    codes_t, q_pad = (torch.as_tensor(a, device=device).contiguous() for a in (codes_t, q_pad))
    with_codes, with_q, shape, with_ids = _geometry(variant, codes_t, q_pad, tile_rows)
    if not codes_t.is_cuda:
        return plain(variant, codes_t, q_pad, tile_rows=tile_rows)
    lib = _kernel()
    with torch.cuda.device(device):
        vals = torch.empty(shape, dtype=torch.float32, device=device)
        ids = torch.empty(shape, dtype=torch.int32, device=device) if with_ids else None
        err = lib.gulon_floor_probe(
            codes_t.data_ptr() if with_codes else None,
            codes_t.numel() * codes_t.element_size() if with_codes else 0,
            q_pad.data_ptr() if with_q else None,
            q_pad.numel() * q_pad.element_size() if with_q else 0,
            vals.data_ptr(), None if ids is None else ids.data_ptr(), vals.numel(), 0,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"floor_probe {variant} launch failed: cudaError_t {err}")
    tracing.count("probe.p4.launches")
    return (vals,) if ids is None else (vals, ids)


def rotated(variant: str, codes_t, q_pad, *, copies: int = 32, kept: int = 8):
    """A call of the variant that reads the next of ``copies`` copies of the
    operands and keeps its last ``kept`` outputs alive, so that calls back
    to back touch more bytes than the card's L2 (50 MB) holds and each
    reads and writes the memory, as the first call of a batch would."""
    ring = itertools.cycle([(codes_t.clone(), q_pad.clone()) for _ in range(copies)])
    held = collections.deque(maxlen=kept)
    return lambda: held.append(floor_probe(variant, *next(ring), device=codes_t.device))


def main() -> int:
    """Print each variant's ms a batch on the card (its device time,
    queued back to back over rotated operands: :func:`rotated`,
    :func:`gulon_tpu_torch.probes.median_ms`)."""
    codes_t, q_pad = floor_operands()
    for variant in VARIANTS:
        ms = median_ms(rotated(variant, codes_t, q_pad))
        print(f"{variant:28s} {ms:9.3f} ms/batch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
