"""Matmul precision, set per call.

The JAX package names two precisions (``gulon_tpu/ops/scan.py:46-58``):
``"default"`` lets the matrix unit take its fast path and ``"highest"``
forces full f32. Here each matmul states its own precision instead of a
process-wide flag:

- ``"highest"``: f32 with TF32 off;
- ``"default"``: TF32 allowed on a CUDA device (about three decimal
  digits in the products); plain f32 on the CPU.

The TF32 switch is PyTorch's global ``torch.backends.cuda.matmul``
flag, so :func:`matmul` sets it for the one call and restores it after.
"""

from __future__ import annotations

import contextlib

import torch

_PRECISIONS = {"default": True, "highest": False}  # name -> TF32 allowed


def resolve_precision(name: str) -> bool:
    """Validate a precision name; returns whether TF32 is allowed."""
    try:
        return _PRECISIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown precision {name!r} (expected default|highest)"
        ) from None


@contextlib.contextmanager
def _tf32(allowed: bool):
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = allowed
    try:
        yield
    finally:
        flags.allow_tf32 = prev


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``torch.matmul`` at the named precision (f32 operands)."""
    allowed = resolve_precision(precision)
    if not a.is_cuda:
        return torch.matmul(a, b)
    with _tf32(allowed):
        return torch.matmul(a, b)
