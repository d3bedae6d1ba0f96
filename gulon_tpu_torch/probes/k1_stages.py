"""K1 cut stage by stage: its own time split, on its own kernel template.

P3 (``kernel_probe.py``) cuts the TPU's formulation of K1 (a one-hot
decode, the sign-folded int key), so its stage times are P3's. This module
runs K1's kernel (``csrc/adc_scan.cu``, entry ``gulon_adc_scan_stage``)
stopped after one of its stages, on K1's operands (``adc.fused_block_scan``
documents them) with one winner a block:

- ``decode``: each row block staged and decoded as K1 does it (once, or
  per query tile when too deep to hold); no queries; zeros written;
- ``contraction``: + the query ring and the ``wgmma`` scores; each block's
  first row's score written (``out[q, b] = score(row 128 b, q)``);
- ``block_min``: + the minimum of each block's raw scores (no row packed
  into them) written.

K1 itself (``adc.fused_block_scan``) is the last stage: + the lane pack.
The output is K1's ``[Q, N'/128]`` f32. CUDA tensors launch the kernel
(or raise); CPU tensors take :func:`plain`. No serving path reaches it.
"""

from __future__ import annotations

import ctypes

import torch

from gulon_tpu_torch.ops.cuda import adc
from gulon_tpu_torch.ops.cuda.adc import _LANES
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.probes.adc_probes import _decode_rows_plain
from gulon_tpu_torch.utils import tracing

STAGES = ("decode", "contraction", "block_min")


def _check(stage, codes_t, norms_hl, q_op, cb, nblk):
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    devices = {t.device for t in (codes_t, norms_hl, q_op, cb)}
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {devices}")
    adc._check_operands(codes_t, norms_hl, q_op, cb, 1, nblk)
    if q_op.shape[0] == 0:
        raise ValueError("need at least one query")


def plain(codes_t, norms_hl, q_op, cb, *, stage: str, nblk: int) -> torch.Tensor:
    """The plain version of a stage: zeros, each block's first row's
    score, or each block's minimum score, ``[Q, N'/128]`` f32; scores as
    K1's plain version makes them (bf16 rows and queries, f32 sums)."""
    _check(stage, codes_t, norms_hl, q_op, cb, nblk)
    m, n_cols = codes_t.shape
    num_q, width = q_op.shape
    dev = codes_t.device
    if stage == "decode":
        return torch.zeros((num_q, n_cols // _LANES), dtype=torch.float32, device=dev)
    q = q_op.to(torch.float32)
    if stage == "contraction":
        rows = _decode_rows_plain(codes_t[:, ::_LANES], norms_hl[:, ::_LANES], cb, width)
        return matmul(q, rows.to(torch.float32).T, "highest")
    out = torch.empty((num_q, n_cols // _LANES), dtype=torch.float32, device=dev)
    step = max(_LANES, (1 << 28) // (4 * num_q) // _LANES * _LANES)
    for start in range(0, n_cols, step):
        stop = min(start + step, n_cols)
        rows = _decode_rows_plain(codes_t[:, start:stop], norms_hl[:, start:stop], cb, width)
        scores = matmul(q, rows.to(torch.float32).T, "highest")  # [Q, rows]
        out[:, start // _LANES:stop // _LANES] = torch.amin(
            scores.reshape(num_q, -1, _LANES), dim=2)
    return out


_STAGE_FN = None


def _kernel():
    """K1's library with the stage entry's C signature declared."""
    global _STAGE_FN
    if _STAGE_FN is None:
        fn = adc._kernel().gulon_adc_scan_stage
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]  # codes, code bytes
            + [ctypes.c_void_p] * 4  # norms, queries, cb, out
            + [ctypes.c_int] * 9  # n_cols num_q q_stride depth m K dsub nblk stage
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
        _STAGE_FN = fn
    return _STAGE_FN


def k1_stage_scan(codes_t, norms_hl, q_op, cb, *, stage: str, nblk: int) -> torch.Tensor:
    """K1 cut after ``stage`` (:data:`STAGES`): ``[Q, N'/128]`` f32 as
    :func:`plain` describes. CUDA tensors launch the kernel on the current
    stream (or raise); CPU tensors take :func:`plain`."""
    _check(stage, codes_t, norms_hl, q_op, cb, nblk)
    if not codes_t.is_cuda:
        return plain(codes_t, norms_hl, q_op, cb, stage=stage, nblk=nblk)
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    num_q = q_op.shape[0]
    codes_t, norms_hl, q_op, cb = (t.contiguous() for t in (codes_t, norms_hl, q_op, cb))
    if q_op.data_ptr() % 16 or cb.data_ptr() % 16 or q_op.shape[1] % 8:
        raise ValueError("queries and codebooks must be 16-byte aligned rows")
    fn = _kernel()
    with torch.cuda.device(codes_t.device):
        out = torch.empty((num_q, n_cols // _LANES), dtype=torch.float32,
                          device=codes_t.device)
        err = fn(
            codes_t.data_ptr(), codes_t.element_size(), norms_hl.data_ptr(), q_op.data_ptr(),
            cb.data_ptr(), out.data_ptr(), n_cols, num_q, q_op.shape[1], m * dsub + 4, m,
            k_codes, dsub, nblk, STAGES.index(stage), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"adc_scan stage {stage} launch failed: cudaError_t {err}")
    tracing.count("probe.k1_stages.launches")
    return out
