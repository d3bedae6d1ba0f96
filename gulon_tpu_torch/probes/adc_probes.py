"""ADC scan probes P1 and P2: the counterpart of ``benchmarks/adc_probes.py``.

Kernels P1 (``adc_scan_probe`` with ``pipe=False``) and P2 (``pipe=True``)
of ``csrc/adc_probes.cu`` replace the TPU probes
``_adc_fused_kernel_probe`` and ``_adc_fused_kernel_pipe``: K1's contract
(``ops/cuda/adc.py``) with the in-kernel formulation selectable, so that a
variant's time against K1's is exactly the cost of that formulation:

- ``decode_mode``: ``"take"`` gathers codewords from shared memory (K1's
  own decode, the anchor); ``"base"`` contracts a one-hot of the codes
  against the codebooks on the tensor cores (the TPU's decode);
  ``"bf16cmp"`` builds that one-hot with compares on packed bf16 pairs;
- ``natural``: corpus rows on the tensor cores' M side and queries on N,
  the block minimum taken across warps;
- ``pipe``: a decode warpgroup fills a two-slot ring of decoded rows while
  the consumers contract the other slot; pairs of row tiles, as the TPU's
  schedule laid out its output.

The modes resolve as the TPU's do (``adc_probes.py:302-309`` and
``:446-449``), and the caller learns what ran: ``bf16cmp`` becomes
``base`` above K = 256, ``take`` becomes ``base`` above K = 256 or on a
row tile that K's 128-lane chunks do not divide, ``natural`` is dropped
at a depth of 128 or less (glove100's 112 runs the base orientation), and
``natural`` wins over ``pipe``.

Operand prep and the epilogue are K1's (``prepare_scan_operands``,
``finish_scan``); the outputs ``(dists, ids)`` follow that contract. The
kernels run for CUDA tensors and raise if they cannot; CPU tensors take
K1's plain version (``_block_scan_plain``), whose contract the probes
share. Parameters come as arrays, as ``adc_scan_fused`` takes them: a PQ
carried across from a JAX ``ProductQuantizer`` by ``interop.py`` serves
as it is, so no new carrier is needed.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from gulon_tpu_torch.ops.cuda import adc
from gulon_tpu_torch.ops.cuda.adc import _BIG, _LANES, _round_up
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE

DECODE_MODES = ("base", "bf16cmp", "take")
_DECODE_IDS = {"take": 0, "base": 1, "bf16cmp": 2}

# Launches in this process, counted where each kernel is launched and
# nowhere else: P1 and P2 (csrc/adc_probes.cu) once per probe_block_scan
# call on CUDA tensors, and the decoded-rows check (probe_decode_rows).
adc_probe_kernel_launches = 0
adc_probe_pipe_kernel_launches = 0
adc_probe_decode_launches = 0


def _pipe_tile_rows(t: int, *, qt: int, mdp: int, k_codes: int, m: int) -> int:
    """The pipelined schedule's row tile: ``t`` halved (kept a multiple of
    1024) while the TPU's VMEM budget would not hold two score tiles, two
    decoded tiles, the one-hot and two code blocks (``adc_probes.py:433-447``)."""
    budget = 14 * 1024 * 1024
    while t > 1024 and (
        2 * 4 * qt * t + 2 * 2 * mdp * t + 2 * 2 * t * k_codes + 2 * 4 * m * 2 * t
    ) >= budget:
        t = max(1024, (t // 2) // 1024 * 1024)
    return t


def resolve_modes(
    decode_mode: str, natural: bool, pipe: bool, *, k_codes: int, tile_rows: int,
    mdp: int, qt: int, m: int,
) -> dict:
    """The modes that run for a request, and the row tile, as the TPU probe
    resolves them."""
    if decode_mode not in DECODE_MODES:
        raise ValueError(f"decode_mode must be one of {DECODE_MODES}, got {decode_mode!r}")
    t = tile_rows
    if decode_mode == "bf16cmp" and k_codes > 256:
        decode_mode = "base"  # bf16 holds integers exactly only to 256
    if decode_mode == "take" and (k_codes > 256 or t % min(k_codes, _LANES) != 0):
        decode_mode = "base"
    natural = bool(natural and mdp > 128)  # shallow depths: nothing to gain
    pipe = bool(pipe and not natural)
    if pipe:
        t = _pipe_tile_rows(t, qt=qt, mdp=mdp, k_codes=k_codes, m=m)
        if decode_mode == "take" and t % min(k_codes, _LANES) != 0:
            decode_mode = "base"
    return dict(decode_mode=decode_mode, natural=natural, pipe=pipe, tile_rows=t)


def cb_transposed(cb: torch.Tensor, multiple: int = 64) -> torch.Tensor:
    """``[m, K, dsub] -> [m, dpad, kpad]`` (dsub to 16, K to ``multiple``),
    zero padded: the codebook slices the one-hot decodes (P1-P3) contract."""
    m, k_codes, dsub = cb.shape
    out = torch.zeros(
        (m, _round_up(dsub, 16), _round_up(k_codes, multiple)), dtype=cb.dtype,
        device=cb.device,
    )
    out[:, :dsub, :k_codes] = cb.transpose(1, 2)
    return out


_LIB = None


def _kernel():
    """The built probe library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from gulon_tpu_torch.ops.cuda import _build

        lib = _build.load("adc_probes")
        fn = lib.gulon_adc_probe
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]  # codes, code bytes
            + [ctypes.c_void_p] * 5  # norms, queries, cb, cbT, out
            + [ctypes.c_int] * 13  # n_cols num_q q_stride depth m K dsub kpad W nblk decode natural pipe
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
        fn = lib.gulon_adc_probe_decode
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]  # codes, code bytes
            + [ctypes.c_void_p] * 4  # norms, cb, cbT, rows
            + [ctypes.c_int] * 8  # n_cols width depth m K dsub kpad decode
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _cuda_operands(codes_t, norms_hl, cb, decode_mode):
    codes_t, norms_hl, cb = (t.contiguous() for t in (codes_t, norms_hl, cb))
    cb_t = None if decode_mode == "take" else cb_transposed(cb)
    if cb.data_ptr() % 16 or (cb_t is not None and cb_t.data_ptr() % 16):
        raise ValueError("codebooks must be 16-byte aligned")
    return codes_t, norms_hl, cb, cb_t


def probe_block_scan(
    codes_t: torch.Tensor,
    norms_hl: torch.Tensor,
    q_op: torch.Tensor,
    cb: torch.Tensor,
    *,
    winners: int,
    nblk: int,
    decode_mode: str = "base",
    natural: bool = False,
    pipe: bool = False,
) -> torch.Tensor:
    """Packed block winners ``[Q, N'/128 * winners]`` of P1 (P2 with
    ``pipe``) on K1's operands (``adc.fused_block_scan`` documents them),
    with the modes as given: resolve them first (:func:`resolve_modes`).

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors take K1's plain version, the probes' shared contract."""
    global adc_probe_kernel_launches, adc_probe_pipe_kernel_launches
    if decode_mode not in DECODE_MODES:
        raise ValueError(f"decode_mode must be one of {DECODE_MODES}, got {decode_mode!r}")
    if natural and pipe:
        raise ValueError("the piped schedule runs the base orientation only")
    devices = {t.device for t in (codes_t, norms_hl, q_op, cb)}
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {devices}")
    if not codes_t.is_cuda:
        return adc._block_scan_plain(codes_t, norms_hl, q_op, cb, winners=winners, nblk=nblk)
    adc._check_operands(codes_t, norms_hl, q_op, cb, winners, nblk)
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    if decode_mode == "bf16cmp" and k_codes > 256:
        raise ValueError("bf16cmp needs K <= 256 (resolve_modes turns it into base)")
    num_q = q_op.shape[0]
    if num_q == 0:
        raise ValueError("need at least one query")
    codes_t, norms_hl, cb, cb_t = _cuda_operands(codes_t, norms_hl, cb, decode_mode)
    q_op = q_op.contiguous()
    if q_op.data_ptr() % 16 or q_op.shape[1] % 8:
        raise ValueError("queries must be 16-byte aligned rows")
    lib = _kernel()
    with torch.cuda.device(codes_t.device):
        out = torch.empty(
            (num_q, n_cols // _LANES * winners), dtype=torch.float32, device=codes_t.device
        )
        err = lib.gulon_adc_probe(
            codes_t.data_ptr(), codes_t.element_size(), norms_hl.data_ptr(),
            q_op.data_ptr(), cb.data_ptr(), 0 if cb_t is None else cb_t.data_ptr(),
            out.data_ptr(), n_cols, num_q, q_op.shape[1], m * dsub + 4, m, k_codes, dsub,
            0 if cb_t is None else cb_t.shape[2], winners, nblk, _DECODE_IDS[decode_mode],
            int(natural), int(pipe), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"adc_probes kernel launch failed: cudaError_t {err}")
    if pipe:
        adc_probe_pipe_kernel_launches += 1
    else:
        adc_probe_kernel_launches += 1
    return out


def _decode_rows_plain(codes_t, norms_hl, cb, width: int) -> torch.Tensor:
    """The decoded rows ``[N', width]`` bf16 by a gather: codewords (+0 for
    codes outside [0, K), as the kernels write them), hi/lo norm lanes, two
    ones, zeros."""
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    c = codes_t.to(torch.int32) + (128 if codes_t.dtype == torch.int8 else 0)
    valid = (c >= 0) & (c < k_codes)
    sub = torch.arange(m, device=c.device)[:, None]
    dec = torch.where(valid[..., None], cb[sub, torch.where(valid, c, 0).long()], 0.0)
    return torch.cat([
        dec.permute(1, 0, 2).reshape(n_cols, m * dsub), norms_hl.T,
        torch.ones((n_cols, 2), dtype=torch.bfloat16, device=c.device),
        torch.zeros((n_cols, width - m * dsub - 4), dtype=torch.bfloat16, device=c.device),
    ], dim=1)


def probe_decode_rows(
    codes_t: torch.Tensor, norms_hl: torch.Tensor, cb: torch.Tensor, *, width: int,
    decode_mode: str = "base",
) -> torch.Tensor:
    """The rows P1 decodes, ``[N', width]`` bf16, through the decode of
    ``decode_mode``: on the card for holding a formulation against the
    gather bit for bit, the plain gather on the CPU."""
    global adc_probe_decode_launches
    if not codes_t.is_cuda:
        return _decode_rows_plain(codes_t, norms_hl, cb, width)
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    if width % 8 or width < m * dsub + 4 or n_cols % _LANES:
        raise ValueError(f"width {width} must be a multiple of 8 >= depth {m * dsub + 4}")
    codes_t, norms_hl, cb, cb_t = _cuda_operands(codes_t, norms_hl, cb, decode_mode)
    lib = _kernel()
    with torch.cuda.device(codes_t.device):
        rows = torch.empty((n_cols, width), dtype=torch.bfloat16, device=codes_t.device)
        err = lib.gulon_adc_probe_decode(
            codes_t.data_ptr(), codes_t.element_size(), norms_hl.data_ptr(), cb.data_ptr(),
            0 if cb_t is None else cb_t.data_ptr(), rows.data_ptr(), n_cols, width,
            m * dsub + 4, m, k_codes, dsub, 0 if cb_t is None else cb_t.shape[2],
            _DECODE_IDS[decode_mode], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"adc_probes decode launch failed: cudaError_t {err}")
    adc_probe_decode_launches += 1
    return rows


def probe_scan_operands(
    queries, codebooks, codes, recon_norms, *, bounds, tile_rows: int = 0,
    num_rows: int = 0, winners: int = 1, center_scores: bool = False,
    decode_mode: str = "base", natural: bool = False, pipe: bool = False,
) -> dict:
    """K1's operands for a probe call with the modes resolved: the pair
    padding of the piped schedule applied (codes with zeros, norms with
    ``_BIG``, as ``adc_probes.py:448-451``), and the winner geometry."""
    ops = adc.prepare_scan_operands(
        queries, codebooks, codes, recon_norms, bounds=bounds, tile_rows=tile_rows,
        num_rows=num_rows, winners=winners, center_scores=center_scores,
    )
    modes = resolve_modes(
        decode_mode, natural, pipe, k_codes=ops["k_codes"], tile_rows=ops["t"],
        mdp=ops["mdp"], qt=ops["qt"], m=ops["m"],
    )
    t = modes["tile_rows"]
    codes_t, norms = ops["codes_t"], ops["norms"]
    if modes["pipe"]:
        pad = (-codes_t.shape[1]) % (2 * t)
        codes_t = torch.nn.functional.pad(codes_t, (0, pad))
        norms = torch.nn.functional.pad(norms, (0, pad), value=_BIG)
    nblk = t // _LANES
    wn = winners * nblk
    cols = np.arange(codes_t.shape[1] // t * wn, dtype=np.int64)
    base_cols = ((cols // wn) * t + (cols % wn) % nblk * _LANES).astype(np.int32)
    return dict(
        codes_t=codes_t,
        norms_hl=adc._split_hi_lo(norms, ops["center"]),
        q_op=ops["q_pad"][: ops["num_q"]].to(torch.bfloat16),
        cb=codebooks.to(torch.bfloat16).contiguous(),
        base_cols=torch.from_numpy(base_cols).to(codes_t.device),
        nblk=nblk, qs=ops["qs"], pretransposed=ops["pretransposed"], modes=modes,
    )


def adc_scan_probe(
    queries,  # [Q, D] f32
    codebooks,  # [m, K, dsub] f32 (zero-padded subspaces)
    codes,  # [N, m] codes, or pretransposed [m, N] (num_rows)
    recon_norms,  # [N] f32
    *,
    bounds,
    k: int,
    tile_rows: int = 0,
    num_rows: int = 0,
    rescore: bool = False,
    winners: int = 1,
    center_scores: bool = False,
    decode_mode: str = "base",  # base | bf16cmp | take
    natural: bool = False,
    pipe: bool = False,
    device=None,
    resolved: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe-variant ADC scan (counterpart of ``benchmarks/adc_probes.py::
    adc_scan_probe``): ``adc_scan_fused``'s semantics with the in-kernel
    formulation selectable. Returns ``([Q, k] dists ascending, [Q, k]
    ids)``; ``resolved``, when given, receives the modes that ran
    (``decode_mode``, ``natural``, ``pipe``, ``tile_rows``). Inputs go to
    ``device`` (default: the card)."""
    if not 1 <= winners <= 4:
        raise ValueError(f"winners must be in 1..4, got {winners}")
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    queries, codebooks, codes, recon_norms = (
        torch.as_tensor(a, device=device) for a in (queries, codebooks, codes, recon_norms)
    )
    n = num_rows if num_rows > 0 else codes.shape[0]
    if k > _LANES:
        raise ValueError(f"probe ADC kernel supports k <= 128, got {k}")
    kk = min(k, n)
    if n < 256 * kk:
        raise ValueError(f"probe ADC kernel needs corpus >= 256*k rows (n={n}, k={kk})")
    ops = probe_scan_operands(
        queries, codebooks, codes, recon_norms, bounds=bounds, tile_rows=tile_rows,
        num_rows=num_rows, winners=winners, center_scores=center_scores,
        decode_mode=decode_mode, natural=natural, pipe=pipe,
    )
    modes = ops["modes"]
    if resolved is not None:
        resolved.update(modes)
    packed = probe_block_scan(
        ops["codes_t"], ops["norms_hl"], ops["q_op"], ops["cb"], winners=winners,
        nblk=ops["nblk"], decode_mode=modes["decode_mode"], natural=modes["natural"],
        pipe=modes["pipe"],
    )
    return adc.finish_scan(
        packed, ops["base_cols"], ops["qs"], ops["codes_t"], ops["pretransposed"],
        queries=queries, codebooks=codebooks, codes=codes, k=k, kk=kk, rescore=rescore,
        centered=center_scores,
    )
