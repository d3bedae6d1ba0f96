"""Bisection probe P3 of the fused ADC scan: the counterpart of
``benchmarks/kernel_probe.py``.

Kernel P3 (``csrc/kernel_probe.cu``) replaces the TPU probe's four
kernels (``make_tdec``, ``make_cached``, ``make_i8dec``, ``make``): K1 cut
down stage by stage at one shape, each variant writing exactly what the
TPU variant of that name writes at the TPU's row tile t (2048 by default)
and query tile (512). Outputs ``(vals [n_rt * nblk, Q] f32, ids [n_rt *
nblk, Q] int32)``, row ``r * nblk + b`` for row tile r and 128-row block b
(``nblk = t / 128``). Scores are ``norms - 2 <q, dec(row)>`` from one f32
norm row, no hi/lo lanes. Variants (:data:`VARIANTS`):

- ``tdec_*`` (queries on the tensor cores' M side, as K1): ``noop``
  (zeros), ``grid`` (decode, zeros), ``noselect`` (the first nblk score
  rows of each tile), ``min`` (block minimum, zero ids), ``match`` (and
  the lowest row reaching it), ``packed`` (the TPU's sign-folded int32
  key with the row in its low 7 bits, one integer minimum: not K1's f32
  key); each also as ``:nib`` (nibble one-hots multiplied) and ``:cmp8``
  (an int8 compare, on offset-encoded int8 codes); ``tdec_cached`` (match
  over a decoded operand built beforehand, ``[N, mdp]`` bf16) and
  ``tdec_i8`` (match after an s8 one-hot against s8 codewords,
  dequantized per subspace);
- natural orientation (corpus rows on M): ``grid_only`` (zeros),
  ``decode_only``, ``no_select`` (the tile's ``scores[0, 0]`` everywhere),
  ``min_only``, ``full`` (min, then the lowest row), ``packed_lane`` (the
  sign-folded key).

:func:`make` prepares a variant's operands once (the int8 codes, the
one-hot's codebook slices, bf16 or s8 with their scales, the decoded
operand), as the TPU probe did outside its timed loop, and returns the
launch; :func:`kernel_probe` is one call. On the card the one-hot is
built in ``wgmma``'s register operand by decode warpgroups beside the
contraction (``csrc/kernel_probe.cu`` says how), with the codebook slices
resident in shared memory: a shape whose slices, two decoded 128-row
blocks and two query stages do not fit 227 KB is refused (a
``RuntimeError`` from the launch).
CUDA tensors launch the kernel (or raise); CPU tensors take the variant's
plain version. Operands come from numpy (:func:`probe_operands`, seed 0):
``jax.random.key(0)`` cannot be replayed here, so no new carrier is
needed. ``python -m gulon_tpu_torch.probes.kernel_probe [variants]``
prints each variant's ms on the card, with the TPU probe's ``PROBE_*``
shape variables.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Callable, Tuple

import numpy as np
import torch

from gulon_tpu_torch.ops.cuda.adc import _LANES, _round_up
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.probes import median_ms
from gulon_tpu_torch.probes.adc_probes import cb_slices
from gulon_tpu_torch.utils import tracing
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE

_INT_BIG = 2**30
_ONEHOT_LANES = 16  # P3's one-hot pieces (wgmma N): ceil(dsub / 16) of them
_STAGES = ("noop", "grid", "noselect", "min", "match", "packed")
_IMPLS = {"": 0, "nib": 2, "cmp8": 3, "i8": 4, "cached": 5}
_TDEC = {f"tdec_{s}": s for s in _STAGES}
_NATURAL = {
    "grid_only": "noop", "decode_only": "grid", "no_select": "noselect",
    "min_only": "min", "full": "match", "packed_lane": "packed",
}
# variant -> (stage, one-hot recipe, natural orientation)
_SPECS = {
    **{f"{name}{':' + impl if impl else ''}": (stage, impl, False)
       for name, stage in _TDEC.items() for impl in ("", "nib", "cmp8")},
    "tdec_cached": ("match", "cached", False),
    "tdec_i8": ("match", "i8", False),
    **{name: (stage, "", True) for name, stage in _NATURAL.items()},
}
VARIANTS = tuple(_SPECS)
DEFAULT_VARIANTS = ("packed_lane", "tdec_packed", "full")  # kernel_probe.py:489


def spec(variant: str) -> Tuple[str, str, bool]:
    """``(stage, one-hot recipe, natural)`` of a variant name."""
    if variant not in _SPECS:
        raise ValueError(f"unknown kernel_probe variant {variant!r}; known: {VARIANTS}")
    return _SPECS[variant]


def shape_from_env(environ=os.environ) -> dict:
    """The probe's shape, with ``PROBE_N``, ``PROBE_M``, ``PROBE_DSUB``,
    ``PROBE_MDP``, ``PROBE_QT`` and ``PROBE_T`` as ``kernel_probe.py:29-38``
    reads them (K 256, 1024 queries)."""
    n = int(environ.get("PROBE_N", 400_000))
    m = int(environ.get("PROBE_M", 8))
    dsub = int(environ.get("PROBE_DSUB", 13))
    mdp = int(environ.get("PROBE_MDP", max(-(-(m * dsub) // 8) * 8, 128)))
    return dict(n=n, m=m, k_codes=256, dsub=dsub, mdp=mdp, num_q=1024,
                qt=int(environ.get("PROBE_QT", 512)), t=int(environ.get("PROBE_T", 2048)))


def probe_operands(n, m, k_codes, dsub, mdp, num_q, t, *, seed: int = 0, device=None):
    """Seeded operands at the probe's shape, drawn with numpy: codes
    ``[m, N']`` int32 in [0, K) (N' = n rounded up to t), norms ``[1, N']``
    f32 uniform, queries ``[Q, mdp]`` and codebooks ``[m, K, dsub]``
    standard normal, rounded to bf16."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    rng = np.random.default_rng(seed)
    npad = _round_up(n, t)
    codes_t = rng.integers(0, k_codes, (m, npad), dtype=np.int32)
    norms = rng.uniform(size=(1, npad)).astype(np.float32)
    q_pad = rng.standard_normal((num_q, mdp), dtype=np.float32)
    cb = rng.standard_normal((m, k_codes, dsub), dtype=np.float32)
    return (
        torch.from_numpy(codes_t).to(device),
        torch.from_numpy(norms).to(device),
        torch.from_numpy(q_pad).to(device=device, dtype=torch.bfloat16),
        torch.from_numpy(cb).to(device=device, dtype=torch.bfloat16),
    )


def quantize_codebooks(cb: torch.Tensor):
    """``tdec_i8``'s codewords: per subspace ``scale = max|cb| / 127`` and
    ``clip(round(cb / scale), -127, 127)`` as int8 (``kernel_probe.py:
    337-342``). Returns ``(cb_i8 [m, K, dsub], scale [m] f32)``."""
    cbf = cb.to(torch.float32)
    scale = cbf.abs().amax(dim=(1, 2)) / 127.0
    cb_i8 = torch.clamp(torch.round(cbf / scale[:, None, None]), -127, 127).to(torch.int8)
    return cb_i8, scale


def decoded_rows(codes_t, cb, mdp: int, i8=None) -> torch.Tensor:
    """The decoded operand ``[N', mdp]`` bf16: each row's codewords
    ``cb[s, code]`` side by side, zero past ``m * dsub``; with ``i8 =
    (cb_i8, scale)`` the s8 codewords times their scale, rounded to bf16."""
    m, npad = codes_t.shape
    _, _, dsub = cb.shape
    sub = torch.arange(m, device=codes_t.device)[:, None]
    c = codes_t.long()
    if i8 is None:
        dec = cb[sub, c]  # [m, N', dsub]
    else:
        cb_i8, scale = i8
        dec = (cb_i8[sub, c].to(torch.float32) * scale[:, None, None]).to(torch.bfloat16)
    dec = dec.permute(1, 0, 2).reshape(npad, m * dsub)
    return torch.nn.functional.pad(dec, (0, mdp - m * dsub))


def _mono(bits: torch.Tensor) -> torch.Tensor:
    """Monotone int32 image of float bits (its own inverse)."""
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _plain(stage, natural, dec, norms, q_pad, *, t, qt):
    """The plain version of a stage over decoded rows: scores ``norms - 2
    dec q^T`` at full f32, one row tile at a time, then the stage's
    writes."""
    npad = dec.shape[0]
    num_q = q_pad.shape[0]
    nblk = t // _LANES
    dev = dec.device
    vals = torch.zeros((npad // _LANES, num_q), dtype=torch.float32, device=dev)
    ids = torch.zeros((npad // _LANES, num_q), dtype=torch.int32, device=dev)
    if stage in ("noop", "grid"):
        return vals, ids
    q = q_pad.to(torch.float32)
    step = max(t, (1 << 28) // (4 * num_q) // t * t)
    row_in_blk = torch.arange(_LANES, dtype=torch.int32, device=dev)[None, :, None]
    for start in range(0, npad, step):
        stop = min(start + step, npad)
        ip = matmul(dec[start:stop].to(torch.float32), q.T, "highest")  # [rows, Q]
        scores = norms[0, start:stop, None] - 2.0 * ip
        b0, b1 = start // _LANES, stop // _LANES
        if stage == "noselect":
            tiles = scores.reshape(-1, t, num_q)
            if natural:  # scores[0, 0] of each (row tile, query tile)
                first = tiles[:, 0, ::qt]  # [tiles, Q / qt]
                vals[b0:b1] = first.repeat_interleave(qt, dim=1)[:, None, :num_q].expand(
                    -1, nblk, -1).reshape(-1, num_q)
            else:  # the first nblk score rows of each tile
                vals[b0:b1] = tiles[:, :nblk].reshape(-1, num_q)
            continue
        s3 = scores.reshape(-1, _LANES, num_q)
        if stage == "packed":
            key = (_mono(s3.view(torch.int32)) & ~127) | row_in_blk
            pmin = torch.amin(key, dim=1)
            vals[b0:b1] = _mono(pmin).view(torch.float32)
            blocks = torch.arange(b0, b1, dtype=torch.int32, device=dev)[:, None]
            ids[b0:b1] = blocks * _LANES + (pmin & 127)
            continue
        vmin = torch.amin(s3, dim=1)
        vals[b0:b1] = vmin
        if stage == "match":
            cand = torch.where(s3 == vmin[:, None, :], row_in_blk, _INT_BIG)
            blocks = torch.arange(b0, b1, dtype=torch.int32, device=dev)[:, None]
            ids[b0:b1] = blocks * _LANES + torch.amin(cand, dim=1)
    return vals, ids


_LIB = None


def _kernel():
    """The built P3 library, with its C signature declared."""
    global _LIB
    if _LIB is None:
        from gulon_tpu_torch.ops.cuda import _build

        lib = _build.load("kernel_probe")
        fn = lib.gulon_kernel_probe
        fn.argtypes = (
            [ctypes.c_int] * 3  # stage, impl, natural
            + [ctypes.c_void_p, ctypes.c_int]  # codes, code bytes
            + [ctypes.c_void_p] * 7  # norms, queries, slices, scale, cache, vals, ids
            + [ctypes.c_int] * 9  # n_cols num_q mdp m K dsub pieces nblk qt
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _slices(cb, chunk: int) -> torch.Tensor:
    """P3's one-hot slices (``adc_probes.cb_slices``): pieces of 16 lanes,
    K padded with zero codewords to an even count of ``chunk``-code chunks
    (the kernel's decode groups take two chunks)."""
    k_codes = cb.shape[1]
    cb = torch.nn.functional.pad(cb, (0, 0, 0, -k_codes % (2 * chunk)))
    return cb_slices(cb, _ONEHOT_LANES, -(-cb.shape[2] // _ONEHOT_LANES), chunk)


def make(
    variant: str, codes_t, norms, q_pad, cb, *, tile_rows: int = 2048,
    query_tile: int = 512, device=None,
) -> Callable[[], Tuple[torch.Tensor, torch.Tensor]]:
    """A variant's launch over these operands: ``run() -> (vals, ids)``.
    Operands: codes ``[m, N']`` int in [0, K), norms ``[1, N']`` f32,
    queries ``[Q, mdp]`` bf16, codebooks ``[m, K, dsub]`` bf16; N' a
    multiple of ``tile_rows``, which is a multiple of 128, as is
    ``query_tile``. They go to ``device`` (default: the card)."""
    stage, impl, natural = spec(variant)
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    codes_t, norms, q_pad, cb = (
        torch.as_tensor(a, device=device) for a in (codes_t, norms, q_pad, cb)
    )
    m, npad = codes_t.shape
    _, k_codes, dsub = cb.shape
    num_q, mdp = q_pad.shape
    if tile_rows % _LANES or npad % tile_rows or query_tile % _LANES:
        raise ValueError(
            f"need tile_rows ({tile_rows}) and query_tile ({query_tile}) multiples of 128 "
            f"and N' ({npad}) a multiple of tile_rows"
        )
    if norms.shape != (1, npad) or mdp < m * dsub or mdp % 8:
        raise ValueError(f"norms must be [1, {npad}] and mdp >= m * dsub, a multiple of 8")
    if impl in ("cmp8", "i8") and k_codes > 256:
        raise ValueError(f"{variant} needs K <= 256")
    norms = norms.to(torch.float32).contiguous()
    q_pad = q_pad.to(torch.bfloat16).contiguous()
    cb = cb.to(torch.bfloat16).contiguous()
    if not codes_t.is_cuda:
        return lambda: plain(variant, codes_t, norms, q_pad, cb, tile_rows=tile_rows,
                             query_tile=query_tile)
    i8 = quantize_codebooks(cb) if impl == "i8" else None
    nblk = tile_rows // _LANES

    # the variant's own operands, prepared once (outside any timed loop)
    if impl == "cmp8":  # offset-encoded int8, as kernel_probe.py:208
        codes = (codes_t.to(torch.int32) - 128).to(torch.int8).contiguous()
    else:
        codes = codes_t.to(torch.int32).contiguous()
    cache = decoded_rows(codes_t, cb, mdp).contiguous() if impl == "cached" else None
    if impl == "i8":  # s8 codewords, 128 codes a slice row
        slices, scale = _slices(i8[0], 128), i8[1].contiguous()
    elif impl != "cached":
        slices, scale = _slices(cb, 64), None
    else:
        slices = scale = None
    if q_pad.data_ptr() % 16:
        raise ValueError("queries must be 16-byte aligned")
    lib = _kernel()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def run():
        with torch.cuda.device(device):
            vals = torch.empty((npad // _LANES, num_q), dtype=torch.float32, device=device)
            ids = torch.empty((npad // _LANES, num_q), dtype=torch.int32, device=device)
            err = lib.gulon_kernel_probe(
                _STAGES.index(stage), _IMPLS[impl], int(natural), codes.data_ptr(),
                codes.element_size(), norms.data_ptr(), q_pad.data_ptr(), ptr(slices),
                ptr(scale), ptr(cache), vals.data_ptr(), ids.data_ptr(), npad, num_q, mdp, m,
                k_codes, dsub, -(-dsub // _ONEHOT_LANES), nblk, query_tile,
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"kernel_probe {variant} launch failed: cudaError_t {err}")
        tracing.count("probe.p3.launches")
        return vals, ids

    return run


def kernel_probe(
    variant: str, codes_t, norms, q_pad, cb, *, tile_rows: int = 2048,
    query_tile: int = 512, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of a variant: ``(vals, ids)`` as :func:`make` describes."""
    return make(
        variant, codes_t, norms, q_pad, cb, tile_rows=tile_rows, query_tile=query_tile,
        device=device,
    )()


def plain(variant: str, codes_t, norms, q_pad, cb, *, tile_rows: int = 2048,
          query_tile: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of a variant on the operands' own device."""
    stage, impl, natural = spec(variant)
    i8 = quantize_codebooks(cb) if impl == "i8" else None
    dec = decoded_rows(codes_t, cb.to(torch.bfloat16), q_pad.shape[1], i8)
    return _plain(stage, natural, dec, norms.to(torch.float32), q_pad, t=tile_rows,
                  qt=query_tile)


def main(argv=None) -> int:
    """Print each variant's ms a batch on the card (its device time,
    queued back to back: :func:`gulon_tpu_torch.probes.median_ms`); the
    variants from the command line, or the TPU probe's default three."""
    variants = (sys.argv[1:] if argv is None else argv) or DEFAULT_VARIANTS
    shape = shape_from_env()
    ops = probe_operands(
        shape["n"], shape["m"], shape["k_codes"], shape["dsub"], shape["mdp"],
        shape["num_q"], shape["t"],
    )
    for variant in variants:
        run = make(variant, *ops, tile_rows=shape["t"], query_tile=shape["qt"])
        print(f"{variant:12s} {median_ms(run):9.3f} ms/batch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
