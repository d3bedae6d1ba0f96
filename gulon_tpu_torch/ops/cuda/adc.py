"""Fused ADC scan: the counterpart of ``gulon_tpu/ops/pallas/adc.py``.

Kernel K1 (``csrc/adc_scan.cu``) replaces the TPU kernel
``_adc_fused_kernel``: per 128-row block of the corpus it decodes the PQ
codes once, scores every query against them on the tensor cores (wgmma,
f32 accumulation) and keeps each query's lane-packed block minimum. This
module holds everything around it, with the JAX package's names and
semantics so that the two compare one for one:

- tile geometry (``padded_depth``, ``_pick_tiles``, ``block_layout``);
  the row tile only fixes the winner-column order now, which keeps the
  epilogue's ``base_cols`` and tie order identical;
- the operands, owned by :class:`K1Operands` (``_split_hi_lo``,
  ``pack_codes_t``): -2-scaled bf16 queries with unit lanes facing the
  hi/lo bf16 norm rows, and in centered mode ``||q||^2 + mean`` lanes
  facing two rows of ones, so the contraction emits the true ADC
  distance. What depends only on the rows and the launch geometry is
  built once and held by the owner (an index, a shard, or one call); a
  batch builds only its query operand;
- the launch (:func:`fused_block_scan`), which runs K1 for CUDA tensors
  and its plain PyTorch twin :func:`_block_scan_plain` for CPU tensors,
  and counts each launch by K1's launch plan (:func:`k1_plan`: the
  kernel's own plan function, ``make_plan`` in ``adc_scan.cu``, read
  through ``gulon_adc_scan_plan`` once per shape);
- the plain-torch epilogue (``unpack_block_winners``, ``finish_scan``):
  an exact top-k over block winners, id decode, optional f32 LUT rescore;
- the entry points :func:`adc_scan_fused` (``adc_scan_pallas``) and
  :func:`adc_block_scan_fused` (``adc_block_scan_pallas``), over an
  owner built for the call, and :func:`scan_top_k` over a held one.

Selection keeps one winner (1-4 with ``winners``) per 128-row block,
exactly like the TPU kernel: losing a true top-k member needs two of
them in one block, so callers keep ``N >= 256*k``. Limits: K <= 1024,
k <= 128, N >= 256*k; ``FlatIndex`` falls back to the decode scan
outside them. Any depth runs on the card: a row block too deep to sit
decoded in shared memory is decoded chunk by chunk for each query tile
(the streamed plan, past a depth of about 700; 256 queries a tile where
that fits), its codebooks gathered from global memory when they do not
fit beside it, each gather loading the largest of 8, 4, 2 and 1 lanes
that divides the operands' subspace width. :class:`K1Operands` lays its
codebook and query operands out at the width K1's plan gives
(:func:`k1_plan`'s ``width``:
where the plan streams, ``dsub`` rounded up to 8 lanes if that adds no
64-lane chunk to the depth), so 39 lanes at 960 dimensions over 25
subspaces become 40, zero lanes facing zero lanes, and its gathers load
8 lanes, not one.
``center_scores`` is an explicit argument (centered for the flat scan,
uncentered for block-scan callers).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from gulon_tpu_torch.ops.distance import sq_norms
from gulon_tpu_torch.ops.pq import _lut, split_subspaces
from gulon_tpu_torch.ops.precision import matmul
from gulon_tpu_torch.ops.topk import smallest_k_nan_last
from gulon_tpu_torch.utils import tracing

_BIG = 3.0e38
_INVALID_MIN = 1.0e38  # values at/above this are padding, not real rows
_LANES = 128
_PLAIN_SCORE_BYTES = 1 << 30  # score tile budget of the plain twin


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_depth(m: int, dsub: int) -> int:
    """Contraction depth of the query operand: ``m * dsub`` decode rows,
    the hi/lo norm rows and two ones rows, padded to a multiple of 8."""
    return _round_up(m * dsub + 4, 8)


def _pick_tiles(
    num_q: int, k_codes: int, mdp: int, winners: int = 1
) -> Tuple[int, int]:
    """(query tile, row tile) of the TPU kernel (``adc.py:130-154``). The
    row tile fixes the winner-column order; the query tile the query
    padding."""
    budget = 14 * 1024 * 1024
    qt = min(_round_up(num_q, 16), 512)
    score_copies = 2 if winners > 1 else 1
    for t in (4096, 2048, 1024):
        work = 4 * qt * t * score_copies + 2 * t * mdp + 2 * 2 * t * k_codes
        if work < budget:
            return qt, t
    return qt, 1024


def block_layout(
    num_q: int, k_codes: int, mdp: int, n: int, tile_rows: int = 0,
    winners: int = 1,
) -> Tuple[int, int, int, int]:
    """(qt, t, n_rt, nblk): query tile, row tile, row tiles, 128-row
    blocks per tile. ``mdp`` is :func:`padded_depth`."""
    qt, t = _pick_tiles(num_q, k_codes, mdp, winners)
    if tile_rows:
        t = tile_rows
    if n < t:
        t = _round_up(n, 1024)
    n_pad = _round_up(n, t)
    return qt, t, n_pad // t, t // _LANES


def _split_hi_lo(norms: torch.Tensor, center=0.0) -> torch.Tensor:
    """``[N] f32 -> [2, N] bf16`` with ``hi + lo ~= norms - center`` to
    ~2^-17 relative. +inf padding clamps to ``_BIG`` first, since
    ``inf - inf`` would be NaN."""
    norms = torch.clamp(norms, max=_BIG) - center
    hi = norms.to(torch.bfloat16)
    lo = (norms - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, lo])


def pack_codes_t(codes: torch.Tensor, k_codes: int) -> torch.Tensor:
    """Pretransposed code operand ``[m, N]`` at minimal width: K <= 256
    as offset-encoded int8 (``code - 128``), K <= 32768 int16, else int32."""
    c = codes.to(torch.int32)
    if k_codes <= 256:
        return (c - 128).to(torch.int8).T.contiguous()
    if k_codes <= 32768:
        return c.to(torch.int16).T.contiguous()
    return c.T.contiguous()


def _center(recon_norms: torch.Tensor, center_scores: bool) -> torch.Tensor:
    """The centered mode's constant, the mean norm over the real rows (0
    uncentered), as a 0-d f32 tensor."""
    if not center_scores:
        return torch.zeros((), dtype=torch.float32, device=recon_norms.device)
    nf = torch.clamp(recon_norms.to(torch.float32), max=_BIG)
    valid = nf < _INVALID_MIN
    return torch.sum(torch.where(valid, nf, 0.0)) / torch.clamp(
        torch.sum(valid.to(torch.float32)), min=1.0
    )


def _winner_blocks(num_cols: int, winners: int, nblk: int, device):
    """``(block, rank)`` of each of K1's ``num_cols`` output columns, int64
    on the device: rank-major inside each row tile of ``nblk`` 128-row
    blocks (the inverse of :func:`_winner_columns`)."""
    cols = torch.arange(num_cols, dtype=torch.int64, device=device)
    wn = winners * nblk
    return (cols // wn) * nblk + (cols % wn) % nblk, (cols % wn) // nblk


def _base_cols(n_cols: int, t: int, winners: int, device) -> torch.Tensor:
    """``[n_cols / 128 * winners]`` int32: the first row of each winner
    column's 128-row block, built on the device."""
    block, _ = _winner_blocks(n_cols // _LANES * winners, winners, t // _LANES, device)
    return (block * _LANES).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _query_columns(bounds: tuple, dsub: int, centered: bool, device: torch.device):
    """``(cols [mdp] int64, lanes [3] f32)`` on ``device``: lane ``j`` of the
    query operand is column ``cols[j]`` of the rows :func:`_query_lanes`
    concatenates, ``[lanes (-0.0, +0.0, 1.0), (||q||^2 + center hi, lo),
    -2 q]``. A zero-padded subspace lane reads -0.0 (0 scaled by -2), the
    two unit lanes 1.0, the center lanes their hi / lo parts (+0.0
    uncentered), the depth padding +0.0. Held per shape, so a caller that
    holds no index uploads them once."""
    m = len(bounds)
    md = m * dsub
    lead = 5 if centered else 3
    cols = np.ones(padded_depth(m, dsub), np.int64)
    for s, (start, width) in enumerate(bounds):
        cols[s * dsub : (s + 1) * dsub] = 0
        cols[s * dsub : s * dsub + width] = lead + start + np.arange(width)
    cols[md : md + 2] = 2
    if centered:
        cols[md + 2 : md + 4] = (3, 4)
    with tracing.span("gulon.wait.upload_columns"):
        return (
            torch.from_numpy(cols).to(device),
            torch.tensor([-0.0, 0.0, 1.0], dtype=torch.float32, device=device),
        )


def _query_lanes(
    queries: torch.Tensor, cols: torch.Tensor, lanes: torch.Tensor,
    center: torch.Tensor, centered: bool,
) -> torch.Tensor:
    """``[Q, mdp]`` query operand in the queries' precision: one
    concatenation and one column gather (:func:`_query_columns`), no loop
    over subspaces. Bit for bit the lanes the subspace split, the -2 scale
    and the padding give."""
    parts = [lanes.expand(queries.shape[0], 3)]
    if centered:
        qc = sq_norms(queries) + center  # [Q]
        qc_hi = qc.to(torch.bfloat16).to(torch.float32)
        parts += [qc_hi[:, None], (qc - qc_hi)[:, None]]
    parts.append(queries * -2.0)
    return torch.index_select(torch.cat(parts, dim=1), 1, cols)


def _k1_lane_width(codebooks: torch.Tensor, device) -> int:
    """The subspace width K1's operands for an index's codebooks ``[m, K,
    dsub]`` are laid out at for a launch on ``device``: the ``width`` of
    K1's plan at that shape (:func:`k1_plan`) on the card; ``dsub``
    elsewhere, where the plain twin gathers nothing."""
    m, k_codes, dsub = codebooks.shape
    if torch.device(device).type != "cuda":
        return dsub
    return k1_plan(m, k_codes, dsub)["width"]


class K1Operands:
    """K1's operands over one index's rows, one shard's, or one call's: what
    they are and who holds them is decided here alone.

    Built from the codebooks ``[m, K, dsub]`` f32, the code operand
    (pretransposed ``[m, num_rows]``, :func:`pack_codes_t`, or with
    ``num_rows=0`` row-major ``[N, m]`` codes, taken as int32), the rows'
    norms ``[N]`` f32 (an IVF layout's row constants) and the centering
    (flat indices centered, IVF indices and the block-scan API
    uncentered). It holds:

    - the bf16 codebooks and the query operand's column map
      (:func:`_query_columns`) at the subspace width of K1's plan
      (:func:`_k1_lane_width`; ``lane_padded`` when wider than ``dsub``:
      codebook lanes past ``dsub`` +0.0 face query lanes of -0.0, exact
      zeros), and the center;
    - one code operand zero-padded to the row tile, and its ``[2, N']`` bf16 hi/lo norm rows with the center folded in
      (``_BIG`` on the padding rows): launch geometries of its width share
      them, one of another width replaces them and every geometry held;
    - ``base_cols`` per launch geometry ``(t, winners)``, ``t`` from
      :func:`block_layout` at the own width; each one built adds one to
      ``k1.operand_builds``.

    A batch then builds its query operand alone (:meth:`query_operand`).
    ``_own_width`` keeps the subspaces' own width on the card too, for
    the probes and the kernel-level checks, which reach K1's narrower
    gathers."""

    def __init__(
        self,
        codebooks: torch.Tensor,
        codes: torch.Tensor,
        norms: torch.Tensor,
        *,
        bounds,
        num_rows: int = 0,
        center_scores: bool = False,
        _own_width: bool = False,
    ):
        m, k_codes, dsub = codebooks.shape
        if k_codes > 1024:
            raise ValueError(f"fused ADC kernel supports K <= 1024, got {k_codes}")
        self.codebooks, self.bounds, self.norms = codebooks, bounds, norms
        self.n = num_rows if num_rows > 0 else codes.shape[0]
        self.mdp = padded_depth(m, dsub)
        self.centered = bool(center_scores)
        self.device = codes.device
        width = dsub if _own_width else _k1_lane_width(codebooks, self.device)
        self.lane_padded = width > dsub
        self.cb = torch.nn.functional.pad(
            codebooks.to(torch.bfloat16), (0, width - dsub)
        ).contiguous()
        self.cols, self.lanes = _query_columns(
            tuple((int(s), int(w)) for s, w in bounds), width, self.centered, self.device
        )
        self.center = _center(norms, self.centered)
        # the code operand as given, until the first padding
        self.codes_t = codes if num_rows > 0 else codes.to(torch.int32).T
        self.norms_hl = None
        self._base_cols = {}  # (t, winners) -> base_cols

    def geometry(self, num_q: int, *, winners: int = 1, tile_rows: int = 0):
        """``(t, base_cols)`` of a launch over ``num_q`` queries, the code
        operand and norm rows held at its width."""
        if tile_rows % 1024:
            raise ValueError(f"tile_rows must be a 1024-multiple, got {tile_rows}")
        _, t, _, _ = block_layout(num_q, self.cb.shape[1], self.mdp, self.n, tile_rows, winners)
        key = (t, winners)
        if key not in self._base_cols:
            self._pad_columns(_round_up(self.n, t))
            self._base_cols[key] = _base_cols(self.codes_t.shape[1], t, winners, self.device)
            tracing.count("k1.operand_builds")
        return t, self._base_cols[key]

    def _pad_columns(self, n_cols: int) -> None:
        """Hold the code operand and norm rows at ``n_cols`` columns."""
        if self.norms_hl is not None and self.codes_t.shape[1] == n_cols:
            return
        self._base_cols.clear()  # one code operand at a time
        pad = (0, n_cols - self.n)
        self.codes_t = torch.nn.functional.pad(self.codes_t[:, : self.n], pad).contiguous()
        norms = torch.nn.functional.pad(self.norms.to(torch.float32), pad, value=_BIG)
        self.norms_hl = _split_hi_lo(norms, self.center)

    def query_operand(self, queries: torch.Tensor) -> torch.Tensor:
        """``[Q, mdp]`` bf16 query operand of K1 against these operands."""
        return _query_lanes(
            queries, self.cols, self.lanes, self.center, self.centered
        ).to(torch.bfloat16)

    def operands(self, queries: torch.Tensor, *, winners: int = 1, tile_rows: int = 0):
        """``((codes_t, norms_hl, q_op, cb), nblk)``: the four tensors
        :func:`fused_block_scan` takes for a batch, and its blocks a row
        tile."""
        t, _ = self.geometry(queries.shape[0], winners=winners, tile_rows=tile_rows)
        return (self.codes_t, self.norms_hl, self.query_operand(queries), self.cb), t // _LANES

    def scan(self, queries: torch.Tensor, *, winners: int = 1, tile_rows: int = 0):
        """K1 over a batch: ``(packed [Q, NW], base_cols [NW] int32)``, as
        ``adc.py:422-507`` returns them: ``packed`` holds lane-packed winner
        floats, ``base_cols[c]`` the first row of winner column ``c``'s
        block, so ``row = base_cols[c] + (bits(packed) & 127)``; values
        ``>= _INVALID_MIN`` mark padding. A launch on the card also adds
        to ``k1.launches.lane_padded`` (1 where the operands are wider
        than the subspaces)."""
        with tracing.span("gulon.scan.operands"):
            operands, nblk = self.operands(queries, winners=winners, tile_rows=tile_rows)
        with tracing.span("gulon.scan.k1"):
            packed = fused_block_scan(*operands, winners=winners, nblk=nblk)
            if self.device.type == "cuda":
                tracing.count("k1.launches.lane_padded", int(self.lane_padded))
        return packed, self._base_cols[(nblk * _LANES, winners)]


def _winner_columns(blocks: torch.Tensor, w: int, winners: int, nblk: int):
    """Output column of winner ``w`` of each global 128-row block: rank-
    major inside each row tile of ``nblk`` blocks (``adc.py:494-500``)."""
    return (blocks // nblk) * winners * nblk + w * nblk + blocks % nblk


def _check_operands(codes_t, norms_hl, q_op, cb, winners: int, nblk: int):
    if codes_t.dim() != 2 or codes_t.dtype not in (torch.int8, torch.int16, torch.int32):
        raise ValueError(
            f"codes_t must be [m, N] int8/int16/int32, got "
            f"{tuple(codes_t.shape)} {codes_t.dtype}"
        )
    m, n_cols = codes_t.shape
    if cb.dim() != 3 or cb.shape[0] != m or cb.dtype != torch.bfloat16:
        raise ValueError(
            f"codebooks must be [{m}, K, dsub] bf16, got {tuple(cb.shape)} {cb.dtype}"
        )
    depth = m * cb.shape[2] + 4
    if n_cols % _LANES or n_cols == 0 or (n_cols // _LANES) % nblk:
        raise ValueError(
            f"codes_t width {n_cols} must be a positive multiple of "
            f"{_LANES} * nblk ({nblk})"
        )
    if norms_hl.shape != (2, n_cols) or norms_hl.dtype != torch.bfloat16:
        raise ValueError(
            f"norms must be [2, {n_cols}] bf16, got {tuple(norms_hl.shape)} "
            f"{norms_hl.dtype}"
        )
    if q_op.dim() != 2 or q_op.shape[1] < depth or q_op.dtype != torch.bfloat16:
        raise ValueError(
            f"queries must be [Q, >={depth}] bf16, got {tuple(q_op.shape)} "
            f"{q_op.dtype}"
        )
    if not 1 <= winners <= 4:
        raise ValueError(f"winners must be in 1..4, got {winners}")


def _block_min_plain(packed: torch.Tensor) -> torch.Tensor:
    """``[nb, 128, Q]`` lane-packed scores -> ``[nb, Q]`` block minima, by
    K1's rule: a NaN wins its block (as with ``jnp.min``), and the winner
    is the packed NaN of the block's lowest NaN row, its row bits intact.
    (Which NaN's bits survive ``jnp.min`` is XLA's choice and no rule of
    the reference: the JAX kernel in interpret mode gives the last row of
    each block for an all-+inf query. Sorting or ``torch.amin`` over NaN
    promises no row either, so neither is used on NaN.)"""
    nan = torch.isnan(packed)
    vmin = torch.amin(torch.where(nan, float("inf"), packed), dim=1)
    first = nan.to(torch.uint8).argmax(dim=1, keepdim=True)  # lowest NaN row
    return torch.where(nan.any(dim=1), torch.gather(packed, 1, first)[:, 0], vmin)


def _block_scan_plain(
    codes_t: torch.Tensor,  # [m, N'] int8 (code - 128) / int16 / int32
    norms_hl: torch.Tensor,  # [2, N'] bf16
    q_op: torch.Tensor,  # [Q, mdp] bf16
    cb: torch.Tensor,  # [m, K, dsub] bf16
    *,
    winners: int,
    nblk: int,
) -> torch.Tensor:
    """Plain PyTorch version of K1 on the same operands: gather-decode,
    bf16 values upcast to f32, one f32 matmul, lane pack, per-block min
    (``_block_min_plain``; repeated with the winner masked for ``winners >
    1``, where a NaN winner, equal to nothing, wins again). Tiled over rows
    so no more than ``_PLAIN_SCORE_BYTES`` of scores exist at once. Returns
    ``[Q, N'/128 * winners]`` f32 packed winners."""
    _check_operands(codes_t, norms_hl, q_op, cb, winners, nblk)
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    depth = m * dsub + 4
    num_q = q_op.shape[0]
    dev = codes_t.device
    q = q_op[:, :depth].to(torch.float32)  # [Q, depth]
    cbf = cb.to(torch.float32)
    out = torch.empty((num_q, n_cols // _LANES * winners), dtype=torch.float32, device=dev)
    step = max(_LANES, _PLAIN_SCORE_BYTES // (4 * num_q) // _LANES * _LANES)
    sub = torch.arange(m, device=dev)[:, None]
    for start in range(0, n_cols, step):
        stop = min(start + step, n_cols)
        rows = stop - start
        c = codes_t[:, start:stop].to(torch.int32)
        if codes_t.dtype == torch.int8:
            c = c + 128
        valid = (c >= 0) & (c < k_codes)
        dec = cbf[sub, torch.where(valid, c, 0).long()]  # [m, T, dsub]
        dec = torch.where(valid[..., None], dec, 0.0)
        dec = torch.cat(
            [
                dec.permute(1, 0, 2).reshape(rows, m * dsub),
                norms_hl[:, start:stop].to(torch.float32).T,
                torch.ones((rows, 2), dtype=torch.float32, device=dev),
            ],
            dim=1,
        )
        scores = matmul(dec, q.T, "highest")  # [T, Q]
        lane = (torch.arange(rows, dtype=torch.int32, device=dev) % _LANES)[:, None]
        packed = ((scores.view(torch.int32) & ~127) | lane).view(torch.float32)
        masked = packed.reshape(rows // _LANES, _LANES, num_q)
        blocks = torch.arange(start // _LANES, stop // _LANES, device=dev)
        for w in range(winners):
            vmin = _block_min_plain(masked)  # [nb, Q]
            out[:, _winner_columns(blocks, w, winners, nblk)] = vmin.T
            if w + 1 < winners:
                masked = torch.where(masked == vmin[:, None, :], _BIG, masked)
    return out


_LIB = None
# the fields of K1's launch plan, in the order gulon_adc_scan_plan writes them
K1_PLAN_FIELDS = ("streamed", "cb_smem", "stages", "lanes", "smem", "width", "qtile")


def _kernel():
    """The built K1 library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from gulon_tpu_torch.ops.cuda import _build

        lib = _build.load("adc_scan")
        fn = lib.gulon_adc_scan
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]  # codes, code bytes
            + [ctypes.c_void_p] * 4  # norms, queries, cb, out
            + [ctypes.c_int] * 9  # n_cols num_q q_stride depth m K dsub winners nblk
            + [ctypes.c_void_p]  # stream
        )
        fn.restype = ctypes.c_int
        fn = lib.gulon_adc_scan_plan
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]  # depth m K dsub, plan
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=64)
def k1_plan(m: int, k_codes: int, dsub: int) -> dict:
    """K1's launch plan at this shape, as the kernel's ``make_plan`` picks
    it (read once per shape): ``streamed`` (1: a row block decoded a chunk
    at a time for each query tile), ``cb_smem`` (1: codebooks in shared
    memory, 0: gathered from global memory), ``stages`` (query-ring
    stages), ``lanes`` (codebook lanes one gather loads; 1 when held
    decoded), ``smem`` (dynamic shared memory, bytes), ``width`` (the
    subspace width an index of this shape lays its codebook and query
    operands out at: ``dsub`` rounded up to 8 lanes where the plan streams
    at fewer lanes a gather and that adds no 64-lane chunk, else
    ``dsub``) and ``qtile`` (queries a query tile: 256 where a streamed
    plan fits it, so a block is decoded 4 times a 1024-query batch, else
    128)."""
    out = (ctypes.c_int * len(K1_PLAN_FIELDS))()
    err = _kernel().gulon_adc_scan_plan(m * dsub + 4, m, k_codes, dsub, out)
    if err != 0:
        raise RuntimeError(f"no K1 plan for m={m} K={k_codes} dsub={dsub}: cudaError_t {err}")
    return dict(zip(K1_PLAN_FIELDS, out))


def count_launch(plan: dict, n_cols: int, num_q: int) -> None:
    """Count one K1 launch over ``n_cols`` rows and ``num_q`` queries under
    ``plan`` (:func:`k1_plan`): ``k1.launches``, ``k1.launches.streamed``,
    ``k1.launches.cb_global``, the 128-row blocks it covers
    (``k1.blocks``), the block decodes it performs (``k1.block_decodes``:
    each block once held decoded, once per query tile of the plan's
    ``qtile`` queries streamed), and ``k1.gather_lanes`` (the plan's lanes
    a gather, summed over launches)."""
    blocks = n_cols // _LANES
    decodes = blocks * (-(-num_q // plan["qtile"]) if plan["streamed"] else 1)
    for name, n in (
        ("k1.launches", 1), ("k1.launches.streamed", plan["streamed"]),
        ("k1.launches.cb_global", 1 - plan["cb_smem"]), ("k1.blocks", blocks),
        ("k1.block_decodes", decodes), ("k1.gather_lanes", plan["lanes"]),
    ):
        tracing.count(name, n)


def fused_block_scan(
    codes_t: torch.Tensor,
    norms_hl: torch.Tensor,
    q_op: torch.Tensor,
    cb: torch.Tensor,
    *,
    winners: int,
    nblk: int,
) -> torch.Tensor:
    """Packed block winners ``[Q, N'/128 * winners]`` of K1.

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors take :func:`_block_scan_plain`. Operands as
    :func:`_block_scan_plain` documents. Each launch is counted by its
    plan (:func:`count_launch`, counters of ``utils/tracing.py``)."""
    tensors = (codes_t, norms_hl, q_op, cb)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {devices}")
    if not codes_t.is_cuda:
        return _block_scan_plain(
            codes_t, norms_hl, q_op, cb, winners=winners, nblk=nblk
        )
    _check_operands(codes_t, norms_hl, q_op, cb, winners, nblk)
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    depth = m * dsub + 4
    num_q = q_op.shape[0]
    if num_q == 0:
        raise ValueError("need at least one query")
    codes_t, norms_hl, q_op, cb = (
        t.contiguous() for t in (codes_t, norms_hl, q_op, cb)
    )
    if q_op.data_ptr() % 16 or cb.data_ptr() % 16 or q_op.shape[1] % 8:
        # TMA reads the queries, 16-byte loads the codebooks
        raise ValueError("queries and codebooks must be 16-byte aligned rows")
    lib = _kernel()
    with torch.cuda.device(codes_t.device):
        out = torch.empty(
            (num_q, n_cols // _LANES * winners), dtype=torch.float32,
            device=codes_t.device,
        )
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gulon_adc_scan(
            codes_t.data_ptr(), codes_t.element_size(), norms_hl.data_ptr(),
            q_op.data_ptr(), cb.data_ptr(), out.data_ptr(), n_cols, num_q,
            q_op.shape[1], depth, m, k_codes, dsub, winners, nblk, stream,
        )
    if err != 0:
        raise RuntimeError(f"adc_scan kernel launch failed: cudaError_t {err}")
    count_launch(k1_plan(m, k_codes, dsub), n_cols, num_q)
    return out


def unpack_block_winners(
    packed: torch.Tensor, base_cols: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-packed block winners -> ``([Q, NW] values, [Q, NW] row ids)``;
    values keep the <=2^-16 packing coarseness."""
    bits = packed.view(torch.int32)
    vals = (bits & ~127).view(torch.float32)
    ids = base_cols[None, :] + (bits & 127)
    return vals, ids


def adc_block_scan_fused(
    queries: torch.Tensor,  # [Q, D] f32
    codebooks: torch.Tensor,  # [m, K, dsub] f32
    codes: torch.Tensor,  # [N, m] codes, or [m, N] when num_rows is given
    recon_norms: torch.Tensor,  # [N] f32
    *,
    bounds,
    tile_rows: int = 0,
    num_rows: int = 0,
    winners: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw block winners ``([Q, NB] values, [Q, NB] row ids)`` for custom
    epilogues (counterpart of ``adc_block_scan_pallas``). Uncentered:
    values are ``recon_norms[row] - 2<q, dec(row)>``."""
    if not 1 <= winners <= 4:
        raise ValueError(f"winners must be in 1..4, got {winners}")
    k1 = K1Operands(codebooks, codes, recon_norms, bounds=bounds, num_rows=num_rows)
    return unpack_block_winners(*k1.scan(queries, winners=winners, tile_rows=tile_rows))


def finish_scan(
    packed: torch.Tensor,  # [Q, NW] lane-packed block winners
    base_cols: torch.Tensor,  # [NW] int32
    qs,  # [m, Q, dsub] split queries, read by the rescore alone (else None)
    codes_t: torch.Tensor,  # the kernel's code operand (K1Operands.codes_t)
    *,
    queries: torch.Tensor,
    codebooks: torch.Tensor,
    k: int,
    kk: int,
    rescore: bool,
    centered: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Epilogue of ``gulon_tpu/ops/pallas/adc.py:569-660`` in plain torch:
    strip the lane bits, exact top-k over the block winners (equal values
    keep the lowest column, i.e. the earliest rows, as the reference heap
    does), decode ids from column + lane bits, optional exact f32 LUT
    rescore."""
    num_q = queries.shape[0]
    m = codebooks.shape[0]
    bits_all = packed.view(torch.int32)
    vals_all = (bits_all & ~127).view(torch.float32)
    best_v, pos = smallest_k_nan_last(vals_all, kk)
    pos = pos.long()
    lanes = torch.gather(bits_all & 127, 1, pos)
    best_ids = base_cols[pos] + lanes
    invalid = best_v >= _INVALID_MIN

    if rescore:
        with tracing.span("gulon.scan.rescore"):
            lut = _lut(qs, codebooks.to(torch.float32))  # [Q, m, K]
            safe = torch.where(invalid, 0, best_ids).long()
            sel = codes_t[:, safe.reshape(-1)].to(torch.int32)
            if codes_t.dtype == torch.int8:  # undo the offset encoding
                sel = sel + 128
            sel = sel.reshape(m, num_q, kk).permute(1, 2, 0)
            dev = lut.device
            exact = lut[
                torch.arange(num_q, device=dev)[:, None, None],
                torch.arange(m, device=dev)[None, None, :],
                sel.long(),
            ].sum(dim=-1)  # [Q, kk]
            exact = torch.where(invalid, float("inf"), exact)
            best_ids = torch.where(invalid, -1, best_ids)
            best_d, pos2 = smallest_k_nan_last(exact, kk)
            best_ids = torch.gather(best_ids, 1, pos2.long())
    else:
        # centered: the contraction already emitted the full distance
        if centered:
            best_d = torch.where(invalid, float("inf"), best_v)
        else:
            qn = sq_norms(queries)
            best_d = torch.where(invalid, float("inf"), best_v + qn[:, None])
        best_ids = torch.where(invalid, -1, best_ids)
    if kk < k:
        best_d = torch.nn.functional.pad(best_d, (0, k - kk), value=float("inf"))
        best_ids = torch.nn.functional.pad(best_ids, (0, k - kk), value=-1)
    return best_d, best_ids


def scan_top_k(
    k1: K1Operands,
    queries: torch.Tensor,  # [Q, D] f32
    *,
    k: int,
    tile_rows: int = 0,  # 0 = the TPU kernel's choice (column order only)
    rescore: bool = False,  # exact f32 LUT rescore of the k winners
    winners: int = 1,  # ranked candidates per 128-row block (1..4)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over ``k1``'s rows, then :func:`finish_scan`: ([Q, k] dists
    ascending, [Q, k] ids)."""
    if not 1 <= winners <= 4:
        raise ValueError(f"winners must be in 1..4, got {winners}")
    if k > _LANES:
        raise ValueError(f"fused ADC kernel supports k <= 128, got {k}")
    kk = min(k, k1.n)
    if k1.n < 256 * kk:
        raise ValueError(
            f"fused ADC kernel needs corpus >= 256*k rows (n={k1.n}, k={kk}); "
            "use the decode scan for small corpora"
        )
    packed, base_cols = k1.scan(queries, winners=winners, tile_rows=tile_rows)
    qs = split_subspaces(queries, k1.bounds, k1.codebooks.shape[2]) if rescore else None
    with tracing.span("gulon.scan.select"):
        return finish_scan(
            packed, base_cols, qs, k1.codes_t, queries=queries, codebooks=k1.codebooks,
            k=k, kk=kk, rescore=rescore, centered=k1.centered,
        )


def adc_scan_fused(
    queries: torch.Tensor,  # [Q, D] f32
    codebooks: torch.Tensor,  # [m, K, dsub] f32 (zero-padded subspaces)
    codes: torch.Tensor,  # [N, m] codes, or pretransposed [m, N] (num_rows)
    recon_norms: torch.Tensor,  # [N] f32
    *,
    bounds,
    k: int,
    tile_rows: int = 0,  # 0 = the TPU kernel's choice (column order only)
    num_rows: int = 0,  # >0: codes is pretransposed [m, num_rows]
    rescore: bool = False,  # exact f32 LUT rescore of the k winners
    winners: int = 1,  # ranked candidates per 128-row block (1..4)
    center_scores: bool = True,  # the kernel emits the true ADC distance
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel ADC scan (counterpart of ``adc_scan_pallas``) over
    operands built for this call. Returns ([Q, k] dists ascending, [Q, k]
    ids)."""
    k1 = K1Operands(
        codebooks, codes, recon_norms, bounds=bounds, num_rows=num_rows,
        center_scores=center_scores,
    )
    return scan_top_k(k1, queries, k=k, tile_rows=tile_rows, rescore=rescore, winners=winners)
