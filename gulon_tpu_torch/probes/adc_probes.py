"""ADC scan probes P1 and P2: the counterpart of ``benchmarks/adc_probes.py``.

Kernels P1 (``adc_scan_probe`` with ``pipe=False``) and P2 (``pipe=True``)
of ``csrc/adc_probes.cu`` replace the TPU probes
``_adc_fused_kernel_probe`` and ``_adc_fused_kernel_pipe``: K1's contract
(``ops/cuda/adc.py``) with the in-kernel formulation selectable, so that a
variant's time against K1's is exactly the cost of that formulation:

- ``decode_mode``: ``"take"`` gathers codewords (K1's own decode, the
  anchor); ``"base"`` contracts a one-hot of the codes against the
  codebook slices on the tensor cores (the TPU's decode), the one-hot
  built straight into the register A operand of ``wgmma``
  (``csrc/onehot_rs.cuh``; :func:`onehot_decode_rows_plain` emulates it
  register by register); ``"bf16cmp"`` builds that one-hot with compares
  on packed bf16 pairs;
- ``natural``: corpus rows on the tensor cores' M side and queries on N,
  the block minimum taken across warps;
- ``pipe``: two decode warpgroups fill a ring of decoded 64-column chunks
  while the consumers contract the chunks already there; pairs of row
  tiles, as the TPU's schedule laid out its output.

The kernels' shared-memory layout (held or streamed, decoded slots,
query-ring stages, the one-hot's lanes and where its slices live) is
:func:`probe_plan`'s, computed here and checked again by the kernel's C
entry; ``resolved`` reports it beside the modes.

The modes resolve as the TPU's do (``adc_probes.py:302-309`` and
``:446-449``), and the caller learns what ran: ``bf16cmp`` becomes
``base`` above K = 256, ``take`` becomes ``base`` above K = 256 or on a
row tile that K's 128-lane chunks do not divide, ``natural`` is dropped
at a depth of 128 or less (glove100's 112 runs the base orientation), and
``natural`` wins over ``pipe``.

Operand prep and the epilogue are K1's (``K1Operands``,
``finish_scan``); the outputs ``(dists, ids)`` follow that contract. The
kernels run for CUDA tensors and raise if they cannot; CPU tensors take
K1's plain version (``_block_scan_plain``), whose contract the probes
share. Parameters come as arrays, as ``adc_scan_fused`` takes them: a PQ
carried across from a JAX ``ProductQuantizer`` by ``interop.py`` serves
as it is, so no new carrier is needed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from gulon_tpu_torch.ops.cuda import adc
from gulon_tpu_torch.ops.cuda.adc import _LANES, _round_up
from gulon_tpu_torch.ops.pq import split_subspaces
from gulon_tpu_torch.utils import tracing
from gulon_tpu_torch.utils.device import DEFAULT_DEVICE

DECODE_MODES = ("base", "bf16cmp", "take")
_DECODE_IDS = {"take": 0, "base": 1, "bf16cmp": 2}


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


_CHUNK = 64  # bf16 lanes of a 128-byte row: one decoded chunk
_CHUNK_BYTES = 128 * 128  # one [128 rows][64] bf16 chunk
_SMEM_LIMIT = 232_448  # dynamic shared memory of a block (227 KB)
_MAX_STAGES = 6
_DECODE_WGS = 2  # P2's decode warpgroups
PLAN_FIELDS = (
    "streamed", "stages", "slots", "lanes", "pieces", "kc", "resident", "chunk_subs", "bufs",
    "decode_wgs", "cb_smem",
)


def onehot_lanes(dsub: int) -> Tuple[int, int]:
    """``(N, pieces)`` of the one-hot decode: a subspace's lanes in
    ``pieces`` of at most 32, each rounded up to a multiple of 8 (the
    wgmma N): n8 at dsub 8, n16 at dsub 13, two n24 at dsub 33."""
    pieces = -(-dsub // 32)
    return _round_up(-(-dsub // pieces), 8), pieces


def chunk_subspaces(c: int, m: int, dsub: int) -> int:
    """Subspaces whose codeword lanes fall in decoded chunk ``c``."""
    md = m * dsub
    c0, c1 = _CHUNK * c, min(_CHUNK * (c + 1), md)
    return 0 if c0 >= c1 else (c1 - 1) // dsub - c0 // dsub + 1


def _r16(x: int) -> int:
    return _round_up(x, 16)


def plan_bytes(plan: dict, *, m: int, k_codes: int, dsub: int, code_bytes: int,
               decode_mode: str, natural: bool = False, pipe: bool = False,
               decode_only: bool = False) -> int:
    """Dynamic shared memory of a plan, as ``adc_probes.cu`` lays it out
    (``layout`` and ``read_plan``, with the 1024 bytes of base alignment)."""
    onehot = decode_mode != "take"
    nch = -(-(m * dsub + 4) // _CHUNK)
    slice_bytes = plan["pieces"] * plan["kc"] * plan["lanes"] * 128
    bufs = plan["bufs"]
    slices = (m if plan["resident"] else bufs * plan["chunk_subs"]) * slice_bytes if onehot else 0
    codes = bufs * _r16(plan["chunk_subs"] * 128 * code_bytes) if onehot else 0
    if decode_only:
        return 1024 + _CHUNK_BYTES + slices + codes
    take_held = not onehot and not plan["streamed"] and not pipe
    total = (plan["slots"] + plan["stages"]) * _CHUNK_BYTES + slices + codes
    total += _r16(m * k_codes * dsub * 2) if (not onehot and plan["cb_smem"]) else 0
    if take_held:
        total += _r16(m * 128 * 2) + 2 * 128 * 2 + nch * _CHUNK * 8
    total = _r16(_r16(total) + (2 * plan["stages"] + 2 * plan["slots"]) * 8)
    return 1024 + total + (9 * 128 * 4 if natural else 0)


def probe_plan(*, m: int, k_codes: int, dsub: int, code_bytes: int, decode_mode: str,
               natural: bool = False, pipe: bool = False, decode_only: bool = False) -> dict:
    """The first layout that fits a block's 227 KB, in order: the row block
    held decoded before streamed (a chunk decoded per query tile); the
    one-hot's codebook slices resident for the whole kernel before staged
    per chunk (the gather's codebooks in shared memory before global); the
    one-hot's copies (a chunk's codes, and its slices unless resident)
    double-buffered, one item ahead, before single; for P2, the most
    decoded slots (a held block's chunks twice over, to
    decode one block ahead); then the most query-ring stages. P1 holds one
    block (``nch`` slots) or, streamed, 2 slots (3 for the gather, which
    has no barrier before its decode). ``decode_only``: the decoded-rows
    kernel (one chunk tile, slices as the scan). Returns the fields of
    ``PLAN_FIELDS`` and ``bytes``."""
    onehot = decode_mode != "take"
    lanes, pieces = onehot_lanes(dsub)
    nch = -(-(m * dsub + 4) // _CHUNK)
    base = dict(
        streamed=0, stages=0, slots=0, lanes=lanes, pieces=pieces,
        kc=-(-k_codes // _CHUNK), resident=1,
        chunk_subs=max(chunk_subspaces(c, m, dsub) for c in range(nch)), bufs=2,
        decode_wgs=_DECODE_WGS if pipe else 0, cb_smem=0,
    )
    size = functools.partial(
        plan_bytes, m=m, k_codes=k_codes, dsub=dsub, code_bytes=code_bytes,
        decode_mode=decode_mode, natural=natural, pipe=pipe, decode_only=decode_only,
    )
    if decode_only:
        for resident in ((1, 0) if onehot else (0,)):
            for bufs in (2, 1):
                plan = dict(base, resident=resident, bufs=bufs)
                if size(plan) <= _SMEM_LIMIT:
                    return dict(plan, bytes=size(plan))
        raise ValueError("no decode plan fits 227 KB of shared memory")
    for streamed in (0, 1):
        if pipe:
            slot_options = range(2 * nch, nch - 1, -1) if not streamed else range(6, 1, -1)
        else:
            slot_options = (nch,) if not streamed else ((2,) if onehot else (3,))
        for held_operand in (1, 0):
            for bufs in (2, 1):
                for slots in slot_options:
                    for stages in range(_MAX_STAGES, 1, -1):
                        plan = dict(base, streamed=streamed, stages=stages, slots=slots,
                                    bufs=bufs)
                        if onehot:
                            plan["resident"] = held_operand
                        else:
                            plan["resident"] = 0
                            plan["cb_smem"] = held_operand
                        if size(plan) <= _SMEM_LIMIT:
                            return dict(plan, bytes=size(plan))
    raise ValueError("no probe plan fits 227 KB of shared memory")


def cb_slices(cb: torch.Tensor, lanes: int, pieces: int, chunk: int = _CHUNK) -> torch.Tensor:
    """``[m, K, dsub] -> [m, pieces, K/chunk, lanes, chunk]`` (K to
    ``chunk``, lanes past dsub zero): the codebook slices of the one-hot
    decodes (P1-P3), each ``[lanes][chunk codes]`` the K-major B tile of one
    chunk of codes of one piece (128 bytes a row: 64 bf16 codes, or 128 for
    P3's s8 codewords), so that a subspace's slices are one contiguous
    copy."""
    m, k_codes, dsub = cb.shape
    kc = -(-k_codes // chunk)
    t = torch.zeros((m, kc * chunk, pieces * lanes), dtype=cb.dtype, device=cb.device)
    t[:, :k_codes, :dsub] = cb
    return t.reshape(m, kc, chunk, pieces, lanes).permute(0, 3, 1, 4, 2).contiguous()


def _plan_array(plan: dict):
    return (ctypes.c_int * len(PLAN_FIELDS))(*(int(plan[f]) for f in PLAN_FIELDS))


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
            + [ctypes.c_void_p] * 5  # norms, queries, cb, slices, out
            + [ctypes.c_int] * 12  # n_cols num_q q_stride depth m K dsub W nblk decode natural pipe
            + [ctypes.c_void_p] * 2  # plan, stream
        )
        fn.restype = ctypes.c_int
        fn = lib.gulon_adc_probe_decode
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]  # codes, code bytes
            + [ctypes.c_void_p] * 4  # norms, cb, slices, rows
            + [ctypes.c_int] * 7  # n_cols width depth m K dsub decode
            + [ctypes.c_void_p] * 2  # plan, stream
        )
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _cuda_operands(codes_t, norms_hl, cb, plan, decode_mode):
    codes_t, norms_hl, cb = (t.contiguous() for t in (codes_t, norms_hl, cb))
    slices = None if decode_mode == "take" else cb_slices(cb, plan["lanes"], plan["pieces"])
    if cb.data_ptr() % 16 or codes_t.data_ptr() % 16:
        raise ValueError("codes and codebooks must be 16-byte aligned")
    return codes_t, norms_hl, cb, slices


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
    The kernel's layout is :func:`probe_plan`'s.

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors take K1's plain version, the probes' shared contract."""
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
    plan = probe_plan(m=m, k_codes=k_codes, dsub=dsub, code_bytes=codes_t.element_size(),
                      decode_mode=decode_mode, natural=natural, pipe=pipe)
    codes_t, norms_hl, cb, slices = _cuda_operands(codes_t, norms_hl, cb, plan, decode_mode)
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
            q_op.data_ptr(), cb.data_ptr(), 0 if slices is None else slices.data_ptr(),
            out.data_ptr(), n_cols, num_q, q_op.shape[1], m * dsub + 4, m, k_codes, dsub,
            winners, nblk, _DECODE_IDS[decode_mode], int(natural), int(pipe),
            _plan_array(plan), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"adc_probes kernel launch failed: cudaError_t {err}")
    if pipe:
        tracing.count("probe.p2.launches")
    else:
        tracing.count("probe.p1.launches")
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


def _register_bits(code: torch.Tensor, k: torch.Tensor, recipe: str) -> torch.Tensor:
    """The one-hot bits of one A register, ``[..., per]`` (0 / 1): whether
    the code matches each of the register's columns ``k + e``, computed as
    ``onehot_rs.cuh`` builds them: an int compare (``base``; ``pair_int``),
    bf16 pair compares (``bf16cmp``), the hi-nibble match of the pair
    ANDed with the lo-nibble one (``nib``; k even), offset int8 bytes
    compared (``cmp8``), and four s8 columns a register (``i8``)."""
    per = 4 if recipe == "i8" else 2
    cols = k[..., None] + torch.arange(per)
    code = code[..., None]
    if recipe == "bf16cmp":
        return code.to(torch.bfloat16) == cols.to(torch.bfloat16)
    if recipe == "nib":
        return ((code >> 4) == (k[..., None] >> 4)) & ((code & 15) == (k[..., None] & 15) + (
            cols - k[..., None]))
    if recipe == "cmp8":
        return ((code - 128) & 0xFF) == ((cols - 128) & 0xFF)
    return code == cols


def onehot_decode_rows_plain(
    codes_t: torch.Tensor, norms_hl: torch.Tensor, cb: torch.Tensor, *, width: int,
    decode_mode: str = "base", lanes: Optional[int] = None, i8=None,
) -> torch.Tensor:
    """A plain emulation of the one-hot decode of P1 - P3
    (``onehot_rs.cuh``), register by register: for each 64-row group, warp
    w, lane and k-step, the four A registers of wgmma m64nNk16 (rows 16 w
    + lane / 4 and + 8, k columns 2 (lane % 4) + {0, 1} and + 8) from the
    rows' codes, placed by that map into the one-hot, multiplied in f32 by
    the ``cb_slices`` tiles group by group, and stored through the
    accumulator map (row 16 w + lane / 4 + 8 i, lane 8 j + 2 (lane % 4) +
    h) under the kernel's chunk, subspace and piece loop. ``[N', width]``
    bf16, as :func:`_decode_rows_plain`: equal to it bit for bit but for
    the sign of a zero (a -0.0 codeword may decode to +0.0: the f32 sum of
    its one product and the zero products is +0.0 once any term is).

    ``decode_mode`` is the recipe: P1 / P2's
    ``base`` and ``bf16cmp``, P3's ``nib`` and ``cmp8`` (bf16 one-hots),
    and ``i8``: the A fragment of m64nNk32 (k columns 4 (lane % 4) + {0 ..
    3} and + 16, 128 codes a group) against the s8 codewords of ``i8 =
    (cb_i8 [m, K, dsub], scale [m])``, the exact sum times its subspace's
    scale rounded to bf16. ``lanes``: the piece width (P1 / P2's
    :func:`onehot_lanes` by default; P3 takes 16)."""
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    s8 = decode_mode == "i8"
    if lanes is None:
        lanes, pieces = onehot_lanes(dsub)
    else:
        pieces = -(-dsub // lanes)
    group = 2 * _CHUNK if s8 else _CHUNK  # codes a commit group covers
    per, step = (4, 32) if s8 else (2, 16)  # columns a register, codes a k-step
    slices = cb_slices(i8[0] if s8 else cb, lanes, pieces, group).to(torch.float32)
    kc = slices.shape[2]
    md = m * dsub
    c = codes_t.to(torch.int64) + (128 if codes_t.dtype == torch.int8 else 0)
    c = torch.where((c >= 0) & (c < k_codes), c, -1).reshape(m, n_cols // 64, 64)
    lane = torch.arange(32)
    g, tq = lane // 4, lane % 4
    warp = torch.arange(4)[:, None]
    reg = torch.arange(4)
    # [warp, lane, reg]: the row (of 64) and the first k column (of a
    # k-step) of register reg
    row_of = (16 * warp + g)[..., None] + 8 * (reg % 2)
    col_of = (per * tq)[None, :, None] + (step // 2) * (reg // 2) + 0 * warp[..., None]
    out = _decode_rows_plain(codes_t, norms_hl, cb, width).clone()
    out[:, :md] = 0
    dec = out.view(n_cols // 64, 64, width)
    groups = torch.arange(n_cols // 64)[:, None, None, None]
    done = torch.zeros(md, dtype=torch.int64)
    for ch in range(-(-md // _CHUNK)):
        c0, c1 = _CHUNK * ch, min(_CHUNK * (ch + 1), md)
        for s_ in range(c0 // dsub, (c1 - 1) // dsub + 1):
            code = c[s_][groups, row_of]  # [G, warp, lane, reg]
            for p in range(pieces):
                lo, hi = s_ * dsub + p * lanes, min(s_ * dsub + (p + 1) * lanes, (s_ + 1) * dsub)
                if lo >= hi or hi <= c0 or lo >= c1:
                    continue
                acc = None
                for kch in range(kc):
                    a = torch.zeros((n_cols // 64, 64, group), dtype=torch.float32)
                    for ks in range(4):
                        k = group * kch + step * ks + col_of
                        bits = _register_bits(code, k, decode_mode)
                        for e in range(per):
                            a[groups, row_of, (k - group * kch + e).expand_as(row_of)] = (
                                bits[..., e].to(torch.float32))
                    prod = a @ slices[s_, p, kch].T
                    acc = prod if acc is None else acc + prod
                n = torch.arange(lanes)
                col = s_ * dsub + p * lanes + n
                ok = (p * lanes + n < dsub) & (col >= c0) & (col < c1)
                vals = acc[:, :, ok]
                if s8:
                    vals = vals * i8[1][s_].to(torch.float32)
                dec[:, :, col[ok]] = vals.to(torch.bfloat16)
                done[col[ok]] += 1
    if not bool((done == 1).all()):
        raise AssertionError("every codeword column is written exactly once")
    return out


def probe_decode_rows(
    codes_t: torch.Tensor, norms_hl: torch.Tensor, cb: torch.Tensor, *, width: int,
    decode_mode: str = "base",
) -> torch.Tensor:
    """The rows P1 and P2 decode, ``[N', width]`` bf16, through the decode
    of ``decode_mode``: on the card for holding a formulation against the
    gather bit for bit but for the sign of a zero (a -0.0 codeword may come
    out of the one-hot as +0.0, ``onehot_rs.cuh``), the plain gather on
    the CPU."""
    if not codes_t.is_cuda:
        return _decode_rows_plain(codes_t, norms_hl, cb, width)
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    if width % 8 or width < m * dsub + 4 or n_cols % _LANES:
        raise ValueError(f"width {width} must be a multiple of 8 >= depth {m * dsub + 4}")
    if decode_mode == "bf16cmp" and k_codes > 256:
        raise ValueError("bf16cmp needs K <= 256")
    plan = probe_plan(m=m, k_codes=k_codes, dsub=dsub, code_bytes=codes_t.element_size(),
                      decode_mode=decode_mode, decode_only=True)
    codes_t, norms_hl, cb, slices = _cuda_operands(codes_t, norms_hl, cb, plan, decode_mode)
    lib = _kernel()
    with torch.cuda.device(codes_t.device):
        rows = torch.empty((n_cols, width), dtype=torch.bfloat16, device=codes_t.device)
        err = lib.gulon_adc_probe_decode(
            codes_t.data_ptr(), codes_t.element_size(), norms_hl.data_ptr(), cb.data_ptr(),
            0 if slices is None else slices.data_ptr(), rows.data_ptr(), n_cols, width,
            m * dsub + 4, m, k_codes, dsub, _DECODE_IDS[decode_mode], _plan_array(plan),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"adc_probes decode launch failed: cudaError_t {err}")
    tracing.count("probe.decode.launches")
    return rows


def probe_scan_operands(
    queries, codebooks, codes, recon_norms, *, bounds, tile_rows: int = 0,
    num_rows: int = 0, winners: int = 1, center_scores: bool = False,
    decode_mode: str = "base", natural: bool = False, pipe: bool = False,
) -> dict:
    """K1's operands for a probe call (:class:`~gulon_tpu_torch.ops.cuda.adc.
    K1Operands`, at the subspaces' own width) with the modes resolved: the
    pair padding of the piped schedule applied (codes with zeros, norms with
    ``_BIG``, as ``adc_probes.py:448-451``), the winner geometry, and the
    kernel's layout (``modes["plan"]``, :func:`probe_plan`)."""
    k1 = adc.K1Operands(
        codebooks, codes, recon_norms, bounds=bounds, num_rows=num_rows,
        center_scores=center_scores, _own_width=True,
    )
    m, k_codes, dsub = codebooks.shape
    qt, t, _, _ = adc.block_layout(queries.shape[0], k_codes, k1.mdp, k1.n, tile_rows, winners)
    modes = resolve_modes(
        decode_mode, natural, pipe, k_codes=k_codes, tile_rows=t, mdp=k1.mdp, qt=qt, m=m,
    )
    n_cols = _round_up(k1.n, t)
    if modes["pipe"]:
        n_cols = _round_up(n_cols, 2 * modes["tile_rows"])
    k1._pad_columns(n_cols)
    modes["plan"] = probe_plan(
        m=m, k_codes=k_codes, dsub=dsub, code_bytes=k1.codes_t.element_size(),
        decode_mode=modes["decode_mode"], natural=modes["natural"], pipe=modes["pipe"],
    )
    return dict(
        codes_t=k1.codes_t, norms_hl=k1.norms_hl, q_op=k1.query_operand(queries), cb=k1.cb,
        base_cols=adc._base_cols(n_cols, modes["tile_rows"], winners, k1.device),
        nblk=modes["tile_rows"] // _LANES,
        qs=split_subspaces(queries, bounds, dsub), modes=modes,
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
    (``decode_mode``, ``natural``, ``pipe``, ``tile_rows``) and the
    kernel's layout (``plan``: :func:`probe_plan`). Inputs go to
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
        packed, ops["base_cols"], ops["qs"], ops["codes_t"], queries=queries,
        codebooks=codebooks, k=k, kk=kk, rescore=rescore, centered=center_scores,
    )
