"""Port parity: the probe kernels P1-P4 (``gulon_tpu_torch/probes``).

P1 and P2 (``adc_probes.adc_scan_probe``): on the CPU the port runs K1's
plain version, whose contract the probes share, and the JAX package runs
``benchmarks.adc_probes.adc_scan_probe`` in interpret mode, on the same
seeded numpy inputs. Tolerance, K1's (``tests/test_torch_adc.py``): >= 99 %
equal ids, distances within rtol 1e-4 (both sum exact bf16 x bf16 products
in f32 and differ in summation order), and P2's ids equal. The modes each
side resolves (``adc_probes.py:302-309``) must agree: the JAX side's are
read off a trace, by wrapping the functions that make the probe's kernels.

K1 cut by stage (``k1_stages``): no JAX counterpart (the TPU cut its
probe's formulation, not K1's); the plain version is held to a numpy
statement of each stage, and its last cut, packed, to K1's plain version.

P3 and P4: the JAX versions are closures inside ``main()`` that run only on
a TPU, so each plain version is held to a numpy statement of what that
variant's body writes, each naming the line of ``benchmarks/
kernel_probe.py`` / ``floor_probe.py`` it restates. Values within
``2^-14 * max(|v|, 1)`` (numpy sums in f64, torch in f32), ids >= 99.5 %
equal and every mismatch a near-tie; zeros exactly. The kernels run only
on a card (``tests/test_torch_probes_cuda.py``).
"""

import ast
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import benchmarks.adc_probes as jprobe
from gulon_tpu.ops.pq import subspace_bounds
from gulon_tpu_torch.ops.cuda import adc as tadc
from gulon_tpu_torch.probes import adc_probes as tp
from gulon_tpu_torch.probes import floor_probe as fp
from gulon_tpu_torch.probes import k1_stages as ks
from gulon_tpu_torch.probes import kernel_probe as kp
from gulon_tpu_torch.utils import tracing

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]

# D 132 over m 4 (dsub 33): depth 136 > 128, so natural really runs; few
# subspaces keep the TPU gather walk's interpret-mode trace short
N, D, M, Q, K = 3000, 132, 4, 6, 5


def _problem(k_codes, seed, n=N, d=D, m=M):
    rng = np.random.default_rng(seed)
    bounds = subspace_bounds(d, m)
    dsub = max(w for _, w in bounds)
    cb = rng.normal(size=(m, k_codes, dsub)).astype(np.float32)
    for s, (_, w) in enumerate(bounds):
        cb[s, :, w:] = 0.0
    cb = cb.astype(jnp.bfloat16).astype(np.float32)  # snapped, as trained
    codes = rng.integers(0, k_codes, size=(n, m)).astype(
        np.uint8 if k_codes <= 256 else np.uint16
    )
    norms = (cb[np.arange(m)[None], codes] ** 2).sum((1, 2)).astype(np.float32)
    q = rng.normal(size=(Q, d)).astype(np.float32)
    return bounds, cb, codes, norms, q


def _jax_modes(monkeypatch, inputs, **kw):
    """The modes the JAX probe runs for a request, read off a trace: the
    decode mode its decode is built with, whether its kernel is built
    natural, and whether the piped launch runs."""
    seen = {"decode_mode": None, "natural": False, "pipe": False}
    decode, kernel, pipe = (
        jprobe._decode_columns_probe, jprobe._adc_fused_kernel_probe, jprobe._block_scan_pipe
    )

    def decode_seen(*a, decode_mode, **k):
        seen["decode_mode"] = decode_mode
        return decode(*a, decode_mode=decode_mode, **k)

    def kernel_seen(*a, natural=False, **k):
        seen["natural"] = natural
        return kernel(*a, natural=natural, **k)

    def pipe_seen(*a, **k):
        seen["pipe"] = True
        return pipe(*a, **k)

    monkeypatch.setattr(jprobe, "_decode_columns_probe", decode_seen)
    monkeypatch.setattr(jprobe, "_adc_fused_kernel_probe", kernel_seen)
    monkeypatch.setattr(jprobe, "_block_scan_pipe", pipe_seen)
    # a fresh trace of the unjitted function: no cached trace hides the calls
    jax.eval_shape(functools.partial(jprobe.adc_scan_probe.__wrapped__, **kw), *inputs)
    return seen


P1_CASES = [
    (mode, natural, winners, centered)
    for mode in tp.DECODE_MODES
    for natural in (False, True)
    for winners in (1, 2, 4)
    for centered in (False, True)
]


@pytest.mark.parametrize("mode,natural,winners,centered", P1_CASES)
def test_p1_plain_matches_jax_probe(monkeypatch, mode, natural, winners, centered):
    """Every decode mode, both orientations at depth 136, 1/2/4 winners,
    centered and uncentered, at 1024-row tiles (three of them)."""
    bounds, cb, codes, norms, q = _problem(256, seed=winners + 3 * centered)
    kw = dict(bounds=bounds, k=K, tile_rows=1024, winners=winners, center_scores=centered,
              decode_mode=mode, natural=natural)
    inputs = tuple(jnp.asarray(a) for a in (q, cb, codes, norms))
    d_j, i_j = map(np.asarray, jprobe.adc_scan_probe(*inputs, interpret=True, **kw))
    resolved = {}
    d_t, i_t = tp.adc_scan_probe(q, cb, codes.astype(np.int32), norms, device="cpu",
                                 resolved=resolved, **kw)
    assert np.mean(i_j == i_t.numpy()) >= 0.99
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-4, atol=1e-4)
    jax_modes = _jax_modes(monkeypatch, inputs, interpret=True, **kw)
    assert resolved["decode_mode"] == jax_modes["decode_mode"] == mode
    assert resolved["natural"] == bool(jax_modes["natural"]) == natural
    assert resolved["pipe"] is False and jax_modes["pipe"] is False


@pytest.mark.parametrize("winners", [1, 2])
def test_p2_pipe_plain_matches_jax_probe(winners):
    """The piped schedule at an odd tile count (n = 5000, 1024-row tiles:
    five tiles, paired into three with one padding tile), as
    ``tests/test_pallas.py::test_probe_pipe_schedule_matches_base``:
    ids equal, the pair padding's geometry equal."""
    bounds, cb, codes, norms, q = _problem(256, seed=11 + winners, n=5000, d=24, m=6)
    kw = dict(bounds=bounds, k=10, tile_rows=1024, winners=winners, pipe=True)
    d_j, i_j = map(np.asarray, jprobe.adc_scan_probe(
        *(jnp.asarray(a) for a in (q, cb, codes, norms)), interpret=True, **kw))
    resolved = {}
    d_t, i_t = tp.adc_scan_probe(q, cb, codes.astype(np.int32), norms, device="cpu",
                                 resolved=resolved, **kw)
    plan = tp.probe_plan(m=6, k_codes=256, dsub=4, code_bytes=4, decode_mode="base",
                         pipe=True)  # [N, m] codes: the int32 operand
    assert resolved == dict(decode_mode="base", natural=False, pipe=True, tile_rows=1024,
                            plan=plan)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-4, atol=1e-4)
    ops = tp.probe_scan_operands(
        *(torch.from_numpy(np.asarray(a)) for a in (q, cb, codes.astype(np.int32), norms)),
        bounds=bounds, tile_rows=1024, winners=winners, pipe=True,
    )
    assert ops["codes_t"].shape[1] == 6 * 1024  # three pairs
    assert bool((ops["norms_hl"][0, 5000:].float() > 1e38).all())
    assert ops["base_cols"].shape[0] == 6 * 8 * winners


# (K, decode mode, natural, pipe, D, m): the resolution rules at their edges
RESOLVE_CASES = [
    (512, "bf16cmp", False, False, 24, 6),  # bf16 holds integers only to 256
    (512, "take", False, False, 24, 6),  # K > 256: base
    (100, "take", False, False, 24, 6),  # 1024 % 100: base
    (128, "take", True, False, 132, 4),  # natural at depth 136
    (256, "base", True, False, 24, 6),  # depth 32: natural dropped
    (256, "take", True, True, 132, 4),  # natural wins over pipe
    (256, "take", False, True, 132, 4),  # piped, take kept
    (100, "take", False, True, 24, 6),  # piped, take dropped
]


@pytest.mark.parametrize("k_codes,mode,natural,pipe,d,m", RESOLVE_CASES)
def test_resolved_modes_equal_the_jax_probes(monkeypatch, k_codes, mode, natural, pipe, d, m):
    bounds, cb, codes, norms, q = _problem(k_codes, seed=5, d=d, m=m)
    kw = dict(bounds=bounds, k=K, tile_rows=1024, decode_mode=mode, natural=natural,
              pipe=pipe)
    inputs = tuple(jnp.asarray(a) for a in (q, cb, codes, norms))
    jax_modes = _jax_modes(monkeypatch, inputs, interpret=True, **kw)
    mdp = -(-(m * cb.shape[2] + 4) // 8) * 8
    port = tp.resolve_modes(mode, natural, pipe, k_codes=k_codes, tile_rows=1024, mdp=mdp,
                            qt=16, m=m)
    assert port["decode_mode"] == jax_modes["decode_mode"]
    assert port["natural"] == bool(jax_modes["natural"])
    assert port["pipe"] == jax_modes["pipe"]
    resolved = {}
    tp.adc_scan_probe(q, cb, codes.astype(np.int32), norms, device="cpu", resolved=resolved,
                      **kw)
    plan = tp.probe_plan(m=m, k_codes=k_codes, dsub=cb.shape[2],
                         code_bytes=4,  # [N, m] codes: the int32 operand
                         decode_mode=port["decode_mode"], natural=port["natural"],
                         pipe=port["pipe"])
    assert resolved == dict(port, plan=plan)


def test_probe_decode_rows_plain_is_the_gather():
    """The decoded rows on the CPU: codewords side by side, the hi/lo norm
    lanes, two ones, zeros (the check the card holds each decode to); rows
    past n, whose padding code 128 is no code at K = 16, decode to +0 bits,
    as the kernels write them."""
    bounds, cb, codes, norms, q = _problem(16, seed=2, n=1000, d=24, m=6)
    packed = tadc.pack_codes_t(torch.from_numpy(codes.astype(np.int32)), 16)
    ops = tp.probe_scan_operands(
        *(torch.from_numpy(a) for a in (q, cb)), packed, torch.from_numpy(norms),
        bounds=bounds, num_rows=1000,
    )
    rows = tp.probe_decode_rows(ops["codes_t"], ops["norms_hl"], ops["cb"], width=32)
    assert rows.shape == (1024, 32) and rows.dtype == torch.bfloat16
    np.testing.assert_array_equal(rows[:1000, :24].float().numpy(),
                                  cb[np.arange(6)[None], codes].reshape(1000, 24))
    assert bool((rows[1000:, :24].view(torch.int16) == 0).all())
    assert bool((rows[:, 26:28] == 1).all()) and bool((rows[:, 28:] == 0).all())


# (D, m, K, code bytes): chip_smoke.PROBE_SHAPES (glove100, deep768), the
# card tests' shapes, dsub 33 (two pieces) and 86 (three), K = 1024
PLAN_SHAPES = [
    (100, 8, 256, 1), (768, 96, 256, 1), (24, 4, 16, 1), (60, 6, 256, 1), (300, 19, 256, 1),
    (96, 12, 1024, 2), (132, 4, 256, 1), (688, 8, 256, 1), (720, 720, 16, 1),
    (800, 100, 1024, 4),
]


@pytest.mark.parametrize(
    "d,m,k_codes,code_bytes,mode",
    [(*shape, mode) for shape in PLAN_SHAPES for mode in tp.DECODE_MODES
     if mode != "bf16cmp" or shape[2] <= 256],  # bf16cmp resolves to base above 256
)
def test_every_probe_plan_fits(d, m, k_codes, code_bytes, mode):
    """P1 (both orientations), P2 and the decoded-rows kernel: each plan
    fits 227 KB as the kernel lays it out; P1 holds a block in nch slots
    (or streams through 2, 3 for the gather), P2 keeps at least one held
    block's chunks (or 2) in its ring and decodes with two warpgroups; the
    one-hot's pieces cover dsub in widths of 8 to 32; staged slices cover
    every chunk's subspaces; glove100 holds its block and every slice
    resident, deep768 streams."""
    dsub = -(-d // m)
    nch = -(-(m * dsub + 4) // 64)
    for natural, pipe in ((False, False), (True, False), (False, True)):
        plan = tp.probe_plan(m=m, k_codes=k_codes, dsub=dsub, code_bytes=code_bytes,
                             decode_mode=mode, natural=natural, pipe=pipe)
        assert set(plan) == set(tp.PLAN_FIELDS) | {"bytes"}
        size = tp.plan_bytes(plan, m=m, k_codes=k_codes, dsub=dsub, code_bytes=code_bytes,
                             decode_mode=mode, natural=natural, pipe=pipe)
        assert plan["bytes"] == size <= tp._SMEM_LIMIT
        assert 2 <= plan["stages"] <= 6
        if pipe:
            assert plan["decode_wgs"] == 2
            assert plan["slots"] >= (2 if plan["streamed"] else nch)
        else:
            assert plan["slots"] == (nch if not plan["streamed"] else 3 if mode == "take" else 2)
        if mode != "take":
            assert plan["lanes"] in (8, 16, 24, 32) and plan["lanes"] % 8 == 0
            assert plan["pieces"] * plan["lanes"] >= dsub > (plan["pieces"] - 1) * plan["lanes"]
            assert 64 * plan["kc"] >= k_codes
            assert plan["chunk_subs"] == max(tp.chunk_subspaces(c, m, dsub) for c in range(nch))
    plan = tp.probe_plan(m=m, k_codes=k_codes, dsub=dsub, code_bytes=code_bytes,
                         decode_mode=mode, decode_only=True)
    assert plan["bytes"] <= tp._SMEM_LIMIT
    if (d, m, k_codes) == (100, 8, 256):  # glove100
        for pipe in (False, True):
            plan = tp.probe_plan(m=m, k_codes=k_codes, dsub=dsub, code_bytes=1,
                                 decode_mode=mode, pipe=pipe)
            assert plan["streamed"] == 0 and (mode == "take" or plan["resident"] == 1)
            assert (plan["lanes"], plan["pieces"]) == (16, 1)
    if (d, m) == (768, 96):  # deep768
        plan = tp.probe_plan(m=m, k_codes=k_codes, dsub=dsub, code_bytes=1, decode_mode=mode,
                             pipe=True)
        assert plan["streamed"] == 1 and (mode == "take" or plan["resident"] == 0)
        assert (plan["lanes"], plan["pieces"]) == (8, 1)


# (D, m, K, code bytes): dsub 13 and 8 (glove100's and deep768's one-hot
# widths), odd dsub 33 in two pieces, dsub 86 in three, K 16 to 1024
EMULATION_CASES = [
    (52, 4, 16, 1), (64, 8, 64, 1), (104, 8, 256, 1), (96, 12, 256, 2), (66, 2, 1024, 2),
    (172, 2, 64, 4),
]


@pytest.mark.parametrize("d,m,k_codes,code_bytes", EMULATION_CASES)
def test_onehot_register_map_decodes_the_gather(d, m, k_codes, code_bytes):
    """The one-hot decode emulated register by register (the RS A fragment
    and the accumulator map of ``onehot_rs.cuh``) equals the plain gather
    bit for bit, but for the sign of a zero: codes outside [0, K) and
    padding rows decode to +0, a -0.0 codeword to +0.0 (its lane's other
    codewords are not all negative). A wrong register map would put the
    ones in the wrong k columns or rows and miss here."""
    rng = np.random.default_rng(d + k_codes)
    dsub = d // m
    cb = torch.from_numpy(rng.normal(size=(m, k_codes, dsub)).astype(np.float32))
    cb = cb.to(torch.bfloat16)
    cb[0, 5, 2] = -0.0
    n = 384
    codes = torch.from_numpy(rng.integers(0, k_codes, size=(m, n)))
    codes[0, :7] = 5  # the -0.0 codeword
    if code_bytes == 1:
        codes_t = (codes - 128).to(torch.int8)
        if k_codes < 256:
            codes_t[1, 7:11] = 127  # code 255: no code at this K
    else:
        codes_t = codes.to(torch.int16 if code_bytes == 2 else torch.int32)
        codes_t[1, 7:11] = -1
        codes_t[0, 11] = k_codes  # past K
    norms = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32)).to(torch.bfloat16)
    width = -(-(m * dsub + 4) // 8) * 8 + 8
    plain = tp._decode_rows_plain(codes_t, norms, cb, width)
    canon = lambda x: (x.float() + 0.0).to(torch.bfloat16).view(torch.int16)  # noqa: E731
    for mode in ("base", "bf16cmp") if k_codes <= 256 else ("base",):
        emu = tp.onehot_decode_rows_plain(codes_t, norms, cb, width=width, decode_mode=mode)
        assert torch.equal(canon(emu), canon(plain)), mode
        differ = emu.view(torch.int16) != plain.view(torch.int16)
        assert bool((plain[differ] == 0).all()) and bool((emu[differ].view(torch.int16) == 0).all())
        assert int(plain[0, 2].view(torch.int16)) == -32768  # -0.0 gathered
        assert int(emu[0, 2].view(torch.int16)) == 0  # +0.0 from the one-hot
        if k_codes < 256 or code_bytes > 1:
            assert bool((emu[7:11, dsub:2 * dsub].view(torch.int16) == 0).all())


def test_probe_block_scan_rejects_bad_requests():
    bounds, cb, codes, norms, q = _problem(16, seed=2, n=1024, d=24, m=6)
    ops = tp.probe_scan_operands(
        *(torch.from_numpy(a) for a in (q, cb, codes.astype(np.int32), norms)),
        bounds=bounds,
    )
    args = (ops["codes_t"], ops["norms_hl"], ops["q_op"], ops["cb"])
    with pytest.raises(ValueError, match="decode_mode"):
        tp.probe_block_scan(*args, winners=1, nblk=ops["nblk"], decode_mode="gather")
    with pytest.raises(ValueError, match="piped"):
        tp.probe_block_scan(*args, winners=1, nblk=ops["nblk"], natural=True, pipe=True)
    with pytest.raises(ValueError, match="256"):
        tp.adc_scan_probe(q, cb, codes, norms, bounds=bounds, k=10, device="cpu")


# ---- P3 ---------------------------------------------------------------------


def _tpu_variant_names():
    """Every variant name ``benchmarks/kernel_probe.py`` tests for: the
    strings compared with ``variant``, the default list, and each tdec
    variant with the ``:nib`` / ``:cmp8`` builds its decode names."""
    tree = ast.parse((ROOT / "benchmarks" / "kernel_probe.py").read_text())
    names, impls = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name):
            consts = [c for c in ast.walk(node) if isinstance(c, ast.Constant)
                      and isinstance(c.value, str)]
            if node.left.id == "variant":
                names |= {c.value for c in consts}
            elif node.left.id == "decode_impl":
                impls |= {c.value for c in consts}
        if isinstance(node, ast.BoolOp) and isinstance(node.values[-1], ast.Tuple):
            names |= {c.value for c in node.values[-1].elts}
    tdec = {n for n in names if n.startswith("tdec_")} | {"tdec_packed"}
    return names | {f"{n}:{impl}" for n in tdec - {"tdec_cached", "tdec_i8"} for impl in impls}


def test_every_tpu_variant_has_a_port():
    names = _tpu_variant_names()
    assert {"tdec_noop", "tdec_match", "tdec_packed:nib", "tdec_grid:cmp8", "full",
            "packed_lane", "grid_only", "tdec_i8", "tdec_cached"} <= names
    assert names == set(kp.VARIANTS)


def _bf16(x):
    """Round f32 to bf16 (nearest even), as f32."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).view(np.float32)


def _mono(bits):
    return np.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _numpy_variant(variant, codes_t, norms, q_pad, cb, t, qt):
    """What the TPU variant's body writes, in numpy."""
    stage, impl, natural = kp.spec(variant)
    m, npad = codes_t.shape
    _, k_codes, dsub = cb.shape
    num_q, mdp = q_pad.shape
    nblk = t // 128
    vals = np.zeros((npad // 128, num_q), np.float32)
    ids = np.zeros((npad // 128, num_q), np.int32)
    if stage in ("noop", "grid"):  # kernel_probe.py:68-70, 117-119, 396-398
        return vals, ids
    cbT = cb.transpose(0, 2, 1)  # [m, dsub, K]
    if impl == "i8":  # kernel_probe.py:337-342, 296-305: s8 one-hot decode, dequantized
        amax = np.abs(cbT).max(axis=(1, 2))
        scales = (amax / np.float32(127.0)).astype(np.float32)
        cb_i8 = np.clip(np.round(cbT / scales[:, None, None]), -127, 127)
        dec = [_bf16(cb_i8[s][:, codes_t[s]].astype(np.float32) * scales[s]) for s in range(m)]
    else:  # kernel_probe.py:108-115 (one-hot x codebook), 248-252 (cached dec^T)
        dec = [cbT[s][:, codes_t[s]] for s in range(m)]
    decT = np.concatenate(dec + [np.zeros((mdp - m * dsub, npad), np.float32)])
    ipt = (decT.T.astype(np.float64) @ q_pad.T.astype(np.float64)).astype(np.float32)
    scores = norms[0][:, None] - np.float32(2.0) * ipt  # [N', Q]; :127, :234, :401
    tiles = scores.reshape(-1, t, num_q)
    if stage == "noselect" and not natural:  # kernel_probe.py:129-131
        return tiles[:, :nblk].reshape(-1, num_q), ids
    if stage == "noselect":  # kernel_probe.py:408-416: scores[0, 0] of each (r, q) tile
        first = tiles[:, 0, ::qt]
        return np.repeat(np.repeat(first, qt, axis=1)[:, None, :num_q], nblk, 1).reshape(
            -1, num_q), ids
    s3 = scores.reshape(-1, 128, num_q)
    blk = np.arange(npad // 128)[:, None]
    if stage == "packed":  # kernel_probe.py:162-172 (tdec), 419-438 (natural)
        key = (_mono(s3.view(np.int32)) & ~127) | np.arange(128)[None, :, None]
        pmin = key.min(axis=1).astype(np.int32)
        return _mono(pmin).astype(np.int32).view(np.float32), (blk * 128 + (pmin & 127)).astype(
            np.int32)
    vmin = s3.min(axis=1)
    if stage == "min":  # kernel_probe.py:137-139, 443-445
        return vmin, ids
    # kernel_probe.py:140-152, 230-240, 312-322 (lowest row equal to the
    # minimum), 446-459 (lowest row at or below it)
    lane = np.argmax(s3 <= vmin[:, None, :], axis=1)
    return vmin, (blk * 128 + lane).astype(np.int32)


P3_SHAPE = dict(n=4000, m=4, k_codes=256, dsub=13, mdp=64, num_q=300, t=1024)


@pytest.fixture(scope="module")
def p3_operands():
    s = P3_SHAPE
    return kp.probe_operands(s["n"], s["m"], s["k_codes"], s["dsub"], s["mdp"], s["num_q"],
                             s["t"], device="cpu")


@pytest.mark.parametrize("variant", kp.VARIANTS)
def test_p3_plain_matches_the_tpu_variant(p3_operands, variant):
    """4,000 rows (four 1024-row tiles), m 4 x K 256 x dsub 13, mdp 64, 300
    queries, query tile 128."""
    t, qt = P3_SHAPE["t"], 128
    vals, ids = kp.kernel_probe(variant, *p3_operands, tile_rows=t, query_tile=qt,
                                device="cpu")
    codes_t, norms, q_pad, cb = (a.float().numpy() if a.is_floating_point() else a.numpy()
                                 for a in p3_operands)
    ref_v, ref_i = _numpy_variant(variant, codes_t, norms, q_pad, cb, t, qt)
    assert vals.shape == ref_v.shape == (32, 300) and ids.dtype == torch.int32
    vals, ids = vals.numpy(), ids.numpy()
    tol = 2.0 ** -14 * np.maximum(np.abs(ref_v), 1.0)
    assert np.all(np.abs(vals - ref_v) <= tol)
    assert np.mean(ids == ref_i) >= 0.995
    if kp.spec(variant)[0] in ("noop", "grid"):
        assert not vals.any() and not ids.any()


# (n, m, K, dsub): P3's headline widths (dsub 13: one piece of 16), dsub 8,
# 24 and 32 (two pieces), K 16 to 1024; cmp8 and i8 take K <= 256
P3_EMULATION_CASES = [(256, 8, 256, 13), (256, 4, 16, 8), (128, 3, 64, 24), (128, 2, 256, 32),
                      (128, 2, 1024, 13)]
P3_RECIPES = {"int": "base", "nib": "nib", "cmp8": "cmp8", "i8": "i8"}


@pytest.mark.parametrize("case,recipe", [
    (case, recipe) for case in P3_EMULATION_CASES for recipe in P3_RECIPES
    if case[2] <= 256 or recipe in ("int", "nib")
], ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else v)
def test_p3_onehot_register_map_decodes_the_gather(case, recipe):
    """P3's one-hot recipes (``onehot_rs.cuh``: an int compare, nibble
    matches ANDed, offset int8 bytes compared four at a time, an s8
    one-hot against s8 codewords in the k32 fragment) emulated register by
    register at P3's piece width 16 equal ``kernel_probe.decoded_rows`` bit
    for bit but for the sign of a zero: a -0.0 codeword comes out of a bf16
    one-hot as +0.0; the s8 sum is exact, so ``i8`` matches bit for bit."""
    n, m, k_codes, dsub = case
    rng = np.random.default_rng(n + k_codes + dsub)
    cb = torch.from_numpy(rng.normal(size=(m, k_codes, dsub)).astype(np.float32))
    cb = cb.to(torch.bfloat16)
    cb[0, 5, 2] = -0.0
    codes_t = torch.from_numpy(rng.integers(0, k_codes, size=(m, n)).astype(np.int32))
    codes_t[0, :7] = 5  # the -0.0 codeword
    md = m * dsub
    mdp = -(-md // 8) * 8
    i8 = kp.quantize_codebooks(cb) if recipe == "i8" else None
    emu = tp.onehot_decode_rows_plain(
        codes_t, torch.zeros((2, n), dtype=torch.bfloat16), cb, width=-(-(md + 4) // 8) * 8,
        decode_mode=P3_RECIPES[recipe], lanes=16, i8=i8)[:, :md]
    ref = kp.decoded_rows(codes_t, cb, mdp, i8)[:, :md]
    canon = lambda x: (x.float() + 0.0).to(torch.bfloat16).view(torch.int16)  # noqa: E731
    assert torch.equal(canon(emu), canon(ref))
    bits = emu.view(torch.int16) == ref.view(torch.int16)
    if recipe == "i8":
        assert bool(bits.all())
    else:
        assert not bool(bits[:7, 2].any())  # -0.0 gathered, +0.0 from the one-hot
        assert bool(bits[:, 3:].all()) and int(emu[0, 2].view(torch.int16)) == 0


def test_p3_rejects_bad_shapes(p3_operands):
    with pytest.raises(ValueError, match="unknown"):
        kp.kernel_probe("tdec_fast", *p3_operands, tile_rows=1024, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        kp.kernel_probe("full", *p3_operands, tile_rows=3000, device="cpu")


def test_p3_shape_from_env():
    """The TPU probe's shape variables (``kernel_probe.py:29-38``)."""
    assert kp.shape_from_env({}) == dict(n=400_000, m=8, k_codes=256, dsub=13, mdp=128,
                                         num_q=1024, qt=512, t=2048)
    s = kp.shape_from_env({"PROBE_M": "25", "PROBE_DSUB": "12", "PROBE_T": "4096"})
    assert s["mdp"] == 304 and s["t"] == 4096


# ---- P4 ---------------------------------------------------------------------


def test_every_floor_variant_has_a_port():
    tree = ast.parse((ROOT / "benchmarks" / "floor_probe.py").read_text())
    names = [n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "run_variant"]
    assert names == list(fp.VARIANTS)


@pytest.mark.parametrize("variant", list(fp.VARIANTS))
def test_p4_plain_writes_the_zeros(variant):
    """floor_probe.py:37-41: zeros to [n_rt * rows, Q] f32 (and int32 ids);
    rows is nblk = t / 128 or 8 (:83-87)."""
    codes, q = fp.floor_operands(n=8192, device="cpu")
    out = fp.floor_probe(variant, codes, q, tile_rows=4096, device="cpu")
    with_codes, with_q, rows, with_ids = fp.VARIANTS[variant]
    rows = 32 if rows == "nblk" else rows
    assert [o.shape for o in out] == [(2 * rows, 1024)] * (2 if with_ids else 1)
    assert out[0].dtype == torch.float32 and not any(bool(o.any()) for o in out)
    moved = fp.bytes_moved(variant, codes, q, tile_rows=4096)
    assert moved == dict(read=8 * 8192 * with_codes + 1024 * 112 * 2 * with_q,
                         written=2 * rows * 1024 * 4 * (2 if with_ids else 1))


def test_p4_rotated_reads_each_copy_in_turn():
    """``rotated``: a call of the variant on the operands' own device, over
    copies of them, returning nothing (its outputs are kept for a while)."""
    codes, q = fp.floor_operands(n=4096, device="cpu")
    before = tracing.counter("probe.p4.launches")
    call = fp.rotated("codes only, out v [8]", codes, q, copies=3, kept=2)
    assert all(call() is None for _ in range(5))
    assert tracing.counter("probe.p4.launches") == before  # the CPU ran the plain zeros


def test_p4_operands_are_the_headline_shape():
    codes, q = fp.floor_operands(n=4096, device="cpu")
    assert codes.dtype == torch.int8 and codes.shape == (8, 4096)
    assert q.dtype == torch.bfloat16 and q.shape == (1024, 112)


# ---- K1 cut by stage ----------------------------------------------------------


def _k1_stage_operands(centered, n=3000):
    """K1's operands of a small problem: int32 codes uncentered, the
    pretransposed offset int8 codes (as the kernel phases hand them over)
    centered."""
    bounds, cb, codes, norms, q = _problem(256, seed=7 + centered, n=n, d=24, m=6)
    codes = torch.from_numpy(codes.astype(np.int32))
    if centered:
        codes = tadc.pack_codes_t(codes, 256)
    ops = tp.probe_scan_operands(
        torch.from_numpy(q), torch.from_numpy(cb), codes, torch.from_numpy(norms),
        bounds=bounds, tile_rows=1024, num_rows=n if centered else 0, center_scores=centered,
    )
    return (ops["codes_t"], ops["norms_hl"], ops["q_op"], ops["cb"]), ops["nblk"]


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("stage", ks.STAGES)
def test_k1_stage_plain_restates_the_stage(stage, centered):
    """The cut K1's plain version against a numpy statement of what each
    stage writes (``adc_scan.cu``'s kStage): zeros; each block's first
    row's score; each block's minimum score; scores over K1's decoded rows
    (codewords, or 0 for a code outside [0, K), hi/lo norm lanes, two ones,
    zeros) in f64. Values within ``2^-14 * max(|v|, 1)``, zeros exactly."""
    (codes_t, norms_hl, q_op, cb), nblk = _k1_stage_operands(centered)
    got = ks.k1_stage_scan(codes_t, norms_hl, q_op, cb, stage=stage, nblk=nblk).numpy()
    m, n_cols = codes_t.shape
    assert got.shape == (q_op.shape[0], n_cols // 128) and got.dtype == np.float32
    if stage == "decode":
        assert not got.any()
        return
    c = codes_t.numpy().astype(np.int64) + (128 if codes_t.dtype == torch.int8 else 0)
    cbn = cb.float().numpy().astype(np.float64)
    valid = c < cbn.shape[1]
    dec = np.where(valid[..., None], cbn[np.arange(m)[:, None], np.where(valid, c, 0)], 0.0)
    rows = np.concatenate([
        dec.transpose(1, 0, 2).reshape(n_cols, -1), norms_hl.float().numpy().T.astype(np.float64),
        np.ones((n_cols, 2)), np.zeros((n_cols, q_op.shape[1] - dec.shape[0] * dec.shape[2] - 4)),
    ], axis=1)
    scores = q_op.float().numpy().astype(np.float64) @ rows.T  # [Q, N']
    want = scores[:, ::128] if stage == "contraction" else scores.reshape(
        q_op.shape[0], -1, 128).min(axis=2)
    assert np.all(np.abs(got - want) <= 2.0 ** -14 * np.maximum(np.abs(want), 1.0))


def test_k1_stage_block_min_is_k1_without_its_lane_pack():
    """Stage ``block_min`` then the lane pack is K1: its minima, their low
    7 bits cleared, are K1's plain winners' values, within K1's tolerance
    (the two sum in different orders)."""
    operands, nblk = _k1_stage_operands(True)
    vmin = ks.k1_stage_scan(*operands, stage="block_min", nblk=nblk)
    k1 = tadc._block_scan_plain(*operands, winners=1, nblk=nblk)
    trunc = lambda v: (v.view(torch.int32) & ~127).view(torch.float32)  # noqa: E731
    err = (trunc(vmin) - trunc(k1)).abs()
    assert bool((err <= 2.0 ** -14 * torch.clamp(trunc(k1).abs(), min=1.0)).all())


def test_k1_stage_rejects_bad_requests():
    operands, nblk = _k1_stage_operands(False)
    with pytest.raises(ValueError, match="stage"):
        ks.k1_stage_scan(*operands, stage="selection", nblk=nblk)
    with pytest.raises(ValueError):
        ks.k1_stage_scan(*operands, stage="decode", nblk=nblk + 1)
    with pytest.raises(ValueError, match="query"):
        ks.plain(operands[0], operands[1], operands[2][:0], operands[3], stage="decode",
                 nblk=nblk)


# ---- device -------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    """Without ``device=`` each probe puts its operands on the card, and
    without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the defaults would run there")
    bounds, cb, codes, norms, q = _problem(16, seed=2, n=1024, d=24, m=6)
    calls = [
        lambda: tp.adc_scan_probe(q, cb, codes, norms, bounds=bounds, k=2),
        lambda: kp.kernel_probe("full", *kp.probe_operands(1024, 2, 16, 4, 8, 4, 1024,
                                                           device="cpu"), tile_rows=1024),
        lambda: kp.probe_operands(1024, 2, 16, 4, 8, 4, 1024),
        lambda: fp.floor_probe("q only, out v [8]", *fp.floor_operands(n=4096, device="cpu")),
        lambda: fp.floor_operands(n=4096),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
