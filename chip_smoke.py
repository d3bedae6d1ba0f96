#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gulon_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.
It needs one CUDA device and the CUDA toolkit (``nvcc``), and it
imports no JAX. Phases, one JSON line each; any failure raises and
the script exits non-zero:

1. device: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: ``nvcc`` builds kernel K1 (``adc_scan``) and kernels K2/K3
   (``dense_scan``) from ``gulon_tpu_torch/csrc``, one process each, in
   parallel;
3. kernel: K1 against its plain PyTorch version on the same operands at
   the glove100 shape (400,000 rows, D=100, PQ 8x256, 1024 queries), for
   1 and 2 winners per block, centered and uncentered, 4 winners
   uncentered, and once with int16 codes (K=512); median ms of 10 timed
   runs after 3 warm-ups;
4. main path: build a flat PQ index of a seeded 400,000 x 100 low-rank
   corpus on the card, answer 4 batches of 1024 top-10 queries through
   the ``auto`` strategy (which must pick the fused kernel), and measure
   recall@1/@10 on 1000 sampled queries against the decode strategy;
5. dense kernel: K2 and K3 against their plain versions on the same
   operands at the fasttext shape (a seeded 2,000,000 x 300 low-rank
   corpus, Dp 304 / 320, 1024 queries drawn from it), and K2 once at the
   glove100 cache width (400,000 x 104, Dp 112); K2 within
   ``2^-14 * max(|v|, ||x||^2 + ||q||^2)`` with >= 99.5 % equal ids, K3
   bit for bit;
6. exact path: ``build_exact_index`` of that corpus on the card; 4
   batches of 1024 top-10 queries through ``auto`` (which must pick the
   kernel route, K2), then with ``operand="int8"`` (K3) and with
   ``scan_strategy="xla"``; recall@1/@10 of each on 1000 sampled queries;
7. cached path: ``enable_cache()`` on the glove100 index; ``auto`` must
   pick ``cached``; 4 batches through K2; recall against decode;
8. IVF path (ivf1m): ``build_ivf_index`` of a seeded 1,000,000 x 96
   low-rank corpus (intrinsic 24, 4096 clusters) on the card, PQ 12x256,
   the default 1000 partitions and probe limit 50; K1 at 4 winners
   against its plain version on the index's own partition-padded
   operands (no padding row may win); 4 batches of 1024 top-10 queries
   through ``auto`` (which must pick ``pallas``, K1), through 2 winners
   with and without rescore 4, and through the masked scan; ``auto`` must
   go sublinear for 1 and 8 queries and match the masked scan's
   distances; recall@1/@10 of each route on 1000 sampled queries
   (recall@10 >= 0.97x masked at 4 winners, >= 0.95x at 2 + rescore 4).

Then a line with each kernel's launches on the paths, error and times,
the raw ``nvidia-smi`` line, and last ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, each between two CUDA
    events, after ``warmup`` runs."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def low_rank_corpus(seed: int, n: int, d: int, intrinsic: int = 32,
                    n_clusters: int = 1000, noise: float = 0.05):
    """Clustered low-rank corpus with isotropic noise: the recipe of
    ``benchmarks/common.py::low_rank_corpus_device``, drawn with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((intrinsic, d), dtype=np.float32)
    centers = rng.standard_normal((n_clusters, intrinsic), dtype=np.float32)
    labels = rng.integers(0, n_clusters, n)
    z = centers[labels] + 0.3 * rng.standard_normal((n, intrinsic), dtype=np.float32)
    x = z @ basis / np.float32(np.sqrt(intrinsic))
    return (x + noise * rng.standard_normal((n, d), dtype=np.float32)).astype(np.float32)


def _serve(index, x, rows, k):
    """(host ms ending in a synchronize, dists, ids) of one query batch."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    dists, ids = index.query_arrays(k, x[rows])
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, dists, ids


def _serve_checked(index, x, rows, k) -> float:
    """Serve one batch and check it: shape, finite distances, ids in
    range, distances ascending. Returns its ms."""
    import torch

    ms, dists, ids = _serve(index, x, rows, k)
    if dists.shape != (len(rows), k) or not bool(torch.isfinite(dists).all()):
        raise AssertionError(f"bad distances {tuple(dists.shape)}")
    if not bool(((ids >= 0) & (ids < len(x))).all()):
        raise AssertionError("row ids out of range")
    if not bool((dists[:, 1:] >= dists[:, :-1]).all()):
        raise AssertionError("distances not ascending")
    return ms


def phase_kernel(seed: int) -> dict:
    """K1 against its plain version at the glove100 shape."""
    import numpy as np
    import torch

    from gulon_tpu_torch.ops.cuda import adc
    from gulon_tpu_torch.ops.pq import subspace_bounds

    dev = "cuda"
    n, d, m, q_n = 400_000, 100, 8, 1024
    bounds = subspace_bounds(d, m)
    dsub = max(w for _, w in bounds)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for k_codes, winners, centered in (
        (256, 1, True), (256, 1, False), (256, 2, True), (256, 2, False),
        (512, 1, True), (256, 4, False),
    ):
        cb = torch.randn((m, k_codes, dsub), generator=gen, device=dev)
        for s, (_, w) in enumerate(bounds):
            cb[s, :, w:] = 0.0
        cb = cb.to(torch.bfloat16).to(torch.float32)
        codes = torch.randint(0, k_codes, (n, m), generator=gen, device=dev)
        norms = (cb[torch.arange(m, device=dev)[None], codes] ** 2).sum((1, 2))
        queries = torch.randn((q_n, d), generator=gen, device=dev)
        codes_t = adc.pack_codes_t(codes, k_codes)
        ops = adc.prepare_scan_operands(
            queries, cb, codes_t, norms, bounds=bounds, tile_rows=0,
            num_rows=n, winners=winners, center_scores=centered,
        )
        operands = (
            ops["codes_t"],
            adc._split_hi_lo(ops["norms"], ops["center"]),
            ops["q_pad"][:q_n].to(torch.bfloat16),
            cb.to(torch.bfloat16).contiguous(),
        )
        nblk = ops["t"] // 128
        packed_k = adc.fused_block_scan(*operands, winners=winners, nblk=nblk)
        torch.cuda.synchronize()
        packed_p = adc._block_scan_plain(*operands, winners=winners, nblk=nblk)
        base = torch.zeros(packed_k.shape[1], dtype=torch.int32, device=dev)
        v_k, i_k = adc.unpack_block_winners(packed_k, base)
        v_p, i_p = adc.unpack_block_winners(packed_p, base)
        tol = 2.0 ** -14 * torch.clamp(v_p.abs(), min=1.0)
        err = (v_k - v_p).abs()
        id_equal = float((i_k == i_p).float().mean())
        vals_ok = bool((err <= tol).all())
        # an id mismatch must be a near-tie: both winners' values within tol
        ties_ok = bool((err[i_k != i_p] <= tol[i_k != i_p]).all())
        case = dict(
            k_codes=k_codes, winners=winners, centered=centered,
            code_dtype=str(ops["codes_t"].dtype).replace("torch.", ""),
            shape=[q_n, n, m * dsub], id_equal=id_equal,
            max_abs_err=float(err.max()), values_ok=vals_ok, ties_ok=ties_ok,
            ms=_cuda_ms(lambda: adc.fused_block_scan(*operands, winners=winners, nblk=nblk)),
            plain_ms=_cuda_ms(lambda: adc._block_scan_plain(*operands, winners=winners, nblk=nblk)),
        )
        _emit({"phase": "kernel", **case})
        if id_equal < 0.995 or not vals_ok or not ties_ok:
            raise AssertionError(f"K1 disagrees with its plain version: {case}")
        cases.append(case)
    return cases[0] | {"max_abs_err": max(c["max_abs_err"] for c in cases)}


def phase_main_path(seed: int):
    """Build -> serve -> recall through the port's entry points. Returns
    the phase line and the index, corpus and ground truth for the cached
    path."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.ops.cuda import adc

    n, d, batch, k = 400_000, 100, 1024, 10
    x = low_rank_corpus(seed, n, d)
    keys = np.array([f"w{i:07d}" for i in range(n)], dtype=object)
    rng = np.random.default_rng(seed + 1)

    adc.adc_scan_kernel_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = gt.build_flat_index(
        keys, x,
        pq_config=gt.PQConfig(
            num_clusters=256, num_quantizers=8, max_iters=25,
            train_sample=200_000,
        ),
        device="cuda",
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    strategy = index.resolve_strategy(batch, k)
    if strategy != "pallas":
        raise AssertionError(f"auto resolved to {strategy!r}, not 'pallas'")

    decode = dataclasses.replace(index, scan_strategy="decode")
    fused_ms, decode_ms = [], []
    for b in range(4):
        rows = rng.choice(n, batch, replace=False)
        fused_ms.append(_serve_checked(index, x, rows, k))
        decode_ms.append(_serve(decode, x, rows, k)[0])
    launches_serve = adc.adc_scan_kernel_launches

    truth = gt.sample_ground_truth(
        keys, x, num_samples=1000, ks=(1, 10), device="cuda"
    )
    rec_fused = gt.recall_of(index, truth, x, keys)
    rec_decode = gt.recall_of(decode, truth, x, keys)
    launches = adc.adc_scan_kernel_launches
    ratio = rec_fused[10].mean / max(rec_decode[10].mean, 1e-12)
    out = dict(
        n=n, d=d, pq="8x256", batch=batch, k=k, build_s=build_s,
        strategy=strategy, winners=index.resolved_pallas_winners(),
        rerank=index.resolved_rerank_factor(),
        fused_ms_per_batch=fused_ms, decode_ms_per_batch=decode_ms,
        launches_serve=launches_serve, launches=launches,
        recall_fused={1: rec_fused[1].mean, 10: rec_fused[10].mean},
        recall_decode={1: rec_decode[1].mean, 10: rec_decode[10].mean},
        recall10_ratio=ratio,
    )
    _emit({"phase": "main_path", **out})
    if launches_serve < 4:
        raise AssertionError(f"K1 launched {launches_serve} times for 4 batches")
    if ratio < 0.97:
        raise AssertionError(f"fused/decode recall@10 ratio {ratio:.4f} < 0.97")
    return out, dict(index=index, x=x, keys=keys, truth=truth, rec_decode=rec_decode)


def _dense_case(name, block_scan, plain, data, q_op, exact) -> dict:
    """One kernel against its plain version on the same operands: K3
    (``exact``) bit for bit; K2 with >= 99.5 % equal block-winner ids and
    every value, and both values of every id mismatch, within
    ``2^-14 * max(|v|, S)``. ``S = ||x||^2 + ||q||^2`` of the winner row
    and the query bounds the f32 partial sums: two summation orders of
    the same exact bf16 products differ by a fraction of the summands, not
    of a score that cancels to near 0. How many values miss the tighter
    ``2^-14 * max(|v|, 1)`` is reported as ``outside_value_tol``."""
    import torch

    got = block_scan(data, q_op)
    torch.cuda.synchronize()
    ref = plain(data, q_op)
    shape = [q_op.shape[0], data.shape[0], data.shape[1]]
    if exact:
        err = (got.to(torch.int64) - ref.to(torch.int64)).abs()
        ok = bool(torch.equal(got, ref))
        case = dict(id_equal=float(((got & 127) == (ref & 127)).float().mean()))
    else:
        bk, bp = got.view(torch.int32), ref.view(torch.int32)
        vk, vp = (bk & ~127).view(torch.float32), (bp & ~127).view(torch.float32)
        ik, ip = bk & 127, bp & 127
        rows = torch.clamp(
            torch.arange(bp.shape[1], device=bp.device)[None, :] * 128 + ip,
            max=data.shape[0] - 1,
        ).long()
        x_norm = data[:, -2].float() + data[:, -1].float()  # hi + lo lanes
        q_norm = (q_op[:, :-2].float() ** 2).sum(1) / 4.0  # lanes hold -2q
        scale = torch.clamp(x_norm[rows] + q_norm[:, None], min=1.0)
        tol = 2.0 ** -14 * torch.maximum(vp.abs(), scale)
        err = (vk - vp).abs()
        id_equal = float((ik == ip).float().mean())
        vals_ok = bool((err <= tol).all())
        ties_ok = bool((err[ik != ip] <= tol[ik != ip]).all())
        ok = id_equal >= 0.995 and vals_ok and ties_ok
        outside = err > 2.0 ** -14 * torch.clamp(vp.abs(), min=1.0)
        case = dict(
            id_equal=id_equal, values_ok=vals_ok, ties_ok=ties_ok,
            max_err_over_scale=float((err / scale).max()),
            outside_value_tol=int(outside.sum()), values=err.numel(),
        )
    case = dict(
        kernel=name, shape=shape, dtype=str(data.dtype).replace("torch.", ""),
        **case, max_abs_err=float(err.max()), ok=ok,
        ms=_cuda_ms(lambda: block_scan(data, q_op)),
        plain_ms=_cuda_ms(lambda: plain(data, q_op)),
    )
    _emit({"phase": "dense_kernel", **case})
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {case}")
    return case


def phase_dense_kernel(seed: int, x, glove) -> dict:
    """K2 and K3 against their plain versions at the fasttext shape, and
    K2 at the glove100 cache width (the cached strategy's operand)."""
    import numpy as np
    import torch

    from gulon_tpu_torch.models.flat import _augment_cache
    from gulon_tpu_torch.ops import scan as scan_ops
    from gulon_tpu_torch.ops.cuda import dense

    rng = np.random.default_rng(seed + 3)
    q_n = 1024
    xd = torch.from_numpy(x).to("cuda")
    q = xd[torch.from_numpy(rng.choice(len(x), q_n, replace=False)).to("cuda")]

    def q_aug(q, dp):
        d = q.shape[1]
        return torch.cat(
            [-2.0 * q, torch.zeros((len(q), dp - d - 2), device=q.device),
             torch.ones((len(q), 2), device=q.device)], dim=1,
        ).to(torch.bfloat16)

    data = dense.prepare_data(xd)
    k2 = _dense_case(
        "K2", dense.dense_block_scan, dense._dense_block_scan_plain, data,
        q_aug(q, data.shape[1]), exact=False,
    )
    del data
    d8, meta, _ = dense.prepare_data_i8(xd)
    qi = torch.clamp(torch.round(-q / (meta.scale * meta.gain)), -127, 127)
    q8 = torch.cat(
        [qi, torch.zeros((q_n, meta.dp - meta.d - 2), device="cuda"),
         torch.full((q_n, 1), 127.0, device="cuda"),
         torch.ones((q_n, 1), device="cuda")], dim=1,
    ).to(torch.int8)
    k3 = _dense_case(
        "K3", dense.dense_block_scan_i8, dense._dense_block_scan_plain_i8, d8,
        q8, exact=True,
    )
    del d8, xd

    index, gx = glove["index"], glove["x"]
    pq = index.pq
    cache = scan_ops.decode_tile(pq.codebooks, index.codes).to(torch.bfloat16)
    aug = _augment_cache(cache, index.recon_norms)
    gq = torch.from_numpy(gx[rng.choice(len(gx), q_n, replace=False)]).to("cuda")
    k2_cache = _dense_case(
        "K2", dense.dense_block_scan, dense._dense_block_scan_plain, aug,
        q_aug(scan_ops._q_pad(gq, pq.bounds, pq.pad_width), aug.shape[1]),
        exact=False,
    )
    return dict(k2=k2, k3=k3, k2_cache=k2_cache)


def phase_exact_path(seed: int, x) -> dict:
    """``build_exact_index`` -> serve through the kernel route (K2), the
    int8 operand (K3) and the ``xla`` route -> recall of each."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.ops.cuda import dense

    n, d = x.shape
    batch, k = 1024, 10
    keys = np.array([f"w{i:07d}" for i in range(n)], dtype=object)
    rng = np.random.default_rng(seed + 2)
    batches = [rng.choice(n, batch, replace=False) for _ in range(4)]

    dense.dense_scan_kernel_launches = 0
    dense.dense_scan_i8_kernel_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = gt.build_exact_index(keys, x, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    strategy = index.resolve_strategy(k)
    if strategy != "pallas":
        raise AssertionError(f"auto resolved to {strategy!r}, not 'pallas'")
    routes = {
        "bf16": index,
        "int8": dataclasses.replace(index, operand="int8"),
        "xla": dataclasses.replace(index, scan_strategy="xla"),
    }
    truth = gt.sample_ground_truth(keys, x, num_samples=1000, ks=(1, 10), device="cuda")
    out = dict(n=n, d=d, batch=batch, k=k, build_s=build_s, strategy=strategy)
    for name, idx in routes.items():
        before = (dense.dense_scan_kernel_launches, dense.dense_scan_i8_kernel_launches)
        ms = [_serve_checked(idx, x, rows, k) for rows in batches]
        served = (dense.dense_scan_kernel_launches - before[0],
                  dense.dense_scan_i8_kernel_launches - before[1])
        rec = gt.recall_of(idx, truth, x, keys)
        out[name] = dict(
            ms_per_batch=ms, launches_k2_k3=list(served),
            recall={1: rec[1].mean, 10: rec[10].mean},
        )
    out["resolved_operand_int8"] = routes["int8"].resolved_operand
    out["launches_k2"] = dense.dense_scan_kernel_launches
    out["launches_k3"] = dense.dense_scan_i8_kernel_launches
    xla10 = max(out["xla"]["recall"][10], 1e-12)
    out["recall10_ratio"] = {
        "bf16": out["bf16"]["recall"][10] / xla10,
        "int8": out["int8"]["recall"][10] / xla10,
    }
    _emit({"phase": "exact_path", **out})
    if out["resolved_operand_int8"] != "int8":
        raise AssertionError("the int8 route fell back to the bf16 operand")
    if out["bf16"]["launches_k2_k3"][0] < 4 or out["int8"]["launches_k2_k3"][1] < 4:
        raise AssertionError(f"K2/K3 launched too rarely for 4 batches: {out}")
    if out["recall10_ratio"]["bf16"] < 0.99 or out["recall10_ratio"]["int8"] < 0.98:
        raise AssertionError(f"exact-path recall@10 ratios {out['recall10_ratio']}")
    return out


def phase_cached_path(glove) -> dict:
    """``enable_cache()`` on the glove100 index -> ``auto`` picks
    ``cached`` -> 4 batches through K2 -> recall against decode."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.ops.cuda import dense

    index, x, keys = glove["index"], glove["x"], glove["keys"]
    batch, k = 1024, 10
    rng = np.random.default_rng(4)
    dense.dense_scan_kernel_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.enable_cache()
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    cache_dtype = str(index.decoded_cache.dtype).replace("torch.", "")
    strategy = index.resolve_strategy(batch, k)
    if strategy != "cached":
        raise AssertionError(f"auto resolved to {strategy!r}, not 'cached'")
    pallas = dataclasses.replace(index, scan_strategy="pallas")
    cached_ms, pallas_ms = [], []
    for _ in range(4):
        rows = rng.choice(len(x), batch, replace=False)
        cached_ms.append(_serve_checked(index, x, rows, k))
        pallas_ms.append(_serve(pallas, x, rows, k)[0])
    launches_serve = dense.dense_scan_kernel_launches
    rec = gt.recall_of(index, glove["truth"], x, keys)
    rec_decode = glove["rec_decode"]
    out = dict(
        n=len(x), cache_s=cache_s, strategy=strategy,
        cache_dtype=cache_dtype,
        cached_ms_per_batch=cached_ms, pallas_ms_per_batch=pallas_ms,
        launches_serve=launches_serve, launches=dense.dense_scan_kernel_launches,
        recall_cached={1: rec[1].mean, 10: rec[10].mean},
        recall_decode={1: rec_decode[1].mean, 10: rec_decode[10].mean},
        recall10_ratio=rec[10].mean / max(rec_decode[10].mean, 1e-12),
    )
    _emit({"phase": "cached_path", **out})
    if launches_serve < 4:
        raise AssertionError(f"K2 launched {launches_serve} times for 4 cached batches")
    if out["recall10_ratio"] < 0.97:
        raise AssertionError(f"cached/decode recall@10 ratio {out['recall10_ratio']:.4f} < 0.97")
    return out


def _ivf_kernel_check(index, q) -> dict:
    """K1 at 4 winners, uncentered, against its plain version on the
    index's own partition-padded operands. Values within ``2^-14 *
    max(|v|, S)``, ``S = |rc| + 2 ||q|| ||r^||`` the scale of the winner
    row's summands (the uncentered score ``rc - 2<q, r^>`` cancels toward
    0 where ``rc`` is negative); >= 99.5 % equal ids, every mismatch a
    near-tie; in both, every block yields exactly ``min(4, real rows)``
    valid winners, all of them real rows, so no padding row ever wins.
    How many values miss ``2^-14 * max(|v|, 1)`` is reported."""
    import torch

    from gulon_tpu_torch.ops.cuda import adc

    winners = 4
    pq = index.pq
    codes_t, rc_pal, _, row_map = index._pallas_operands()
    npad = codes_t.shape[1]
    ops = adc.prepare_scan_operands(
        q, pq.codebooks, codes_t, rc_pal, bounds=pq.bounds, tile_rows=0,
        num_rows=npad, winners=winners, center_scores=False,
    )
    nblk = ops["t"] // 128
    operands = (
        ops["codes_t"], adc._split_hi_lo(ops["norms"], ops["center"]),
        ops["q_pad"][: len(q)].to(torch.bfloat16),
        pq.codebooks.to(torch.bfloat16).contiguous(),
    )
    got = adc.fused_block_scan(*operands, winners=winners, nblk=nblk)
    torch.cuda.synchronize()
    ref = adc._block_scan_plain(*operands, winners=winners, nblk=nblk)
    n_cols = ops["codes_t"].shape[1]
    cols = torch.arange(n_cols // 128 * winners, device=q.device)
    wn = winners * nblk
    base = ((cols // wn) * ops["t"] + (cols % wn) % nblk * 128).to(torch.int32)
    rank = (cols % wn) // nblk
    vk, ik = adc.unpack_block_winners(got, base)
    vp, ip = adc.unpack_block_winners(ref, base)

    # real rows per 128-row block of the padded operand (the tail past
    # npad is all padding)
    real = torch.zeros(n_cols // 128, dtype=torch.int64, device=q.device)
    real[: npad // 128] = (row_map.view(-1, 128) >= 0).sum(1)
    expect_valid = rank[None, :] < real[(base // 128).long()][None, :]
    row_ok = torch.cat([row_map >= 0, row_map.new_zeros(n_cols - npad).bool()])

    def winners_ok(v, i):
        valid = v < adc._INVALID_MIN
        return bool(torch.equal(valid, expect_valid.expand_as(valid))) and bool(
            row_ok[i[valid].long()].all()
        )

    # the summand scale of each winner row: |rc| + 2 ||q|| ||r^||
    codes_pal = (ops["codes_t"].to(torch.int32) + 128).T  # [n_cols, m]
    rnorm = pq.reconstruction_norms(codes_pal)
    rc_full = torch.cat([rc_pal, rc_pal.new_full((n_cols - npad,), adc._BIG)])
    qnorm = torch.sqrt((q * q).sum(1))
    rows = ip.long()
    scale = rc_full[rows].abs() + 2.0 * qnorm[:, None] * torch.sqrt(rnorm[rows])
    tol = 2.0 ** -14 * torch.maximum(vp.abs(), torch.clamp(scale, min=1.0))
    err = (vk - vp).abs()
    mism = ik != ip
    case = dict(
        winners=winners, shape=[len(q), npad, pq.num_quantizers * pq.pad_width],
        id_equal=float((~mism).float().mean()),
        values_ok=bool((err <= tol).all()),
        ties_ok=bool((err[mism] <= tol[mism]).all()),
        no_padding_winner_kernel=winners_ok(vk, ik),
        no_padding_winner_plain=winners_ok(vp, ip),
        outside_value_tol=int((err > 2.0 ** -14 * torch.clamp(vp.abs(), min=1.0)).sum()),
        values=err.numel(),
        max_abs_err=float(torch.where(vp < adc._INVALID_MIN, err, 0.0).max()),
        ms=_cuda_ms(lambda: adc.fused_block_scan(*operands, winners=winners, nblk=nblk)),
        plain_ms=_cuda_ms(lambda: adc._block_scan_plain(*operands, winners=winners, nblk=nblk)),
    )
    _emit({"phase": "ivf_kernel", **case})
    ok = (
        case["id_equal"] >= 0.995 and case["values_ok"] and case["ties_ok"]
        and case["no_padding_winner_kernel"] and case["no_padding_winner_plain"]
    )
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version on IVF operands: {case}")
    return case


def phase_ivf_path(seed: int, n: int = 1_000_000, device: str = "cuda") -> dict:
    """ivf1m at full size: build -> K1 check on the index's operands ->
    serve through auto (pallas), W=2 + rescore 4, masked, and sublinear
    small batches -> recall of each route."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.ops.cuda import adc

    d, batch, k = 96, 1024, 10
    x = low_rank_corpus(seed, n, d, intrinsic=24, n_clusters=4096)
    keys = np.array([f"r{i:08d}" for i in range(n)], dtype=object)
    rng = np.random.default_rng(seed + 5)
    batches = [rng.choice(n, batch, replace=False) for _ in range(4)]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = gt.build_ivf_index(
        keys, x,
        pq_config=gt.PQConfig(
            num_clusters=256, num_quantizers=12, max_iters=10,
            train_sample=200_000,
        ),
        coarse_max_iters=10,
        device=device,
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sizes = index.partition_sizes()
    t0 = time.perf_counter()
    index._pallas_operands()
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0

    kernel = _ivf_kernel_check(
        index, torch.from_numpy(x[batches[0]]).to(device)
    )

    adc.adc_scan_kernel_launches = 0
    strategy = index.resolve_strategy(batch, k)
    if strategy != "pallas":
        raise AssertionError(f"auto resolved to {strategy!r}, not 'pallas'")
    routes = {
        "pallas_w4": index,
        "pallas_w2_rescore4": dataclasses.replace(
            index, pallas_winners=2, pallas_rescore=4
        ),
        "pallas_w2": dataclasses.replace(index, pallas_winners=2),
        "masked": dataclasses.replace(index, scan_strategy="masked"),
    }
    out = dict(
        n=n, d=d, pq="12x256", partitions=index.num_partitions,
        probe=index.strategy.count, batch=batch, k=k,
        partition_rows=[int(sizes.min()), int(sizes.max())],
        padded_rows=int(index._pallas_layout[0].shape[1]),
        build_s=build_s, layout_s=layout_s, strategy=strategy,
    )
    for name, idx in routes.items():
        before = adc.adc_scan_kernel_launches
        out[name] = dict(
            ms_per_batch=[_serve_checked(idx, x, rows, k) for rows in batches],
            launches=adc.adc_scan_kernel_launches - before,
        )
    launches_serve = adc.adc_scan_kernel_launches

    # small batches go sublinear and return the masked scan's distances
    # (all three at full f32, so only summation order differs)
    small = {}
    exact = {
        name: dataclasses.replace(index, scan_strategy=name, precision="highest")
        for name in ("masked", "gathered", "bucketed")
    }
    for nq in (1, 8):
        rows = batches[1][:nq]
        resolved = index.resolve_strategy(nq, k)
        ms = [_serve_checked(index, x, rows, k) for _ in range(3)]
        d_m = _serve(exact["masked"], x, rows, k)[1]
        gaps = {}
        for name in ("gathered", "bucketed"):
            d_s = _serve(exact[name], x, rows, k)[1]
            gaps[name] = float(
                ((d_s - d_m).abs() / torch.clamp(d_m.abs(), min=1.0)).max()
            )
        small[nq] = dict(strategy=resolved, ms=ms, max_rel_gap_to_masked=gaps)
    out["small_batches"] = small

    truth = gt.sample_ground_truth(keys, x, num_samples=1000, ks=(1, 10), device=device)
    recall = {}
    for name, idx in routes.items():
        rec = gt.recall_of(idx, truth, x, keys)
        recall[name] = {1: rec[1].mean, 10: rec[10].mean}
    out["recall"] = recall
    masked10 = max(recall["masked"][10], 1e-12)
    out["recall10_ratio"] = {
        name: recall[name][10] / masked10
        for name in ("pallas_w4", "pallas_w2_rescore4", "pallas_w2")
    }
    out["launches_serve"] = launches_serve
    out["launches"] = adc.adc_scan_kernel_launches
    _emit({"phase": "ivf_path", **out})
    if min(out[name]["launches"] for name in routes if name != "masked") < 4:
        raise AssertionError(f"K1 launched too rarely on the IVF routes: {out}")
    if out["masked"]["launches"] != 0:
        raise AssertionError("the masked route launched K1")
    for nq, s in small.items():
        if s["strategy"] not in ("gathered", "bucketed"):
            raise AssertionError(f"auto took {s['strategy']!r} for {nq} queries")
        if max(s["max_rel_gap_to_masked"].values()) > 1e-4:
            raise AssertionError(f"sublinear routes disagree with masked: {s}")
    # two winners a block lose every true neighbour past the second that
    # shares a 128-row block, which no rescore recovers: W=2 + rescore 4
    # is held to 0.95x masked, the default W=4 to 0.97x
    ratio = out["recall10_ratio"]
    if ratio["pallas_w4"] < 0.97 or ratio["pallas_w2_rescore4"] < 0.95:
        raise AssertionError(f"IVF recall@10 ratios {ratio}")
    return dict(out, kernel=kernel)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gulon_tpu_torch.ops.cuda import _build, adc, dense

    smi = _nvidia_smi()
    _emit({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    t0 = time.perf_counter()
    _build.build(["adc_scan", "dense_scan"])  # one nvcc each, in parallel
    adc._kernel()
    dense._kernel()
    for name in ("adc_scan", "dense_scan"):
        seconds, report = _build.BUILD_INFO.get(name, (0.0, ""))
        _emit({
            "phase": "build", "kernel": name, "nvcc_seconds": seconds,
            "seconds": time.perf_counter() - t0,
            "library": str(_build.library_path(name).name),
            "ptxas": sorted({
                line.strip() for line in report.splitlines()
                if "registers" in line or "spill" in line
            }),
        })

    k1 = phase_kernel(args.seed)
    main_path, glove = phase_main_path(args.seed)
    if main_path["launches"] == 0:
        raise AssertionError("the main path never launched K1")
    x2m = low_rank_corpus(args.seed, 2_000_000, 300)
    dense_k = phase_dense_kernel(args.seed, x2m, glove)
    exact = phase_exact_path(args.seed, x2m)
    cached = phase_cached_path(glove)
    del glove, x2m
    ivf = phase_ivf_path(args.seed)
    k2, k3 = dense_k["k2"], dense_k["k3"]
    _emit({"kernels": [
        {
            "name": "adc_scan", "route": "cuda",
            "source": "gulon_tpu_torch/csrc/adc_scan.cu",
            "replaces": "gulon_tpu/ops/pallas/adc.py:276",
            "launches": main_path["launches"] + ivf["launches"],
            "launches_by_path": {"flat": main_path["launches"], "ivf": ivf["launches"]},
            "max_abs_err": max(k1["max_abs_err"], ivf["kernel"]["max_abs_err"]),
            "ms": k1["ms"], "plain_ms": k1["plain_ms"],
            "ivf_w4_ms": ivf["kernel"]["ms"], "ivf_w4_plain_ms": ivf["kernel"]["plain_ms"],
        },
        {
            "name": "dense_scan_bf16", "route": "cuda",
            "source": "gulon_tpu_torch/csrc/dense_scan.cu",
            "replaces": "gulon_tpu/ops/pallas/dense.py:89",
            "launches": exact["launches_k2"] + cached["launches"],
            "max_abs_err": max(k2["max_abs_err"], dense_k["k2_cache"]["max_abs_err"]),
            "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        },
        {
            "name": "dense_scan_i8", "route": "cuda",
            "source": "gulon_tpu_torch/csrc/dense_scan.cu",
            "replaces": "gulon_tpu/ops/pallas/dense.py:419",
            "launches": exact["launches_k3"],
            "max_abs_err": k3["max_abs_err"],
            "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        },
    ]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
