#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gulon_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.
It needs one CUDA device and the CUDA toolkit (``nvcc``), and it
imports no JAX. Phases, one JSON line each; any failure raises and
the script exits non-zero:

1. device: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: ``nvcc`` builds kernel K1 from ``gulon_tpu_torch/csrc``;
3. kernel: K1 against its plain PyTorch version on the same operands at
   the glove100 shape (400,000 rows, D=100, PQ 8x256, 1024 queries), for
   1 and 2 winners per block, centered and uncentered, and once with
   int16 codes (K=512); median ms of 10 timed runs after 3 warm-ups;
4. main path: build a flat PQ index of a seeded 400,000 x 100 low-rank
   corpus on the card, answer 4 batches of 1024 top-10 queries through
   the ``auto`` strategy (which must pick the fused kernel), and measure
   recall@1/@10 on 1000 sampled queries against the decode strategy.

Then a line with each kernel's launches on the main path, error and
times, the raw ``nvidia-smi`` line, and last ``{"ok": true, ...}``.
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
        (512, 1, True),
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


def phase_main_path(seed: int) -> dict:
    """Build -> serve -> recall through the port's entry points."""
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

    def serve(idx, rows):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dists, ids = idx.query_arrays(k, x[rows])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, dists, ids

    decode = dataclasses.replace(index, scan_strategy="decode")
    fused_ms, decode_ms = [], []
    for b in range(4):
        rows = rng.choice(n, batch, replace=False)
        ms, dists, ids = serve(index, rows)
        fused_ms.append(ms)
        if dists.shape != (batch, k) or not bool(torch.isfinite(dists).all()):
            raise AssertionError(f"bad distances {tuple(dists.shape)}")
        if not bool(((ids >= 0) & (ids < n)).all()):
            raise AssertionError("row ids out of range")
        if not bool((dists[:, 1:] >= dists[:, :-1]).all()):
            raise AssertionError("distances not ascending")
        decode_ms.append(serve(decode, rows)[0])
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
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gulon_tpu_torch.ops.cuda import _build, adc

    smi = _nvidia_smi()
    _emit({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    t0 = time.perf_counter()
    adc._kernel()
    ptxas = [
        line.strip() for line in _build.BUILD_INFO.get("adc_scan", (0, ""))[1].splitlines()
        if "registers" in line
    ]
    _emit({
        "phase": "build", "kernel": "adc_scan",
        "seconds": time.perf_counter() - t0,
        "library": str(_build.library_path("adc_scan").name),
        "ptxas": sorted(set(ptxas)),
    })

    k1 = phase_kernel(args.seed)
    main_path = phase_main_path(args.seed)
    if main_path["launches"] == 0:
        raise AssertionError("the main path never launched K1")
    _emit({"kernels": [{
        "name": "adc_scan", "route": "cuda",
        "source": "gulon_tpu_torch/csrc/adc_scan.cu",
        "replaces": "gulon_tpu/ops/pallas/adc.py:276",
        "launches": main_path["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
    }]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
