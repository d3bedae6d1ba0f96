#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gulon_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.
It needs one CUDA device and the CUDA toolkit (``nvcc``), and it imports
no JAX. Phases, one JSON line each (a line per case in the kernel
phases); any failure raises and the script exits non-zero:

1. device: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: ``nvcc`` builds kernel K1 (``adc_scan``), kernels K2/K3
   (``dense_scan``) and the probe kernels P1/P2 (``adc_probes``), P3
   (``kernel_probe``) and P4 (``floor_probe``) from
   ``gulon_tpu_torch/csrc``, one process each, in parallel;
3. main path: build a flat PQ index of a seeded 400,000 x 100 low-rank
   corpus on the card, answer 4 batches of 1024 top-10 queries through
   the ``auto`` strategy (which must pick the fused kernel, K1), and
   measure recall@1/@10 on 1000 sampled queries against the decode
   strategy;
4. kernel: K1 against its plain PyTorch version on the same operands at
   the glove100 shape (400,000 rows, D=100, PQ 8x256, 1024 queries), for
   1 and 2 winners per block, centered and uncentered, 4 winners
   uncentered, and once with int16 codes (K=512); at a 768-d shape
   (400,000 rows, PQ 96x256: row blocks streamed, not held decoded); at
   the gist960 shape (1,000,000 rows, D=960, PQ 25x256, 1024 queries, one
   winner, centered) on operands laid out as an index lays them
   (``K1Operands`` at its plan's width: 40 lanes a subspace,
   not 39, so K1's streamed decode gathers 8 lanes a load), its values
   within ``2^-14 * max(|v|, ||q||^2 + center)``; then at the edge shapes
   (:data:`K1_EDGE_CASES`: 1, 7, 129 and 1000 queries,
   1-4 winners centered and uncentered, depth 100, K=512 and K=1024 int16
   codes, NaN rows, an all-+inf query, IVF padding rows, depths 304 to
   1004, 4 winners uncentered on index operands at 40 lanes a subspace).
   Then the IVF selection kernel (``ivf_topk``) at both IVF cells' shapes
   (sift-128: 1,000 partitions, probe 50; deep-96: 9,990, probe 499; 1,024
   queries, 4 winners, fetch 10 and 40): bit for bit its plain twin and,
   below +inf, the masked sort over every winner column it replaces,
   each time beside the bytes it must read, the twin's and the masked sort's;
   on the IVF paths below (ivf1m's routes, the streamed IVF index, the
   command line, AOT, ivf1m sharded) it launches once a K1 launch.
   Ids >= 99.5 % equal, values within ``2^-14 * max(|v|, 1)``,
   every id mismatch a near-tie, NaN winners in the same places and rows
   (an all-+inf query's: each block's lowest row, as the plain version
   states K1's rule), and with padding rows exactly ``min(W, real rows)``
   valid winners a block, all of them real rows;
5. probes: P1-P4 (``gulon_tpu_torch.probes``), the stage-ablation probes
   of K1, and K1's own kernel cut after its decode, its contraction and
   its block minimum (``k1_stages``). Their path first, through the entry
   points, once each with the launch counts set to 0 before and read
   after: every P4 variant (``floor_probe``, the headline 401,408 x 8 int8
   codes and 1024 x 112 queries), every P3 variant (``kernel_probe``,
   400,000 -> 401,408 rows x m 8 x K 256, dsub 13, mdp 128, 1024 queries,
   t 2048), P1 / P2 (``adc_scan_probe``, top-10) in every decode mode,
   natural and piped, on the kernel phase's glove100 operands and on a
   deep768 draw (depth 772, where natural is live), and each cut of K1 on
   P3's headline operands (as K1 scores them) and on both K1 shapes. Then
   each variant against its plain version: P4 zeros, and no faster than
   its bytes over 3.35 TB/s at the headline shape and at 16x its rows; P3
   zeros exactly, else values within ``2^-14 * max(|v|, 1)``, ids >=
   99.5 % equal and every mismatch a near-tie; P1 / P2 K1's rule, and
   their decoded rows equal the plain gather bit for bit but for the sign
   of a zero (each decode also alone, ``probe_decode_rows``, timed beside
   its bound at both shapes); the cut K1
   zeros exactly after its decode, else values within ``2^-14 * max(|v|,
   1)``. Each prints its ms (the card's time of one call, queued back to
   back: ``probes.median_ms``), plain ms, bound, bytes read, K1's ms on
   the same operands and its library call (``library_ms``,
   ``library_call``): for a decode-only cut (P3's grid variants, each
   decode alone, K1 cut after its decode) one
   ``torch.nn.functional.embedding`` over the flattened codebook
   (``embedding_decode``), for a scored one the contraction's
   ``torch.matmul``; then one ``stage_split`` line: for each of K1's
   operand sets floor (P4), decode, + contraction, + block min, +
   selection (K1 whole), full; and P3's own split (its tdec stages, K1
   on its operands, the no-decode ``tdec_cached``);
6. exact path: ``build_exact_index`` of a seeded 2,000,000 x 300
   low-rank corpus on the card; 4 batches of 1024 top-10 queries through
   ``auto`` (which must pick the kernel route, K2), then with
   ``operand="int8"`` (K3) and with ``scan_strategy="xla"``; recall@1/@10
   of each on 1000 sampled queries;
7. cached path: ``enable_cache()`` on the glove100 index; ``auto`` must
   pick ``cached``; 4 batches through K2; recall against decode;
8. dense kernel: K2 and K3 against their plain versions on the same
   operands at the fasttext shape (that corpus, Dp 304 / 320, 1024
   queries drawn from it), K2 at the glove100 cache width (400,000 x 104,
   Dp 112), K2 at the edge shapes (:data:`K2_EDGE_CASES`: ragged row
   counts, 1-1000 queries, NaN rows, an operand too deep for a resident
   query tile) and K3 at its edge shapes (:data:`K3_EDGE_CASES`: ragged
   row counts down to n < 128, 1-1000 queries, Dp 32 to 1600 with every
   ragged last chunk, a 128-query tile, streamed query chunks, all-+-127
   lanes, a last block won by a padding row); K2 within ``2^-14 *
   max(|v|, ||x||^2 + ||q||^2)`` with >= 99.5 % equal ids, K3 bit for bit;
9. IVF path (ivf1m): ``build_ivf_index`` of a seeded 1,000,000 x 96
   low-rank corpus (intrinsic 24, 4096 clusters) on the card, PQ 12x256,
   the default 1000 partitions and probe limit 50; 4 batches of 1024
   top-10 queries through ``auto`` (which must pick ``pallas``, K1),
   through 2 winners with and without rescore 4, and through the masked
   scan; ``auto`` must go sublinear for 1 and 8 queries and match the
   masked scan's distances; recall@1/@10 of each route on 10,000 sampled
   queries (recall@10 >= 0.97x masked at 4 winners, >= 0.95x at 2 +
   rescore 4); then K1 at 4 winners against its plain version on the
   index's own partition-padded operands (no padding row may win); a
   second build of the same corpus must give the same padded layout,
   codes and row constants, bit for bit;
10. sharded path (deep10m, ``benchmarks/run.py:401``): a 10,000,000 x 96
   low-rank corpus (intrinsic 24, 10,000 clusters), uncut; mesh M is four
   logical shards of the one card, or every card when there are two or
   more. ``build_flat_index(mesh=M)`` (PQ 12x256, 15 iterations, sample
   200,000) twice, bit-equal, and once on one card (its codes equal on
   >= 99.99 % of rows, the rest near-ties); then the flat ``auto`` (K1
   once per shard and batch), ``cached`` (K2 once per shard) and exact
   (K2 once per shard, f32 rescore) routes, 4 batches of 1024 top-10 at
   mesh 1 and mesh M beside the single card, recall@10 on 1000 sampled
   queries >= 0.99x the single card's; K1 and K2 against their plain
   versions on one shard's operands; ivf1m (phase 9's index) sharded over
   M at 4 winners (K1 once per shard, recall >= 0.99x the single card's);
   two processes (``--mesh-child``) over a two-rank mesh, gloo with both
   on one card or NCCL with a card each, whose ids must equal one
   process's two-shard mesh;
11. k-means determinism: two ``fit_kmeans`` runs (uniform and k-means++
   init) and two PQ trainings on the same host array give the same bits;
12. CLI path (glove100, 400,000 x 100): the corpus as a word2vec binary
   file and 1,024 queries as a text file (read by the native parser);
   through ``gulon_tpu_torch.cli.main`` in process: ``build-index
   --metric cosine -m 8 -k 256 -n 25``, ``info``, ``query -k 10`` (its
   lines must equal ``load_index(...).query_arrays`` id for id), ``test
   --sample 1000`` (R@10 >= 0.97x the decode route's, as the fused
   route's), ``add-vectors`` of 1,000 new keys (each finds itself
   first), ``remove-keys`` of them (none comes back), ``build-index -p``
   (400 partitions, probe 20) and ``query``, ``build-index --opq 4`` and
   ``query`` (R@10 not below the plain build's - 0.01), ``build-index
   --exact`` and ``query``, ``query --mesh <card count>`` (the lines of
   ``query``, near-ties aside); K1 and K2 must launch from these calls. Then
   ``python3 -m gulon_tpu_torch.cli query`` in a fresh process must print
   the same lines, a ``serve --port 0`` process must answer 3 JSON
   requests (1, 8 and 1024 queries) with ``query_arrays``'s keys, and
   every ``tests/golden/*.pb`` must load on the card, serve, and save back
   to its own bytes. Build, save and load seconds, the index bytes, the
   first query after a load and the steady ms per 1024 batch are printed
   beside the card's name and power limit.

Every kernel case line carries its ms (the card's time of one call:
back-to-back calls queued behind a sleep kernel between two CUDA events,
median of 10 readings after 3 warm-ups, ``probes.median_ms``), its plain
version's (one call between two events, its host launch path included),
``bound_ms`` (the least time of
the same work on an H100: bytes over the memory rate, the contraction
over the tensor cores' peak, the selection over the CUDA cores' f32
rate, whichever is largest, named in ``bound_resource``), ``library_ms``
(one bare ``torch.matmul`` / ``torch._int_mm`` of the same operands:
the contraction only, without the selection, writing the whole score
matrix the kernels never materialise; for K1 on the operand decoded
beforehand; a decode-only probe one ``embedding``; null where
``torch._int_mm`` refuses the shape: 16 queries or fewer, a row count
not a multiple of 8; ``library_call`` names it) and ``launches_per_batch``
(launches per 1024-query batch on the path that runs that shape). Each
path is driven with the launch counts set to 0 just before it and read
just after; the comparisons of kernels with their plain versions run
after the paths and count for none of them. Each path also reports its
device time per batch by kernel (``torch.profiler`` over its 4 batches
after a warm-up).

Then a line with each kernel's launches on the paths (P1-P4: the probes'
path), error, times and bound, the raw ``nvidia-smi`` line, and last
``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

# Published dense peaks of one H100 SXM at its 700 W limit: bf16 and int8
# tensor cores, f32 outside them (FLOP/s, OP/s), and the HBM3 rate (B/s).
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
_INVALID_MIN = 1.0e38  # a block winner at/above this is padding
_ROOT = os.path.dirname(os.path.abspath(__file__))
# the library calls timed beside the kernels (``library_call``)
MATMUL_CALL = "torch.matmul(queries, decoded rows^T), contraction only"
EMBEDDING_CALL = ("torch.nn.functional.embedding(codes + s K, codebook [m K, dsub]), "
                  "the decode only")

# K1 edge shapes: (rows, D, m, K, queries, winners, centered, extra);
# extra "nan" puts NaN norm lanes on every 300th row, "infq" makes query
# 0 all +inf (NaN against every row: each block's winner is the packed
# NaN of its lowest row, K1's rule), "sentinel" gives block b only its
# first (37 b) % 129 rows and the IVF padding value 2e38 on the others;
# "index" lays the operands out as an index does (``k1_operands``). The
# last eleven are deep: m*dsub 304 (glove300's width, 5 chunks) and 688
# (11 chunks, two ring stages: the deepest row block held decoded) are
# held decoded, their codebooks gathered from global memory; 768 and 800
# (K = 1024; codebooks in global memory), 1000, 720 (dsub 1, 720 code
# rows) and 900 (codebooks in shared memory) are streamed, gathering 8, 8,
# 4, 1 and 2 lanes a load (ops/cuda/adc.py::k1_plan), 256 queries a tile;
# 960 over 25 subspaces of 39 and 38 lanes, on index operands, at 4
# winners uncentered (the IVF form), streams at 40 lanes a subspace on the
# card (the plan's width: depth 1,004, codebooks in global memory, 8 lanes
# a load). Past one 256-query tile: gist's layout at 300 queries (the
# second tile ragged, its second warpgroup's 128 queries wholly past the
# batch) and 768 at 513 (three tiles, the last holding one query); 800
# over 100 at K = 80 keeps its 128 KB of codebooks in shared memory and
# so streams 128 queries a tile.
K1_EDGE_CASES = (
    (8192, 24, 4, 16, 1, 1, True, None),
    (8192, 24, 4, 16, 7, 2, False, None),
    (8192, 24, 4, 16, 129, 4, True, None),
    (16384, 100, 12, 256, 129, 3, True, None),
    (9216, 60, 6, 256, 300, 1, True, None),
    (9216, 60, 6, 256, 7, 3, False, None),
    (16384, 100, 8, 512, 1000, 4, False, None),
    (16384, 96, 12, 1024, 100, 2, True, None),
    (16384, 96, 12, 256, 200, 4, False, "nan"),
    (16384, 96, 12, 256, 40, 2, True, "infq"),
    (16384, 96, 12, 256, 1000, 4, False, "sentinel"),
    (16384, 300, 19, 256, 129, 2, True, None),
    (8192, 688, 8, 256, 200, 2, False, None),
    (16384, 768, 96, 256, 129, 4, False, "sentinel"),
    (8192, 1000, 250, 16, 7, 1, False, None),
    (4096, 800, 100, 1024, 33, 3, True, None),
    (4096, 720, 720, 16, 130, 1, True, None),
    (4096, 900, 90, 64, 65, 2, False, None),
    (16384, 960, 25, 256, 129, 4, False, "index"),
    (4096, 960, 25, 256, 300, 1, True, "index"),
    (4096, 768, 96, 256, 513, 3, False, None),
    (4096, 800, 100, 80, 129, 2, True, None),
)
# K2 edge shapes: (rows, D, queries, NaN rows); D = 1022 is too deep for
# a resident query tile and streams the query chunks beside the rows.
K2_EDGE_CASES = (
    (8192, 30, 24, False),
    (9000, 102, 200, True),
    (40001, 300, 130, False),
    (1000, 110, 1, False),
    (5000, 300, 7, True),
    (3000, 1022, 129, False),
    (70000, 100, 1000, False),
)
# K3 edge shapes: (rows, Dp, queries, lanes). Dp picks the instantiation:
# 32 / 96 / 352 a ragged last chunk of 1 / 3 / 3 k-steps, 256 none, 320
# (the fasttext depth) 2; 1024 and 1120 drop to a 128-query tile (1120
# ragged); 1600 streams the query chunks. Lanes: None uniform in
# [-127, 127]; "pm127" every lane +-127, and row r of the corpus the
# negation of query r, so that query scores -127^2 Dp there, the int32
# extreme of the depth; "wild" the last block's real rows all score above
# 16255, so a padding row wins it (the JAX padding rule).
K3_EDGE_CASES = (
    (8192, 32, 24, None),
    (1000, 320, 1, None),
    (100, 320, 7, None),
    (40001, 352, 129, None),
    (20000, 96, 1000, None),
    (20000, 256, 300, None),
    (9000, 320, 1000, "pm127"),
    (5000, 320, 200, "wild"),
    (3000, 1024, 129, None),
    (2000, 1120, 33, None),
    (3000, 1600, 130, None),
)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _kernel_ms(fn) -> float:
    """Device ms of one call of a kernel or a library call
    (``probes.median_ms``: back-to-back calls queued behind a sleep, median
    of 10 readings after 3 warm-ups)."""
    from gulon_tpu_torch.probes import median_ms

    return median_ms(fn)


def _plain_ms(fn) -> float:
    """ms of one call of a plain version, its host launch path included
    (``probes.median_ms(queued=False)``: one call between two CUDA events,
    median of 10 after 3 warm-ups)."""
    from gulon_tpu_torch.probes import median_ms

    return median_ms(fn, queued=False)


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


# ---- bounds -----------------------------------------------------------------


def bound(bytes_moved: float, mma_ops: float, mma_type: str, select_ops: float,
          more_mma=None) -> dict:
    """Least time of a kernel's work on an H100: the largest of its bytes
    (each input read once, the output written once) over the memory rate,
    its contraction over the tensor cores' peak for ``mma_type`` (plus
    ``more_mma``, ``{type: ops}`` of other tensor-core work, in turn) and
    its selection over the CUDA cores' f32 rate, each counted from the
    shapes of this run's inputs."""
    more = more_mma or {}
    tensor = (mma_ops / PEAK[mma_type] + sum(o / PEAK[t] for t, o in more.items())) * 1e3
    parts = {
        "HBM bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
        f"tensor cores ({'+'.join([mma_type, *more])})": tensor,
        "CUDA cores (selection)": select_ops / PEAK["f32"] * 1e3,
    }
    resource = max(parts, key=parts.get)
    return dict(
        bound_ms=parts[resource],
        bound_by="bytes" if resource == "HBM bytes" else "operations",
        bound_resource=resource, bound_parts_ms=parts,
    )


def _select_ops(pairs: int, winners: int) -> int:
    """CUDA-core operations of the lane-packed selection: per (row, query)
    pair a pack and a min per winner, and a compare and a select per
    extra winner."""
    return pairs * (3 * winners - 1)


def k1_bound(operands, winners: int) -> dict:
    """K1: the codes, norm lanes, queries and codebooks in, the packed
    winners out; ``2 * depth`` bf16 operations per (row, query) pair."""
    codes_t, norms_hl, q_op, cb = operands
    m, n_cols = codes_t.shape
    _, _, dsub = cb.shape
    q_n = q_op.shape[0]
    moved = sum(t.numel() * t.element_size() for t in operands)
    moved += q_n * (n_cols // 128) * winners * 4
    pairs = n_cols * q_n
    return bound(moved, 2 * pairs * (m * dsub + 4), "bf16", _select_ops(pairs, winners))


def dense_bound(data, q_op) -> dict:
    """K2 (bf16) / K3 (int8): rows and queries in, ``[Q, ceil(N/128)]``
    winners out; ``2 * Dp`` operations per (row, query) pair."""
    n, dp = data.shape
    q_n = q_op.shape[0]
    moved = (data.numel() + q_op.numel()) * data.element_size() + q_n * -(-n // 128) * 4
    kind = "int8" if data.element_size() == 1 else "bf16"
    return bound(moved, 2 * n * q_n * dp, kind, _select_ops(n * q_n, 1))


# ---- comparisons ----------------------------------------------------------


def compare_packed(got, ref, scale=None) -> dict:
    """Lane-packed block winners of a kernel against its plain version:
    ids >= 99.5 % equal; every value within ``2^-14 * max(|v|, S)`` (S = 1,
    or ``max(scale, 1)`` per winner), so each id mismatch is a near-tie;
    NaN winners in the same places and on the same rows. How many values
    miss ``2^-14 * max(|v|, 1)`` is reported as ``outside_value_tol``."""
    import torch

    bk, bp = got.view(torch.int32), ref.view(torch.int32)
    vk, vp = (bk & ~127).view(torch.float32), (bp & ~127).view(torch.float32)
    ik, ip = bk & 127, bp & 127
    nan_k, nan_p = torch.isnan(vk), torch.isnan(vp)
    floor = torch.ones_like(vp) if scale is None else torch.clamp(scale, min=1.0)
    tol = 2.0 ** -14 * torch.maximum(vp.abs(), floor)
    err = (vk - vp).abs()
    num = ~nan_p
    mism = (ik != ip) & num
    nan_same = bool(torch.equal(nan_k, nan_p)) and bool(torch.equal(ik[nan_p], ip[nan_p]))
    real = num & (vp.abs() < _INVALID_MIN)
    case = dict(
        id_equal=float((ik == ip).float().mean()),
        values_ok=bool((err[num] <= tol[num]).all()),
        ties_ok=bool((err[mism] <= tol[mism]).all()),
        nan_winners=int(nan_p.sum()), nan_same=nan_same,
        max_abs_err=float(err[real].max()) if bool(real.any()) else 0.0,
        outside_value_tol=int(
            (err[num] > 2.0 ** -14 * torch.clamp(vp[num].abs(), min=1.0)).sum()
        ),
        values=err.numel(),
    )
    case["ok"] = (
        case["id_equal"] >= 0.995 and case["values_ok"] and case["ties_ok"] and nan_same
    )
    return case


def winners_valid(packed, real, winners: int, nblk: int) -> bool:
    """Block b yields exactly ``min(W, real[b])`` winners below the padding
    value, and each is one of its real rows, the first ``real[b]``."""
    import torch

    from gulon_tpu_torch.ops.cuda import adc

    block, rank = adc._winner_blocks(packed.shape[1], winners, nblk, packed.device)
    bits = packed.view(torch.int32)
    valid = (bits & ~127).view(torch.float32) < _INVALID_MIN
    if not torch.equal(valid, (rank < real[block])[None, :].expand_as(valid)):
        return False
    rows = (bits & 127).long()
    return bool((rows < real[block][None, :])[valid].all())


# ---- operands ---------------------------------------------------------------


def k1_inputs(gen, n, d, m, k_codes, q_n, extra=None, *, dev) -> dict:
    """Seeded random inputs of a fused scan: bf16-snapped codebooks with
    zero-padded subspaces, uniform codes, their reconstruction norms
    (``extra == "sentinel"``: see :data:`K1_EDGE_CASES`) and queries."""
    import torch

    from gulon_tpu_torch.ops.pq import subspace_bounds

    bounds = subspace_bounds(d, m)
    dsub = max(w for _, w in bounds)
    cb = torch.randn((m, k_codes, dsub), generator=gen, device=dev)
    for s, (_, w) in enumerate(bounds):
        cb[s, :, w:] = 0.0
    cb = cb.to(torch.bfloat16).to(torch.float32)
    codes = torch.randint(0, k_codes, (n, m), generator=gen, device=dev)
    norms = (cb[torch.arange(m, device=dev)[None], codes] ** 2).sum((1, 2))
    if extra == "sentinel":
        keep = (37 * torch.arange(n // 128, device=dev)) % 129
        pad = torch.arange(128, device=dev)[None, :] >= keep[:, None]
        norms = torch.where(pad.reshape(-1), torch.full_like(norms, 2e38), norms)
    queries = torch.randn((q_n, d), generator=gen, device=dev)
    if extra == "infq":
        queries[0] = float("inf")
    return dict(queries=queries, codebooks=cb, codes=codes, recon_norms=norms, bounds=bounds)


def k1_operands(gen, n, d, m, k_codes, q_n, winners, centered, extra=None, *, dev):
    """Seeded random K1 operands ``(operands, nblk, real rows per block or
    None)``; ``extra`` as :data:`K1_EDGE_CASES`. At the codebooks' own
    subspace width; with ``extra == "index"`` as an index holds them
    (``K1Operands``), at the width K1's plan gives on the card
    (``k1_plan``'s ``width``: 40 lanes at 960 over 25 subspaces) and at the
    own width elsewhere."""
    import torch

    from gulon_tpu_torch.ops.cuda import adc

    raw = k1_inputs(gen, n, d, m, k_codes, q_n, extra, dev=dev)
    k1 = adc.K1Operands(
        raw["codebooks"], adc.pack_codes_t(raw["codes"], k_codes), raw["recon_norms"],
        bounds=raw["bounds"], num_rows=n, center_scores=centered,
        _own_width=extra != "index",
    )
    operands, nblk = k1.operands(raw["queries"], winners=winners)
    if extra == "nan":
        operands[1][0, 3::300] = float("nan")
    real = None
    if extra == "sentinel":
        valid = raw["recon_norms"] < _INVALID_MIN
        real = torch.nn.functional.pad(valid, (0, k1.codes_t.shape[1] - n)).view(-1, 128).sum(1)
    return operands, nblk, real


def dense_queries(q, dp: int):
    """K2's query operand: ``-2q``, zero pad, and two ones facing the
    rows' hi/lo norm lanes."""
    import torch

    n, d = q.shape
    return torch.cat(
        [-2.0 * q, torch.zeros((n, dp - d - 2), device=q.device),
         torch.ones((n, 2), device=q.device)], dim=1,
    ).to(torch.bfloat16)


def dense_scale(data, q_op, ref):
    """``||x||^2 + ||q||^2`` of each plain winner row and query: the scale
    of K2's f32 partial sums (the score ``||x||^2 - 2<x, q>`` cancels
    toward 0, two summation orders differ by a fraction of the summands)."""
    import torch

    ip = ref.view(torch.int32) & 127
    rows = torch.clamp(
        torch.arange(ref.shape[1], device=ref.device)[None, :] * 128 + ip,
        max=data.shape[0] - 1,
    ).long()
    x_norm = data[:, -2].float() + data[:, -1].float()  # hi + lo lanes
    q_norm = (q_op[:, :-2].float() ** 2).sum(1) / 4.0  # lanes hold -2q
    return x_norm[rows] + q_norm[:, None]


def k2_operands(gen, n, d, q_n, nan, *, dev):
    """Seeded random K2 operands ``(rows, queries)``; NaN in a data lane of
    every 257th row when ``nan``."""
    import torch

    from gulon_tpu_torch.ops.cuda import dense

    x = torch.randn((n, d), generator=gen, device=dev)
    q = torch.randn((q_n, d), generator=gen, device=dev)
    data = dense.prepare_data(x)
    if nan:
        data[::257, 3] = float("nan")
    return data, dense_queries(q, data.shape[1])


def k3_operands(gen, n, dp, q_n, lanes, *, dev):
    """Seeded random K3 operands ``(rows, queries)``, int8 ``[*, dp]``,
    with lanes as :data:`K3_EDGE_CASES` describes; in the "wild" case the
    queries' lanes are positive and the last block's real rows all 127,
    so those rows score at least 127 Dp."""
    import torch

    def draw(rows, low=-127):
        if lanes == "pm127":
            bits = torch.randint(0, 2, (rows, dp), generator=gen, device=dev)
            return (bits * 254 - 127).to(torch.int8)
        return torch.randint(low, 128, (rows, dp), generator=gen, device=dev).to(torch.int8)

    data = draw(n)
    q_op = draw(q_n, low=1 if lanes == "wild" else -127)
    if lanes == "wild":
        data[(n - 1) // 128 * 128:] = 127
    if lanes == "pm127":
        m = min(n, q_n)
        data[:m] = -q_op[:m]
    return data, q_op


def centered_scale(operands):
    """``||q||^2 + center`` of each query, from the two lanes of K1's
    query operand that face the rows of ones (0 uncentered): the size of
    the terms a centered score sums, so the scale of its rounding."""
    _, _, q_op, cb = operands
    md = cb.shape[0] * cb.shape[2]
    return q_op[:, md + 2].float() + q_op[:, md + 3].float()


def k1_decoded(operands):
    """K1's row operand decoded once, ``[N', q width]`` bf16 (codewords,
    hi/lo norm lanes, two ones, zero pad): what a bare matmul against the
    queries contracts."""
    from gulon_tpu_torch.probes.adc_probes import _decode_rows_plain

    codes_t, norms_hl, q_op, cb = operands
    return _decode_rows_plain(codes_t, norms_hl, cb, q_op.shape[1])


# ---- kernel cases -----------------------------------------------------------


def _k1_case(label, operands, winners, nblk, real, launches_per_batch,
             scale_of=None) -> dict:
    """One K1 case on the card: kernel against plain (``scale_of(ref)``,
    when given, is each winner's summand scale for :func:`compare_packed`),
    times, bound and the contraction-only matmul."""
    import torch

    from gulon_tpu_torch.ops.cuda import adc

    got = adc.fused_block_scan(*operands, winners=winners, nblk=nblk)
    torch.cuda.synchronize()
    ref = adc._block_scan_plain(*operands, winners=winners, nblk=nblk)
    codes_t, _, q_op, cb = operands
    m, n_cols = codes_t.shape
    case = dict(
        case=label, winners=winners, shape=[q_op.shape[0], n_cols, m * cb.shape[2]],
        k_codes=cb.shape[1], code_dtype=str(codes_t.dtype).replace("torch.", ""),
        **compare_packed(got, ref, None if scale_of is None else scale_of(ref)),
    )
    if real is not None:
        case["winners_valid"] = winners_valid(got, real, winners, nblk) and winners_valid(
            ref, real, winners, nblk
        )
        case["ok"] = case["ok"] and case["winners_valid"]
    del got, ref
    dec = k1_decoded(operands)
    case.update(
        ms=_kernel_ms(lambda: adc.fused_block_scan(*operands, winners=winners, nblk=nblk)),
        plain_ms=_plain_ms(lambda: adc._block_scan_plain(*operands, winners=winners, nblk=nblk)),
        library_ms=_kernel_ms(lambda: torch.matmul(q_op, dec.T)),
        library_call=MATMUL_CALL,
        launches_per_batch=launches_per_batch, **k1_bound(operands, winners),
    )
    return case


def phase_kernel(seed: int, launches_per_batch: float) -> dict:
    """K1 against its plain version at the glove100, deep768 and gist960
    shapes, then at the edge shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = []
    glove = [(400_000, 100, 8, k_codes, 1024, w, c, None) for k_codes, w, c in (
        (256, 1, True), (256, 1, False), (256, 2, True), (256, 2, False),
        (512, 1, True), (256, 4, False),
    )]
    # a 768-d corpus at PQ 96x256: a row block too deep to hold decoded
    deep = (400_000, 768, 96, 256, 1024, 1, True, None)
    # gist-960's flat index: streamed at 40 lanes a subspace (39 own)
    gist = (1_000_000, 960, 25, 256, 1024, 1, True, "index")
    for label, spec in (
        [("glove100", s) for s in glove] + [("deep768", deep), ("gist960", gist)]
        + [("edge", s) for s in K1_EDGE_CASES]
    ):
        operands, nblk, real = k1_operands(gen, *spec, dev="cuda")
        # a centered score sums terms of about ||q||^2 + center each
        scale_of = None
        if label == "gist960":
            def scale_of(ref):
                return centered_scale(operands)[:, None].expand_as(ref)
        case = _k1_case(
            label, operands, spec[5], nblk, real,
            launches_per_batch if label == "glove100" else None, scale_of,
        )
        case.update(centered=spec[6], extra=spec[7])
        _emit({"phase": "kernel", **case})
        if not case["ok"]:
            raise AssertionError(f"K1 disagrees with its plain version: {case}")
        cases.append(case)
    return cases[0] | {"max_abs_err": max(c["max_abs_err"] for c in cases)}


# ---- the IVF selection (ivf_topk) ---------------------------------------------

# The two IVF cells' shapes: (partitions, probe, rows, smallest and largest
# partition in rows, K1's subspace width). deep-96's partitions are its cell's (351-5,109 rows,
# median 927); sift-128's are drawn alike around its mean of 1,000.
IVF_TOPK_SHAPES = {
    "sift128": (1000, 50, 1_000_000, 200, 4000, 6),
    "deep96": (9990, 499, 9_990_000, 351, 5109, 4),
}
IVF_TOPK_MASKED_CALL = ("the masked sort: probe mask and group term gathered onto every "
                        "winner column, torch.where, stable torch.sort over all of them")


def masked_ivf_select(packed, base_cols, group_term, qn, probe_mask, blk_part, fetch):
    """The IVF selection as the route ran it before ``ivf_topk``: every
    winner column masked and sorted; the oracle of this smoke and of
    ``tests/test_torch_ivf_select.py``."""
    import torch

    from gulon_tpu_torch.ops.cuda.adc import unpack_block_winners
    from gulon_tpu_torch.ops.topk import smallest_k_nan_last

    bv, _ = unpack_block_winners(packed, base_cols)
    col_part = blk_part[torch.clamp(base_cols.long() // 128, max=blk_part.shape[0] - 1)]
    valid = (bv < _INVALID_MIN) & probe_mask[:, col_part]
    d = torch.where(valid, bv + group_term[:, col_part] + qn[:, None], float("inf"))
    return smallest_k_nan_last(d, fetch)


def _ivf_topk_operands(seed: int, shape: str, num_q: int = 1024, winners: int = 4,
                       device: str = "cuda"):
    """Selection operands at an IVF cell's shape on the card: the
    partition-padded layout of lognormal partition sizes (``partition_layout``
    over one code row), K1's winner columns at its 1,024-query row tile
    (random distances with lane bits, padding rows invalid), group terms,
    query norms and a ``LimitGroups`` probe mask of random centroid
    distances."""
    import numpy as np
    import torch

    from gulon_tpu_torch.models.ivf import _probe_mask_limit_groups, partition_layout
    from gulon_tpu_torch.ops.cuda.adc import _base_cols, block_layout, padded_depth

    num_p, probe, rows, low, high, dsub = IVF_TOPK_SHAPES[shape]
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.normal(0.0, 0.45, num_p))
    sizes = np.clip(np.round(sizes * rows / sizes.sum()), low, high).astype(np.int64)
    n = int(sizes.sum())
    codes = torch.zeros((n, 1), dtype=torch.uint8, device=device)
    rc = torch.zeros(n, device=device)
    _, _, blocks, _ = partition_layout(codes, rc, sizes, np.arange(num_p), 256,
                                       num_parts=num_p)
    nbp = blocks.blk_part.shape[0]
    _, t, _, nblk = block_layout(num_q, 256, padded_depth(25, dsub), nbp * 128, 0, winners)
    base_cols = _base_cols(-(-nbp * 128 // t) * t, t, winners, device)
    nw = base_cols.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((num_q, nw), generator=gen, device=device).abs()
    v[:, base_cols.long() // 128 >= blocks.real_blocks] = 2.0e38
    lanes = torch.randint(0, 128, (num_q, nw), generator=gen, device=device, dtype=torch.int32)
    packed = ((v.view(torch.int32) & ~127) | lanes).view(torch.float32)
    gt = torch.randn((num_q, num_p), generator=gen, device=device)
    qn = torch.rand(num_q, generator=gen, device=device) + 1.0
    cdist = torch.randn((num_q, num_p), generator=gen, device=device)
    mask = _probe_mask_limit_groups(cdist, probe)
    return dict(packed=packed, base_cols=base_cols, gt=gt, qn=qn, mask=mask, blocks=blocks,
                nblk=nblk, probe=probe, sizes=sizes)


def phase_ivf_topk(seed: int, smi: str) -> dict:
    """The IVF selection kernel at both IVF cells' shapes (1,024 queries,
    4 winners a block, fetch 10 and 40): kernel and plain twin bit for bit
    (values and columns), and against the masked sort it replaces
    (values; columns where it ranks below +inf); the kernel's ms beside
    its bound (the bytes it must read: each probed winner column, the
    mask row, the probed partitions' group terms and ranges, the query
    norm, the output), the plain twin's ms and the masked sort's
    (``library_ms``)."""
    import torch

    from gulon_tpu_torch.ops.cuda import ivf_topk
    from gulon_tpu_torch.utils import tracing

    out = {}
    for shape in IVF_TOPK_SHAPES:
        ops = _ivf_topk_operands(seed, shape)
        blocks = ops["blocks"]
        args = (ops["packed"], ops["gt"], ops["qn"], ops["mask"], blocks.ranges,
                blocks.blk_part, blocks.real_blocks)
        num_q, nw = ops["packed"].shape
        col_part = ivf_topk.column_partitions(blocks.ranges, blocks.blk_part,
                                              blocks.real_blocks, nw, 4, ops["nblk"])
        probed_cols = int(ops["mask"][:, col_part].sum())
        probed_parts = int(ops["mask"].sum())
        for fetch in (10, 40):
            kw = dict(winners=4, nblk=ops["nblk"], fetch=fetch)

            def kernel():
                return ivf_topk.ivf_select(*args, **kw)

            def plain():
                return ivf_topk._select_plain(*args, **kw)

            def masked():
                return masked_ivf_select(ops["packed"], ops["base_cols"], ops["gt"], ops["qn"],
                                         ops["mask"], blocks.blk_part, fetch)

            tracing.set_counter("ivf.topk.launches", 0)
            got, ref, old = kernel(), plain(), masked()
            torch.cuda.synchronize()
            launches = tracing.counter("ivf.topk.launches")
            same_twin = (torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
                         and torch.equal(got[1], ref[1]))
            named = ~torch.isposinf(old[0])
            same_masked = (torch.equal(got[0].view(torch.int32), old[0].view(torch.int32))
                           and torch.equal(got[1][named], old[1][named]))
            bytes_read = (probed_cols * 4 + num_q * ops["mask"].shape[1] + probed_parts * 12
                          + num_q * 4 + num_q * fetch * 8)
            case = dict(
                phase="ivf_topk", shape=shape, queries=num_q, partitions=ops["mask"].shape[1],
                probe=ops["probe"], winner_columns=nw, nblk=ops["nblk"], fetch=fetch,
                probed_columns_per_query=probed_cols / num_q,
                column_bound=blocks.column_bound(("groups", ops["probe"]), 4, nw),
                rows=int(ops["sizes"].sum()), padded_rows=int(blocks.blk_part.shape[0]) * 128,
                plan=ivf_topk.topk_plan(fetch), launches=launches, equal_to_twin=same_twin,
                equal_to_masked_sort=same_masked, bytes_read=bytes_read,
                ms=_kernel_ms(kernel), plain_ms=_plain_ms(plain),
                bound_ms=bytes_read / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bound_resource="HBM", library_ms=_kernel_ms(masked),
                library_call=IVF_TOPK_MASKED_CALL, card=smi,
            )
            _emit(case)
            if not (same_twin and same_masked and launches == 1):
                raise AssertionError(f"the IVF selection kernel disagrees: {case}")
            out[f"{shape}_fetch{fetch}"] = case
        del ops, args
        torch.cuda.empty_cache()
    return out


# ---- probes (P1-P4) -----------------------------------------------------------

# P1 and P2 on the kernel phase's glove100 operands (its first case, drawn
# from the same seed) and on operands drawn as its deep768 case: depth 772,
# where natural is live; every decode mode in both orientations (P1) and
# piped (P2). glove100's depth (108) drops natural, so those requests
# resolve to the base orientation and run once.
PROBE_SHAPES = {
    "glove100": (400_000, 100, 8, 256, 1024),
    "deep768": (400_000, 768, 96, 256, 1024),
}
PROBE_REQUESTS = [(mode, natural, False) for mode in ("take", "base", "bf16cmp")
                  for natural in (False, True)] + [
    (mode, False, True) for mode in ("take", "base", "bf16cmp")]
# P3's stages, from the floor up (P4, then P3's tdec stages): P3's own split
P3_STAGES = (("floor", "codes+q, out v only [32]"), ("decode_only", "tdec_grid"),
             ("contraction", "tdec_noselect"), ("block_min", "tdec_min"),
             ("selection", "tdec_packed"))
# P4's loads check runs it at 16x the headline rows, where its bytes
# outweigh the launch
P4_LOADS_SCALE = 16


def _ms_pair(fn, plain_fn) -> dict:
    return dict(ms=_kernel_ms(fn), plain_ms=_plain_ms(plain_fn))


def p3_bound(variant, operands, prepared_bytes: int) -> dict:
    """P3's work: its operands read once (``prepared_bytes``: the code,
    codebook or decoded operand it reads), vals and ids written; the
    one-hot decode (2 m K dsub operations a row, bf16, s8 for tdec_i8), the
    contraction (2 m dsub a row and query: the lanes past m dsub up to mdp
    are zeros, no work of the function) and the selection (1 a pair for a
    minimum, 3 for a minimum and its row) as far as its stage goes."""
    from gulon_tpu_torch.probes import kernel_probe as kp

    stage, impl, _ = kp.spec(variant)
    codes_t, norms, q_pad, cb = operands
    m, npad = codes_t.shape
    _, k_codes, dsub = cb.shape
    num_q = q_pad.shape[0]
    out = 2 * npad // 128 * num_q * 4
    level = ("noop", "grid", "noselect", "min", "match", "packed").index(stage)
    decode = 0 if level == 0 or impl == "cached" else 2 * npad * m * k_codes * dsub
    scored = level >= 2
    moved = out + (prepared_bytes if level else 0) + (
        norms.numel() * 4 + q_pad.numel() * 2 if scored else 0)
    select = npad * num_q * {3: 1, 4: 3, 5: 3}.get(level, 0)
    contraction = 2 * npad * num_q * m * dsub
    if impl == "i8":
        case = bound(moved, contraction, "bf16", select, more_mma={"int8": decode})
    else:
        case = bound(moved, decode + (contraction if scored else 0), "bf16", select)
    return dict(case, bytes_read=moved - out)


def k1_stage_bound(operands, stage: str) -> dict:
    """K1 cut after ``stage`` (``probes.k1_stages``): the codes, norm lanes
    and codebooks in (and the queries once it contracts), ``[Q, N'/128]``
    f32 out; ``2 (m dsub + 4)`` bf16 operations a (row, query) pair from
    the contraction on, 1 a pair for the block minimum."""
    codes_t, norms_hl, q_op, cb = operands
    m, n_cols = codes_t.shape
    dsub = cb.shape[2]
    q_n = q_op.shape[0]
    level = ("decode", "contraction", "block_min").index(stage)
    moved = sum(t.numel() * t.element_size() for t in (codes_t, norms_hl, cb))
    moved += q_n * (n_cols // 128) * 4 + (q_op.numel() * 2 if level else 0)
    pairs = n_cols * q_n
    return dict(bound(moved, 2 * pairs * (m * dsub + 4) if level else 0, "bf16",
                      pairs if level == 2 else 0), bytes_read=moved - q_n * (n_cols // 128) * 4)


def embedding_decode(codes_t, cb):
    """The library call that decodes rows, for ``library_ms``: one
    ``torch.nn.functional.embedding`` over the codebook flattened to ``[m
    K, dsub]``, each subspace's codes offset by ``s K`` (prepared here,
    outside the timed call), ``[N', m, dsub]`` out. Offset int8 codes are
    K1's (code - 128). No path of the port calls it."""
    import torch

    m, k_codes, dsub = cb.shape
    c = codes_t.to(torch.int64) + (128 if codes_t.dtype == torch.int8 else 0)
    idx = (c.clamp(0, k_codes - 1)
           + k_codes * torch.arange(m, device=c.device)[:, None]).T.contiguous()
    flat = cb.reshape(m * k_codes, dsub).contiguous()
    return lambda: torch.nn.functional.embedding(idx, flat)


def _library(fn, call) -> dict:
    """``library_ms`` (the device ms of ``fn``) and ``library_call``."""
    return dict(library_ms=_kernel_ms(fn), library_call=call)


def _p3_library(variant, p3_ops, dec) -> dict:
    """The library call beside a P3 variant: none for noop; the decode
    (``embedding_decode``) for the decode-only cuts; the contraction
    (``torch.matmul`` of the queries and ``dec``, the decoded rows the
    variant scores: tdec_i8's s8-decoded ones) for the scored stages."""
    import torch

    from gulon_tpu_torch.probes import kernel_probe as kp

    stage, impl, _ = kp.spec(variant)
    if stage == "noop":
        return dict(library_ms=None, library_call=None)
    if stage == "grid":
        return _library(embedding_decode(p3_ops[0], p3_ops[3]), EMBEDDING_CALL)
    call = MATMUL_CALL + (" (the s8-decoded rows)" if impl == "i8" else "")
    return _library(lambda: torch.matmul(p3_ops[2], dec.T), call)


def _p3_check(variant, got, ref, dec, norms, q_pad) -> dict:
    """P3 against its plain version: zeros exactly; else values within
    ``2^-14 * max(|v|, 1)``, ids >= 99.5 % equal, and the kernel's row at
    each id mismatch scoring within that tolerance of the plain minimum."""
    import torch

    (vals, ids), (rv, ri) = got, ref
    if not bool(rv.any()) and not bool(ri.any()):
        ok = not bool(vals.any()) and not bool(ids.any())
        return dict(ok=ok, exact=True, max_abs_err=0.0, id_equal=1.0)
    tol = 2.0 ** -14 * torch.clamp(rv.abs(), min=1.0)
    err = (vals - rv).abs()
    mism = torch.nonzero(ids != ri)
    ties_ok = True
    if len(mism):
        rows = ids[mism[:, 0], mism[:, 1]].long()
        qs = mism[:, 1]
        score = norms[0, rows] - 2.0 * (dec[rows].float() * q_pad[qs].float()).sum(1)
        ties_ok = bool(((score - rv[mism[:, 0], mism[:, 1]]).abs()
                        <= tol[mism[:, 0], mism[:, 1]]).all())
    case = dict(values_ok=bool((err <= tol).all()), id_equal=float((ids == ri).float().mean()),
                id_mismatches=len(mism), ties_ok=ties_ok, max_abs_err=float(err.max()),
                exact=False)
    case["ok"] = case["values_ok"] and case["id_equal"] >= 0.995 and ties_ok
    return case


def _k1_stage_check(stage, got, ref) -> dict:
    """A cut K1 against its plain version: zeros exactly after the decode;
    else NaN in the same places and every other value within ``2^-14 *
    max(|v|, 1)`` (K1's rule on its scores)."""
    import torch

    if stage == "decode":
        return dict(ok=bool(torch.equal(got, ref)), exact=True, max_abs_err=0.0)
    nan = torch.isnan(ref)
    err = (got - ref).abs()[~nan]
    ok = bool(torch.equal(torch.isnan(got), nan)) and bool(
        (err <= 2.0 ** -14 * torch.clamp(ref[~nan].abs(), min=1.0)).all())
    return dict(ok=ok, exact=False, max_abs_err=float(err.max()) if err.numel() else 0.0,
                nan_values=int(nan.sum()))


def k1_on_p3_operands(codes_t, norms, q_pad, cb):
    """K1's operands holding P3's scores: offset int8 codes, the norm row's hi/lo split facing two unit lanes, and ``-2 q``
    over the codeword lanes (exact in bf16), uncentered, so K1 scores
    ``norms - 2 <q, dec(row)>`` as P3 does."""
    import torch

    from gulon_tpu_torch.ops.cuda import adc

    m, npad = codes_t.shape
    dsub = cb.shape[2]
    k1 = adc.K1Operands(
        cb, (codes_t - 128).to(torch.int8), norms[0],
        bounds=[(s * dsub, dsub) for s in range(m)], num_rows=npad, _own_width=True,
    )
    return k1.operands(q_pad[:, : m * dsub])[0]


def _probe_path(shapes, p3_ops, p4_ops, stage_ops) -> dict:
    """The probes' path, through the entry points a user calls: each P4
    variant, each P3 variant at the headline shape, each P1 / P2 request on
    both shapes and each cut of K1 on each of its operand sets, once, with
    the launch counts set to 0 before and read after. Returns the counts
    and the modes each request ran."""
    import torch

    from gulon_tpu_torch.probes import (adc_probes as ap, floor_probe as fp,
                                        k1_stages as ks, kernel_probe as kp)
    from gulon_tpu_torch.utils import tracing

    names = {"P1": "p1", "P2": "p2", "P3": "p3", "P4": "p4", "K1 stages": "k1_stages"}
    for name in names.values():
        tracing.set_counter(f"probe.{name}.launches", 0)
    resolved = {}
    for variant in fp.VARIANTS:
        fp.floor_probe(variant, *p4_ops)
    for variant in kp.VARIANTS:
        kp.kernel_probe(variant, *p3_ops)
    for label, raw in shapes.items():
        for mode, natural, pipe in PROBE_REQUESTS:
            ran = {}
            ap.adc_scan_probe(**raw, k=10, center_scores=True, decode_mode=mode,
                              natural=natural, pipe=pipe, resolved=ran)
            resolved[(label, mode, natural, pipe)] = ran
    for operands, nblk in stage_ops.values():
        for stage in ks.STAGES:
            ks.k1_stage_scan(*operands, stage=stage, nblk=nblk)
    torch.cuda.synchronize()
    return dict(
        launches={label: tracing.counter(f"probe.{name}.launches")
                  for label, name in names.items()},
        resolved=resolved,
    )


def _p4_cases(p4_ops) -> dict:
    """Each P4 variant against its zeros, timed back to back over rotated
    operands at the headline shape; then at ``P4_LOADS_SCALE`` times its
    rows, where it may be no faster than its bytes over the memory rate
    (a kernel that dropped its loads would be)."""
    import torch

    from gulon_tpu_torch.probes import floor_probe as fp

    out = {}
    big = fp.floor_operands(n=fp.HEADLINE["n"] * P4_LOADS_SCALE)
    for variant in fp.VARIANTS:
        got = fp.floor_probe(variant, *p4_ops)
        moved = fp.bytes_moved(variant, *p4_ops)
        case = dict(
            ok=all(bool((g == 0).all()) for g in got), bytes_read=moved["read"],
            bytes_written=moved["written"], max_abs_err=0.0,
            ms=_kernel_ms(fp.rotated(variant, *p4_ops)),
            plain_ms=_plain_ms(lambda: fp.plain(variant, *p4_ops)),
            **bound(moved["read"] + moved["written"], 0, "bf16", 0), library_ms=None,
        )
        del got
        big_moved = fp.bytes_moved(variant, *big)
        big_ms = _kernel_ms(fp.rotated(variant, *big, copies=2, kept=2))
        big_bound = (big_moved["read"] + big_moved["written"]) / HBM_BYTES_PER_S * 1e3
        case["loads_check"] = dict(
            rows=big[0].shape[1], bytes_read=big_moved["read"],
            bytes_written=big_moved["written"], ms=big_ms, bytes_ms=big_bound,
            no_faster_than_bytes=big_ms >= big_bound,
        )
        case["no_faster_than_bytes"] = (case["ms"] >= case["bound_parts_ms"]["HBM bytes"]
                                        and big_ms >= big_bound)
        case["ok"] = case["ok"] and case["no_faster_than_bytes"]
        _emit({"phase": "probes", "kernel": "P4", "variant": variant, **case})
        if not case["ok"]:
            raise AssertionError(f"P4 {variant} failed: {case}")
        out[variant] = case
        torch.cuda.empty_cache()
    return out


def _k1_stage_cases(label, operands, nblk, k1_ms) -> dict:
    """Each cut of K1 on one operand set against its plain version, with
    its ms and bound; K1 itself (``k1_ms``) closes the split."""
    import torch

    from gulon_tpu_torch.probes import k1_stages as ks

    out = {}
    rows = k1_decoded(operands)  # the contraction's library yardstick
    for stage in ks.STAGES:
        got = ks.k1_stage_scan(*operands, stage=stage, nblk=nblk)
        torch.cuda.synchronize()
        ref = ks.plain(*operands, stage=stage, nblk=nblk)
        case = _k1_stage_check(stage, got, ref)
        del got, ref
        case.update(
            **_ms_pair(lambda: ks.k1_stage_scan(*operands, stage=stage, nblk=nblk),
                       lambda: ks.plain(*operands, stage=stage, nblk=nblk)),
            **k1_stage_bound(operands, stage), k1_ms=k1_ms,
            **(_library(embedding_decode(operands[0], operands[3]), EMBEDDING_CALL)
               if stage == "decode" else
               _library(lambda: torch.matmul(operands[2], rows.T), MATMUL_CALL)),
        )
        _emit({"phase": "probes", "kernel": "K1 stages", "variant": f"{label} {stage}",
               **case})
        if not case["ok"]:
            raise AssertionError(f"K1 cut after {stage} ({label}) disagrees: {case}")
        out[stage] = case
    return out


def rows_equal_but_zero_sign(rows, plain) -> bool:
    """Decoded rows against the plain gather: bit for bit, but for the sign
    of a zero (the one-hot decode's f32 sum of one product and zero
    products turns a -0.0 codeword into +0.0, ``onehot_rs.cuh``)."""
    import torch

    canon = [(t.float() + 0.0).to(torch.bfloat16).view(torch.int16) for t in (rows, plain)]
    return bool(torch.equal(*canon))


def _decode_case(raw, mode) -> dict:
    """One decode alone (``probe_decode_rows``: the kernel writes the rows
    it decodes) on a probe shape's K1 operands: against the plain gather,
    its ms beside its bound (codes, norms and codebooks in, the rows out;
    the one-hot's tensor-core work, K x lanes x 2 a row and piece)."""
    import torch

    from gulon_tpu_torch.probes import adc_probes as ap

    ops = ap.probe_scan_operands(**raw, center_scores=True)
    codes_t, norms_hl, cb = ops["codes_t"], ops["norms_hl"], ops["cb"]
    width = ops["q_op"].shape[1]
    m, n_cols = codes_t.shape
    _, k_codes, dsub = cb.shape
    rows = ap.probe_decode_rows(codes_t, norms_hl, cb, width=width, decode_mode=mode)
    torch.cuda.synchronize()
    plain = ap._decode_rows_plain(codes_t, norms_hl, cb, width)
    ok = rows_equal_but_zero_sign(rows, plain)
    moved = sum(t.numel() * t.element_size() for t in (codes_t, norms_hl, cb))
    moved += rows.numel() * rows.element_size()
    del rows, plain
    lanes, pieces = ap.onehot_lanes(dsub)
    mma = 0 if mode == "take" else 2 * n_cols * m * pieces * lanes * (-(-k_codes // 64) * 64)
    return dict(
        ok=ok, decoded_rows_exact=ok, max_abs_err=0.0, rows=n_cols, width=width,
        **_ms_pair(lambda: ap.probe_decode_rows(codes_t, norms_hl, cb, width=width,
                                                decode_mode=mode),
                   lambda: ap._decode_rows_plain(codes_t, norms_hl, cb, width)),
        **bound(moved, mma, "bf16", 0), bytes_moved=moved,
        **_library(embedding_decode(codes_t, cb), EMBEDDING_CALL),
    )


def phase_probes(seed: int, smi: str) -> dict:
    """P1-P4 and the cut K1 on the card: the path run (launch counts), then
    each variant against its plain version with its ms, plain ms, bound and
    bytes read, K1's ms on the same operands beside it, and the stage
    splits: K1's own, and P3's."""
    import torch

    from gulon_tpu_torch.ops.cuda import adc
    from gulon_tpu_torch.probes import adc_probes as ap, floor_probe as fp, kernel_probe as kp

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = {}
    for label, (n, d, m, k_codes, q_n) in PROBE_SHAPES.items():
        raw = k1_inputs(gen, n, d, m, k_codes, q_n, dev="cuda")
        # pretransposed int8 codes, as the kernel phase hands them over
        shapes[label] = dict(raw, codes=adc.pack_codes_t(raw["codes"], k_codes), num_rows=n)
    hs = kp.shape_from_env({})  # the headline shape, whatever the environment says
    p3_ops = kp.probe_operands(hs["n"], hs["m"], hs["k_codes"], hs["dsub"], hs["mdp"],
                               hs["num_q"], hs["t"], seed=seed)
    p4_ops = fp.floor_operands(seed=seed)
    # K1's operand sets for its cut stages: P3's headline operands as K1
    # scores them, and K1's own operands at both probe shapes
    stage_ops = {"p3_headline": (k1_on_p3_operands(*p3_ops), hs["t"] // 128)}
    for label, raw in shapes.items():
        ops = ap.probe_scan_operands(**raw, center_scores=True)
        stage_ops[label] = ((ops["codes_t"], ops["norms_hl"], ops["q_op"], ops["cb"]),
                            ops["nblk"])
    path = _probe_path(shapes, p3_ops, p4_ops, stage_ops)
    out = dict(launches=path["launches"], p4=_p4_cases(p4_ops), p3={}, p1={}, p2={}, k1s={},
               decode={})

    k1_ms = {label: _kernel_ms(lambda: adc.fused_block_scan(*ops_, winners=1, nblk=nblk))
             for label, (ops_, nblk) in stage_ops.items()}
    for label, (operands, nblk) in stage_ops.items():  # K1 cut stage by stage
        for stage, case in _k1_stage_cases(label, operands, nblk, k1_ms[label]).items():
            out["k1s"][f"{label} {stage}"] = case

    dec = kp.decoded_rows(p3_ops[0], p3_ops[3], hs["mdp"])
    for variant in kp.VARIANTS:  # P3 at the headline shape
        run = kp.make(variant, *p3_ops, tile_rows=hs["t"], query_tile=hs["qt"])
        got = run()
        torch.cuda.synchronize()
        ref = kp.plain(variant, *p3_ops, tile_rows=hs["t"], query_tile=hs["qt"])
        stage, impl, _ = kp.spec(variant)
        vdec = dec if impl != "i8" else kp.decoded_rows(
            p3_ops[0], p3_ops[3], hs["mdp"], kp.quantize_codebooks(p3_ops[3]))
        case = _p3_check(variant, got, ref, vdec, p3_ops[1], p3_ops[2])
        del got, ref
        codes_bytes = p3_ops[0].numel() * (1 if impl == "cmp8" else 4)
        read = dec.numel() * 2 if impl == "cached" else codes_bytes + p3_ops[3].numel() * 2
        case.update(
            **_ms_pair(run, lambda: kp.plain(variant, *p3_ops, tile_rows=hs["t"],
                                             query_tile=hs["qt"])),
            **p3_bound(variant, p3_ops, read), k1_ms=k1_ms["p3_headline"],
            **_p3_library(variant, p3_ops, vdec),
        )
        _emit({"phase": "probes", "kernel": "P3", "variant": variant, **case})
        if not case["ok"]:
            raise AssertionError(f"P3 {variant} disagrees with its plain version: {case}")
        out["p3"][variant] = case
    del dec

    for label, raw in shapes.items():  # P1 and P2 on K1's operands
        done = set()
        for mode, natural, pipe in PROBE_REQUESTS:
            modes = path["resolved"][(label, mode, natural, pipe)]
            key = (modes["decode_mode"], modes["natural"], modes["pipe"])
            if key in done:
                continue
            done.add(key)
            ops = ap.probe_scan_operands(**raw, center_scores=True, **dict(
                decode_mode=mode, natural=natural, pipe=pipe))
            operands = (ops["codes_t"], ops["norms_hl"], ops["q_op"], ops["cb"])
            kw = dict(winners=1, nblk=ops["nblk"], decode_mode=modes["decode_mode"],
                      natural=modes["natural"], pipe=modes["pipe"])
            got = ap.probe_block_scan(*operands, **kw)
            torch.cuda.synchronize()
            ref = adc._block_scan_plain(*operands, winners=1, nblk=ops["nblk"])
            case = compare_packed(got, ref)
            del got, ref
            rows = ap.probe_decode_rows(ops["codes_t"], ops["norms_hl"], ops["cb"],
                                        width=ops["q_op"].shape[1],
                                        decode_mode=modes["decode_mode"])
            plain_rows = k1_decoded(operands)
            case["decoded_rows_exact"] = rows_equal_but_zero_sign(rows, plain_rows)
            case["decoded_rows_bits_equal"] = bool(torch.equal(rows.view(torch.int16),
                                                               plain_rows.view(torch.int16)))
            del rows
            case["ok"] = case["ok"] and case["decoded_rows_exact"]
            case.update(
                requested=dict(decode_mode=mode, natural=natural, pipe=pipe), ran=modes,
                shape=[ops["q_op"].shape[0], ops["codes_t"].shape[1],
                       ops["codes_t"].shape[0] * ops["cb"].shape[2]],
                **_ms_pair(lambda: ap.probe_block_scan(*operands, **kw),
                           lambda: adc._block_scan_plain(*operands, winners=1,
                                                         nblk=ops["nblk"])),
                k1_ms=_kernel_ms(lambda: adc.fused_block_scan(*operands, winners=1,
                                                              nblk=ops["nblk"])),
                library_ms=_kernel_ms(lambda: torch.matmul(ops["q_op"], plain_rows.T)),
                library_call=MATMUL_CALL,
                bytes_read=sum(t.numel() * t.element_size() for t in operands),
                **k1_bound(operands, 1),
            )
            del plain_rows
            name = "P2" if modes["pipe"] else "P1"
            tag = f"{label} {modes['decode_mode']}{' natural' if modes['natural'] else ''}"
            _emit({"phase": "probes", "kernel": name, "variant": tag, **case})
            if not case["ok"]:
                raise AssertionError(f"{name} {tag} disagrees with its plain version: {case}")
            out["p2" if modes["pipe"] else "p1"][tag] = case
        for mode in ("take", "base", "bf16cmp"):  # each decode alone, head to head
            case = _decode_case(raw, mode)
            _emit({"phase": "probes", "kernel": "P1 decode", "variant": f"{label} {mode}",
                   **case})
            if not case["ok"]:
                raise AssertionError(f"P1 decode {label} {mode} disagrees: {case}")
            out["decode"][f"{label} {mode}"] = case
        torch.cuda.empty_cache()

    # the stage splits: K1's own on each operand set (its cut stages, then
    # K1 whole), from P4's floor up; and P3's tdec stages at its headline
    # shape, with K1 on the same operands and the no-decode tdec_cached
    floor = out["p4"][P3_STAGES[0][1]]["ms"]
    split = {}
    for label in stage_ops:
        steps = [("floor", floor)] + [(stage, out["k1s"][f"{label} {stage}"]["ms"])
                                      for stage in ("decode", "contraction", "block_min")]
        steps.append(("selection", k1_ms[label]))
        split[label] = {name: dict(ms=ms, added_ms=ms - steps[i - 1][1] if i else None)
                        for i, (name, ms) in enumerate(steps)}
        split[label]["full"] = dict(variant="K1 adc_scan", ms=k1_ms[label])
    p3 = {name: dict(variant=variant, ms=(out["p4"] if name == "floor" else out["p3"])[
        variant]["ms"]) for name, variant in P3_STAGES}
    p3["full"] = dict(variant="K1 adc_scan on the same operands", ms=k1_ms["p3_headline"])
    names = [name for name, _ in P3_STAGES] + ["full"]
    for prev, name in zip(names, names[1:]):
        p3[name]["added_ms"] = p3[name]["ms"] - p3[prev]["ms"]
    p3["no_decode"] = dict(variant="tdec_cached", ms=out["p3"]["tdec_cached"]["ms"])
    split["p3"] = p3
    _emit({"stage_split": dict(
        p3_shape=f"{hs['n']} rows (padded to {p3_ops[0].shape[1]}) x m {hs['m']} x K "
                  f"{hs['k_codes']} x dsub {hs['dsub']}, mdp {hs['mdp']}, "
                  f"{hs['num_q']} queries",
        card=smi, phase_seconds=time.perf_counter() - t0, **split)})
    out["stage_split"] = split
    out["max_abs_err"] = {k: max(c["max_abs_err"] for c in out[k].values())
                          for k in ("p1", "p2", "p3", "p4", "k1s")}
    return out


def _int_mm_refuses(q_n: int, n: int, dp: int) -> bool:
    """The shapes ``torch._int_mm(queries, rows^T)`` refuses by rule: more
    than 16 rows in its first operand and 8-multiples elsewhere."""
    return q_n <= 16 or n % 8 != 0 or dp % 8 != 0


def _library_ms(fn, refused_by_rule: bool = False):
    """Device ms of ``fn`` (:func:`_kernel_ms`), or None where the library
    refuses the shape by rule; any other failure of the call raises."""
    try:
        fn()
    except RuntimeError:
        if refused_by_rule:
            return None
        raise
    return _kernel_ms(fn)


def _dense_case(name, block_scan, plain, data, q_op, exact, launches_per_batch,
                label=None) -> dict:
    """One kernel against its plain version on the same operands: K3
    (``exact``) bit for bit; K2 by :func:`compare_packed` with the summand
    scale of :func:`dense_scale`."""
    import torch

    got = block_scan(data, q_op)
    torch.cuda.synchronize()
    ref = plain(data, q_op)
    if exact:
        err = (got.to(torch.int64) - ref.to(torch.int64)).abs()
        case = dict(
            id_equal=float(((got & 127) == (ref & 127)).float().mean()),
            max_abs_err=float(err.max()), ok=bool(torch.equal(got, ref)),
        )
    else:
        case = compare_packed(got, ref, dense_scale(data, q_op, ref))
    del got, ref
    library = torch._int_mm if exact else torch.matmul
    case = dict(
        kernel=name, case=label, shape=[q_op.shape[0], data.shape[0], data.shape[1]],
        dtype=str(data.dtype).replace("torch.", ""), **case,
        ms=_kernel_ms(lambda: block_scan(data, q_op)),
        plain_ms=_plain_ms(lambda: plain(data, q_op)),
        library_ms=_library_ms(
            lambda: library(q_op, data.T),
            exact and _int_mm_refuses(q_op.shape[0], *data.shape),
        ),
        library_call=f"torch.{library.__name__}(queries, rows^T), contraction only",
        launches_per_batch=launches_per_batch, **dense_bound(data, q_op),
    )
    _emit({"phase": "dense_kernel", **case})
    if not case["ok"]:
        raise AssertionError(f"{name} disagrees with its plain version: {case}")
    return case


def phase_dense_kernel(seed: int, x, glove, lpb: dict) -> dict:
    """K2 and K3 against their plain versions at the fasttext shape, K2 at
    the glove100 cache width (the cached strategy's operand), and each at
    its edge shapes."""
    import numpy as np
    import torch

    from gulon_tpu_torch.models.flat import _augment_cache
    from gulon_tpu_torch.ops import scan as scan_ops
    from gulon_tpu_torch.ops.cuda import dense

    rng = np.random.default_rng(seed + 3)
    q_n = 1024
    xd = torch.from_numpy(x).to("cuda")
    q = xd[torch.from_numpy(rng.choice(len(x), q_n, replace=False)).to("cuda")]

    data = dense.prepare_data(xd)
    k2 = _dense_case(
        "K2", dense.dense_block_scan, dense._dense_block_scan_plain, data,
        dense_queries(q, data.shape[1]), False, lpb["exact_bf16"],
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
        q8, True, lpb["exact_int8"],
    )
    del d8, xd

    index, gx = glove["index"], glove["x"]
    pq = index.pq
    cache = scan_ops.decode_tile(pq.codebooks, index.codes).to(torch.bfloat16)
    aug = _augment_cache(cache, index.recon_norms)
    gq = torch.from_numpy(gx[rng.choice(len(gx), q_n, replace=False)]).to("cuda")
    k2_cache = _dense_case(
        "K2", dense.dense_block_scan, dense._dense_block_scan_plain, aug,
        dense_queries(scan_ops._q_pad(gq, pq.bounds, pq.pad_width), aug.shape[1]),
        False, lpb["cached"],
    )
    del cache, aug
    gen = torch.Generator(device="cuda").manual_seed(seed)
    edge = []
    for n, d, nq, nan in K2_EDGE_CASES:
        data, q_op = k2_operands(gen, n, d, nq, nan, dev="cuda")
        edge.append(_dense_case(
            "K2", dense.dense_block_scan, dense._dense_block_scan_plain, data,
            q_op, False, None, label="edge",
        ))
    k3_edge = []
    for n, dp, nq, lanes in K3_EDGE_CASES:
        data, q_op = k3_operands(gen, n, dp, nq, lanes, dev="cuda")
        k3_edge.append(_dense_case(
            "K3", dense.dense_block_scan_i8, dense._dense_block_scan_plain_i8, data,
            q_op, True, None, label=f"edge {lanes or 'uniform'}",
        ))
    max_err = max(c["max_abs_err"] for c in [k2, k2_cache] + edge)
    k3_err = max(c["max_abs_err"] for c in [k3] + k3_edge)
    return dict(k2=k2, k3=k3, k2_cache=k2_cache, k2_max_abs_err=max_err,
                k3_max_abs_err=k3_err)


# ---- paths ------------------------------------------------------------------


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


def _profile(index, x, batches, k) -> dict:
    """Device ms per batch by kernel over the given batches
    (``torch.profiler``): the sum over device kernels and copies, the
    eight largest, and the sums by role: the scan kernels (K1-K3), the
    sorts (selection over block winners, the merge), the copies, and the
    rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _serve(index, x, batches[0], k)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for rows in batches:
            index.query_arrays(k, x[rows])
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        times[e.key[:90]] = times.get(e.key[:90], 0.0) + us / 1e3 / len(batches)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
    roles = {"scan kernels": 0.0, "sorts": 0.0, "copies": 0.0, "other": 0.0}
    for name, ms in times.items():
        role = ("scan kernels" if "adc_scan_kernel" in name or "dense_kernel" in name
                else "sorts" if "Sort" in name or "sort" in name
                else "copies" if "Memcpy" in name or "copy" in name else "other")
        roles[role] += ms
    return dict(device_ms_per_batch=sum(times.values()), top=top, by_role=roles)


def phase_main_path(seed: int):
    """Build -> serve -> recall through the port's entry points. Returns
    the phase line and the index, corpus and ground truth for the cached
    path."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.utils import tracing

    n, d, batch, k = 400_000, 100, 1024, 10
    x = low_rank_corpus(seed, n, d)
    keys = np.array([f"w{i:07d}" for i in range(n)], dtype=object)
    rng = np.random.default_rng(seed + 1)

    tracing.set_counter("k1.launches", 0)
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
    batches = [rng.choice(n, batch, replace=False) for _ in range(4)]
    for rows in batches:
        fused_ms.append(_serve_checked(index, x, rows, k))
        before = tracing.counter("k1.launches")
        decode_ms.append(_serve(decode, x, rows, k)[0])
        if tracing.counter("k1.launches") != before:
            raise AssertionError("the decode strategy launched K1")
    launches_serve = tracing.counter("k1.launches")

    truth = gt.sample_ground_truth(
        keys, x, num_samples=1000, ks=(1, 10), device="cuda"
    )
    rec_fused = gt.recall_of(index, truth, x, keys)
    rec_decode = gt.recall_of(decode, truth, x, keys)
    launches = tracing.counter("k1.launches")
    ratio = rec_fused[10].mean / max(rec_decode[10].mean, 1e-12)
    out = dict(
        n=n, d=d, pq="8x256", batch=batch, k=k, build_s=build_s,
        strategy=strategy, winners=index.resolved_pallas_winners(),
        rerank=index.resolved_rerank_factor(),
        fused_ms_per_batch=fused_ms, decode_ms_per_batch=decode_ms,
        launches_serve=launches_serve, launches_per_batch=launches_serve / len(batches),
        launches=launches,
        recall_fused={1: rec_fused[1].mean, 10: rec_fused[10].mean},
        recall_decode={1: rec_decode[1].mean, 10: rec_decode[10].mean},
        recall10_ratio=ratio,
    )
    _emit({"phase": "main_path", **out})
    if launches_serve < 4:
        raise AssertionError(f"K1 launched {launches_serve} times for 4 batches")
    if ratio < 0.97:
        raise AssertionError(f"fused/decode recall@10 ratio {ratio:.4f} < 0.97")
    _emit({"phase": "profile", "path": "flat auto (K1)", **_profile(index, x, batches, k)})
    return out, dict(index=index, x=x, keys=keys, truth=truth, rec_decode=rec_decode)


def phase_exact_path(seed: int, x) -> dict:
    """``build_exact_index`` -> serve through the kernel route (K2), the
    int8 operand (K3) and the ``xla`` route -> recall of each."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.utils import tracing

    n, d = x.shape
    batch, k = 1024, 10
    keys = np.array([f"w{i:07d}" for i in range(n)], dtype=object)
    rng = np.random.default_rng(seed + 2)
    batches = [rng.choice(n, batch, replace=False) for _ in range(4)]

    tracing.set_counter("k2.launches", 0)
    tracing.set_counter("k3.launches", 0)
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
        before = (tracing.counter("k2.launches"), tracing.counter("k3.launches"))
        ms = [_serve_checked(idx, x, rows, k) for rows in batches]
        served = (tracing.counter("k2.launches") - before[0],
                  tracing.counter("k3.launches") - before[1])
        rec = gt.recall_of(idx, truth, x, keys)
        out[name] = dict(
            ms_per_batch=ms, launches_k2_k3=list(served),
            launches_per_batch=[s / len(batches) for s in served],
            recall={1: rec[1].mean, 10: rec[10].mean},
        )
    out["resolved_operand_int8"] = routes["int8"].resolved_operand
    out["launches_k2"] = tracing.counter("k2.launches")
    out["launches_k3"] = tracing.counter("k3.launches")
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
    if out["xla"]["launches_k2_k3"] != [0, 0]:
        raise AssertionError("the xla route launched a kernel")
    if out["recall10_ratio"]["bf16"] < 0.99 or out["recall10_ratio"]["int8"] < 0.98:
        raise AssertionError(f"exact-path recall@10 ratios {out['recall10_ratio']}")
    for name in ("bf16", "int8"):
        _emit({"phase": "profile", "path": f"exact {name}",
               **_profile(routes[name], x, batches, k)})
    return out


def phase_cached_path(glove) -> dict:
    """``enable_cache()`` on the glove100 index -> ``auto`` picks
    ``cached`` -> 4 batches through K2 -> recall against decode."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.utils import tracing

    index, x, keys = glove["index"], glove["x"], glove["keys"]
    batch, k = 1024, 10
    rng = np.random.default_rng(4)
    tracing.set_counter("k2.launches", 0)
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
    batches = [rng.choice(len(x), batch, replace=False) for _ in range(4)]
    for rows in batches:
        cached_ms.append(_serve_checked(index, x, rows, k))
        before = tracing.counter("k2.launches")
        pallas_ms.append(_serve(pallas, x, rows, k)[0])
        if tracing.counter("k2.launches") != before:
            raise AssertionError("the pallas strategy launched K2")
    launches_serve = tracing.counter("k2.launches")
    rec = gt.recall_of(index, glove["truth"], x, keys)
    rec_decode = glove["rec_decode"]
    out = dict(
        n=len(x), cache_s=cache_s, strategy=strategy,
        cache_dtype=cache_dtype,
        cached_ms_per_batch=cached_ms, pallas_ms_per_batch=pallas_ms,
        launches_serve=launches_serve, launches_per_batch=launches_serve / len(batches),
        launches=tracing.counter("k2.launches"),
        recall_cached={1: rec[1].mean, 10: rec[10].mean},
        recall_decode={1: rec_decode[1].mean, 10: rec_decode[10].mean},
        recall10_ratio=rec[10].mean / max(rec_decode[10].mean, 1e-12),
    )
    _emit({"phase": "cached_path", **out})
    if launches_serve < 4:
        raise AssertionError(f"K2 launched {launches_serve} times for 4 cached batches")
    if out["recall10_ratio"] < 0.97:
        raise AssertionError(f"cached/decode recall@10 ratio {out['recall10_ratio']:.4f} < 0.97")
    _emit({"phase": "profile", "path": "glove100 cached (K2)",
           **_profile(index, x, batches, k)})
    return out


def _flat_kernel_check(index, q, launches_per_batch, phase: str) -> dict:
    """K1 against its plain version on a flat index's own operands, as its
    ``pallas`` route holds them: :func:`_k1_flat_check`."""
    return _k1_flat_check(index._k1(), index.resolved_pallas_winners(), q,
                          launches_per_batch, phase)


def _k1_flat_check(k1, winners, q, launches_per_batch, phase: str) -> dict:
    """K1 against its plain version on a flat scan's operands ``k1`` (a
    whole index's or one shard's ``K1Operands``), centered, at
    ``winners``, for the prepared queries ``q``: :func:`compare_packed`
    with each winner's summand scale ``|rn - c| + ||q||^2 + c + 2 ||q||
    sqrt(rn)`` (``rn = ||r^||^2``, ``c`` the centering constant), the size
    of the f32 partial sums whose order differs (a self-query cancels
    toward 0)."""
    import torch

    from gulon_tpu_torch.ops.cuda import adc

    operands, nblk = k1.operands(q, winners=winners)
    q2 = (q * q).sum(1)[:, None]
    center = k1.center

    def scale_of(ref):
        block, _ = adc._winner_blocks(ref.shape[1], winners, nblk, ref.device)
        rows = torch.clamp(block[None, :] * 128 + (ref.view(torch.int32) & 127),
                           max=k1.n - 1).long()
        rn = torch.clamp(k1.norms[rows], max=adc._BIG)  # +inf: padding rows
        return (rn - center).abs() + q2 + center.abs() + 2.0 * torch.sqrt(q2 * rn)

    case = _k1_case(phase, operands, winners, nblk, None, launches_per_batch, scale_of)
    _emit({"phase": phase, **case})
    if not case["ok"]:
        raise AssertionError(f"K1 disagrees with its plain version on {phase}: {case}")
    return case


def _ivf_kernel_check(index, q, launches_per_batch, phase: str = "ivf_kernel") -> dict:
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
    rc_pal, _, row_map = index._pallas_operands()
    npad = rc_pal.shape[0]
    k1 = index._k1()
    operands, nblk = k1.operands(q, winners=winners)
    _, base = k1.geometry(len(q), winners=winners)
    got = adc.fused_block_scan(*operands, winners=winners, nblk=nblk)
    torch.cuda.synchronize()
    ref = adc._block_scan_plain(*operands, winners=winners, nblk=nblk)
    n_cols = k1.codes_t.shape[1]
    _, rank = adc._winner_blocks(base.shape[0], winners, nblk, q.device)
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
    codes_pal = (k1.codes_t.to(torch.int32) + 128).T  # [n_cols, m]
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
    )
    del got, ref, vk, ik, vp, ip, err, tol, scale, rows, codes_pal
    dec = k1_decoded(operands)
    case.update(
        ms=_kernel_ms(lambda: adc.fused_block_scan(*operands, winners=winners, nblk=nblk)),
        plain_ms=_plain_ms(lambda: adc._block_scan_plain(*operands, winners=winners, nblk=nblk)),
        library_ms=_kernel_ms(lambda: torch.matmul(operands[2], dec.T)),
        library_call=MATMUL_CALL,
        launches_per_batch=launches_per_batch, **k1_bound(operands, winners),
    )
    _emit({"phase": phase, **case})
    ok = (
        case["id_equal"] >= 0.995 and case["values_ok"] and case["ties_ok"]
        and case["no_padding_winner_kernel"] and case["no_padding_winner_plain"]
    )
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version on IVF operands: {case}")
    return case


def phase_ivf_path(seed: int, n: int = 1_000_000, device: str = "cuda"):
    """ivf1m at full size: build -> serve through auto (pallas), W=2 +
    rescore 4, masked, and sublinear small batches -> recall of each
    route -> K1 check on the index's operands. Returns the phase line and
    the index, corpus, batches and ground truth for the sharded phase."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.utils import tracing

    d, batch, k = 96, 1024, 10
    x = low_rank_corpus(seed, n, d, intrinsic=24, n_clusters=4096)
    keys = np.array([f"r{i:08d}" for i in range(n)], dtype=object)
    rng = np.random.default_rng(seed + 5)
    batches = [rng.choice(n, batch, replace=False) for _ in range(4)]

    tracing.set_counter("k1.launches", 0)
    tracing.set_counter("ivf.topk.launches", 0)
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
    rebuild = _ivf_rebuild_check(index, keys, x, device)

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
        padded_rows=int(index._pallas_layout[0].shape[0]),
        build_s=build_s, layout_s=layout_s, strategy=strategy, rebuild=rebuild,
    )
    for name, idx in routes.items():
        before = _launch_counts()
        out[name] = dict(ms_per_batch=[_serve_checked(idx, x, rows, k) for rows in batches])
        after = _launch_counts()
        out[name].update(launches=after["K1"] - before["K1"],
                         topk_launches=after["TOPK"] - before["TOPK"])
        out[name]["launches_per_batch"] = out[name]["launches"] / len(batches)
        out[name]["topk_launches_per_batch"] = out[name]["topk_launches"] / len(batches)
    launches_serve = tracing.counter("k1.launches")

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

    # 10,000 self-queries: over 1,000 the two-winner ratio moved by about
    # +-0.005 between the builds of a k-means that was not reproducible
    # on the card (before its update added in a fixed order)
    truth = gt.sample_ground_truth(keys, x, num_samples=10_000, ks=(1, 10), device=device)
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
    out["launches"] = tracing.counter("k1.launches")
    out["topk_launches"] = tracing.counter("ivf.topk.launches")
    _emit({"phase": "ivf_path", **out})
    if min(out[name]["launches"] for name in routes if name != "masked") < 4:
        raise AssertionError(f"K1 launched too rarely on the IVF routes: {out}")
    if out["masked"]["launches"] != 0 or out["masked"]["topk_launches"] != 0:
        raise AssertionError("the masked route launched K1 or the selection kernel")
    # the K1 routes select once a K1 launch, through the kernel
    if any(out[name]["topk_launches"] != out[name]["launches"] for name in routes) or (
            out["topk_launches"] != out["launches"]):
        raise AssertionError(f"the IVF selection kernel did not launch once a K1 launch: {out}")
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
    _emit({"phase": "profile", "path": "ivf1m pallas W=4 (K1)",
           **_profile(index, x, batches, k)})

    kernel = _ivf_kernel_check(
        index, torch.from_numpy(x[batches[0]]).to(device),
        out["pallas_w4"]["launches_per_batch"],
    )
    return dict(out, kernel=kernel), dict(
        index=index, x=x, keys=keys, batches=batches, truth=truth, recall=recall)


def _ivf_rebuild_check(index, keys, x, device) -> dict:
    """Build the ivf1m index a second time from the same corpus: the
    k-means adds in a fixed order, so the padded layout, the codes and the
    row constants must be the same bits."""
    import torch

    import gulon_tpu_torch as gt

    again = gt.build_ivf_index(
        keys, x,
        pq_config=gt.PQConfig(
            num_clusters=256, num_quantizers=12, max_iters=10,
            train_sample=200_000,
        ),
        coarse_max_iters=10,
        device=device,
    )
    out = dict(
        padded_rows=[int(index._pallas_operands()[0].shape[0]),
                     int(again._pallas_operands()[0].shape[0])],
        codes_equal=bool(torch.equal(index.codes, again.codes)),
        row_const_equal=bool(torch.equal(index.row_const, again.row_const)),
        centroids_equal=bool(torch.equal(index.centroids, again.centroids)),
    )
    if not (out["codes_equal"] and out["row_const_equal"] and out["centroids_equal"]
            and out["padded_rows"][0] == out["padded_rows"][1]):
        raise AssertionError(f"two ivf1m builds differ: {out}")
    return out


def phase_kmeans_determinism(seed: int) -> dict:
    """Two k-means runs on the same host array give the same bits on the
    card, for both inits, and so do two PQ trainings."""
    import torch

    import gulon_tpu_torch as gt

    x = low_rank_corpus(seed, 400_000, 100)
    out = {}
    for init in ("sample", "kmeans++"):
        cfg = gt.KMeansConfig(k=400, max_iters=10, seed=0, init=init)
        t0 = time.perf_counter()
        a = gt.fit_kmeans(x, cfg, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        b = gt.fit_kmeans(x, cfg, device="cuda")
        out[init] = dict(
            seconds=seconds, iterations=[a.iterations, b.iterations],
            centroids_equal=bool(torch.equal(a.centroids, b.centroids)),
            assignments_equal=bool(torch.equal(a.assignments, b.assignments)),
        )
    cfg = gt.PQConfig(num_clusters=256, num_quantizers=8, max_iters=10, train_sample=200_000)
    p, q = (gt.train_product_quantizer(x, cfg, device="cuda") for _ in range(2))
    out["pq_codebooks_equal"] = bool(torch.equal(p.codebooks, q.codebooks))
    _emit({"phase": "kmeans_determinism", **out})
    bad = [k for k, v in out.items() if v is False or (
        isinstance(v, dict) and not (v["centroids_equal"] and v["assignments_equal"]))]
    if bad:
        raise AssertionError(f"k-means is not bit-reproducible on the card: {bad}")
    return out


# ---- CLI path ------------------------------------------------------------


class _Cli:
    """Runs ``gulon_tpu_torch.cli.main`` in process and counts the kernel
    launches made inside its calls only."""

    def __init__(self):
        self.launches = dict.fromkeys(_launch_counts(), 0)
        self.seconds = {}

    def __call__(self, label, argv, stdin=None) -> str:
        from gulon_tpu_torch import cli

        before = _launch_counts()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        self.seconds[label] = time.perf_counter() - t0
        after = _launch_counts()
        for name in self.launches:
            self.launches[name] += after[name] - before[name]
        if rc != 0:
            raise AssertionError(f"cli {label} exited {rc}: {err.getvalue()[-2000:]}")
        return out.getvalue()


def _query_lines(index, keys_q, q, k) -> str:
    """What ``query`` prints for these queries, from ``query_arrays``."""
    import numpy as np

    ids = index.query_arrays(k, q)[1].cpu().numpy()
    all_keys = np.asarray(index.key_index.keys, dtype=object)
    return "".join(
        f"{key}: {','.join(str(w) for w in all_keys[row[row >= 0]])}\n"
        for key, row in zip(keys_q, ids)
    )


def _rpc(sock_file, req) -> dict:
    sock_file.write(json.dumps(req).encode() + b"\n")
    sock_file.flush()
    return json.loads(sock_file.readline())


def _serve_check(index, path: str, q, env) -> dict:
    """``serve --port 0`` in a fresh process: 3 JSON requests (1, 8 and
    1024 queries) must come back with ``query_arrays``'s keys."""
    import socket

    import numpy as np

    proc = subprocess.Popen(
        [sys.executable, "-m", "gulon_tpu_torch.cli", "serve", "--index", path, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=_ROOT,
    )
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        start_s = time.perf_counter() - t0
        if not line.startswith("serving on "):
            raise AssertionError(f"serve printed {line!r}")
        host, port = line.split()[-1].rsplit(":", 1)
        all_keys = np.asarray(index.key_index.keys, dtype=object)
        answers = {}
        with socket.create_connection((host, int(port)), timeout=120) as sock:
            f = sock.makefile("rwb")
            for nq in (1, 8, 1024):
                t1 = time.perf_counter()
                reply = _rpc(f, {"k": 10, "vectors": q[:nq].tolist()})
                ms = (time.perf_counter() - t1) * 1e3
                dists, ids = index.query_arrays(10, q[:nq])
                want = [[str(w) for w in all_keys[row]] for row in ids.cpu().numpy()]
                answers[nq] = dict(
                    ms=ms, keys_equal=reply.get("keys") == want,
                    max_dist_gap=float(np.abs(
                        np.array(reply["distances"]) - dists.cpu().numpy()).max()),
                )
            info = _rpc(f, {"op": "info"})
    finally:
        proc.send_signal(2)  # SIGINT: the server's loop returns
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    out = dict(start_s=start_s, answers=answers, info=info, rc=proc.returncode)
    if not all(a["keys_equal"] and a["max_dist_gap"] <= 1e-5 for a in answers.values()):
        raise AssertionError(f"the server's answers differ from query_arrays: {out}")
    return out


def _golden_check(smi) -> dict:
    """Every ``tests/golden/*.pb`` loads on the card, serves, and saves
    back to its own bytes."""
    import numpy as np

    import gulon_tpu_torch as gt

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for path in sorted((pathlib.Path(_ROOT) / "tests" / "golden").glob("*.pb")):
            index = gt.load_index(path)
            q = np.random.default_rng(len(path.name)).normal(
                size=(4, index.dimension)).astype(np.float32)
            d, ids = index.query_arrays(1, q)
            resaved = pathlib.Path(tmp) / path.name
            gt.save_index(index, resaved)
            out[path.name] = dict(
                device=str(index.codes.device), served=list(ids.shape),
                finite=bool(d.isfinite().all()),
                bytes_equal=resaved.read_bytes() == path.read_bytes(),
            )
    if len(out) != 7 or not all(v["bytes_equal"] and v["finite"] and v["device"] == "cuda:0"
                                for v in out.values()):
        raise AssertionError(f"golden indices on the card: {out}")
    return out


def phase_cli_path(seed: int, smi: str, n: int = 400_000) -> dict:
    """The glove100 corpus through the command line, in process, then a
    fresh ``query`` process, a ``serve`` process and the golden files."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.parallel import make_mesh, shard_index
    from gulon_tpu_torch.utils import native, tracing

    d, batch, k = 100, 1024, 10
    x = low_rank_corpus(seed, n, d)
    keys = np.array([f"w{i:07d}" for i in range(n)], dtype=object)
    rng = np.random.default_rng(seed + 11)
    q_rows = rng.choice(n, batch, replace=False)
    q_keys = np.array([f"q{i:04d}" for i in range(batch)], dtype=object)
    new_x = rng.standard_normal((1000, d), dtype=np.float32)  # off the corpus
    new_keys = np.array([f"new{i:04d}" for i in range(1000)], dtype=object)
    tracing.set_counter("k1.launches", 0)
    tracing.set_counter("k2.launches", 0)
    tracing.set_counter("k3.launches", 0)
    tracing.set_counter("ivf.topk.launches", 0)
    run = _Cli()
    out = dict(n=n, d=d, card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        p = {name: os.path.join(tmp, name) for name in (
            "vecs.bin", "q.txt", "new.txt", "new.keys", "flat.pb", "flat2.pb", "added.pb",
            "removed.pb", "ivf.pb", "opq.pb", "exact.npz")}
        t0 = time.perf_counter()
        gt.write_word2vec_bin(gt.WordVectors(keys, x), p["vecs.bin"])
        with open(p["q.txt"], "w") as f:
            gt.write_word2vec(gt.WordVectors(q_keys, x[q_rows]), f)
        with open(p["new.txt"], "w") as f:
            gt.write_word2vec(gt.WordVectors(new_keys, new_x), f)
        with open(p["new.keys"], "w") as f:
            f.write("\n".join(new_keys) + "\n")
        out["write_s"] = time.perf_counter() - t0
        out["vecs_bytes"] = os.path.getsize(p["vecs.bin"])
        t0 = time.perf_counter()
        wv = gt.read_word2vec_path(p["vecs.bin"])
        out["read_binary_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wq = gt.read_word2vec_path(p["q.txt"])
        out["read_text_s"] = time.perf_counter() - t0
        out["readers"] = {
            "binary": "python mmap (read_word2vec_bin)",
            "text": "native" if native.available() else "python",
        }
        if not (np.array_equal(wv.vectors, x) and list(wv.keys) == list(keys)
                and np.array_equal(wq.vectors, x[q_rows])):
            raise AssertionError("the word2vec files do not read back as written")
        del wv
        q = wq.vectors

        run("build", ["build-index", "--metric", "cosine", "-m", "8", "-k", "256",
                      "-n", "25", "-o", p["flat.pb"], p["vecs.bin"]])
        out["index_bytes"] = os.path.getsize(p["flat.pb"])
        info = run("info", ["info", "--index", p["flat.pb"]])
        if not info.startswith("type:        FlatIndex"):
            raise AssertionError(f"info printed {info!r}")
        query_out = run("query", ["query", "-k", "10", "--index", p["flat.pb"], p["q.txt"]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = gt.load_index(p["flat.pb"])
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gt.save_index(index, p["flat2.pb"])
        out["save_s"] = time.perf_counter() - t0
        out["resave_bytes_equal"] = (
            pathlib.Path(p["flat2.pb"]).read_bytes() == pathlib.Path(p["flat.pb"]).read_bytes()
        )
        first_ms = _serve(index, q, np.arange(batch), k)[0]
        steady = [_serve(index, q, np.arange(batch), k)[0] for _ in range(5)]
        out.update(first_query_ms=first_ms, steady_ms_per_batch=steady,
                   strategy=index.resolve_strategy(batch, k))
        out["query_equal"] = query_out == _query_lines(index, q_keys, q, k)
        # the same file served row-sharded over every card
        cards = torch.cuda.device_count()
        mesh_out = run("query_mesh", ["query", "-k", "10", "--mesh", str(cards), "--index",
                                      p["flat.pb"], p["q.txt"]])
        sharded = shard_index(index, make_mesh(cards))
        out["query_mesh"] = dict(
            cards=cards, lines_equal=mesh_out == query_out,
            lines_of_sharded=mesh_out == _query_lines(sharded, q_keys, q, k),
            **_near_ties(index.query_arrays(k, q), sharded.query_arrays(k, q)),
        )
        del sharded

        test_out = run("test", ["test", "--vectors", p["vecs.bin"], "--index", p["flat.pb"],
                                "--sample", "1000"])
        cli_r10 = float(test_out.split("R@10: ")[1].split()[0])
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        truth = gt.sample_ground_truth(keys, xn, num_samples=1000, ks=(1, 10))
        rec = {
            "fused": gt.recall_of(index, truth, xn, keys)[10].mean,
            "decode": gt.recall_of(
                dataclasses.replace(index, scan_strategy="decode"), truth, xn, keys)[10].mean,
        }
        out["recall10"] = dict(cli_test=cli_r10, **rec)
        out["recall10_ratio"] = {
            "cli_test": cli_r10 / max(rec["decode"], 1e-12),
            "fused": rec["fused"] / max(rec["decode"], 1e-12),
        }

        run("add", ["add-vectors", "--index", p["flat.pb"], "-o", p["added.pb"], p["new.txt"]])
        added_out = run("query_added", ["query", "-k", "1", "--index", p["added.pb"], p["new.txt"]])
        firsts = [ln.split(": ") for ln in added_out.splitlines()]
        out["added_find_themselves"] = sum(a == b for a, b in firsts)
        run("remove", ["remove-keys", "--index", p["added.pb"], "-o", p["removed.pb"],
                       "--keys-file", p["new.keys"]])
        removed_out = run("query_removed", ["query", "-k", "10", "--index", p["removed.pb"],
                                            p["new.txt"]])
        out["removed_seen_again"] = sum(
            w.startswith("new") for ln in removed_out.splitlines()
            for w in ln.split(": ")[1].split(",")
        )

        run("build_ivf", ["build-index", "--metric", "cosine", "-m", "8", "-k", "256",
                          "-n", "25", "-p", "-o", p["ivf.pb"], p["vecs.bin"]])
        ivf_out = run("query_ivf", ["query", "-k", "10", "--index", p["ivf.pb"], p["q.txt"]])
        ivf = gt.load_index(p["ivf.pb"])
        out["ivf"] = dict(
            partitions=ivf.num_partitions, probe=ivf.strategy.count,
            strategy=ivf.resolve_strategy(batch, k),
            query_equal=ivf_out == _query_lines(ivf, q_keys, q, k),
            recall10=gt.recall_of(ivf, truth, xn, keys)[10].mean,
        )
        del ivf

        run("build_opq", ["build-index", "--metric", "cosine", "-m", "8", "-k", "256",
                          "-n", "25", "--opq", "4", "-o", p["opq.pb"], p["vecs.bin"]])
        opq_out = run("query_opq", ["query", "-k", "10", "--index", p["opq.pb"], p["q.txt"]])
        opq = gt.load_index(p["opq.pb"])
        out["opq"] = dict(
            query_equal=opq_out == _query_lines(opq, q_keys, q, k),
            recall10=gt.recall_of(opq, truth, xn, keys)[10].mean,
            rotation=list(opq.rotation.shape),
        )
        del opq

        run("build_exact", ["build-index", "--metric", "cosine", "--exact", "-o",
                            p["exact.npz"], p["vecs.bin"]])
        exact_out = run("query_exact", ["query", "-k", "10", "--index", p["exact.npz"],
                                        p["q.txt"]])
        exact = gt.load_index(p["exact.npz"])
        out["exact"] = dict(
            strategy=exact.resolve_strategy(k),
            query_equal=exact_out == _query_lines(exact, q_keys, q, k),
        )
        del exact
        out["launches"] = dict(run.launches)
        out["cli_seconds"] = run.seconds
        out["aot"] = _aot_check(
            p, q, {"flat": query_out, "ivf": ivf_out, "exact": exact_out}, batch, k
        )

        env = dict(os.environ, PYTHONPATH=_ROOT)
        t0 = time.perf_counter()
        fresh = subprocess.run(
            [sys.executable, "-m", "gulon_tpu_torch.cli", "query", "-k", "10", "--index",
             p["flat.pb"], p["q.txt"]],
            capture_output=True, text=True, env=env, cwd=_ROOT, timeout=600,
        )
        out["fresh_process"] = dict(
            rc=fresh.returncode, seconds=time.perf_counter() - t0,
            stdout_equal=fresh.stdout == query_out,
        )
        out["aot"]["fresh_processes"] = _fresh_aot_check(p, query_out, env)
        out["serve"] = _serve_check(index, p["flat.pb"], q, env)
    out["golden"] = _golden_check(smi)
    _emit({"phase": "cli_path", **out})

    checks = {
        "query_equal": out["query_equal"], "resave": out["resave_bytes_equal"],
        "query_mesh": out["query_mesh"]["lines_equal"] or (
            out["query_mesh"]["lines_of_sharded"]
            and out["query_mesh"]["mismatches_near_ties"]),
        "cli_test_ratio": out["recall10_ratio"]["cli_test"] >= 0.97,
        "fused_ratio": out["recall10_ratio"]["fused"] >= 0.97,
        "added": out["added_find_themselves"] == 1000,
        "removed": out["removed_seen_again"] == 0,
        "ivf_query": out["ivf"]["query_equal"], "ivf_pallas": out["ivf"]["strategy"] == "pallas",
        "opq_query": out["opq"]["query_equal"],
        "opq_recall": out["opq"]["recall10"] >= rec["fused"] - 0.01,
        "exact_query": out["exact"]["query_equal"],
        "exact_pallas": out["exact"]["strategy"] == "pallas",
        "flat_pallas": out["strategy"] == "pallas",
        "k1": run.launches["K1"] > 0, "k2": run.launches["K2"] > 0,
        "fresh": out["fresh_process"]["rc"] == 0 and out["fresh_process"]["stdout_equal"],
        "aot_query": all(out["aot"][name]["query_equal"] for name in ("flat", "ivf", "exact")),
        "aot_warm_equal": all(out["aot"][name]["warm_equal_cold"]
                              for name in ("flat", "ivf", "exact")),
        "aot_fresh": out["aot"]["fresh_processes"]["stdout_equal"],
        "aot_k1": out["aot"]["launches"]["K1"] > 0, "aot_k2": out["aot"]["launches"]["K2"] > 0,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cli_path checks failed: {failed}")
    return out


# ---- streaming path ---------------------------------------------------------

# bytes of one text row: "w%07d" key, 300 values of " +d.dddd", newline
_STREAM_DIM = 300
_STREAM_ROW_BYTES = 8 + 8 * _STREAM_DIM + 1


def write_fixed_width_word2vec(path: str, x, chunk: int = 32768) -> int:
    """Write ``x`` ``[n, 300]`` as a word2vec text file, keys ``w%07d``
    and every value as ``+d.dddd`` / ``-d.dddd`` (|v| clipped below 10).
    Rows have one width, so chunks of rows are formatted on a thread each
    (numpy on byte arrays: each value's 8 bytes from a table of the
    100,000 magnitudes) and written at their offsets. Returns the file's
    bytes."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    n, d = x.shape
    width = 8 + 8 * d + 1
    header = f"{n} {d}\n".encode()
    mags = np.arange(100_000)
    table = np.empty((100_000, 8), np.uint8)  # " +d.dddd" without its sign
    table[:, 0], table[:, 1], table[:, 3] = ord(" "), ord("+"), ord(".")
    for col, div in ((2, 10_000), (4, 1000), (5, 100), (6, 10), (7, 1)):
        table[:, col] = ord("0") + (mags // div) % 10

    def write(fd, start):
        xc = x[start : start + chunk]
        b = len(xc)
        buf = np.empty((b, width), np.uint8)
        row = np.arange(start, start + b)
        buf[:, 0] = ord("w")
        for j in range(7):
            buf[:, 7 - j] = ord("0") + (row // 10 ** j) % 10
        vals = table[np.minimum(np.rint(np.abs(xc) * 1e4), 99_999).astype(np.int32)]
        vals[..., 1][xc < 0] = ord("-")
        buf[:, 8 : 8 + 8 * d] = vals.reshape(b, 8 * d)
        buf[:, -1] = ord("\n")
        os.pwrite(fd, buf.tobytes(), len(header) + start * width)

    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.pwrite(fd, header, 0)
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            for fut in [pool.submit(write, fd, s) for s in range(0, n, chunk)]:
                fut.result()
    finally:
        os.close(fd)
    return os.path.getsize(path)


def _smaps_rss(text: str) -> dict:
    """The resident set from ``/proc/self/smaps`` (the sum of every
    mapping's Rss), the Rss of the mappings of the file ``text`` (the
    memory-mapped word2vec file the parser reads, whose pages count as
    they are touched) and their difference, ``held``: what the process
    holds apart from the text."""
    text = os.path.realpath(text)
    rss = text_rss = 0
    in_text = False
    with open("/proc/self/smaps") as f:
        for line in f:
            if line.startswith("Rss:"):
                size = int(line.split()[1]) * 1024
                rss += size
                text_rss += size if in_text else 0
            elif "-" in line.split(" ", 1)[0]:  # a mapping's header line
                in_text = line.rstrip("\n").endswith(" " + text)
    return {"rss": rss, "text_rss": text_rss, "held": rss - text_rss}


class _RssPeak:
    """The peak of each :func:`_smaps_rss` figure over its samples: those
    :meth:`sample` takes where the build's host memory changes (after the
    training-sample gather, and at every chunk boundary of the streamed
    passes, through ``report_fn``), and one every 50 ms on a thread in
    between (the codebook training), until :meth:`stop`."""

    def __init__(self, text: str):
        import threading

        self.text = text
        self.peak = _smaps_rss(text)
        self.samples = 1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def sample(self, *_):
        now = _smaps_rss(self.text)
        with self._lock:
            self.peak = {k: max(v, self.peak[k]) for k, v in now.items()}
            self.samples += 1

    def _run(self):
        while not self._stop.wait(0.05):
            self.sample()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        self.sample()
        return self.peak


def _streaming_child(path: str, train_sample: int) -> dict:
    """The streaming path in a process of its own, so that its resident
    set holds the build and not the parent's corpora: parse-only pass,
    ``build_flat_index_streaming`` with its pipeline split and the host
    memory it held, bit-equality with ``build_flat_index`` of the same
    file, 4 x 1024 queries through ``auto`` (K1) and recall against
    decode, then ``build_ivf_index_streaming`` twice (bit-equal) served
    through K1 at recall against ``masked``; K1 against its plain version
    on each index's own operands."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.models.streaming import _DEFAULT_CHUNK
    from gulon_tpu_torch.ops.cuda import adc
    from gulon_tpu_torch.utils import native, tracing

    torch.cuda.init()
    adc._kernel()  # the library the parent built
    k, batch = 10, 1024
    cfg = gt.PQConfig(num_clusters=256, num_quantizers=25, train_sample=train_sample)
    # a tiny build first, so the libraries' host state exists before the
    # memory baseline
    warm = np.random.default_rng(0).standard_normal((2048, _STREAM_DIM), dtype=np.float32)
    gt.build_flat_index([f"k{i}" for i in range(2048)], warm, pq_config=cfg._replace(
        num_clusters=16, max_iters=2, train_sample=None))
    out = {}
    start = _smaps_rss(path)
    memory = _RssPeak(path)
    gather = native.Word2VecStream.gather

    def gather_sampled(self, ids):
        rows = gather(self, ids)
        memory.sample()  # the training sample is held from here on
        return rows

    native.Word2VecStream.gather = gather_sampled
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        index = gt.build_flat_index_streaming(
            path, pq_config=cfg, pipeline_stats=stats, report_fn=memory.sample)
        torch.cuda.synchronize()
    finally:
        native.Word2VecStream.gather = gather
    build_s = time.perf_counter() - t0
    peak = memory.stop()
    n, d = index.size, index.dimension
    chunk_bytes = min(_DEFAULT_CHUNK, n) * d * 4
    some = index.key_index.keys[:10000]
    key_bytes = (sum(sys.getsizeof(w) for w in some) // len(some) + 8) * n
    held = dict(sample=min(train_sample, n) * d * 4, two_chunks=2 * chunk_bytes,
                codes=n * index.pq.num_quantizers, keys=key_bytes)
    out["memory"] = dict(
        corpus_f32_bytes=n * d * 4, samples=memory.samples,
        peak_growth_bytes={name: peak[name] - start[name] for name in start},
        held_bytes=held, held_sum_bytes=sum(held.values()),
        pinned_bytes=2 * (1 << (chunk_bytes - 1).bit_length()),  # rounded up to 2^k
    )
    out.update(n=n, d=d, pq="25x256", train_sample=train_sample, build_s=build_s,
               pipeline=stats, chunk=_DEFAULT_CHUNK)

    # parse-only: the same chunks through the parser into one buffer; the
    # resident-set growth meanwhile says whether mapped text counts in it
    buf = np.zeros((_DEFAULT_CHUNK, d), np.float32)
    with gt.Word2VecStream(path) as stream:
        t0 = time.perf_counter()
        for first in range(0, n, _DEFAULT_CHUNK):
            stream.rows(first, min(_DEFAULT_CHUNK, n - first), out=buf)
        out["parse_only_s"] = time.perf_counter() - t0
    out["overlap_fraction"] = 1.0 - stats["wait_s"] / max(out["parse_only_s"], 1e-9)

    t0 = time.perf_counter()
    wv = gt.read_word2vec_path(path)
    out["read_s"] = time.perf_counter() - t0
    keys, x = wv.keys, wv.vectors
    del wv
    t0 = time.perf_counter()
    memory = gt.build_flat_index(keys, x, pq_config=cfg)
    torch.cuda.synchronize()
    out["in_memory_build_s"] = time.perf_counter() - t0
    out["bit_equal"] = dict(
        codebooks=bool(torch.equal(index.pq.codebooks, memory.pq.codebooks)),
        codes=bool(torch.equal(index.codes, memory.codes)),
        keys=list(index.key_index.keys[:5]) == list(memory.key_index.keys[:5]),
    )
    del memory

    rng = np.random.default_rng(31)
    batches = [rng.choice(n, batch, replace=False) for _ in range(4)]
    tracing.set_counter("k1.launches", 0)
    strategy = index.resolve_strategy(batch, k)
    ms = [_serve_checked(index, x, rows, k) for rows in batches]
    launches = tracing.counter("k1.launches")
    truth = gt.sample_ground_truth(keys, x, num_samples=1000, ks=(1, 10))
    rec = {name: gt.recall_of(idx, truth, x, keys)[10].mean for name, idx in (
        ("fused", index), ("decode", dataclasses.replace(index, scan_strategy="decode")))}
    out["flat"] = dict(strategy=strategy, ms_per_batch=ms, recall10=rec,
                       recall10_ratio=rec["fused"] / max(rec["decode"], 1e-12))
    # the comparison's launches are not the path's
    counted = tracing.counter("k1.launches")
    out["flat"]["kernel"] = _flat_kernel_check(
        index, index._prepare_queries(x[batches[0]]), launches / len(batches),
        "streaming_flat_kernel",
    )
    tracing.set_counter("k1.launches", counted)
    del index
    torch.cuda.empty_cache()

    ivf_runs, ivf_build_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivf_runs.append(gt.build_ivf_index_streaming(path, pq_config=cfg))
        torch.cuda.synchronize()
        ivf_build_s.append(time.perf_counter() - t0)
    ivf, again = ivf_runs
    equal = {name: bool(torch.equal(getattr(ivf, name), getattr(again, name)))
             for name in ("centroids", "codes", "group_ids", "row_const")}
    equal["codebooks"] = bool(torch.equal(ivf.pq.codebooks, again.pq.codebooks))
    del again, ivf_runs
    strategy = ivf.resolve_strategy(batch, k)
    before = tracing.counter("k1.launches"), tracing.counter("ivf.topk.launches")
    ms = [_serve_checked(ivf, x, rows, k) for rows in batches]
    ivf_serve_launches = tracing.counter("k1.launches") - before[0]
    ivf_topk_launches = tracing.counter("ivf.topk.launches") - before[1]
    rec = {name: gt.recall_of(idx, truth, x, keys)[10].mean for name, idx in (
        ("pallas", ivf), ("masked", dataclasses.replace(ivf, scan_strategy="masked")))}
    out["ivf"] = dict(
        partitions=ivf.num_partitions, probe=ivf.strategy.count, strategy=strategy,
        build_s=ivf_build_s, ms_per_batch=ms, serve_launches=ivf_serve_launches,
        serve_topk_launches=ivf_topk_launches,
        recall10=rec, recall10_ratio=rec["pallas"] / max(rec["masked"], 1e-12),
        rebuild_bit_equal=equal,
    )
    out["launches"] = tracing.counter("k1.launches")
    out["topk_launches"] = tracing.counter("ivf.topk.launches")
    out["ivf"]["kernel"] = _ivf_kernel_check(
        ivf, torch.from_numpy(x[batches[0]]).cuda(), ivf_serve_launches / len(batches),
        "streaming_ivf_kernel",
    )
    out["max_abs_err"] = max(out["flat"]["kernel"]["max_abs_err"],
                             out["ivf"]["kernel"]["max_abs_err"])
    out["serve_launches"] = launches + ivf_serve_launches
    return out


def phase_streaming(seed: int, x, smi: str) -> dict:
    """The 2,000,000 x 300 corpus as a word2vec text file (the shape of
    fastText's crawl-300d-2M.vec), built from the file by the streaming
    builders in a child process; see :func:`_streaming_child`."""
    n, d = x.shape
    tmp_root = max((_ROOT, tempfile.gettempdir()), key=lambda p: shutil.disk_usage(p).free)
    free = shutil.disk_usage(tmp_root).free
    need = n * _STREAM_ROW_BYTES + (2 << 30)
    if free < need:
        raise AssertionError(
            f"{free} bytes free in {tmp_root}: the {n}-row corpus needs {need}")
    with tempfile.TemporaryDirectory(dir=tmp_root, prefix="gulon_stream_") as tmp:
        path = os.path.join(tmp, "crawl2m.vec")
        t0 = time.perf_counter()
        file_bytes = write_fixed_width_word2vec(path, x)
        write_s = time.perf_counter() - t0
        env = dict(os.environ, PYTHONPATH=_ROOT)
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--streaming-child", path],
            capture_output=True, text=True, env=env, cwd=_ROOT, timeout=900,
        )
    if child.returncode != 0:
        raise AssertionError(f"streaming child exited {child.returncode}: {child.stderr[-3000:]}")
    lines = child.stdout.strip().splitlines()
    for line in lines[:-1]:  # the child's kernel lines
        print(line, flush=True)
    out = json.loads(lines[-1])
    out.update(file_bytes=file_bytes, write_s=write_s, card=smi)
    _emit({"phase": "streaming", **out})
    mem = out["memory"]
    checks = {
        "memory": mem["peak_growth_bytes"]["held"] < mem["corpus_f32_bytes"],
        "bit_equal": all(out["bit_equal"].values()),
        "flat_pallas": out["flat"]["strategy"] == "pallas",
        "flat_ratio": out["flat"]["recall10_ratio"] >= 0.97,
        "flat_kernel": out["flat"]["kernel"]["ok"],
        "ivf_pallas": out["ivf"]["strategy"] == "pallas",
        "ivf_ratio": out["ivf"]["recall10_ratio"] >= 0.97,
        "ivf_rebuild": all(out["ivf"]["rebuild_bit_equal"].values()),
        "k1": out["serve_launches"] >= 8,
        "ivf_topk": out["ivf"]["serve_topk_launches"] == out["ivf"]["serve_launches"],
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"streaming checks failed: {failed}")
    return out


# ---- packed path ------------------------------------------------------------


def phase_packed(glove, smi: str) -> dict:
    """The glove100 corpus at PQ 8x16 (4-bit codes) and 8x4 (2-bit):
    ``pack_memory()``, then 4 x 1024 queries through ``auto``, which must
    take ``decode``; ids and distances equal the unpacked index's decode
    route exactly, and ``save_index`` writes the unpacked index's bytes."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.utils import tracing

    x, keys = glove["x"], glove["keys"]
    batch, k = 1024, 10
    rng = np.random.default_rng(12)
    batches = [rng.choice(len(x), batch, replace=False) for _ in range(4)]
    out = dict(n=len(x), d=x.shape[1], card=smi)
    before = (tracing.counter("k1.launches"), tracing.counter("k2.launches"),
              tracing.counter("k3.launches"))
    with tempfile.TemporaryDirectory() as tmp:
        for clusters, width in ((16, 4), (4, 2)):
            plain = gt.build_flat_index(keys, x, pq_config=gt.PQConfig(
                num_clusters=clusters, num_quantizers=8, max_iters=25,
                train_sample=200_000))
            decode = dataclasses.replace(plain, scan_strategy="decode")
            packed = dataclasses.replace(plain)
            packed.pack_memory()
            packed.scan_strategy = "auto"
            strategy = packed.resolve_strategy(batch, k)
            equal, ms, ms_plain = True, [], []
            for rows in batches:
                t, dp, ip = _serve(packed, x, rows, k)
                t2, dd, idd = _serve(decode, x, rows, k)
                ms.append(t)
                ms_plain.append(t2)
                equal = equal and bool(torch.equal(ip, idd)) and bool(torch.equal(dp, dd))
            a, b = os.path.join(tmp, "plain.pb"), os.path.join(tmp, "packed.pb")
            gt.save_index(plain, a)
            gt.save_index(packed, b)
            out[f"{width}bit"] = dict(
                pq=f"8x{clusters}", packed_width=packed.packed_width, strategy=strategy,
                code_bytes=int(packed.codes.numel()), unpacked_code_bytes=int(plain.codes.numel()),
                ms_per_batch=ms, unpacked_decode_ms_per_batch=ms_plain, results_equal=equal,
                file_bytes_equal=pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes(),
            )
    after = (tracing.counter("k1.launches"), tracing.counter("k2.launches"),
             tracing.counter("k3.launches"))
    out["launches"] = [a - b for a, b in zip(after, before)]
    _emit({"phase": "packed", **out})
    bad = [w for w in ("4bit", "2bit") if not (
        out[w]["strategy"] == "decode" and out[w]["results_equal"]
        and out[w]["file_bytes_equal"] and out[w]["code_bytes"] < out[w]["unpacked_code_bytes"])]
    if bad or out["launches"] != [0, 0, 0]:
        raise AssertionError(f"packed checks failed: {bad} {out['launches']}")
    return out


# ---- sharded path -----------------------------------------------------------


def _sharding_mesh(device: str = "cuda"):
    """The sharded phase's mesh: every card when there are two or more,
    else four logical shards of the one card."""
    import torch

    from gulon_tpu_torch.parallel import make_mesh

    if device == "cuda" and torch.cuda.device_count() >= 2:
        return make_mesh()
    return make_mesh(devices=[torch.device(device, 0)] * 4)


def _near_ties(ref, got, rel: float = 1e-4) -> dict:
    """Two ``(dists, ids)`` top-k results: the share of equal ids, and
    whether every slot whose ids differ holds near-equal distances in both
    (within ``rel * max(|d|, 1)``): a swapped near-tie, or a tie at the
    k-th slot."""
    import torch

    (d_a, i_a), (d_b, i_b) = ref, got
    d_b, i_b = d_b.to(d_a.device), i_b.to(i_a.device)
    diff = i_a != i_b
    tol = rel * torch.clamp(d_a.abs(), min=1.0)
    return dict(
        id_equal=float((~diff).float().mean()),
        mismatches_near_ties=bool(((d_a - d_b).abs()[diff] <= tol[diff]).all()),
        max_dist_gap=float((d_a - d_b).abs().max()),
    )


def _recall_rows(index, truth, x, k: int = 10) -> float:
    """recall@k as ``recall_of`` counts it (a returned row within the true
    k-th distance is a hit), for an index whose row i is corpus row i."""
    import numpy as np

    _, ids = index.query_arrays(k, truth.queries)
    ids = ids.cpu().numpy()
    valid = ids >= 0
    rows = np.where(valid, ids, 0)
    exact = ((x[rows] - truth.queries[:, None, :]) ** 2).sum(axis=2)
    exact = np.where(valid, exact, np.inf)
    return float(np.mean((exact[:, :k] <= truth.kth_distances[k][:, None]).sum(1) / k))


def _route(index, x, batches, k, counter: str) -> dict:
    """A warm-up batch, then ``batches`` through ``index``: host ms of
    each (ending in a synchronize) and the launches of the ``counter``
    kernel ("K1" or "K2") and of the IVF selection kernel they made."""
    _serve(index, x, batches[0], k)
    before = _launch_counts()
    ms = [_serve_checked(index, x, rows, k) for rows in batches]
    after = _launch_counts()
    return dict(ms_per_batch=ms, launches=after[counter] - before[counter],
                topk_launches=after["TOPK"] - before["TOPK"])


def _mesh_child(rank: int, port: int, work: str, backend: str) -> dict:
    """One rank of the multi-process check: join the group, load the
    glove100 index, shard it over the two-rank mesh (one shard a rank),
    answer the 1024-query batch and write the result."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.ops.cuda import adc
    from gulon_tpu_torch.parallel import distributed_init, make_mesh, shard_index
    from gulon_tpu_torch.utils import tracing

    dev = torch.device("cuda", rank if torch.cuda.device_count() >= 2 else 0)
    distributed_init(devices=[dev], backend=backend, world_size=2, rank=rank,
                     init_method=f"tcp://127.0.0.1:{port}")
    adc._kernel()  # the library the parent built
    gloo_cuda = None
    if backend == "gloo":
        # does gloo gather CUDA tensors, or only host ones?
        t = torch.full((4,), float(rank), device=dev)
        got = [torch.empty_like(t) for _ in range(2)]
        try:
            dist.all_gather(got, t)
            gloo_cuda = "gathers" if [float(g[0]) for g in got] == [0.0, 1.0] else "wrong values"
        except RuntimeError as e:
            gloo_cuda = "refuses: " + str(e).splitlines()[0][:200]
    mesh = make_mesh(devices=[dev])
    index = gt.load_index(os.path.join(work, "glove.pb"), device=dev)
    q = np.load(os.path.join(work, "q.npy"))
    sharded = shard_index(index, mesh)
    tracing.set_counter("k1.launches", 0)
    d, ids = sharded.query_arrays(10, q)
    torch.cuda.synchronize()
    np.savez(os.path.join(work, f"rank{rank}.npz"), d=d.cpu().numpy(), ids=ids.cpu().numpy())
    out = dict(rank=rank, backend=dist.get_backend(), device=str(dev),
               shards=mesh.shape["rows"], local_rows=mesh.local_rows,
               k1_launches=tracing.counter("k1.launches"), gloo_all_gather_cuda=gloo_cuda)
    dist.destroy_process_group()
    return out


def _multiprocess_check(work: str) -> dict:
    """Two child processes (:func:`_mesh_child`) serve the saved glove100
    index over a two-rank mesh: NCCL with a card a rank when there are two
    cards, else gloo with both ranks on card 0. Their ids must equal one
    process's two-shard mesh, near-ties aside."""
    import socket

    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.parallel import make_mesh, shard_index

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=_ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child", str(r), str(port), work,
         backend], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=_ROOT) for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    for proc, (stdout, stderr) in zip(procs, outs):
        if proc.returncode != 0:
            raise AssertionError(f"mesh child exited {proc.returncode}: {stderr[-3000:]}")
    ranks = [json.loads(stdout.strip().splitlines()[-1]) for stdout, _ in outs]
    index = gt.load_index(os.path.join(work, "glove.pb"))
    q = np.load(os.path.join(work, "q.npy"))
    ref = shard_index(index, make_mesh(devices=["cuda:0"] * 2)).query_arrays(10, q)
    compared = []
    for r in range(2):
        got = np.load(os.path.join(work, f"rank{r}.npz"))
        compared.append(_near_ties(ref, (torch.from_numpy(got["d"]), torch.from_numpy(got["ids"]))))
    return dict(backend=backend, seconds=seconds, ranks=ranks, against_one_process=compared)


def phase_sharded(seed: int, smi: str, ivf_ctx: dict, work: str,
                  n: int = 10_000_000, device: str = "cuda") -> dict:
    """deep10m (``benchmarks/run.py:401``): 10,000,000 x 96, PQ 12x256,
    top-10 over batches of 1024, uncut. Two mesh builds (bit-equal) and a
    single-card build; the flat ``auto`` (K1 per shard), ``cached`` (K2
    per shard) and exact (K2 per shard) routes at mesh 1 and mesh M
    against the single-card routes by recall@10; K1 and K2 against their
    plain versions on one shard's operands; ivf1m sharded at W=4; the
    multi-process check."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.models.build import _encode_chunked
    from gulon_tpu_torch.ops import scan as scan_ops
    from gulon_tpu_torch.ops.cuda import dense
    from gulon_tpu_torch.parallel import make_mesh, shard_index
    from gulon_tpu_torch.utils import tracing

    d, batch, k = 96, 1024, 10
    tracing.set_counter("k1.launches", 0)
    tracing.set_counter("k2.launches", 0)
    tracing.set_counter("k3.launches", 0)
    tracing.set_counter("ivf.topk.launches", 0)
    t0 = time.perf_counter()
    x = low_rank_corpus(seed, n, d, intrinsic=24, n_clusters=10_000)
    keys = np.array([f"d{i:08d}" for i in range(n)], dtype=object)  # sorted: row i is key i
    rng = np.random.default_rng(seed)
    batches = [np.sort(rng.choice(n, batch, replace=False)) for _ in range(4)]
    mesh, mesh1 = _sharding_mesh(device), make_mesh(devices=[torch.device(device, 0)])
    shards = mesh.shape["rows"]
    out = dict(n=n, d=d, pq="12x256", batch=batch, k=k, card=smi,
               corpus_s=time.perf_counter() - t0,
               mesh=dict(shards=shards, devices=[str(v) for v in mesh.devices[:, 0]]))
    cfg = gt.PQConfig(num_clusters=256, num_quantizers=12, max_iters=15, train_sample=200_000)

    def build(on_mesh):
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx = gt.build_flat_index(keys, x, pq_config=cfg, mesh=on_mesh, device=device)
        torch.cuda.synchronize()
        return idx, time.perf_counter() - t

    index, mesh_s = build(mesh)
    again, mesh_s2 = build(mesh)
    single, single_s = build(None)
    out["build_s"] = dict(mesh=[mesh_s, mesh_s2], single_card=single_s)
    out["mesh_builds_bit_equal"] = dict(
        codebooks=bool(torch.equal(index.pq.codebooks, again.pq.codebooks)),
        codes=bool(torch.equal(index.codes, again.codes)),
        norms=bool(torch.equal(index.recon_norms, again.recon_norms)),
    )
    del again
    same_cb = bool(torch.equal(single.pq.codebooks, index.pq.codebooks))
    ref_codes = single.codes if same_cb else _encode_chunked(index.pq, x, 1 << 20)
    del single
    differ = (index.codes != ref_codes).any(dim=1).nonzero()[:, 0]
    gaps = []
    if len(differ):
        rows = differ.cpu().numpy()
        xs = index.pq.split(x[rows])  # [m, r, dsub]
        cb = index.pq.codebooks
        sub = torch.arange(cb.shape[0], device=cb.device)[:, None]
        for codes in (index.codes[differ], ref_codes[differ]):
            c = cb[sub, codes.T.long()]  # [m, r, dsub]
            gaps.append(((xs.double() - c.double()) ** 2).sum(-1))
        scale = (xs.double() ** 2).sum(-1) + (cb.double() ** 2).sum(-1).max(dim=1).values[:, None]
        near = ((gaps[0] - gaps[1]).abs() <= 2.0 ** -8 * scale).all().item()
    else:
        near = True
    out["encode_vs_single_card"] = dict(
        same_codebooks=same_cb, rows_equal=1.0 - len(differ) / n, rows_differing=len(differ),
        differing_rows_near_ties=bool(near),
    )
    del ref_codes

    truth = gt.sample_ground_truth(keys, x, num_samples=1000, ks=(1, 10), device=device)
    decode = dataclasses.replace(index, scan_strategy="decode")
    out["recall_single_decode"] = _recall_rows(decode, truth, x)
    del decode
    # the timed batches' launches: sharded (mesh 1 and mesh M) and single card
    sharded_launches, single_launches = {"K1": 0, "K2": 0}, {"K1": 0, "K2": 0}
    routes = {}

    def drive(name, single_index, counter, make):
        """The single-card route, then the same index sharded at mesh 1
        and mesh M: ms per batch, launches, recall@10."""
        r = {}
        for tag, idx in (("mesh1", make(mesh1)), (f"mesh{shards}", make(mesh))):
            r[tag] = _route(idx, x, batches, k, counter)
            r[tag]["recall10"] = _recall_rows(idx, truth, x)
            sharded_launches[counter] += r[tag]["launches"]
            if tag != "mesh1":
                r["sharded"] = idx
        r["single_card"] = _route(single_index, x, batches, k, counter)
        single_launches[counter] += r["single_card"]["launches"]
        r["single_card"]["recall10"] = _recall_rows(single_index, truth, x)
        r["recall10_ratio"] = r[f"mesh{shards}"]["recall10"] / max(
            r["single_card"]["recall10"], 1e-12)
        routes[name] = r
        return r.pop("sharded")

    if index.resolve_strategy(batch, k) != "pallas":
        raise AssertionError("deep10m flat auto does not resolve to the kernel route")
    flat_m = drive("flat_auto", index, "K1", lambda m: shard_index(index, m))
    out["profile_flat_auto"] = _profile(flat_m, x, batches, k)
    q0 = torch.from_numpy(x[batches[0]]).to(device)
    lpb = routes["flat_auto"][f"mesh{shards}"]["launches"] / len(batches)
    counted = tracing.counter("k1.launches")  # the comparison's launches are not the path's
    k1_shard = _k1_flat_check(
        flat_m._k1(0), index.resolved_pallas_winners(), q0, lpb, "sharded_k1",
    )
    tracing.set_counter("k1.launches", counted)
    del flat_m

    index.enable_cache()
    index.scan_strategy = "cached"
    sharded_cached = {}

    def make_cached(m):
        sharded_cached[m.shape["rows"]] = shard_index(index, m)
        return sharded_cached[m.shape["rows"]]

    # shard before the single-card route: its K2 operand replaces the cache
    drive("cached", index, "K2", make_cached)
    aug0 = sharded_cached[shards].cache_aug_sharded[0]
    q_pad = scan_ops._q_pad(q0, index.pq.bounds, index.pq.pad_width)
    counted = tracing.counter("k2.launches")
    k2_shard = _dense_case(
        "K2", dense.dense_block_scan, dense._dense_block_scan_plain, aug0,
        dense_queries(q_pad, aug0.shape[1]), False,
        routes["cached"][f"mesh{shards}"]["launches"] / len(batches), label="deep10m_shard",
    )
    tracing.set_counter("k2.launches", counted)
    del sharded_cached, aug0, index
    torch.cuda.empty_cache()

    exact = gt.build_exact_index(keys, x, device=device)
    if exact.resolve_strategy(k) != "pallas":
        raise AssertionError("deep10m exact auto does not resolve to the kernel route")
    drive("exact", exact, "K2", lambda m: shard_index(exact, m))
    del exact
    torch.cuda.empty_cache()

    ivf, ivf_x = ivf_ctx["index"], ivf_ctx["x"]
    ivf_m = shard_index(ivf, mesh)
    resolved = ivf_m._resolve(batch, k)
    ivf_route = _route(ivf_m, ivf_x, ivf_ctx["batches"], k, "K1")
    sharded_launches["K1"] += ivf_route["launches"]
    rec = gt.recall_of(ivf_m, ivf_ctx["truth"], ivf_x, ivf_ctx["keys"])
    single = ivf_ctx["recall"]
    ivf_route.update(
        strategy=resolved, recall10=rec[10].mean,
        recall10_single_pallas_w4=single["pallas_w4"][10],
        recall10_single_masked=single["masked"][10],
        recall10_ratio=rec[10].mean / max(single["pallas_w4"][10], 1e-12),
        recall10_ratio_to_masked=rec[10].mean / max(single["masked"][10], 1e-12),
    )
    out["ivf1m_w4"] = ivf_route
    out["multiprocess"] = _multiprocess_check(work)
    _emit({"phase": "sharded_backend", "backend": out["multiprocess"]["backend"],
           "gloo_all_gather_cuda": [r["gloo_all_gather_cuda"]
                                    for r in out["multiprocess"]["ranks"]]})
    out["routes"] = routes
    out["launches_sharded"] = sharded_launches
    out["launches_single_card"] = single_launches
    # every launch of the phase but the kernel-against-plain comparisons':
    # the timed batches above, plus warm-ups, recall, profile and the
    # multi-process reference
    out["launches"] = _launch_counts()
    _emit({"phase": "sharded", **out})

    checks = {
        "bit_equal": all(out["mesh_builds_bit_equal"].values()),
        "encode_rows": out["encode_vs_single_card"]["rows_equal"] >= 0.9999,
        "encode_near_ties": out["encode_vs_single_card"]["differing_rows_near_ties"],
        "ivf_pallas": resolved == "pallas",
        "ivf_launches": ivf_route["launches"] == shards * len(batches),
        "ivf_topk_launches": ivf_route["topk_launches"] == ivf_route["launches"],
        "ivf_recall": ivf_route["recall10_ratio"] >= 0.99,
        "multiprocess": all(c["id_equal"] == 1.0 or c["mismatches_near_ties"]
                            for c in out["multiprocess"]["against_one_process"]),
        "multiprocess_k1": all(r["k1_launches"] >= 1 for r in out["multiprocess"]["ranks"]),
    }
    for name, r in routes.items():
        checks[f"{name}_launches"] = (
            r[f"mesh{shards}"]["launches"] == shards * len(batches)
            and r["mesh1"]["launches"] == len(batches)
            and r[f"mesh{shards}"]["topk_launches"] == r["mesh1"]["topk_launches"] == 0)
        checks[f"{name}_recall"] = r["recall10_ratio"] >= 0.99
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sharded checks failed: {failed}")
    return dict(out, k1_shard=k1_shard, k2_shard=k2_shard)


def _launch_counts() -> dict:
    from gulon_tpu_torch.utils import tracing

    return {"K1": tracing.counter("k1.launches"), "K2": tracing.counter("k2.launches"),
            "K3": tracing.counter("k3.launches"),
            "TOPK": tracing.counter("ivf.topk.launches")}


def _aot_check(p, q, plain_out, batch, k) -> dict:
    """``export-aot`` of the flat, ``-p`` and ``--exact`` files, ``query
    --aot`` in process (stdout equal to ``query``'s), and the first 1024
    batch after ``load_index`` (cold) against the first after
    ``load_serving`` (warm), in process."""
    import numpy as np
    import torch

    import gulon_tpu_torch as gt

    start = _launch_counts()
    run = _Cli()
    out = {}
    for name, path in (("flat", p["flat.pb"]), ("ivf", p["ivf.pb"]), ("exact", p["exact.npz"])):
        sidecar = path + ".aot"
        line = run(f"export_{name}", ["export-aot", "--index", path, "-o", sidecar])
        served = run(f"query_{name}", ["query", "-k", str(k), "--index", path, "--aot",
                                       sidecar, p["q.txt"]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = gt.load_index(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cold_ms, d_cold, i_cold = _serve(cold, q, np.arange(batch), k)
        del cold
        warm_index = gt.load_index(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serving = gt.load_serving(sidecar, warm_index)
        torch.cuda.synchronize()
        load_serving_s = time.perf_counter() - t0
        warm_ms, d_warm, i_warm = _serve(serving, q, np.arange(batch), k)
        steady = [_serve(serving, q, np.arange(batch), k)[0] for _ in range(3)]
        out[name] = dict(
            export_line=line.strip(), sidecar_bytes=os.path.getsize(sidecar),
            plans={f"{b}x{kk}": plan["scan_strategy"]
                   for (b, kk), plan in sorted(serving._plans.items())},
            query_equal=served == plain_out[name], load_index_s=load_s,
            cold_first_ms=cold_ms, load_serving_s=load_serving_s, warm_first_ms=warm_ms,
            warm_steady_ms=steady,
            warm_equal_cold=bool(torch.equal(i_cold, i_warm) and torch.equal(d_cold, d_warm)),
        )
        del serving, warm_index
    end = _launch_counts()
    out["launches"] = {name: end[name] - start[name] for name in start}
    out["cli_seconds"] = run.seconds
    return out


def _fresh_aot_check(p, query_out, env) -> dict:
    """Fresh ``query`` processes with and without ``--aot``, in turns
    (plain, aot, aot, plain): each one's seconds, and the same stdout."""
    out = {"plain_s": [], "aot_s": [], "stdout_equal": True}
    for tag in ("plain", "aot", "aot", "plain"):
        extra = ["--aot", p["flat.pb"] + ".aot"] if tag == "aot" else []
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gulon_tpu_torch.cli", "query", "-k", "10", "--index",
             p["flat.pb"], *extra, p["q.txt"]],
            capture_output=True, text=True, env=env, cwd=_ROOT, timeout=600,
        )
        out[f"{tag}_s"].append(time.perf_counter() - t0)
        out["stdout_equal"] = out["stdout_equal"] and (
            proc.returncode == 0 and proc.stdout == query_out)
    return out


def _kernel_entry(name, source, replaces, launches, max_abs_err, case, **extra) -> dict:
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_resource", "library_ms",
            "library_call", "launches_per_batch")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max_abs_err, **{k: case[k] for k in keys}, **extra,
    )


def _probe_entries(probes) -> list:
    """The ``kernels`` entries of P1-P4 and the cut K1: launches on the probes' path, the
    largest error against the plain versions, and the numbers of one
    representative variant (the TPU probe's default decode, or its first
    variant), every variant's beside it."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_resource", "library_ms",
            "library_call", "bytes_read", "k1_ms")
    rows = (
        ("adc_probe", "P1", "p1", "gulon_tpu_torch/csrc/adc_probes.cu",
         "benchmarks/adc_probes.py:153", "glove100 base"),
        ("adc_probe_pipe", "P2", "p2", "gulon_tpu_torch/csrc/adc_probes.cu",
         "benchmarks/adc_probes.py:206", "glove100 base"),
        ("kernel_probe", "P3", "p3", "gulon_tpu_torch/csrc/kernel_probe.cu",
         "benchmarks/kernel_probe.py:49", "tdec_packed"),
        ("floor_probe", "P4", "p4", "gulon_tpu_torch/csrc/floor_probe.cu",
         "benchmarks/floor_probe.py:35", "codes+q, out v+i [32]"),
        ("adc_scan_stage", "K1 stages", "k1s", "gulon_tpu_torch/csrc/adc_scan.cu",
         "gulon_tpu/ops/pallas/adc.py:276 (K1, cut as benchmarks/kernel_probe.py:364 cuts it)",
         "glove100 contraction"),
    )
    entries = []
    for name, tag, group, source, replaces, rep in rows:
        cases = probes[group]
        case = cases[rep]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=probes["launches"][tag], max_abs_err=probes["max_abs_err"][group],
            **{k: case.get(k) for k in keys}, variant=rep,
            launches_by_path={"probes": probes["launches"][tag]},
            variants={v: {k: c.get(k) for k in keys} for v, c in cases.items()},
        ))
        if tag == "P1":  # each decode alone (probe_decode_rows), head to head
            entries[-1]["decode_alone"] = {v: {k: c.get(k) for k in keys}
                                           for v, c in probes["decode"].items()}
    return entries


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # internal: the streaming phase runs its builds in a child process,
    # the sharded phase its two ranks in two
    parser.add_argument("--streaming-child", metavar="FILE", help=argparse.SUPPRESS)
    parser.add_argument("--mesh-child", nargs=4, metavar=("RANK", "PORT", "DIR", "BACKEND"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.streaming_child:
        _emit(_streaming_child(args.streaming_child, train_sample=500_000))
        return 0
    if args.mesh_child:
        rank, port, work, backend = args.mesh_child
        _emit(_mesh_child(int(rank), int(port), work, backend))
        return 0
    import gulon_tpu_torch as gt
    from gulon_tpu_torch.ops.cuda import _build, adc, dense, ivf_topk
    from gulon_tpu_torch.probes import adc_probes, floor_probe, kernel_probe

    smi = _nvidia_smi()
    _emit({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    t0 = time.perf_counter()
    sources = ("adc_scan", "dense_scan", "adc_probes", "kernel_probe", "floor_probe",
               "ivf_topk")
    _build.build(sources)  # one nvcc each, in parallel
    adc._kernel()
    dense._kernel()
    adc_probes._kernel()
    kernel_probe._kernel()
    floor_probe._kernel()
    ivf_topk._kernel()
    for name in sources:
        seconds, report = _build.BUILD_INFO.get(name, (0.0, ""))
        _emit({
            "phase": "build", "kernel": name, "nvcc_seconds": seconds,
            "seconds": time.perf_counter() - t0,
            "library": str(_build.library_path(name).name),
            # registers, spill bytes and serialization warnings (C751x) of
            # each kernel instantiation
            "ptxas": _build.ptxas_by_kernel(report),
        })

    main_path, glove = phase_main_path(args.seed)
    if main_path["launches"] == 0:
        raise AssertionError("the main path never launched K1")
    k1 = phase_kernel(args.seed, main_path["launches_per_batch"])
    topk = phase_ivf_topk(args.seed, smi)
    probes = phase_probes(args.seed, smi)
    for name, count in probes["launches"].items():
        if count == 0:
            raise AssertionError(f"the probes' path never launched {name}")
    torch.cuda.empty_cache()
    x2m = low_rank_corpus(args.seed, 2_000_000, 300)
    exact = phase_exact_path(args.seed, x2m)
    cached = phase_cached_path(glove)
    lpb = {
        "exact_bf16": exact["bf16"]["launches_per_batch"][0],
        "exact_int8": exact["int8"]["launches_per_batch"][1],
        "cached": cached["launches_per_batch"],
    }
    dense_k = phase_dense_kernel(args.seed, x2m, glove, lpb)
    packed = phase_packed(glove, smi)
    work = tempfile.mkdtemp(prefix="gulon_smoke_")
    try:
        # the glove100 index and a query batch for the multi-process check
        gt.save_index(glove["index"], os.path.join(work, "glove.pb"))
        rows = np.random.default_rng(args.seed + 13).choice(len(glove["x"]), 1024, replace=False)
        np.save(os.path.join(work, "q.npy"), glove["x"][rows])
        del glove
        torch.cuda.empty_cache()
        streaming = phase_streaming(args.seed, x2m, smi)
        del x2m
        ivf, ivf_ctx = phase_ivf_path(args.seed)
        sharded = phase_sharded(args.seed, smi, ivf_ctx, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del ivf_ctx
    torch.cuda.empty_cache()
    phase_kmeans_determinism(args.seed)
    cli = phase_cli_path(args.seed, smi)
    k2, k3 = dense_k["k2"], dense_k["k3"]
    cli_l, aot_l = cli["launches"], cli["aot"]["launches"]
    packed_l = dict(zip(("K1", "K2", "K3"), packed["launches"]))
    sh_l, sh_1, sh_all = (sharded["launches_sharded"], sharded["launches_single_card"],
                          sharded["launches"])
    case_keys = ("ms", "plain_ms", "bound_ms", "bound_resource", "library_ms",
                 "launches_per_batch", "max_abs_err")
    _emit({"kernels": [
        _kernel_entry(
            "adc_scan", "gulon_tpu_torch/csrc/adc_scan.cu",
            "gulon_tpu/ops/pallas/adc.py:276",
            main_path["launches"] + ivf["launches"] + cli_l["K1"] + streaming["launches"]
            + aot_l["K1"] + sh_all["K1"],
            max(k1["max_abs_err"], ivf["kernel"]["max_abs_err"], streaming["max_abs_err"],
                sharded["k1_shard"]["max_abs_err"]),
            k1,
            launches_by_path={"flat": main_path["launches"], "ivf": ivf["launches"],
                              "cli": cli_l["K1"], "streaming": streaming["launches"],
                              "aot": aot_l["K1"], "packed": packed_l["K1"],
                              "sharded": sh_l["K1"], "deep10m_single_card": sh_1["K1"],
                              "sharded_phase_untimed": sh_all["K1"] - sh_l["K1"] - sh_1["K1"]},
            **{name: {k: case[k] for k in case_keys} for name, case in (
                ("ivf_w4", ivf["kernel"]),
                ("crawl2m_streamed_w1", streaming["flat"]["kernel"]),
                ("crawl2m_streamed_ivf_w4", streaming["ivf"]["kernel"]),
                ("deep10m_shard", sharded["k1_shard"]))},
        ),
        _kernel_entry(
            "dense_scan_bf16", "gulon_tpu_torch/csrc/dense_scan.cu",
            "gulon_tpu/ops/pallas/dense.py:89",
            exact["launches_k2"] + cached["launches"] + cli_l["K2"] + aot_l["K2"]
            + sh_all["K2"],
            max(dense_k["k2_max_abs_err"], sharded["k2_shard"]["max_abs_err"]), k2,
            launches_by_path={"exact": exact["launches_k2"], "cached": cached["launches"],
                              "cli": cli_l["K2"], "aot": aot_l["K2"],
                              "packed": packed_l["K2"], "sharded": sh_l["K2"],
                              "deep10m_single_card": sh_1["K2"],
                              "sharded_phase_untimed": sh_all["K2"] - sh_l["K2"] - sh_1["K2"]},
            cache_400k={k: dense_k["k2_cache"][k] for k in case_keys[:-1]},
            deep10m_shard={k: sharded["k2_shard"][k] for k in case_keys},
        ),
        _kernel_entry(
            "dense_scan_i8", "gulon_tpu_torch/csrc/dense_scan.cu",
            "gulon_tpu/ops/pallas/dense.py:419",
            exact["launches_k3"] + cli_l["K3"] + aot_l["K3"] + sh_all["K3"],
            dense_k["k3_max_abs_err"], k3,
            launches_by_path={"exact": exact["launches_k3"], "cli": cli_l["K3"],
                              "aot": aot_l["K3"], "packed": packed_l["K3"],
                              "sharded": sh_all["K3"]},
        ),
        _kernel_entry(
            "ivf_topk", "gulon_tpu_torch/csrc/ivf_topk.cu",
            "none: the JAX package's IVF epilogue ranks with lax.top_k under XLA",
            ivf["topk_launches"] + streaming["topk_launches"] + cli_l["TOPK"] + aot_l["TOPK"]
            + sh_all["TOPK"], 0.0,
            topk["deep96_fetch10"] | {
                "launches_per_batch": ivf["pallas_w4"]["topk_launches_per_batch"]},
            launches_by_path={"ivf": ivf["topk_launches"],
                              "streaming": streaming["topk_launches"], "cli": cli_l["TOPK"],
                              "aot": aot_l["TOPK"], "sharded": sh_all["TOPK"]},
            **{name: {k: case[k] for k in case_keys[:-2]} for name, case in topk.items()},
        ),
        *_probe_entries(probes),
    ]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
