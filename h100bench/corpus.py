"""Corpus and queries of a cell, drawn on the device from the seed.

The recipe is ``benchmarks/common.py::low_rank_corpus_device`` (low-rank
clustered rows: a random basis of ``intrinsic`` directions, ``clusters``
centres in that space, a spread of 0.3 about each centre, isotropic noise
of ``noise`` in the full space), copied here in PyTorch so that changes
to the program cannot change the data. Queries are further rows of the
same draw, held out of the index, as ann-benchmarks holds its query
sets out. A configuration fixes the seed of its data (``corpus.seed``):
the data stands in for the dataset's file, which is the same in every
run; a run's ``--seed`` orders the queries and arrivals and draws the
answers the check compares.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def low_rank(
    seed: int,
    rows: int,
    dim: int,
    *,
    intrinsic: int,
    clusters: int,
    noise: float,
    device,
) -> torch.Tensor:
    """``[rows, dim]`` f32 on ``device``, in a few large calls."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    basis = torch.randn((intrinsic, dim), **f32)
    centres = torch.randn((clusters, intrinsic), **f32)
    labels = torch.randint(0, clusters, (rows,), device=device, generator=g)
    z = centres[labels] + 0.3 * torch.randn((rows, intrinsic), **f32)
    x = torch.matmul(z, basis) / math.sqrt(intrinsic)
    return x + noise * torch.randn((rows, dim), **f32)


def keys_for(n: int):
    """Zero-padded string keys in sorted order: key ``i`` names row ``i``."""
    width = len(str(max(n - 1, 0)))
    return [f"{i:0{width}d}" for i in range(n)]


def rows_of_keys(keys) -> np.ndarray:
    """Row numbers of keys made by :func:`keys_for`."""
    return np.asarray(keys, dtype=str).astype(np.int64)


def make(config: dict, device):
    """``(corpus [n, d], queries [q, d])`` host f32 arrays of a configuration.

    Drawn on ``device``, then copied to the host once: the builders take
    host arrays, as users call them. An angular dataset stays unnormalised
    here: the index normalises what it is given (``Metric.COSINE``), and
    the reference normalises on its own."""
    data, recipe = config["dataset"], config["corpus"]
    n, nq, d = data["n"], data["queries"], data["d"]
    if torch.device(device).type == "cuda":
        # exact f32 products, whatever the process-wide TF32 switch says
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
    x = low_rank(
        recipe["seed"], n + nq, d, intrinsic=recipe["intrinsic"],
        clusters=recipe["clusters"], noise=recipe["noise"], device=device,
    )
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = prev
    host = x.cpu().numpy()
    del x
    return host[:n], host[n:]
