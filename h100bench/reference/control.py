"""The control: the reference put in the program's place, one precision
below the one the configuration states (its ``checks`` file names each).

It builds the same index (k-means from drawn rows, the reference's
subspace split, encode, norms; exact: the rows themselves) and answers
the same queries (the flat scan over every row; IVF: the ``probe``
partitions with the nearest centroids, then their rows; exact: every
row), with every product on the grid of the precision given, so that the
check can be shown to fail it. A flat index with its cache decoded is
the flat control: the cache is the codes' reconstruction. The exact
control keeps its rows on the ``rows`` grid and reports the distances its
``scan`` computes from them, with no float32 rescore.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h100bench.check import IndexState
from h100bench.reference import exact
from h100bench.reference import pq as rpq


@dataclasses.dataclass
class ControlIndex:
    state: IndexState
    cosine: bool


class ControlSystem:
    def __init__(self, config: dict, precision: dict, device):
        self.spec = config["index"]
        self.prec = precision
        self.device = torch.device(device)

    def build(self, keys, vectors: np.ndarray, max_iters=None) -> ControlIndex:
        spec, p = self.spec, self.prec
        cosine = spec["metric"] == "cosine"
        x = torch.from_numpy(np.asarray(vectors, np.float32)).to(self.device)
        if cosine:
            x = exact.normalized(x)
        if spec["kind"] == "exact":
            rows = rpq.rounded(x, p["rows"])
            return ControlIndex(IndexState(kind="exact", vectors=rows), cosine)
        m, k = spec["pq"]["num_quantizers"], spec["pq"]["num_clusters"]
        iters, seed = max_iters or spec["pq"]["max_iters"], spec["pq"]["seed"]
        bounds = rpq.subspace_bounds(x.shape[1], m)
        width = max(w for _, w in bounds)
        state = IndexState(kind=spec["kind"], bounds=bounds, codebooks=None, codes=None)
        if spec["kind"] == "ivf":
            cents = rpq.kmeans(
                x[None], spec["partitions"], iters, seed,
                precision=p["coarse"], storage=p["centroids"],
            )[0]
            state.part = rpq.assign(x, cents, p["coarse"])
            state.centroids = cents
            state.probe = int(spec["probe"])
            x = x - cents[state.part]
        xs = rpq.split(x, bounds, width)
        state.codebooks = rpq.kmeans(xs, k, iters, seed, precision=p["train"], storage=p["codebook"])
        state.codes = rpq.assign(xs, state.codebooks, p["encode"]).T.contiguous()
        xr = rpq.decode(state.codebooks, state.codes, bounds)
        state.norms = rpq.rounded((xr * xr).sum(-1), p["norms"])
        return ControlIndex(state, cosine)

    def query(self, index: ControlIndex, k: int, q: np.ndarray, block: int = 256):
        """``(dists, rows)`` host arrays; rows are corpus rows."""
        s, p = index.state, self.prec
        q = torch.from_numpy(np.asarray(q, np.float32)).to(self.device)
        if index.cosine:
            q = exact.normalized(q)
        if s.kind == "exact":
            r, norms = s.vectors, (s.vectors * s.vectors).sum(-1)
        else:
            r, norms = rpq.decode(s.codebooks, s.codes, s.bounds), s.norms  # residual
        if s.kind == "ivf":
            c = s.centroids
            row_const = norms + 2.0 * (c[s.part] * r).sum(-1)
        vals, rows = [], []
        for b in range(0, q.shape[0], block):
            qb = q[b : b + block]
            qn = (qb * qb).sum(-1)
            if s.kind != "ivf":
                d = qn[:, None] + norms[None, :] - 2.0 * rpq.mm(qb, r.T, p["scan"])
            else:
                cdist = qn[:, None] + (c * c).sum(-1)[None, :] - 2.0 * rpq.mm(qb, c.T, "f32")
                probed = torch.topk(cdist, min(s.probe, c.shape[0]), dim=1, largest=False).indices
                hit = torch.zeros_like(cdist, dtype=torch.bool).scatter_(1, probed, True)
                d = (cdist[:, s.part] + row_const[None, :]) - 2.0 * rpq.mm(qb, r.T, p["scan"])
                d = torch.where(hit[:, s.part], d, torch.inf)
            v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
            vals.append(v)
            rows.append(i)
        return torch.cat(vals).cpu().numpy(), torch.cat(rows).cpu().numpy()

    @staticmethod
    def corpus_rows(index: ControlIndex) -> np.ndarray:
        s = index.state
        return np.arange((s.vectors if s.kind == "exact" else s.codes).shape[0])

    @staticmethod
    def export(index: ControlIndex) -> IndexState:
        return index.state
