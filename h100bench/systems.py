"""The system under test, ``gulon_tpu_torch``, behind the harness's
small interface; ``reference/control.py`` is the control behind the same
one. Only this module imports the program."""

from __future__ import annotations

import numpy as np
import torch

from h100bench.check import IndexState
from h100bench.corpus import rows_of_keys

# ExactIndex field <- the key of an exact configuration's index section
EXACT_FIELDS = {
    "operand": "operand", "rescore_factor": "rescore_factor",
    "exact_rescore": "exact_rescore", "scan_strategy": "strategy",
}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PortSystem:
    """``gulon_tpu_torch`` as a configuration's ``index`` section sets it."""

    def __init__(self, config: dict, device):
        import gulon_tpu_torch as gt

        self.gt = gt
        self.spec = config["index"]
        self.device = torch.device(device)

    def build(self, keys, vectors: np.ndarray, max_iters=None):
        """Build through the public entry from host arrays, as users call it;
        ``max_iters`` cuts the Lloyd loops (a warm-up build). An exact index
        takes the fields its file states; a flat one with ``"cache": true``
        decodes its cache after the build, as ``enable_cache()`` does for
        users."""
        gt, spec = self.gt, self.spec
        metric = gt.Metric.parse(spec["metric"])
        if spec["kind"] == "exact":
            index = gt.build_exact_index(keys, vectors, metric, device=self.device)
            for field, key in EXACT_FIELDS.items():
                setattr(index, field, spec[key])
            _sync(self.device)
            return index
        pq = gt.PQConfig(**dict(spec["pq"], **({"max_iters": max_iters} if max_iters else {})))
        if spec["kind"] == "flat":
            index = gt.build_flat_index(keys, vectors, metric, pq, device=self.device)
            if spec.get("cache"):
                index.enable_cache()
        else:
            index = gt.build_ivf_index(
                keys, vectors, metric, pq, num_partitions=spec["partitions"],
                strategy=gt.LimitGroups(spec["probe"]), device=self.device,
                **({"coarse_max_iters": max_iters} if max_iters else {}),
            )
        _sync(self.device)
        return index

    @staticmethod
    def compile_seconds() -> float:
        """Seconds of ``nvcc`` the port spent building its kernels in this
        process, summed over the libraries it built (0 when the checkout's
        build cache held them all)."""
        from gulon_tpu_torch.ops.cuda import _build

        return float(sum(seconds for seconds, _ in _build.BUILD_INFO.values()))

    @staticmethod
    def query(index, k: int, q: np.ndarray):
        """``(dists, rows)`` host arrays of one batch; rows are the index's."""
        d, i = index.query_arrays(k, q)
        return d.cpu().numpy(), i.cpu().numpy()

    @staticmethod
    def corpus_rows(index) -> np.ndarray:
        """Corpus row of each of the index's rows (from its keys)."""
        return rows_of_keys(index.key_index.keys)

    def export(self, index) -> IndexState:
        rows = torch.from_numpy(self.corpus_rows(index)).to(index.device)
        if self.spec["kind"] == "exact":
            vectors = torch.empty_like(index.vectors)
            vectors[rows] = index.vectors
            return IndexState(kind="exact", vectors=vectors)
        codes = torch.empty_like(index.codes, dtype=torch.long)
        codes[rows] = index.codes.long()
        state = IndexState(
            kind=self.spec["kind"], bounds=list(index.pq.bounds),
            codebooks=index.pq.codebooks.clone(), codes=codes,
        )
        if state.kind == "flat":
            state.norms = torch.empty_like(index.recon_norms)
            state.norms[rows] = index.recon_norms
        else:
            state.part = torch.empty_like(codes[:, 0])
            state.part[rows] = index.group_ids.long()
            state.centroids = index.centroids.clone()
            state.probe = int(self.spec["probe"])
        return state
