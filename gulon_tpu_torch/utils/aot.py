"""Ahead-of-time serving plans (counterpart of ``gulon_tpu/utils/aot.py``).

The JAX package exports its query computation as StableHLO at standard
``(batch, k)`` shapes, so a fresh process skips the trace on its first
query. The port has nothing to trace: what its first query pays for is
resolving the route (the ``auto`` policy and the code-degeneracy
statistic behind the rerank factor and the winners) and building the
lazy operands the route reads (K1's transposed codes, the IVF
partition-padded layout, the dense kernels' operands) and loading the
kernel library. So a port artifact is the route resolved for one
``(batch, k)``, stored as JSON:

- the index kind and scan strategy, IVF ``auto`` resolved per batch as
  the live path resolves it (the port's policy: ``pallas``, so K1, for
  batches on the card), ``bucketed`` refused and ``gathered`` needing a
  ``LimitGroups`` strategy (``gulon_tpu/utils/aot.py:383-420``);
- a flat index's resolved rerank factor and winners, an IVF index's
  winners and rescore, and an exact index's operand.

:func:`load_serving` refuses a plan that differs from the route the
loaded index resolves at that shape (a sidecar of another index), then
builds every plan's operands and runs each plan once, so the first query
after it runs at steady speed. The sidecar is
the JAX package's container: an npz holding a ``meta`` JSON (``version``,
``platform``, ``dimension``, ``shapes`` and a ``format`` key that marks
the port's plans) and one ``a_{batch}_{k}`` uint8 entry a shape.
``AOTServing.query_arrays`` serves a request through the plan of the
tightest exported batch, then the smallest ``k' >= k`` (truncating),
without padding the batch: results are per query. A JAX-written sidecar
loads (version and dimension checked) and every call takes the live
path, as the JAX package does on a platform mismatch.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gulon_tpu_torch.models.exact import ExactIndex
from gulon_tpu_torch.models.flat import FlatIndex
from gulon_tpu_torch.models.index import Index
from gulon_tpu_torch.models.ivf import IVFIndex, LimitGroups

_VERSION = 1
_FORMAT = "gulon_tpu_torch.plan"


def _kind(index) -> str:
    if isinstance(index, ExactIndex):
        return "exact"
    if isinstance(index, FlatIndex):
        return "flat"
    if isinstance(index, IVFIndex):
        return "ivf"
    raise TypeError(f"cannot export serving for {type(index)!r}")


def _plan_for(index, k: int, batch: int) -> dict:
    """The route the live path takes for a ``[batch, D]`` query at ``k``."""
    kind = _kind(index)
    k_eff = min(k, index.size)
    if kind == "exact":
        strategy = index.resolve_strategy(k)
        knobs = {"operand": index.resolved_operand} if strategy == "pallas" else {}
    elif kind == "flat":
        strategy = index.resolve_strategy(batch, k)
        knobs = {}
        if strategy in ("pallas", "cached"):
            knobs["rerank_factor"] = index.resolved_rerank_factor()
        if strategy == "pallas":
            knobs["pallas_winners"] = index.resolved_pallas_winners()
    else:
        groups = isinstance(index.strategy, LimitGroups)
        strategy = index.scan_strategy
        if strategy == "auto":
            strategy = index._resolve_auto(batch, k_eff)
            if strategy in ("gathered", "bucketed"):
                # gathered is the plannable sublinear form; LimitVectors'
                # data-dependent probe widths take the masked scan
                strategy = "gathered" if groups else "masked"
        if strategy == "pallas" and not index._pallas_eligible(k_eff):
            strategy = "masked"
        if strategy == "gathered" and not groups:
            raise ValueError(
                "AOT export of scan_strategy='gathered' requires a LimitGroups "
                "strategy (LimitVectors probe widths are data-dependent)"
            )
        if strategy == "bucketed":
            raise ValueError(
                "scan_strategy='bucketed' plans its entry schedule host-"
                "side per batch and cannot be AOT-exported; use 'gathered' "
                "(sublinear, exportable) or 'masked'"
            )
        knobs = {}
        if strategy == "pallas":
            knobs = {"pallas_winners": index.pallas_winners,
                     "pallas_rescore": index.pallas_rescore}
    return {"kind": kind, "batch": int(batch), "k": int(k),
            "scan_strategy": strategy, **knobs}


def _view(index, plan: dict):
    """The index with the plan's route fixed; it shares the index's
    arrays and lazily built operands."""
    knobs = {name: plan[name] for name in (
        "scan_strategy", "rerank_factor", "pallas_winners", "pallas_rescore", "operand",
    ) if name in plan}
    return dataclasses.replace(index, **knobs)


def _warm(index, view, batch: int, k: int) -> None:
    """Run the view once at its shape, then hand the operands it built to
    the index so later views start from them."""
    view.query_arrays(k, np.zeros((batch, index.dimension), np.float32))
    index._adopt_operands(view)


@dataclasses.dataclass
class ServingBundle:
    """Serving plans keyed by ``(batch, k)``, JSON bytes each."""

    platform: str
    dimension: int
    artifacts: Dict[Tuple[int, int], bytes]


def export_serving(
    index,
    shapes: Sequence[Tuple[int, int]] = ((1, 10), (1024, 10)),
    *,
    warm_cache: bool = True,
) -> ServingBundle:
    """Resolve the index's route at each ``(batch, k)``. ``warm_cache``
    runs each shape once (building its operands on the index)."""
    plans = {(int(b), int(k)): _plan_for(index, int(k), int(b)) for b, k in shapes}
    if warm_cache:
        for (batch, k), plan in plans.items():
            _warm(index, _view(index, plan), batch, k)
    artifacts = {key: json.dumps(plan, sort_keys=True).encode()
                 for key, plan in plans.items()}
    return ServingBundle(
        platform=index.device.type, dimension=index.dimension, artifacts=artifacts
    )


def save_serving(path: str, bundle: ServingBundle) -> None:
    """Write a bundle as one npz sidecar (the JAX package's container)."""
    arrays = {
        f"a_{b}_{k}": np.frombuffer(blob, np.uint8)
        for (b, k), blob in bundle.artifacts.items()
    }
    meta = json.dumps({
        "version": _VERSION,
        "platform": bundle.platform,
        "dimension": bundle.dimension,
        "shapes": sorted(bundle.artifacts),
        "format": _FORMAT,
    })
    arrays["meta"] = np.frombuffer(meta.encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


@dataclasses.dataclass
class AOTServing(Index):
    """An index and its serving plans; a drop-in for the Index API.

    ``query_arrays`` serves a ``(batch, k)`` that fits an exported shape
    through that plan's view of the index (the batch is not padded), and
    every other call through the index itself."""

    index: object
    platform: str
    _plans: Dict[Tuple[int, int], dict] = dataclasses.field(default_factory=dict)
    _views: Dict[Tuple[int, int], object] = dataclasses.field(default_factory=dict)

    def _pick(self, k: int, num_q: int) -> Optional[Tuple[int, int]]:
        # an exported k' >= k serves k by truncation (results ascend).
        # The tightest batch first, then the smallest k'
        # (gulon_tpu/utils/aot.py:502-513)
        if self.platform != self.index.device.type:
            return None
        fits = [(b, kk) for (b, kk) in self._views if kk >= k and b >= num_q]
        return min(fits) if fits else None

    def query_arrays(self, k: int, vectors):
        shape = tuple(getattr(vectors, "shape", None) or np.shape(vectors))
        key = self._pick(k, shape[0]) if len(shape) == 2 else None
        if key is None:
            return self.index.query_arrays(k, vectors)
        dists, ids = self._views[key].query_arrays(key[1], vectors)
        return dists[:, :k], ids[:, :k]

    def batch_query(self, k: int, vectors) -> List:
        dists, ids = self.query_arrays(k, vectors)
        return self._make_results(dists.cpu().numpy(), ids.cpu().numpy())

    # --- passthroughs, so AOTServing serves wherever an index does ---

    @property
    def key_index(self):
        return self.index.key_index

    @property
    def dimension(self) -> int:
        return self.index.dimension

    @property
    def size(self) -> int:
        return self.index.size

    @property
    def metric(self):
        return self.index.metric

    @property
    def device(self):
        return self.index.device

    def lookup(self, word: str):
        return self.index.lookup(word)


def load_serving(path: str, index) -> AOTServing:
    """Attach a saved sidecar's plans to a loaded index.

    For the port's plans on the index's device type, this checks that each
    plan is the route the index resolves at that shape (``ValueError`` if
    not), builds each plan's operands and runs each plan once, so the
    first request runs at steady speed. A sidecar the JAX package wrote
    (StableHLO, no ``format`` key) loads too, and every call takes the
    live path."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["version"] != _VERSION:
            raise ValueError(
                f"serving artifact version {meta['version']} unsupported"
            )
        if meta["dimension"] != index.dimension:
            raise ValueError(
                "serving artifacts were exported for dimension "
                f"{meta['dimension']}, index has {index.dimension}"
            )
        plans = {}
        if meta.get("format") == _FORMAT:
            for b, k in meta["shapes"]:
                plans[(int(b), int(k))] = json.loads(z[f"a_{b}_{k}"].tobytes())
    serving = AOTServing(index=index, platform=meta["platform"], _plans=plans)
    if serving.platform != index.device.type:
        return serving
    kind = _kind(index)
    for (b, k), plan in sorted(plans.items()):
        if plan["kind"] != kind:
            raise ValueError(
                f"serving plans were exported for a {plan['kind']} index, "
                f"this one is {kind}"
            )
        # a plan is what the index resolves at its shape: one that differs
        # was exported for another index (or other knobs) of this width
        live = _plan_for(index, k, b)
        if plan != live:
            raise ValueError(
                f"serving plan {plan} for ({b}, {k}) was exported for another "
                f"index or other serving knobs; this one resolves {live}"
            )
    for (b, k), plan in sorted(plans.items()):
        _warm(index, _view(index, plan), b, k)
    # the views made after every warm-up share all the index's operands
    serving._views = {key: _view(index, plan) for key, plan in plans.items()}
    return serving
