#!/usr/bin/env python3
"""When the queries reach the shards' cards, and what that does to a
sharded batch.

The sharded scans (``gulon_tpu_torch/parallel/ops.py``) copy the queries
to every shard's device before any shard's work is issued (``first``).
This script holds that against copying each shard's queries just before
that shard's own work (``lazy``): a cross-device copy is ordered after the
work already queued on its source card, so there a shard cannot start
before shard 0's work on card 0 has ended.

deep10m's serving shape over a mesh of every card (four logical shards of
card 0 on a one-card machine): 10,000,000 x 96 standard-normal rows, PQ 12
x 256, batches of 1024 queries drawn from the rows, top-10. Routes: flat
``auto`` (K1 per shard), ``cached`` (K2 per shard) and exact (K2 per shard
with its f32 rescore), each at mesh 1 (card 0 alone) and then over the
mesh in turns: first, lazy, lazy, first. Each turn is a warm-up batch and
``--batches`` timed ones. For each batch: host ms until ``query_arrays``
returns (``issue_ms``) and until card 0 holds the merged result
(``ms``), and for each shard the ms from the batch's start on its card to
the start and to the end of its work (CUDA events recorded on each card at
the batch's start and around each shard's work).

Run from the root of a checkout: ``python3 scripts/shard_copy_ab.py
[--rows 10000000] [--batches 6]``. ``--device cpu --rows 40000`` runs the
script itself on eight logical CPU shards (no timings). Prints the card's
name and power limit first, then one JSON line per route and turn.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _OnAccess:
    """``replicate()``'s list, but each device's copy is made when a shard
    first reads it: inside that shard's work, after the earlier shards'
    work is queued."""

    def __init__(self, array, mesh):
        self.array, self.mesh, self.copies = array, mesh, {}

    def __getitem__(self, r):
        dev = self.mesh.row_device(r)
        if dev not in self.copies:
            self.copies[dev] = self.array.to(dev)
        return self.copies[dev]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--batches", type=int, default=6)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    import gulon_tpu_torch as gt
    from gulon_tpu_torch.parallel import make_mesh, shard_index
    from gulon_tpu_torch.parallel import ops as pops
    from gulon_tpu_torch.parallel.mesh import replicate

    on_cuda = args.device == "cuda"
    if on_cuda:
        if not torch.cuda.is_available():
            print("shard_copy_ab: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
        cards = torch.cuda.device_count()
        mesh = make_mesh() if cards >= 2 else make_mesh(devices=["cuda:0"] * 4)
    else:
        cards = 0
        mesh = make_mesh(devices=["cpu"] * 8)
    dev0 = torch.device(args.device, 0) if on_cuda else torch.device("cpu")
    mesh1 = make_mesh(devices=[dev0])

    def sync():
        if on_cuda:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def event(dev):
        if not on_cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(dev))
        return e

    def between(a, b) -> float:
        return a.elapsed_time(b) if on_cuda else (b - a) * 1e3

    # the shards' work, bracketed by events on its card
    spans = {}
    scan_and_merge = pops.scan_and_merge

    def traced(mesh_, k, shard_fn, local_n=None):
        def timed(r):
            dev = mesh_.row_device(r)
            start = event(dev)
            out = shard_fn(r)
            spans[r] = (dev, start, event(dev))
            return out
        return scan_and_merge(mesh_, k, timed, local_n)

    pops.scan_and_merge = traced

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    x = rng.standard_normal((args.rows, 96), dtype=np.float32)
    keys = np.array([f"d{i:08d}" for i in range(args.rows)], dtype=object)
    batches = [np.sort(rng.choice(args.rows, 1024, replace=False))
               for _ in range(args.batches + 1)]
    cfg = gt.PQConfig(num_clusters=256, num_quantizers=12, max_iters=15,
                      train_sample=min(200_000, args.rows))
    print(json.dumps({"cards": cards, "shards": mesh.shape["rows"],
                      "devices": [str(d) for d in mesh.devices[:, 0]],
                      "setup_s": time.perf_counter() - t0}), flush=True)

    def turn(route, variant, index, mesh_tag, rnd) -> None:
        pops.replicate = _OnAccess if variant == "lazy" else replicate
        rows = []
        for i, b in enumerate(batches):
            q = x[b]
            sync()
            spans.clear()
            starts = {d: event(d) for d in set(mesh_tag.devices[:, 0])}
            t = time.perf_counter()
            d, ids = index.query_arrays(10, q)
            issue = time.perf_counter() - t
            sync()
            ms = (time.perf_counter() - t) * 1e3
            if not bool(torch.isfinite(d).all()) or d.shape != (1024, 10):
                raise AssertionError(f"{route} {variant}: bad result {tuple(d.shape)}")
            if i:  # the first batch warms up
                rows.append(dict(ms=ms, issue_ms=issue * 1e3, shards=[
                    [between(starts[dev], a), between(starts[dev], e)]
                    for _, (dev, a, e) in sorted(spans.items())]))
        pops.replicate = replicate
        shards = len(rows[0]["shards"])
        print(json.dumps({
            "route": route, "variant": variant, "round": rnd,
            "ms_per_batch": [r["ms"] for r in rows],
            "issue_ms": [r["issue_ms"] for r in rows],
            "shard_start_end_ms": [
                [statistics.median(r["shards"][s][j] for r in rows) for j in (0, 1)]
                for s in range(shards)],
        }), flush=True)

    def routes(name, index) -> None:
        turn(name, "mesh1", shard_index(index, mesh1), mesh1, 0)
        sharded = shard_index(index, mesh)
        for rnd, variant in enumerate(("first", "lazy", "lazy", "first")):
            turn(name, variant, sharded, mesh, rnd)

    index = gt.build_flat_index(keys, x, pq_config=cfg, device=dev0)
    routes("flat_auto", index)
    index.enable_cache()
    index.scan_strategy = "cached"
    routes("cached", index)
    del index
    exact = gt.build_exact_index(keys, x, device=dev0)
    routes("exact", exact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
