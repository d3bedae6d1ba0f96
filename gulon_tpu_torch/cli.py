"""``gulon-tpu-torch`` command-line interface: ``python -m gulon_tpu_torch.cli``
(counterpart of ``gulon_tpu/cli.py``; the reference CLI is
``command/Main.scala`` and its subcommand files).

The verbs, flags, defaults, output formats and error messages are the JAX
package's: ``build-index`` (``BuildIndex.scala:29-68,104-106``), ``query``
(``Query.scala``, ``key: n1,n2,...`` lines), ``query-words``
(``QueryWords.scala``, ``<word> not found`` for misses), ``test``
(``Test.scala:17-37``, ``R@k: mean +/- stdDev`` lines), and the extras
``add-vectors``, ``remove-keys``, ``tune``, ``info`` and ``serve``. Index
files are the reference's protobuf format (``utils/serde.py``), npz for
``--exact``.

Every verb runs on the CUDA card; :func:`main` takes ``device=`` as a
Python keyword (the tests pass ``"cpu"``), not as a flag.
``build-index --streaming`` builds from the text file without holding its
vectors (``models/streaming.py``); ``export-aot`` writes serving plans
that ``--aot`` serves through (``utils/aot.py``). ``--mesh N`` serves the
index row-sharded over the first N cards (``parallel/``); on the CPU
(``device="cpu"``) over N logical shards of it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

def _positive_int(lo: int, hi: Optional[int] = None):
    def parse(value: str) -> int:
        v = int(value)
        if v < lo or (hi is not None and v > hi):
            bound = f">= {lo}" if hi is None else f"in [{lo}, {hi}]"
            raise argparse.ArgumentTypeError(f"expected {bound}, got {v}")
        return v

    return parse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gulon-tpu-torch",
        description="approximate nearest-neighbour indices over keyed "
        "embedding vectors, served from an NVIDIA GPU",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    b = sub.add_parser(
        "build-index", help="build an ANN index from word2vec-format vectors"
    )
    b.add_argument(
        "--metric",
        required=True,
        choices=["l2", "cosine"],
        help="distance metric",
    )
    b.add_argument(
        "-k", "--clusters",
        type=_positive_int(1, 65536),
        default=256,
        help="codewords per subquantizer (default 256)",
    )
    b.add_argument(
        "-m", "--quantizers",
        type=_positive_int(1),
        default=25,
        help="number of subquantizers (default 25)",
    )
    b.add_argument(
        "-n", "--max-iters",
        type=_positive_int(1),
        default=100,
        help="max k-means iterations (default 100)",
    )
    b.add_argument(
        "-p", "--partitioned",
        action="store_true",
        help="build a partitioned (IVF residual) index",
    )
    b.add_argument(
        "--exact",
        action="store_true",
        help="build an exact (unquantized full-scan) index instead of a PQ "
        "index; saved as npz, quantization flags are ignored",
    )
    b.add_argument(
        "--partitions",
        type=_positive_int(1),
        default=None,
        help="number of coarse partitions (default: size/1000)",
    )
    b.add_argument(
        "--limit",
        type=_positive_int(1),
        default=None,
        help="partitions probed per query (default: max(5%% of partitions, 5))",
    )
    b.add_argument(
        "--limit-vectors",
        type=_positive_int(1),
        default=None,
        help="probe nearest partitions until this many candidate vectors "
        "are covered (LimitVectors strategy; mutually exclusive with "
        "--limit)",
    )
    b.add_argument(
        "--max-partition-size",
        type=_positive_int(1),
        default=None,
        help="split coarse partitions larger than this into capacity-"
        "bounded children (bounds sublinear-scan probe cost; requires "
        "--partitioned)",
    )
    b.add_argument(
        "--kmeans-init",
        choices=("sample", "kmeans++"),
        default="sample",
        help="codebook/partition seeding: 'sample' (reference-faithful "
        "uniform rows, default) or 'kmeans++' (D^2-weighted, usually "
        "lower quantization error at equal iterations)",
    )
    b.add_argument(
        "--opq",
        type=_positive_int(1),
        default=None,
        metavar="ITERS",
        help="train an OPQ rotation (that many alternating rounds) before "
        "quantizing: lower quantization error / higher recall at the same "
        "code bytes (quantized in-memory builds; partitioned builds learn "
        "the rotation on the coarse residuals)",
    )
    b.add_argument(
        "--streaming",
        action="store_true",
        help="stream the build: parse the text file in chunks on host "
        "threads while the card encodes, never holding the full float "
        "matrix in host memory (word2vec text input, quantized builds)",
    )
    b.add_argument("-o", "--output", required=True, help="output index file")
    b.add_argument("input", help="word2vec-format text file")

    q = sub.add_parser("query", help="batch query an index")
    q.add_argument("-k", type=_positive_int(1), default=1)
    q.add_argument("--index", required=True, help="index file")
    q.add_argument("input", help="word2vec-format query file")

    w = sub.add_parser(
        "query-words", help="interactive nearest-word lookup (words on stdin)"
    )
    w.add_argument("-k", type=_positive_int(1), default=1)
    w.add_argument("--index", required=True, help="index file")

    a = sub.add_parser(
        "add-vectors",
        help="add word2vec-format vectors to an existing index "
        "(frozen codebooks; an extra over the reference)",
    )
    a.add_argument("--index", required=True, help="input index file")
    a.add_argument("-o", "--output", required=True, help="output index file")
    a.add_argument("input", help="word2vec-format vectors to add")

    r = sub.add_parser(
        "remove-keys",
        help="remove keys from an existing index (an extra over the "
        "reference)",
    )
    r.add_argument("--index", required=True, help="input index file")
    r.add_argument("-o", "--output", required=True, help="output index file")
    r.add_argument("keys", nargs="*", help="keys to remove")
    r.add_argument(
        "--keys-file",
        default=None,
        help="file with one key per line (combined with positional keys)",
    )

    tn = sub.add_parser(
        "tune",
        help="auto-tune a partitioned index's probe limit to a recall "
        "target (an extra over the reference)",
    )
    tn.add_argument("--vectors", required=True, help="word2vec-format source")
    tn.add_argument("--index", required=True, help="index file")
    tn.add_argument("-o", "--output", required=True, help="tuned index file")
    tn.add_argument(
        "--target-recall", type=float, default=0.9,
        help="distance-cutoff recall@k target (default 0.9)",
    )
    tn.add_argument("-k", type=_positive_int(1), default=10)
    tn.add_argument(
        "--sample", type=_positive_int(1), default=256,
        help="number of sampled self-queries (default 256)",
    )
    tn.add_argument(
        "-e", "--error", type=float, default=0.0,
        help="relative distance epsilon (default 0)",
    )

    info = sub.add_parser(
        "info", help="print an index's configuration and memory footprint"
    )
    info.add_argument("--index", required=True, help="index file")

    ex = sub.add_parser(
        "export-aot",
        help="export ahead-of-time serving artifacts for an index (a "
        "sidecar of resolved serving plans; an extra over the reference)",
    )
    ex.add_argument("--index", required=True, help="index file")
    ex.add_argument(
        "-o", "--output", required=True, help="output .aot sidecar file"
    )
    ex.add_argument(
        "--batches",
        default="1,1024",
        help="comma-separated query batch sizes to export (default 1,1024); "
        "serving pads smaller batches up to the nearest exported size",
    )
    ex.add_argument(
        "-k",
        default="10",
        help="comma-separated top-k values to export (default 10)",
    )

    srv = sub.add_parser(
        "serve",
        help="serve an index over a TCP line protocol (JSON per line; "
        "an extra over the reference)",
    )
    srv.add_argument("--index", required=True, help="index file")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument(
        "--port", type=int, default=0,
        help="TCP port (default 0 = ephemeral, printed at startup)",
    )
    srv.add_argument(
        "--warm-k", type=_positive_int(1), default=10, metavar="K",
        help="warm the query path for this k at startup (first request "
        "then runs at device speed; default 10)",
    )
    srv.add_argument(
        "--batch-window-ms", type=float, default=0.0, metavar="MS",
        help="micro-batching: coalesce query requests arriving within "
        "this window into one device batch (0 = off, the default; "
        "many-small-client deployments gain up to the batch factor in "
        "throughput at up to MS added latency)",
    )

    t = sub.add_parser("test", help="measure recall@k of an index")
    t.add_argument("--vectors", required=True, help="word2vec-format source")
    t.add_argument("--index", required=True, help="index file")
    t.add_argument(
        "--sample", type=_positive_int(1), default=1000,
        help="number of sampled self-queries (default 1000)",
    )
    t.add_argument(
        "--queries",
        default=None,
        metavar="FILE",
        help="word2vec-format external query file: measure recall for "
        "these queries instead of self-samples (--sample is then ignored; "
        "an extra over the reference CLI, library parity with "
        "Tests.forQueries)",
    )
    t.add_argument(
        "-e", "--error", type=float, default=0.0,
        help="relative distance epsilon (default 0)",
    )
    for sp in (q, w, t, ex, srv):  # serving-side knobs
        sp.add_argument(
            "--scan-strategy",
            default=None,
            help="device scan strategy (flat index: auto|decode|lut|cached|"
            "pallas; partitioned index: auto|masked|pallas|gathered|"
            "bucketed; exact index: auto|xla|pallas)",
        )
        sp.add_argument(
            "--precision",
            default=None,
            choices=["default", "highest"],
            help="scan matmul precision (default: TF32 allowed on the card)",
        )
        sp.add_argument(
            "--rerank-factor",
            type=int,
            default=None,
            metavar="R",
            help="over-fetch R*k kernel candidates and exact-rescore to k "
            "(flat index; 0 = auto from the code-degeneracy statistic, "
            "1 = off)",
        )
        sp.add_argument(
            "--pallas-winners",
            type=int,
            default=None,
            metavar="W",
            help="ranked candidates the fused kernel keeps per 128-row "
            "block (flat: 0 = auto; ivf: 1..4)",
        )
    for sp in (q, w, t, srv):
        sp.add_argument(
            "--mesh",
            type=_positive_int(1),
            default=None,
            metavar="N",
            help="shard the index row-wise over the first N devices and "
            "serve with a top-k merge (default: single device)",
        )
        sp.add_argument(
            "--aot",
            default=None,
            metavar="SIDECAR",
            help="serve through ahead-of-time artifacts written by "
            "export-aot (routes resolved and operands built at load; "
            "exported (batch, k) shapes use the plan, others the live "
            "path; incompatible with --mesh)",
        )
    for sp in (b, q, w, t, a, r, tn, ex):
        sp.add_argument(
            "--profile",
            metavar="DIR",
            default=None,
            help="write a torch.profiler Chrome trace (DIR/trace.json)",
        )
    return parser



_FLAT_STRATEGIES = ("auto", "decode", "lut", "cached", "pallas")
_IVF_STRATEGIES = ("auto", "masked", "pallas", "gathered", "bucketed")
_EXACT_STRATEGIES = ("auto", "xla", "pallas")


def _load_serving_index(args, reporter, device):
    """Load an index and apply the serving knobs (strategy, precision,
    rerank factor, winners, mesh)."""
    from gulon_tpu_torch.models.exact import ExactIndex
    from gulon_tpu_torch.models.flat import FlatIndex
    from gulon_tpu_torch.models.ivf import IVFIndex
    from gulon_tpu_torch.utils.serde import load_index

    if getattr(args, "mesh", None):
        if getattr(args, "aot", None):
            raise ValueError(
                "--aot serves a single-device index (artifacts are "
                "exported unsharded); it is incompatible with --mesh"
            )
    with reporter.task(f"loading {args.index}"):
        index = load_index(args.index, device=device)
    strategy = getattr(args, "scan_strategy", None)
    if strategy:
        allowed = (
            _FLAT_STRATEGIES
            if isinstance(index, FlatIndex)
            else _IVF_STRATEGIES
            if isinstance(index, IVFIndex)
            else _EXACT_STRATEGIES
            if isinstance(index, ExactIndex)
            else ()
        )
        if strategy not in allowed:
            kind = type(index).__name__
            options = "|".join(allowed) if allowed else "none"
            raise ValueError(
                f"scan strategy {strategy!r} not valid for a {kind} "
                f"(expected {options})"
            )
        index.scan_strategy = strategy
    if getattr(args, "precision", None):
        index.precision = args.precision
    rerank = getattr(args, "rerank_factor", None)
    if rerank is not None:
        if not isinstance(index, FlatIndex):
            raise ValueError("--rerank-factor applies to flat indices")
        if rerank < 0:
            raise ValueError("--rerank-factor must be >= 0 (0 = auto)")
        index.rerank_factor = rerank
    winners = getattr(args, "pallas_winners", None)
    if winners is not None:
        if isinstance(index, FlatIndex):
            if not 0 <= winners <= 4:
                raise ValueError(
                    "--pallas-winners must be 0..4 for a flat index"
                )
        elif isinstance(index, IVFIndex):
            if not 1 <= winners <= 4:
                raise ValueError(
                    "--pallas-winners must be 1..4 for a partitioned index"
                )
        else:
            raise ValueError(
                "--pallas-winners applies to flat/partitioned indices"
            )
        index.pallas_winners = winners
    if getattr(args, "mesh", None):
        import torch

        from gulon_tpu_torch.parallel import make_mesh, shard_index

        devices = None  # the first N cards
        if torch.device(device).type == "cuda":
            avail = torch.cuda.device_count()
        else:  # N logical shards of the named device
            avail = os.cpu_count() or 1
            devices = [device] * args.mesh
        if args.mesh > avail:
            raise ValueError(
                f"--mesh {args.mesh} exceeds the {avail} available devices"
            )
        with reporter.task(f"sharding over {args.mesh} devices"):
            index = shard_index(index, make_mesh(args.mesh, devices=devices))
    if getattr(args, "aot", None):
        from gulon_tpu_torch.utils.aot import load_serving

        with reporter.task(f"loading AOT artifacts {args.aot}"):
            index = load_serving(args.aot, index)
    return index


def cmd_build_index(args, reporter, device) -> int:
    from gulon_tpu_torch.models.build import (
        build_flat_index,
        build_ivf_index,
        default_limit,
        default_num_partitions,
    )
    from gulon_tpu_torch.models.ivf import LimitGroups, LimitVectors
    from gulon_tpu_torch.models.metric import Metric
    from gulon_tpu_torch.ops.pq import PQConfig
    from gulon_tpu_torch.utils.progress import format_bytes
    from gulon_tpu_torch.utils.serde import save_index
    from gulon_tpu_torch.utils.word2vec import read_word2vec_path

    if not args.partitioned and (
        args.partitions or args.limit or args.limit_vectors
        or args.max_partition_size
    ):
        reporter.out.write(
            "error: --partitions/--limit/--limit-vectors/"
            "--max-partition-size require --partitioned\n"
        )
        return 1
    if args.limit and args.limit_vectors:
        reporter.out.write(
            "error: --limit and --limit-vectors are mutually exclusive\n"
        )
        return 1
    if args.exact and args.partitioned:
        reporter.out.write(
            "error: --exact and --partitioned are mutually exclusive\n"
        )
        return 1
    if args.exact and args.streaming:
        reporter.out.write(
            "error: --streaming requires a quantized build (--exact keeps "
            "the raw vectors, which a stream cannot avoid materializing)\n"
        )
        return 1
    if args.opq and (args.exact or args.streaming):
        reporter.out.write(
            "error: --opq applies to quantized in-memory builds only\n"
        )
        return 1

    metric = Metric.parse(args.metric)
    pq_config = PQConfig(
        num_clusters=args.clusters,
        num_quantizers=args.quantizers,
        max_iters=args.max_iters,
        init=args.kmeans_init,
    )
    if args.streaming:
        from gulon_tpu_torch.utils.word2vec import sniff_word2vec_binary

        if sniff_word2vec_binary(args.input):
            reporter.out.write(
                "error: --streaming reads the word2vec text format; "
                f"{args.input} is the binary format — drop --streaming "
                "(binary files mmap, so host RSS stays bounded anyway)\n"
            )
            return 1
        return _build_streaming(args, reporter, metric, pq_config, device)
    with reporter.task(f"reading {args.input}"):
        wv = read_word2vec_path(
            args.input,
            normalize=False,  # builders normalize; matches BuildIndex.scala:116
            report_fn=lambda p: reporter.progress(
                "reading",
                (p.lines_read / p.total_lines) if p.total_lines else None,
                f"{p.lines_read} vectors, ~{format_bytes(p.size_estimate_bytes)}",
            ),
        )

    def kmeans_progress(
        iteration, step_size, converged_count,
        step_std=0.0, step_min=0.0, step_max=0.0,
    ):
        # (iteration, centroid-step mean, converged count, std, min, max)
        # per Lloyd iteration: the reference's KMeans.ProgressReport with
        # its SummaryStats of step sizes (KMeans.scala:119-127,160-168)
        reporter.progress(
            "k-means",
            float(iteration) / args.max_iters,
            f"iter {int(iteration)}/{args.max_iters} "
            f"step {float(step_size):.3e} +/- {float(step_std):.1e} "
            f"({int(converged_count)} done)",
        )
    if args.exact:
        from gulon_tpu_torch.models.exact import build_exact_index

        with reporter.task("building exact index"):
            index = build_exact_index(wv.keys, wv.vectors, metric=metric, device=device)
        with reporter.task(f"writing {args.output}"):
            save_index(index, args.output)
        return 0
    if args.partitioned:
        num_partitions = args.partitions or default_num_partitions(len(wv))
        if args.limit_vectors:
            strategy = LimitVectors(args.limit_vectors)
            desc = f"cover {args.limit_vectors} vectors"
        else:
            strategy = LimitGroups(args.limit or default_limit(num_partitions))
            desc = f"probe {strategy.count}"
        opq_note = f", OPQ x{args.opq}" if args.opq else ""
        with reporter.task(
            f"building partitioned index ({num_partitions} partitions, "
            f"{desc}{opq_note})"
        ):
            index = build_ivf_index(
                wv.keys,
                wv.vectors,
                metric=metric,
                pq_config=pq_config,
                num_partitions=num_partitions,
                strategy=strategy,
                coarse_init=args.kmeans_init,
                max_partition_size=args.max_partition_size,
                opq_iters=args.opq or 0,
                report_fn=kmeans_progress,
                device=device,
            )
    else:
        label = (
            f"building index (OPQ x{args.opq})" if args.opq
            else "building index"
        )
        with reporter.task(label):
            index = build_flat_index(
                wv.keys, wv.vectors, metric=metric, pq_config=pq_config,
                opq_iters=args.opq or 0,
                report_fn=kmeans_progress,
                device=device,
            )
    with reporter.task(f"writing {args.output}"):
        save_index(index, args.output)
    return 0


def _build_streaming(args, reporter, metric, pq_config, device) -> int:
    """``build-index --streaming``: native parser -> chunked device encode
    (the library surface is ``models/streaming.py``). Where the parser
    library cannot load it prints an error and exits 1; it never builds in
    memory instead."""
    from gulon_tpu_torch.models.ivf import LimitGroups, LimitVectors
    from gulon_tpu_torch.models.streaming import (
        build_flat_index_streaming,
        build_ivf_index_streaming,
    )
    from gulon_tpu_torch.utils import native
    from gulon_tpu_torch.utils.serde import save_index

    if not native.available():
        reporter.out.write(
            "error: streaming build unavailable (native IO library "
            "unavailable); rerun without --streaming\n"
        )
        return 1

    def stream_progress(*a):
        if len(a) == 1:  # StreamProgress from the encode pipeline
            p = a[0]
            reporter.progress(
                "encoding",
                p.rows_done / max(p.total_rows, 1),
                f"{p.rows_done}/{p.total_rows} rows",
            )
        else:  # (iteration, step stats..., converged) from k-means
            iteration, step_size = a[0], a[1]
            step_std = a[3] if len(a) > 3 else 0.0
            reporter.progress(
                "k-means",
                float(iteration) / args.max_iters,
                f"iter {int(iteration)}/{args.max_iters} "
                f"step {float(step_size):.3e} "
                f"+/- {float(step_std):.1e}",
            )

    if args.partitioned:
        strategy = None
        if args.limit_vectors:
            strategy = LimitVectors(args.limit_vectors)
        elif args.limit:
            strategy = LimitGroups(args.limit)
        with reporter.task("building partitioned index (streaming)"):
            index = build_ivf_index_streaming(
                args.input,
                metric=metric,
                pq_config=pq_config,
                num_partitions=args.partitions,
                strategy=strategy,
                coarse_init=args.kmeans_init,
                max_partition_size=args.max_partition_size,
                report_fn=stream_progress,
                device=device,
            )
    else:
        with reporter.task("building index (streaming)"):
            index = build_flat_index_streaming(
                args.input,
                metric=metric,
                pq_config=pq_config,
                report_fn=stream_progress,
                device=device,
            )
    with reporter.task(f"writing {args.output}"):
        save_index(index, args.output)
    return 0


def cmd_query(args, reporter, device) -> int:
    from gulon_tpu_torch.utils.word2vec import read_word2vec_path

    index = _load_serving_index(args, reporter, device)
    with reporter.task(f"reading {args.input}"):
        wv = read_word2vec_path(args.input)
    with reporter.task(f"querying {len(wv)} vectors"):
        # query_arrays + one vectorized id -> key map: no per-result host
        # Result assembly on the serving path
        _, ids = index.query_arrays(args.k, wv.vectors)
        ids = ids.cpu().numpy()
    all_keys = np.asarray(index.key_index.keys, dtype=object)
    for key, row_ids in zip(wv.keys, ids):
        neighbours = all_keys[row_ids[row_ids >= 0]]
        print(f"{key}: {','.join(str(w) for w in neighbours)}")
    return 0


def cmd_query_words(args, reporter, device) -> int:
    index = _load_serving_index(args, reporter, device)
    for line in sys.stdin:
        word = line.strip()
        if not word:
            continue
        res = index.query_by_word(args.k, word)
        if res is None:
            print(f"{word} not found")
        else:
            print(f"{word}: {','.join(str(w) for w in res.keys)}")
    return 0


def cmd_add_vectors(args, reporter, device) -> int:
    from gulon_tpu_torch.utils.serde import load_index, save_index
    from gulon_tpu_torch.utils.word2vec import read_word2vec_path

    with reporter.task(f"loading {args.index}"):
        index = load_index(args.index, device=device)
    with reporter.task(f"reading {args.input}"):
        wv = read_word2vec_path(args.input)
    with reporter.task(f"adding {len(wv)} vectors"):
        updated = index.add(wv.keys, wv.vectors)
    with reporter.task(f"writing {args.output}"):
        save_index(updated, args.output)
    return 0


def cmd_remove_keys(args, reporter, device) -> int:
    from gulon_tpu_torch.utils.serde import load_index, save_index

    keys = list(args.keys)
    if args.keys_file:
        with open(args.keys_file, "r", encoding="utf-8") as f:
            keys.extend(line.strip() for line in f if line.strip())
    if not keys:
        raise ValueError("no keys given (positional args or --keys-file)")
    with reporter.task(f"loading {args.index}"):
        index = load_index(args.index, device=device)
    with reporter.task(f"removing {len(keys)} keys"):
        updated = index.remove(keys)
    with reporter.task(f"writing {args.output}"):
        save_index(updated, args.output)
    return 0


def cmd_tune(args, reporter, device) -> int:
    from gulon_tpu_torch.utils.serde import load_index, save_index
    from gulon_tpu_torch.utils.tune import tune_probe_limit
    from gulon_tpu_torch.utils.word2vec import read_word2vec_path

    with reporter.task(f"loading {args.index}"):
        index = load_index(args.index, device=device)
    with reporter.task(f"reading {args.vectors}"):
        wv = read_word2vec_path(args.vectors)
    with reporter.task(
        f"tuning probe limit to recall@{args.k} >= {args.target_recall}"
    ):
        result = tune_probe_limit(
            index, wv.vectors, wv.keys,
            target_recall=args.target_recall, k=args.k,
            num_samples=args.sample, epsilon=args.error,
            report_fn=lambda limit, evals, r: reporter.progress(
                "tune", min(evals / 12.0, 1.0),
                f"limit={limit} R@{args.k}={r:.3f}",
            ),
        )
    with reporter.task(f"writing {args.output}"):
        save_index(result.index, args.output)
    kind = type(result.index.strategy).__name__
    status = "met" if result.met else "NOT met (code-budget ceiling)"
    print(
        f"{kind} limit {result.limit}: recall@{result.k} = "
        f"{result.achieved_recall:.4f} (target {result.target_recall}, "
        f"{status}, {result.evaluations} evaluations)"
    )
    return 0


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size())


def cmd_info(args, reporter, device) -> int:
    from gulon_tpu_torch.models.exact import ExactIndex
    from gulon_tpu_torch.models.flat import FlatIndex
    from gulon_tpu_torch.models.ivf import IVFIndex
    from gulon_tpu_torch.utils.progress import format_bytes
    from gulon_tpu_torch.utils.serde import load_index

    index = load_index(args.index, device=device)
    lines = [
        f"type:        {type(index).__name__}",
        f"vectors:     {index.size}",
        f"dimension:   {index.dimension}",
        f"metric:      {index.metric.name.lower()}",
    ]
    if isinstance(index, (FlatIndex, IVFIndex)):
        pq = index.pq
        # codes are uint8 up to 256 clusters, int32 above (the JAX
        # package stores the latter as uint16)
        code_bytes = _nbytes(index.codes)
        lines += [
            f"quantizers:  {pq.num_quantizers} x {pq.num_clusters} clusters "
            f"({pq.code_bits}-bit codes, "
            f"{code_bytes / max(index.size, 1):.1f} B/vector in HBM)",
            f"codebooks:   {format_bytes(_nbytes(pq.codebooks))}",
            f"codes:       {format_bytes(code_bytes)}",
        ]
        if index.rotation is not None:
            lines.append("opq:         learned rotation "
                         f"[{index.dimension} x {index.dimension}]")
    if isinstance(index, IVFIndex):
        sizes = index.partition_sizes()
        strat = index.strategy
        lines += [
            f"partitions:  {index.num_partitions} "
            f"(rows/partition min {int(sizes.min())} / "
            f"median {int(np.median(sizes))} / max {int(sizes.max())}; "
            f"{int((sizes == 0).sum())} empty)",
            f"strategy:    {type(strat).__name__}({strat.count})",
        ]
    if isinstance(index, ExactIndex):
        lines.append(f"vectors mem: {format_bytes(_nbytes(index.vectors))}")
    print("\n".join(lines))
    return 0


def cmd_export_aot(args, reporter, device) -> int:
    from gulon_tpu_torch.utils.aot import export_serving, save_serving
    from gulon_tpu_torch.utils.progress import format_bytes

    def _int_list(text: str, flag: str) -> List[int]:
        try:
            values = [int(v) for v in text.split(",") if v.strip()]
        except ValueError:
            values = []
        if not values or any(v < 1 for v in values):
            raise ValueError(
                f"{flag} expects a comma-separated list of positive "
                f"integers, got {text!r}"
            )
        return values

    batches = _int_list(args.batches, "--batches")
    ks = _int_list(args.k, "-k")
    index = _load_serving_index(args, reporter, device)
    shapes = [(b, k) for b in batches for k in ks]
    with reporter.task(
        f"exporting {len(shapes)} serving computations "
        f"(batches {batches}, k {ks})"
    ):
        bundle = export_serving(index, shapes=shapes)
    with reporter.task(f"writing {args.output}"):
        save_serving(args.output, bundle)
    print(
        f"{len(shapes)} artifacts for platform {bundle.platform} "
        f"({format_bytes(os.path.getsize(args.output))}); serve with "
        f"--aot {args.output}"
    )
    return 0


def cmd_serve(args, reporter, device) -> int:
    from gulon_tpu_torch.server import serve

    index = _load_serving_index(args, reporter, device)
    with reporter.task(f"warming k={args.warm_k} query path"):
        # a batch of 1 and one of 1024 build the lazy operands of the small
        # and the batched routes (the kernel's among them), so the first
        # real request of either size answers at device speed
        index.warmup(min(args.warm_k, index.size), batch_sizes=(1, 1024))
    serve(
        index,
        host=args.host,
        port=args.port,
        ready_fn=lambda h, p: print(f"serving on {h}:{p}", flush=True),
        micro_batch_window_ms=args.batch_window_ms,
    )
    return 0


def cmd_test(args, reporter, device) -> int:
    from gulon_tpu_torch.utils.eval import (
        format_recall,
        ground_truth_for_queries,
        recall_of,
        sample_ground_truth,
    )
    from gulon_tpu_torch.utils.word2vec import read_word2vec_path

    index = _load_serving_index(args, reporter, device)
    with reporter.task(f"reading {args.vectors}"):
        wv = read_word2vec_path(args.vectors)
    if index.metric.normalized:
        wv = wv.normalized()
    if args.queries:
        with reporter.task(f"reading {args.queries}"):
            wv_q = read_word2vec_path(args.queries)
        if index.metric.normalized:
            wv_q = wv_q.normalized()
        with reporter.task(
            f"computing ground truth for {len(wv_q)} queries"
        ):
            # corpus and queries are both already normalized above
            truth = ground_truth_for_queries(
                wv_q.vectors, wv.vectors, query_keys=wv_q.keys, device=device
            )
    else:
        with reporter.task(f"sampling {args.sample} ground-truth queries"):
            truth = sample_ground_truth(
                wv.keys, wv.vectors, num_samples=args.sample, device=device
            )
    with reporter.task("measuring recall"):
        per_k = recall_of(
            index,
            truth,
            wv.vectors,
            wv.keys,
            epsilon=args.error,
            report_fn=lambda p: reporter.progress(
                "recall", p.completed / p.total, f"{p.qps:.0f} qps"
            ),
        )
    print(format_recall(per_k))
    return 0


_HANDLERS = {
    "build-index": cmd_build_index,
    "query": cmd_query,
    "query-words": cmd_query_words,
    "add-vectors": cmd_add_vectors,
    "remove-keys": cmd_remove_keys,
    "tune": cmd_tune,
    "info": cmd_info,
    "export-aot": cmd_export_aot,
    "serve": cmd_serve,
    "test": cmd_test,
}


def main(argv: Optional[List[str]] = None, *, device=None) -> int:
    """Run one verb; returns the exit code. ``device`` (default: the CUDA
    card, with no CPU fallback) is where every index lives."""
    from gulon_tpu_torch.utils.device import DEFAULT_DEVICE
    from gulon_tpu_torch.utils.progress import Reporter

    args = build_parser().parse_args(argv)
    reporter = Reporter()
    device = DEFAULT_DEVICE if device is None else device
    profile_dir = getattr(args, "profile", None)
    prof = None
    if profile_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    try:
        return _HANDLERS[args.command](args, reporter, device)
    except (OSError, ValueError, KeyError) as e:
        sys.stderr.write(f"error: {e}\n")
        return 1
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            reporter.out.write(f"profiler trace written to {profile_dir}\n")


if __name__ == "__main__":
    sys.exit(main())
