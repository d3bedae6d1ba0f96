"""The two loops a traffic mix can name (its ``loop`` key), each driven
by the mix's parameters alone:

- ``closed_batch``: one client sends a batch of ``batch`` queries, taken
  in turn from the query set, and sends the next once the ids and
  distances of the last are on the host;
- ``build_loop``: whole builds of the index back to back.

Each loop builds what it serves in ``setup`` and warms exactly the shapes
its window uses; ``window`` runs for the run's seconds; ``close`` reads
the end-to-end numbers, keeps a sample of the answers drawn from the
seed, exports the index the check judges and lets the program's state go.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from h100bench.check import Answers, IndexState
from h100bench.corpus import keys_for
from h100bench.trace import Tracer

WARMUP_BATCHES = 3  # batches a closed loop runs before its window
WARMUP_MAX_ITERS = 1  # Lloyd iterations of the warm-up build
SAMPLE_BATCHES = 8  # batches of a closed loop the check compares


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    traffic: dict
    seed: int
    seconds: float
    system: object  # PortSystem, or the control
    corpus: np.ndarray  # [n, d] host f32
    queries: np.ndarray  # [q, d] host f32
    tracer: Tracer


@dataclasses.dataclass
class Outcome:
    e2e: dict  # end-to-end metric -> value
    attempted: int
    failed: int
    state: IndexState
    answers: Optional[Answers]  # the sample the check compares
    answered: Optional[Tuple[np.ndarray, np.ndarray]]  # (query rows, corpus rows) of all
    notes: List[str] = dataclasses.field(default_factory=list)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def _to_corpus_rows(rows: np.ndarray, corpus_rows: np.ndarray) -> np.ndarray:
    return np.where(rows >= 0, corpus_rows[np.maximum(rows, 0)], -1)


class ClosedBatch:
    def __init__(self, run: Run):
        self.run = run
        self.batch = int(run.traffic["batch"])
        self.k = int(run.traffic["k"])

    def setup(self) -> None:
        r = self.run
        self.index = r.system.build(keys_for(len(r.corpus)), r.corpus)
        nq = len(r.queries)
        self.cycle = math.lcm(self.batch, nq) // self.batch
        self.batches = [
            np.ascontiguousarray(r.queries[self.query_rows(b)]) for b in range(self.cycle)
        ]
        self.offset = int(_rng(r.seed, 0).integers(self.cycle))
        for b in range(WARMUP_BATCHES):
            r.system.query(self.index, self.k, self.batches[b])

    def query_rows(self, b: int) -> np.ndarray:
        nq = len(self.run.queries)
        return ((b % self.cycle) * self.batch + np.arange(self.batch)) % nq

    def window(self) -> None:
        r, tr = self.run, self.run.tracer
        self.results = []  # (batch number, dists, rows) of each batch answered
        self.failed = 0
        tr.start()
        t0 = time.perf_counter()
        end = t0 + r.seconds
        i = 0
        while True:
            b = (self.offset + i) % self.cycle
            try:
                with tr.span("query"):
                    d, ids = r.system.query(self.index, self.k, self.batches[b])
                self.results.append((b, d, ids))
            except Exception as e:  # noqa: BLE001 - a failed batch is counted
                print(f"batch {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
                self.failed += self.batch
            i += 1
            tr.unit_done()
            now = time.perf_counter()
            if now >= end:
                break
        self.elapsed = now - t0
        self.sent = i * self.batch

    def close(self) -> Outcome:
        r = self.run
        state = r.system.export(self.index)
        corpus_rows = r.system.corpus_rows(self.index)
        del self.index
        res = self.results
        answered = (
            np.concatenate([self.query_rows(b) for b, _, _ in res]),
            _to_corpus_rows(np.concatenate([ids for _, _, ids in res]), corpus_rows),
        ) if res else None
        pick = np.sort(_rng(r.seed, 1).choice(len(res), min(SAMPLE_BATCHES, len(res)), replace=False))
        answers = Answers(
            query_rows=np.concatenate([self.query_rows(res[j][0]) for j in pick]),
            dists=np.concatenate([res[j][1] for j in pick]),
            rows=_to_corpus_rows(np.concatenate([res[j][2] for j in pick]), corpus_rows),
        ) if res else None
        done = len(res) * self.batch
        return Outcome(
            e2e={"qps": done / self.elapsed}, attempted=self.sent, failed=self.failed,
            state=state, answers=answers, answered=answered,
        )


class BuildLoop:
    def __init__(self, run: Run):
        self.run = run

    def setup(self) -> None:
        r = self.run
        self.keys = keys_for(len(r.corpus))
        # the warm-up build runs every kernel of a build on the same shapes,
        # with the Lloyd loops cut short
        r.system.build(self.keys, r.corpus, max_iters=WARMUP_MAX_ITERS)

    def window(self) -> None:
        r, tr = self.run, self.run.tracer
        rng = _rng(r.seed, 2)
        self.builds = 0
        self.chosen = None  # one build, drawn uniformly from the seed
        tr.start()
        t0 = time.perf_counter()
        while True:
            with tr.span("build"):
                index = r.system.build(self.keys, r.corpus)
            self.builds += 1
            if rng.random() * self.builds < 1.0:
                self.chosen = index
            del index
            tr.unit_done()
            now = time.perf_counter()
            if now - t0 >= r.seconds:
                break
        self.elapsed = now - t0

    def close(self) -> Outcome:
        r = self.run
        state = r.system.export(self.chosen)
        del self.chosen
        return Outcome(
            e2e={"build_vps": self.builds * len(r.corpus) / self.elapsed},
            attempted=self.builds, failed=0, state=state, answers=None, answered=None,
        )


LOOPS = {"closed_batch": ClosedBatch, "build_loop": BuildLoop}
