"""Line-protocol query server: load an index once, serve batched queries
(counterpart of ``gulon_tpu/server.py``; an extra over the reference,
whose only interactive surface is the stdin ``query-words`` loop,
``QueryWords.scala:33-54``).

Loading, placing the index on the card and building its lazy kernel
operands happen once, at startup; every connection then queries the
resident index at batch speed.

Protocol: newline-delimited JSON over TCP. Requests:

    {"k": 10, "vector": [0.1, ...]}          one query vector
    {"k": 10, "vectors": [[...], [...]]}     a batch
    {"k": 5, "words": ["tokyo", "paris"]}    query by key
    {"op": "lookup", "word": "tokyo"}        approximate reconstruction
    {"op": "info"}                           index metadata
    {"op": "ping"}                           liveness

Responses, one JSON line per request: ``{"keys": [[...]], "distances":
[[...]]}`` for queries (``null`` entries for words not in the index),
``{"vector": [...]}`` / ``{"vector": null}`` for lookup, ``{"error":
msg}`` on bad input (the connection stays open).

Concurrency: connections are handled on threads, and all device work
(queries and lookups) runs under one lock, ``_device_lock``. Besides
keeping one batch on the card at a time, the lock guards the port's
process-wide TF32 switch, which ``ops/precision.py`` flips around each
matmul: two threads doing device work at once would race on it. Each
batch's results move to the host once, inside the lock.

Micro-batching (``micro_batch_window_ms > 0``, CLI ``--batch-window-ms``):
the batcher coalesces query requests that arrive within the window into
one device batch, runs it at the largest requested k and slices each
caller's rows and k back out (truncating a sorted top-k_max is exact).
Unlike the JAX package it does not pad a cohort to a power of two: the
port compiles nothing per shape.
"""

from __future__ import annotations

import json
import queue as _queue_mod
import socketserver
import threading
import time
from typing import Optional

import numpy as np

_MAX_LINE = 64 << 20  # 64 MiB: far above any sane query batch


class _Pending:
    """One in-flight query request inside the micro-batcher."""

    __slots__ = ("q", "k", "event", "dists", "ids", "error")

    def __init__(self, q: np.ndarray, k: int):
        self.q = q
        self.k = k
        self.event = threading.Event()
        self.dists = None
        self.ids = None
        self.error = None


class _MicroBatcher:
    """Coalesce concurrent query requests into one device batch: a worker
    thread waits ``window_s`` after the first arrival, drains what is
    waiting (at most ``max_rows`` rows) and answers the cohort with one
    query at ``k = max(k_i)``."""

    _SENTINEL = object()

    def __init__(self, server, window_s: float, max_rows: int):
        self._server = server
        self._window_s = window_s
        self._max_rows = max_rows
        self.cohorts = 0  # device batches dispatched
        self.requests = 0  # requests served through the batcher
        self.rows = 0  # query rows served
        self._queue: _queue_mod.Queue = _queue_mod.Queue()
        self._worker = threading.Thread(
            target=self._run, name="gulon-microbatch", daemon=True
        )
        self._worker.start()

    def submit(self, q: np.ndarray, k: int):
        """Block until the cohort holding this request is answered."""
        p = _Pending(q, k)
        self._queue.put(p)
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.dists, p.ids

    def close(self):
        self._queue.put(self._SENTINEL)

    def _drain(self, first) -> list:
        cohort = [first]
        rows = first.q.shape[0]
        deadline = time.monotonic() + self._window_s
        while rows < self._max_rows:
            timeout = deadline - time.monotonic()
            try:
                item = (
                    self._queue.get(timeout=timeout)
                    if timeout > 0
                    else self._queue.get_nowait()
                )
            except _queue_mod.Empty:
                break
            if item is self._SENTINEL:
                self._queue.put(item)  # seen again by the outer loop
                break
            cohort.append(item)
            rows += item.q.shape[0]
        return cohort

    def _run(self):
        while True:
            first = self._queue.get()
            if first is self._SENTINEL:
                return
            cohort = self._drain(first)
            try:
                self._answer(cohort)
            except Exception as e:  # noqa: BLE001 — fail the cohort, not
                # the worker: each caller re-raises in its own handler,
                # which turns it into an error reply
                for p in cohort:
                    p.error = e
                    p.event.set()

    def _answer(self, cohort: list):
        rows = np.concatenate([p.q for p in cohort], axis=0)
        self.cohorts += 1
        self.requests += len(cohort)
        self.rows += rows.shape[0]
        dists, ids = self._server._device_query(max(p.k for p in cohort), rows)
        at = 0
        for p in cohort:
            stop = at + p.q.shape[0]
            p.dists = dists[at:stop, : p.k]
            p.ids = ids[at:stop, : p.k]
            at = stop
            p.event.set()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server = self.server  # QueryServer
        while True:
            raw = self.rfile.readline(_MAX_LINE)
            if not raw:
                break
            if len(raw) >= _MAX_LINE and not raw.endswith(b"\n"):
                # an unbounded line: reply once and drop the connection
                self.wfile.write(b'{"error": "request line exceeds 64MiB"}\n')
                self.wfile.flush()
                break
            line = raw.strip()
            if not line:
                continue
            try:
                reply = server.handle_payload(json.loads(line))
            except json.JSONDecodeError as e:
                reply = {"error": f"bad json: {e}"}
            except Exception as e:  # noqa: BLE001 — the protocol answers
                # every request with one line and keeps the connection
                reply = {"error": f"{type(e).__name__}: {e}"}
            self.wfile.write(json.dumps(reply).encode("utf-8") + b"\n")
            self.wfile.flush()


class QueryServer(socketserver.ThreadingTCPServer):
    """TCP server around a loaded index (see the module docstring)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(
        self,
        index,
        host: str = "127.0.0.1",
        port: int = 0,
        micro_batch_window_ms: float = 0.0,
        max_micro_batch: int = 1024,
    ):
        super().__init__((host, port), _Handler)
        self.index = index
        self._device_lock = threading.Lock()
        self._batcher = (
            _MicroBatcher(self, micro_batch_window_ms / 1000.0, max_micro_batch)
            if micro_batch_window_ms > 0
            else None
        )

    @property
    def address(self):
        return self.server_address  # (host, bound port)

    def server_close(self):
        if self._batcher is not None:
            self._batcher.close()
        super().server_close()

    def _device_query(self, k: int, q: np.ndarray):
        """One device batch under the lock; (dists, ids) on the host."""
        with self._device_lock:
            dists, ids = self.index.query_arrays(k, q)
            return dists.cpu().numpy(), ids.cpu().numpy()

    def _query_arrays(self, k: int, q: np.ndarray):
        """A query through the micro-batcher when it is on."""
        if self._batcher is not None:
            return self._batcher.submit(q, k)
        return self._device_query(k, q)

    def _lookup(self, word: str):
        with self._device_lock:
            return self.index.lookup(word)

    def handle_payload(self, req: dict) -> dict:
        # not named handle_request, which socketserver.BaseServer has
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
        op = req.get("op", "query")
        if op == "ping":
            return {"ok": True}
        if op == "info":
            idx = self.index
            info = {
                "type": type(idx).__name__,
                "size": int(idx.size),
                "dimension": int(idx.dimension),
                "metric": idx.metric.name.lower(),
            }
            if self._batcher is not None:
                b = self._batcher
                info["micro_batch"] = {
                    "window_ms": round(b._window_s * 1000.0, 3),
                    "cohorts": b.cohorts,
                    "requests": b.requests,
                    "rows": b.rows,
                }
            return info
        if op == "lookup":
            vec = self._lookup(str(req["word"]))
            return {"vector": None if vec is None else
                    np.asarray(vec, np.float32).tolist()}
        if op != "query":
            raise ValueError(f"unknown op {op!r}")

        k = int(req.get("k", 1))
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if "words" in req:
            # look every word up, then one batched query for those found
            words = [str(w) for w in req["words"]]
            found = [(i, self._lookup(w)) for i, w in enumerate(words)]
            rows = [(i, v) for i, v in found if v is not None]
            keys_out = [None] * len(words)
            dists_out = [None] * len(words)
            if rows:
                q = np.stack([v for _, v in rows]).astype(np.float32)
                found_keys, found_dists = self._format_rows(*self._query_arrays(k, q))
                for (i, _), kk, dd in zip(rows, found_keys, found_dists):
                    keys_out[i] = kk
                    dists_out[i] = dd
            return {"keys": keys_out, "distances": dists_out}

        if "vector" in req:
            q = np.asarray([req["vector"]], np.float32)
        elif "vectors" in req:
            q = np.asarray(req["vectors"], np.float32)
        else:
            raise ValueError("query needs 'vector', 'vectors', or 'words'")
        if q.ndim != 2 or q.shape[1] != self.index.dimension:
            raise ValueError(
                f"queries must be [n, {self.index.dimension}], got {list(q.shape)}"
            )
        keys_out, dists_out = self._format_rows(*self._query_arrays(k, q))
        return {"keys": keys_out, "distances": dists_out}

    def _format_rows(self, dists: np.ndarray, ids: np.ndarray):
        # the validity rule of Index._make_results: drop -1 padding and
        # non-finite distances (inf/NaN are not RFC JSON)
        valid = (ids >= 0) & np.isfinite(dists)
        all_keys = np.asarray(self.index.key_index.keys, dtype=object)
        keys_out = [[str(w) for w in all_keys[row[v]]] for row, v in zip(ids, valid)]
        dists_out = [[float(d) for d in drow[v]] for drow, v in zip(dists, valid)]
        return keys_out, dists_out


def serve(
    index,
    host: str = "127.0.0.1",
    port: int = 0,
    ready_fn: Optional[callable] = None,
    micro_batch_window_ms: float = 0.0,
) -> None:
    """Run a :class:`QueryServer` until interrupted; ``ready_fn(host,
    port)`` is called once the socket is bound."""
    with QueryServer(
        index, host, port, micro_batch_window_ms=micro_batch_window_ms
    ) as server:
        h, p = server.address[0], server.address[1]
        if ready_fn is not None:
            ready_fn(h, p)
        try:
            server.serve_forever(poll_interval=0.2)
        except KeyboardInterrupt:
            pass
