"""Spans and counters of the port, in one registry.

- :func:`span` marks a stretch of host code at a layer boundary of the
  query and build paths. With no ``torch.profiler`` session active it
  returns one shared no-op context: no allocation, no ``RecordFunction``,
  no device op, no sync. With a session active it opens a
  ``torch._C._profiler._RecordFunctionFast``: a plain host event
  (``cpu_op``, not a user annotation, so nothing lands on the device's
  timeline) on the clock of the profiler's device events, so the trace's
  idle gaps fall under it by name. It also adds to in-memory aggregates
  per name: count, total seconds, and self seconds (the total less the
  time its child spans cover, kept per thread).
- The aggregates cover the latest profiled session: the first span a
  thread opens after it skipped one with the profiler off starts them
  afresh, so warm-up and earlier sessions never count. (A profiler sees
  the thread that started it; a span skipped in another thread leaves
  the session's aggregates alone.)
- :func:`count` / :func:`counter`: always-on counters, a dict add under a
  lock each: kernel launches (``k1.launches``, ``k2.launches``, ...),
  builds of K1's index-constant operands (``k1.operand_builds``, one per
  holder, an index or a shard, and launch geometry, or one per call where
  none holds them: ``ops/cuda/adc.py::K1Operands``), K1's launch plans
  (``count_launch``: ``k1.launches.streamed``, ``k1.launches.cb_global``,
  ``k1.blocks``, ``k1.block_decodes``, ``k1.gather_lanes``), and
  ``k1.launches.lane_padded`` (``K1Operands.scan``: launches whose
  codebook and query operands carry zero lanes past each subspace's own
  width), and the IVF K1 route's selection (``models/ivf.py``:
  ``ivf.selects``, its calls, and ``ivf.select_keys``, the winner columns
  it may read, a bound from the probe and the layout's partition sizes,
  no sync; ``ops/cuda/ivf_topk.py``: ``ivf.topk.launches``, its kernel's
  launches).
- :func:`snapshot` returns both; :func:`reset` clears both.

A profiler turns the spans on: ``cli --profile``, or any caller's
``torch.profiler.profile``. Span names start with ``gulon.``; a span
named ``gulon.wait.<site>`` wraps one call that blocks the host until
the device's stream has drained (a copy from host memory, a read-back),
and wait spans never nest.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch

_profiler_on = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()

_lock = threading.Lock()
_local = threading.local()
_spans: Dict[str, List[int]] = {}  # name -> [count, total ns, self ns]
_counters: Dict[str, int] = {}


class _Span:
    __slots__ = ("name", "_rf", "_t0", "_child_ns", "_stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        local = _local.__dict__
        if local.get("stale"):  # this thread skipped a span with the profiler off
            local["stale"] = False
            with _lock:
                _spans.clear()
        stack = local.get("stack")
        if stack is None:
            stack = local["stack"] = []
        self._stack = stack
        self._child_ns = 0
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self._rf.__exit__(*exc)
        stack = self._stack
        stack.pop()
        if stack:
            stack[-1]._child_ns += dt
        with _lock:
            agg = _spans.get(self.name)
            if agg is None:
                agg = _spans[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self._child_ns
        return False


def span(name: str):
    """A context manager marking ``name`` in the profiler's trace while a
    profiler runs; the shared no-op context otherwise."""
    if not _profiler_on():
        _local.stale = True
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` (0 if never counted)."""
    return _counters.get(name, 0)


def set_counter(name: str, value: int) -> None:
    """Set the counter ``name`` (0 to start a count afresh)."""
    with _lock:
        _counters[name] = value


def snapshot() -> dict:
    """``{"spans": {name: {count, total_s, self_s}}, "counters": {name: n}}``."""
    with _lock:
        spans = {
            name: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
            for name, (c, t, s) in _spans.items()
        }
        counters = dict(_counters)
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Clear every span aggregate and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()
