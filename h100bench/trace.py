"""The traced run: ``torch.profiler`` over the first seconds of the window.

The profiler starts with the window and stops at the first unit boundary
(a batch, a build) past ``TRACE_SECONDS`` (or the window, if shorter);
the run's window goes on untraced. The harness marks its own calls
into the program with spans (``h100bench.<name>``), by which idle gaps
are told apart. From the trace come the device's busy seconds (the union
of every device interval), the traced window's length, each kernel's
intervals for the per-layer readers, and ``breakdown``. The full
profiler table and the Chrome trace go to files in the run's output
directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import heapq
import os
import shutil
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

TRACE_SECONDS = 2.0
SPAN_PREFIX = "h100bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
_PROFILER_OWN = ("Activity Buffer",)  # the profiler's own host events


@dataclasses.dataclass
class TraceView:
    """What the per-layer readers read."""

    kernels: List[Tuple[str, int, int]]  # (name, start_ns, end_ns) on the device
    window_s: float
    busy_s: float
    units: int  # batches or builds inside the traced window
    breakdown: dict


def union_seconds(intervals: List[Tuple[int, int]]) -> Tuple[float, List[Tuple[int, int]]]:
    """Seconds covered by ``(start_ns, end_ns)`` intervals, and the merged
    intervals in order."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e9, [tuple(m) for m in merged]


def idle_percent(view: TraceView) -> Optional[float]:
    if view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


class Tracer:
    """Profiles the head of the window when ``enabled``; a no-op otherwise."""

    def __init__(self, enabled: bool, out_prefix: Path, window_s: float):
        self.enabled = enabled
        self.cap_s = min(TRACE_SECONDS, window_s)
        self.out_prefix = out_prefix
        self.active = False
        self.units = 0
        self._prof = None
        self._span = None
        self._t0 = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.active = True
        self._t0 = time.perf_counter()

    def span(self, name: str):
        """A ``h100bench.<name>`` span while tracing."""
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    def unit_done(self) -> None:
        """Count a unit; stop once the traced window is long enough."""
        if self.active:
            self.units += 1
            if time.perf_counter() - self._t0 >= self.cap_s:
                self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False

    def view(self) -> TraceView:
        """Read the trace; write the profiler table and the Chrome trace."""
        self.stop()
        prof = self._prof
        events = list(prof.profiler.kineto_results.events())
        cuda = torch.autograd.DeviceType.CUDA
        win = [e for e in events if e.name() == WINDOW_SPAN]
        w0 = win[0].start_ns()
        w1 = w0 + win[0].duration_ns()
        dev, cpu = [], []
        for e in events:
            name, s, d = e.name(), e.start_ns(), e.duration_ns()
            if name.startswith(_PROFILER_OWN):
                continue
            if e.device_type() == cuda:
                if name.startswith(SPAN_PREFIX):
                    continue  # a span's mark on the device's timeline is no work
                s, t = max(s, w0), min(s + d, w1)
                if t > s:
                    dev.append((name, s, t))
            elif name != WINDOW_SPAN and d > 0:
                cpu.append((s, s + d, name))
        busy_s, merged = union_seconds([(s, t) for _, s, t in dev])
        view = TraceView(
            kernels=dev,
            window_s=(w1 - w0) / 1e9,
            busy_s=busy_s,
            units=self.units,
            breakdown={
                "device_ops": top_device_ops(dev),
                "idle_gaps": idle_gaps(merged, cpu, w0, w1),
            },
        )
        self._write(prof)
        return view

    def _write(self, prof) -> None:
        self.out_prefix.parent.mkdir(parents=True, exist_ok=True)
        sort_by = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
        table = prof.key_averages().table(sort_by=sort_by, row_limit=80, max_name_column_width=100)
        Path(f"{self.out_prefix}.profile.txt").write_text(table + "\n")
        raw = f"{self.out_prefix}.trace.json"
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.unlink(raw)


def top_device_ops(dev: List[Tuple[str, int, int]], n: int = 10) -> List[list]:
    total: Dict[str, int] = defaultdict(int)
    for name, s, t in dev:
        total[name[:160]] += t - s
    return [[k, v / 1e9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(
    merged: List[Tuple[int, int]],
    cpu: List[Tuple[int, int, str]],
    w0: int,
    w1: int,
    n: int = 10,
) -> List[list]:
    """Idle seconds of the device, summed by the innermost host span or
    operation open at each gap's midpoint (the open one that started
    last), in one sweep over the gaps in time order."""
    cpu.sort()
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    total: Dict[str, int] = defaultdict(int)
    open_now: list = []  # heap of (-start, end, name): the latest start on top
    i = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(cpu) and cpu[i][0] <= mid:
            heapq.heappush(open_now, (-cpu[i][0], cpu[i][1], cpu[i][2]))
            i += 1
        while open_now and open_now[0][1] < mid:
            heapq.heappop(open_now)
        name = open_now[0][2] if open_now else "host outside any span"
        total[name[:160]] += b - a
    return [[k, v / 1e9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
