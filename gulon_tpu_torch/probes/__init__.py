"""Stage-ablation probes of the fused ADC scan K1 on the card: the
counterparts of ``benchmarks/adc_probes.py`` (P1, P2), ``benchmarks/
kernel_probe.py`` (P3) and ``benchmarks/floor_probe.py`` (P4), each module
under its TPU file's name, and K1's own kernel cut stage by stage
(``k1_stages.py``). No serving path reaches them: they measure where K1's
time goes."""

import math

import numpy as np
import torch

_SLEEP_CYCLES = 1 << 21  # ~1 ms of the card's clock: the first sleep tried
_MAX_SLEEP_CYCLES = 1 << 31
_FILL_MS, _MAX_CALLS = 2.0, 64  # a reading's calls: enough for 2 ms, at most 64


def median_ms(fn, warmup: int = 3, reps: int = 10, *, queued: bool = True) -> float:
    """Median ms of one ``fn()`` call on the card, over ``reps`` readings
    after ``warmup`` calls.

    ``queued`` (kernels, one library call): each reading is one CUDA-event
    pair around ``calls`` back-to-back calls, enough to fill 2 ms (at most
    64), divided by ``calls``. A sleep kernel ahead of
    the first event holds the card while the host queues every call; a
    reading counts only when the card was still in that sleep once the
    last call was queued (else the sleep doubles and the reading is
    retaken), so it holds the card's time and none of the host's launch
    path. ``fn`` must not synchronize with the host: the sleep would never
    outlast it, and this raises.

    ``queued=False`` (a plain version: many small ops, each launched from
    Python): one call between the events, its host launch path included,
    as a caller waits for it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not queued:
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times))

    cycles = _SLEEP_CYCLES

    def reading(calls: int) -> float:
        nonlocal cycles
        while True:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(calls):
                fn()
            stop.record()
            ahead = not start.query()  # the card is still asleep
            torch.cuda.synchronize()
            if ahead:
                return start.elapsed_time(stop) / calls
            if cycles >= _MAX_SLEEP_CYCLES:
                raise RuntimeError(
                    "median_ms: the card finished its sleep before the host had queued the "
                    "calls; the function synchronizes with the host (time it queued=False)"
                )
            cycles *= 2

    calls = max(1, min(_MAX_CALLS, math.ceil(_FILL_MS / max(reading(1), 1e-4))))
    return float(np.median([reading(calls) for _ in range(reps)]))
