"""Peaks of the card and the least time a kernel's work needs.

The peaks are NVIDIA's published figures for the H100 SXM part (dense,
no sparsity) at its full 700 W limit. A card held below that limit runs
slower under load; ``run.py`` prints the limit beside every run.
"""

from __future__ import annotations

from typing import Tuple

# torch.cuda.get_device_name() -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_s": 989e12, "hbm_byte_s": 3.35e12},
}


def adc_scan_work(
    num_queries: int,
    rows_per_query: float,
    lanes: int,
    *,
    distinct_rows: int,
    code_bytes_per_row: int,
    k: int,
) -> Tuple[float, float]:
    """``(flop, bytes)`` an ADC scan needs: every query scores each of its
    rows over ``lanes`` decoded lanes (a multiply and an add each); the
    codes of the ``distinct_rows`` rows it touches are read once, the
    bf16 queries once, and the ``k`` winners a query (f32 distance and
    int32 row) written once."""
    flop = 2.0 * num_queries * rows_per_query * lanes
    nbytes = (
        distinct_rows * code_bytes_per_row
        + num_queries * lanes * 2
        + num_queries * k * 8
    )
    return flop, float(nbytes)


def least_seconds(flop: float, nbytes: float, peaks: dict) -> Tuple[float, str]:
    """The larger of the bf16 tensor-core bound and the HBM bound, and
    which of them it is."""
    t_flop = flop / peaks["bf16_flop_s"]
    t_mem = nbytes / peaks["hbm_byte_s"]
    return (t_flop, "bf16 tensor cores") if t_flop >= t_mem else (t_mem, "HBM bytes")
