"""The dense scan's share of its roofline: the least time the card could
take for the dense-scan work the traced batches need, over the device
time of the kernels this file classifies as the dense scan (K2, and K3,
which shares its template: ``dense_kernel`` in ``csrc/dense_scan.cu``).

The work is counted from the cell's shapes, so it reads the same however
the scan is implemented: each query scores every one of the ``n`` rows
over the dataset's ``d`` lanes (not the operand's padded width); the rows
are read once at 2 bytes a lane (the bf16 operand the configuration
states: an exact index's rows, or a flat index's decoded cache), the
bf16 queries once and the top-k written once
(``roofline.adc_scan_work``). Against the card's published peaks
(``roofline.PEAKS``; ``None`` for a card not in it).
"""

import re

from h100bench.roofline import adc_scan_work, least_seconds

DENSE = re.compile(r"dense_kernel")


def read(ctx):
    view = ctx.view
    device_s = sum(e - s for name, s, e in view.kernels if DENSE.search(name)) / 1e9
    if device_s <= 0 or ctx.peaks is None or view.units == 0:
        return None
    n, d = ctx.config["dataset"]["n"], ctx.config["dataset"]["d"]
    flop, nbytes = adc_scan_work(
        ctx.traffic["batch"], n, d, distinct_rows=n, code_bytes_per_row=2 * d,
        k=ctx.traffic["k"],
    )
    least, _ = least_seconds(flop, nbytes, ctx.peaks)
    return 100.0 * least * view.units / device_s
