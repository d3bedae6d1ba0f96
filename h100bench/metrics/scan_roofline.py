"""K1's share of its roofline: the least time the card could take for the
scan work the traced batches need, over the device time of the kernels
this file classifies as the scan (K1, ``csrc/adc_scan.cu``).

The work is counted from the cell's shapes, so it reads the same however
the scan is implemented: each query scores ``rows`` rows over ``d``
decoded lanes, where ``rows`` is the whole corpus for a flat index and
the rows of the probed partitions, ``probe x n / partitions``, for IVF
(what the algorithm needs, not the padded layout K1 sweeps); the codes of
the rows a batch touches are read once, its bf16 queries once and its
top-k written once (``roofline.adc_scan_work``). Against the card's
published peaks (``roofline.PEAKS``; ``None`` for a card not in it).
"""

import math
import re

from h100bench.roofline import adc_scan_work, least_seconds

SCAN = re.compile(r"adc_scan_kernel")


def read(ctx):
    view = ctx.view
    device_s = sum(e - s for name, s, e in view.kernels if SCAN.search(name)) / 1e9
    if device_s <= 0 or ctx.peaks is None or view.units == 0:
        return None
    data, index = ctx.config["dataset"], ctx.config["index"]
    n, d, batch = data["n"], data["d"], ctx.traffic["batch"]
    rows = n if index["kind"] == "flat" else index["probe"] * n / index["partitions"]
    code_bytes = index["pq"]["num_quantizers"] * math.ceil(
        math.log2(index["pq"]["num_clusters"]) / 8
    )
    flop, nbytes = adc_scan_work(
        batch, rows, d, distinct_rows=min(n, math.ceil(batch * rows)),
        code_bytes_per_row=code_bytes, k=ctx.traffic["k"],
    )
    least, _ = least_seconds(flop, nbytes, ctx.peaks)
    return 100.0 * least * view.units / device_s
