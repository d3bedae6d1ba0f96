"""Share of the device's time spent in sort and top-k kernels (the
selection epilogue's sorts in ``ops/cuda/adc.py::finish_scan`` and
``ops/topk.py``, the rescore's selection, the IVF winner sort), by kernel
name: device time of the kernels ``SORT`` matches over all device time."""

import re

SORT = re.compile(r"sort|topk|radix|bitonic", re.IGNORECASE)


def read(ctx):
    total = sum(e - s for _, s, e in ctx.view.kernels)
    if total <= 0:
        return None
    sorts = sum(e - s for name, s, e in ctx.view.kernels if SORT.search(name))
    return 100.0 * sorts / total
