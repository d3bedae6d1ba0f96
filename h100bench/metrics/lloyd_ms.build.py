"""One Lloyd iteration of the build's k-means, in ms: the traced
``gulon.kmeans.iter`` spans' time over their count. Each iteration ends
by reading its convergence mask back, so a span holds the iteration's
device time (the program's own span, ``gulon_tpu_torch/ops/kmeans.py``)."""


def _program_spans(ctx):
    """The program's span aggregates of the traced window
    (``gulon_tpu_torch.utils.tracing.snapshot()``), or ``None``: no device
    work traced, or a program that records no spans."""
    if not ctx.view.kernels:
        return None
    try:
        from gulon_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()["spans"]


def read(ctx):
    spans = _program_spans(ctx)
    it = (spans or {}).get("gulon.kmeans.iter")
    if not it or not it["count"]:
        return None
    return 1e3 * it["total_s"] / it["count"]
