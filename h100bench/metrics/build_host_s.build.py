"""Seconds a build spends in host-only work: the traced ``gulon.build.host``
spans (the rows' cast, normalisation, key sort and permutation; an IVF
build's host grouping) over the traced ``gulon.build`` spans (the
program's own, ``gulon_tpu_torch/models/build.py``)."""


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
    spans = _program_spans(ctx) or {}
    build, host = spans.get("gulon.build"), spans.get("gulon.build.host")
    if not build or not build["count"] or not host:
        return None
    return host["total_s"] / build["count"]
