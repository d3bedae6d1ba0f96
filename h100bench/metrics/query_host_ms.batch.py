"""Host time a batch spends issuing work inside the program, in ms: over
the traced ``gulon.query`` spans, their time less the time of the
``gulon.wait.*`` spans (each a call that blocks the host until the device's
stream drains, all inside a query in a batch cell), over their count. The
spans are the program's own (``gulon_tpu_torch/utils/tracing.py``), on the
profiler's clock."""


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
    query = (spans or {}).get("gulon.query")
    if not query or not query["count"]:
        return None
    wait_s = sum(v["total_s"] for name, v in spans.items() if name.startswith("gulon.wait."))
    return 1e3 * (query["total_s"] - wait_s) / query["count"]
