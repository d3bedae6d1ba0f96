"""Calls a batch makes that block the host until the device's stream
drains: the traced ``gulon.wait.*`` spans over the traced ``gulon.query``
spans (the program's own, ``gulon_tpu_torch/utils/tracing.py``)."""


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
    waits = sum(v["count"] for name, v in spans.items() if name.startswith("gulon.wait."))
    return waits / query["count"]
