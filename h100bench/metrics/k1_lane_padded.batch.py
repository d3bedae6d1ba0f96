"""The share of K1's launches, in percent over the run, whose codebook and
query operands carry zero lanes past each subspace's own width: the
program's always-on counters ``k1.launches.lane_padded`` over
``k1.launches`` (``gulon_tpu_torch/ops/cuda/adc.py::count_launch``). The
program pads where K1 streams and a subspace's width is not a whole
number of 16-byte gathers (the ``width`` of K1's plan, ``k1_plan``), so
that each gather loads 8 lanes: 100 at gist-960's 39-lane subspaces, and
0, as it should, where K1 holds its blocks decoded. ``None`` where no device work was traced (a CPU run), where K1
never ran, or where the program keeps no such counter."""


def _program_counters(ctx):
    """The program's counters (``gulon_tpu_torch.utils.tracing.snapshot()``),
    or ``None``: no device work traced, or a program without them."""
    if not ctx.view.kernels:
        return None
    try:
        from gulon_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()["counters"]


def read(ctx):
    counters = _program_counters(ctx) or {}
    launches = counters.get("k1.launches", 0)
    if not launches or "k1.launches.lane_padded" not in counters:
        return None
    return 100.0 * counters["k1.launches.lane_padded"] / launches
