"""Keys the IVF K1 route's selection sorts a batch, in millions: the
program's always-on counters ``ivf.select_keys`` over ``ivf.selects``
(``gulon_tpu_torch/models/ivf.py::_pallas_ivf_query``), counted from the
shapes: a batch's queries times K1's winner columns, the winners of every
128-row block of the partition-padded layout, probed or not. About 340 at
deep-image-96 (1,024 queries x about 83,000 blocks x 4 winners) and 34 at
sift-128; sorting only the probed columns would cut it about 20-fold.
``None`` where no device work was traced, where the program keeps no
such counters (a program before they were added) or where the route
never ran."""


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
    selects = counters.get("ivf.selects", 0)
    if not selects:
        return None
    return counters.get("ivf.select_keys", 0) / selects / 1e6
