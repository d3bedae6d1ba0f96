"""Times K1 decodes each 128-row block it covers, over the run: the
program's always-on counters ``k1.block_decodes`` over ``k1.blocks``
(``gulon_tpu_torch/ops/cuda/adc.py::count_launch``, by the launch plan
the kernel itself picks). 1.0 where a block is held decoded and decoded
once; in the streamed plan a block is decoded once per query tile of the
plan's ``qtile`` queries (256 where it fits, else 128): 4 times a
1024-query batch at gist-960. ``None`` where no device work was traced (a
CPU run) or where the program keeps no such counters."""


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
    blocks = counters.get("k1.blocks", 0)
    if not blocks:
        return None
    return counters.get("k1.block_decodes", 0) / blocks
