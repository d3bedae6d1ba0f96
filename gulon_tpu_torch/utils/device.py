"""The device the port's entry points use when the caller names none.

The port serves from a CUDA card: builders, adapters and the recall
harness put their tensors on :data:`DEFAULT_DEVICE` unless they are given
``device=``. There is no fallback to the CPU: on a machine without a card
the first tensor moved there raises, as ``torch`` does. CPU runs (the
tests, a host-only drive) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = torch.device("cuda")
