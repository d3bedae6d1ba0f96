"""Bit-packing codecs for PQ code storage (wire-compatible with the reference).

Counterpart of ``Coder.scala``: supported storage widths are 0, 2, 4, 8, 10,
12 and 16 bits (``Coder.scala:27-28``); ``storage_width`` rounds a logical
width up (``Coder.scala:35-45``). Packing layout:

- 2/4-bit: little-endian within each byte — index i lands in byte ``i*w//8``
  shifted left by ``(i % (8//w)) * w`` (``Coder.scala:99-127``);
- 8-bit: one byte per index (``Coder.scala:130-140``);
- 10/12/16-bit ("byte-plus"): an MSB byte-plane of ``n`` bytes
  (``index >> (w-8)``) followed by the packed (w-8)-bit LSB plane
  (``Coder.scala:142-168``).

In-memory codes stay unpacked (uint8/int32 ``[N, m]``) for the device scan;
packing is applied per-subquantizer at serialization time, quantizer-major
like ``EncodedMatrix`` (``EncodedMatrix.scala:11-35``). A copy of
``gulon_tpu/ops/coder.py`` (host-side numpy), so the port stands alone.
"""

from __future__ import annotations

import numpy as np

SUPPORTED_WIDTHS = (0, 2, 4, 8, 10, 12, 16)


def storage_width(logical_bits: int) -> int:
    """Round a logical code width up to a supported storage width."""
    if logical_bits < 0 or logical_bits > 16:
        raise ValueError(f"unsupported code width {logical_bits}")
    for w in SUPPORTED_WIDTHS:
        if w >= logical_bits:
            return w
    raise AssertionError


def packed_size(n: int, width: int) -> int:
    """Exact packed byte count (CoderSpec size law: sub-byte widths pack
    ceil(n*w/8); byte-plus widths use n + ceil(n*(w-8)/8))."""
    if width == 0:
        return 0
    if width in (2, 4, 8):
        per_byte = 8 // width
        return (n + per_byte - 1) // per_byte
    if width in (10, 12, 16):
        return n + packed_size(n, width - 8)
    raise ValueError(f"unsupported width {width}")


def _pack_sub_byte(indices: np.ndarray, width: int) -> np.ndarray:
    per_byte = 8 // width
    n = len(indices)
    pad = (-n) % per_byte
    idx = np.asarray(indices, np.uint32) & ((1 << width) - 1)
    if pad:
        idx = np.concatenate([idx, np.zeros(pad, np.uint32)])
    idx = idx.reshape(-1, per_byte)
    shifts = (np.arange(per_byte, dtype=np.uint32) * width)[None, :]
    return (idx << shifts).sum(axis=1).astype(np.uint8)


def _unpack_sub_byte(data: np.ndarray, n: int, width: int) -> np.ndarray:
    per_byte = 8 // width
    shifts = (np.arange(per_byte, dtype=np.uint32) * width)[None, :]
    vals = (data.astype(np.uint32)[:, None] >> shifts) & ((1 << width) - 1)
    return vals.reshape(-1)[:n].astype(np.int32)


def pack(indices, width: int) -> bytes:
    """Pack integer code indices into the reference byte layout."""
    indices = np.asarray(indices)
    if indices.ndim != 1:
        raise ValueError("pack expects a 1-D index array")
    n = len(indices)
    if width == 0:
        return b""
    if width in (2, 4):
        return _pack_sub_byte(indices, width).tobytes()
    if width == 8:
        return (np.asarray(indices, np.uint32) & 0xFF).astype(np.uint8).tobytes()
    if width in (10, 12, 16):
        lsb_w = width - 8
        idx = np.asarray(indices, np.uint32)
        msb = ((idx >> lsb_w) & 0xFF).astype(np.uint8)
        lsb = pack(idx & ((1 << lsb_w) - 1), lsb_w)
        return msb.tobytes() + lsb
    raise ValueError(f"unsupported width {width}")


def unpack(data: bytes, n: int, width: int) -> np.ndarray:
    """Inverse of :func:`pack`; returns int32 indices."""
    buf = np.frombuffer(data, np.uint8)
    if width == 0:
        return np.zeros(n, np.int32)
    if width in (2, 4):
        return _unpack_sub_byte(buf, n, width)
    if width == 8:
        return buf[:n].astype(np.int32)
    if width in (10, 12, 16):
        lsb_w = width - 8
        msb = buf[:n].astype(np.int32)
        lsb = unpack(data[n:], n, lsb_w)
        return (msb << lsb_w) | lsb
    raise ValueError(f"unsupported width {width}")
