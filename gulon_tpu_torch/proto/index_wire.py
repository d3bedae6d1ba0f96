"""The index wire format (``index.proto`` beside this file) in plain Python
and numpy, without the protobuf library.

The messages are dataclasses that encode to the bytes the generated
``index_pb2`` bindings give for the same contents and decode what they
write:

- fields are written in field-number order, as ``SerializeToString``
  does; a required field that is unset raises :class:`WireError` on
  write and on read;
- the schema is proto2, so a repeated scalar is written unpacked, a tag
  for each element (a float is ``0x0d`` and its 4 little-endian bytes);
  the reader also takes the packed form;
- an unknown field is skipped on read; of the ``Index.implementation``
  oneof the last one read wins.

Float runs are written and read as strided numpy views, so a codebook of
10^5 floats costs no Python loop per float. Strings, bytes and messages
cost one Python step each.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5
_FLOAT_TAG = (1 << 3) | _FIXED32  # FloatVector.values: 0x0d


class WireError(ValueError):
    """Malformed or incomplete index bytes."""


def _varint(value: int) -> bytes:
    """Base-128 varint; a negative int32/enum is its 64-bit two's
    complement (10 bytes), as protobuf writes it."""
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _tag(number: int, wire_type: int) -> bytes:
    return _varint((number << 3) | wire_type)


def _read_varint(buf: bytes, pos: int, end: int):
    result = shift = 0
    while True:
        if pos >= end:
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise WireError("varint longer than 10 bytes")


def _int32(raw: int) -> int:
    """A decoded varint as proto2 reads an int32 or enum."""
    raw &= 0xFFFFFFFF
    return raw - (1 << 32) if raw >= 1 << 31 else raw


def _skip(buf: bytes, pos: int, end: int, wire_type: int) -> int:
    if wire_type == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wire_type == _FIXED64:
        pos += 8
    elif wire_type == _LEN:
        size, pos = _read_varint(buf, pos, end)
        pos += size
    elif wire_type == _FIXED32:
        pos += 4
    else:
        raise WireError(f"unsupported wire type {wire_type}")
    if pos > end:
        raise WireError("truncated field")
    return pos


def _float_run(values: np.ndarray) -> bytes:
    """Unpacked ``repeated float``: ``0x0d`` + 4 bytes per element."""
    v = np.ascontiguousarray(values, dtype="<f4").reshape(-1)
    rows = np.empty((len(v), 5), np.uint8)
    rows[:, 0] = _FLOAT_TAG
    rows[:, 1:] = v.view(np.uint8).reshape(-1, 4)
    return rows.tobytes()


def _read_floats(buf: bytes, start: int, end: int) -> np.ndarray:
    """The ``values`` of a FloatVector payload: the fast path for a run of
    unpacked floats, else a field walk that also takes packed runs and
    skips unknown fields."""
    size = end - start
    if size % 5 == 0:
        rows = np.frombuffer(buf, np.uint8, count=size, offset=start).reshape(-1, 5)
        if bool((rows[:, 0] == _FLOAT_TAG).all()):
            return np.ascontiguousarray(rows[:, 1:]).view("<f4").reshape(-1).astype(np.float32)
    parts = []
    pos = start
    while pos < end:
        key, pos = _read_varint(buf, pos, end)
        number, wire_type = key >> 3, key & 7
        if number == 1 and wire_type == _FIXED32:
            if pos + 4 > end:
                raise WireError("truncated float")
            parts.append(np.frombuffer(buf, "<f4", count=1, offset=pos))
            pos += 4
        elif number == 1 and wire_type == _LEN:
            length, pos = _read_varint(buf, pos, end)
            if length % 4 or pos + length > end:
                raise WireError("bad packed float run")
            parts.append(np.frombuffer(buf, "<f4", count=length // 4, offset=pos))
            pos += length
        else:
            pos = _skip(buf, pos, end, wire_type)
    if pos != end:
        raise WireError("field overruns its message")
    if not parts:
        return np.zeros(0, np.float32)
    return np.concatenate(parts).astype(np.float32)


class _Message:
    """Schema-driven encode/decode. ``_FIELDS`` lists ``(number, name,
    kind, label)`` in field-number order; ``kind`` is ``"int32"``,
    ``"string"``, ``"bytes"`` or a message class; ``label`` is
    ``"required"``, ``"optional"`` or ``"repeated"``. ``_ONEOF`` names
    fields of which at most one is set."""

    _FIELDS: tuple = ()
    _ONEOF: tuple = ()

    def encode(self) -> bytes:
        out: List[bytes] = []
        set_oneof = [n for n in self._ONEOF if getattr(self, n) is not None]
        if len(set_oneof) > 1:
            raise WireError(f"{type(self).__name__}: more than one of {set_oneof} set")
        for number, name, kind, label in self._FIELDS:
            value = getattr(self, name)
            if label == "repeated":
                for item in value:
                    out.append(_encode_one(number, kind, item))
            elif value is None:
                if label == "required":
                    raise WireError(f"{type(self).__name__}.{name} is required")
            else:
                out.append(_encode_one(number, kind, value))
        return b"".join(out)

    @classmethod
    def decode(cls, buf: bytes, start: int = 0, end: Optional[int] = None):
        end = len(buf) if end is None else end
        by_number = {f[0]: f for f in cls._FIELDS}
        values = {f[1]: [] for f in cls._FIELDS if f[3] == "repeated"}
        pos = start
        while pos < end:
            key, pos = _read_varint(buf, pos, end)
            number, wire_type = key >> 3, key & 7
            spec = by_number.get(number)
            if spec is None:
                pos = _skip(buf, pos, end, wire_type)
                continue
            _, name, kind, label = spec
            if kind == "int32":
                if wire_type == _LEN and label == "repeated":  # packed
                    length, pos = _read_varint(buf, pos, end)
                    stop = pos + length
                    while pos < stop:
                        raw, pos = _read_varint(buf, pos, stop)
                        values[name].append(_int32(raw))
                    continue
                if wire_type != _VARINT:
                    raise WireError(f"{cls.__name__}.{name}: wire type {wire_type}")
                raw, pos = _read_varint(buf, pos, end)
                value = _int32(raw)
            else:
                if wire_type != _LEN:
                    raise WireError(f"{cls.__name__}.{name}: wire type {wire_type}")
                length, pos = _read_varint(buf, pos, end)
                stop = pos + length
                if stop > end:
                    raise WireError(f"{cls.__name__}.{name}: truncated")
                if kind == "string":
                    value = buf[pos:stop].decode("utf-8")
                elif kind == "bytes":
                    value = bytes(buf[pos:stop])
                else:
                    value = kind.decode(buf, pos, stop)
                pos = stop
            if label == "repeated":
                values[name].append(value)
            else:
                if name in cls._ONEOF:
                    for other in cls._ONEOF:
                        values.pop(other, None)
                values[name] = value
        if pos != end:
            raise WireError(f"{cls.__name__}: field overruns its message")
        for _, name, _, label in cls._FIELDS:
            if label == "required" and name not in values:
                raise WireError(f"{cls.__name__}.{name} is required")
        return cls(**values)


def _encode_one(number: int, kind, value) -> bytes:
    if kind == "int32":
        return _tag(number, _VARINT) + _varint(int(value))
    if kind == "string":
        payload = value.encode("utf-8")
    elif kind == "bytes":
        payload = bytes(value)
    else:
        payload = value.encode()
    return _tag(number, _LEN) + _varint(len(payload)) + payload


@dataclasses.dataclass
class FloatVector:
    """``message FloatVector { repeated float values = 1; }``"""

    values: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32)
    )

    def encode(self) -> bytes:
        return _float_run(self.values)

    @classmethod
    def decode(cls, buf: bytes, start: int = 0, end: Optional[int] = None):
        end = len(buf) if end is None else end
        return cls(_read_floats(buf, start, end))


@dataclasses.dataclass
class Quantizer(_Message):
    """``ProductQuantizer.Quantizer``: one subspace's codebook."""

    start_index: Optional[int] = None
    dimension: Optional[int] = None
    centroids: List[FloatVector] = dataclasses.field(default_factory=list)
    _FIELDS = (
        (1, "start_index", "int32", "required"),
        (2, "dimension", "int32", "required"),
        (3, "centroids", FloatVector, "repeated"),
    )


@dataclasses.dataclass
class ProductQuantizer(_Message):
    num_clusters: Optional[int] = None
    quantizers: List[Quantizer] = dataclasses.field(default_factory=list)
    _FIELDS = (
        (1, "num_clusters", "int32", "required"),
        (2, "quantizers", Quantizer, "repeated"),
    )


@dataclasses.dataclass
class EncodedMatrix(_Message):
    """Codes quantizer-major: one packed blob per subquantizer."""

    code_width: Optional[int] = None
    length: Optional[int] = None
    encodings: List[bytes] = dataclasses.field(default_factory=list)
    _FIELDS = (
        (1, "code_width", "int32", "required"),
        (2, "length", "int32", "required"),
        (3, "encodings", "bytes", "repeated"),
    )


@dataclasses.dataclass
class PQIndex(_Message):
    product_quantizer: Optional[ProductQuantizer] = None
    data: Optional[EncodedMatrix] = None
    _FIELDS = (
        (1, "product_quantizer", ProductQuantizer, "required"),
        (2, "data", EncodedMatrix, "required"),
    )


# enum Metric
L2, COSINE = 0, 1
# enum GroupedIndex.Strategy
LIMIT_GROUPS, LIMIT_VECTORS = 0, 2


@dataclasses.dataclass
class SortedIndex(_Message):
    sorted_words: List[str] = dataclasses.field(default_factory=list)
    vector_index: Optional[PQIndex] = None
    metric: Optional[int] = None
    rotation: Optional[FloatVector] = None  # extension field 100
    _FIELDS = (
        (1, "sorted_words", "string", "repeated"),
        (2, "vector_index", PQIndex, "required"),
        (3, "metric", "int32", "required"),
        (100, "rotation", FloatVector, "optional"),
    )


@dataclasses.dataclass
class GroupedIndex(_Message):
    grouped_words: List[str] = dataclasses.field(default_factory=list)
    vector_index: Optional[PQIndex] = None
    metric: Optional[int] = None
    centroids: List[FloatVector] = dataclasses.field(default_factory=list)
    offsets: List[int] = dataclasses.field(default_factory=list)
    strategy: Optional[int] = None
    limit: Optional[int] = None
    rotation: Optional[FloatVector] = None  # extension field 100
    _FIELDS = (
        (1, "grouped_words", "string", "repeated"),
        (2, "vector_index", PQIndex, "required"),
        (3, "metric", "int32", "required"),
        (4, "centroids", FloatVector, "repeated"),
        (5, "offsets", "int32", "repeated"),
        (6, "strategy", "int32", "required"),
        (7, "limit", "int32", "required"),
        (100, "rotation", FloatVector, "optional"),
    )


@dataclasses.dataclass
class Index(_Message):
    """``message Index { oneof implementation { sorted = 1; grouped = 2; } }``"""

    sorted: Optional[SortedIndex] = None
    grouped: Optional[GroupedIndex] = None
    _FIELDS = (
        (1, "sorted", SortedIndex, "optional"),
        (2, "grouped", GroupedIndex, "optional"),
    )
    _ONEOF = ("sorted", "grouped")

    def which(self) -> Optional[str]:
        """The set member of the ``implementation`` oneof, or None."""
        for name in self._ONEOF:
            if getattr(self, name) is not None:
                return name
        return None
