"""Keyed embedding matrices, their coarse grouping, and the word2vec
readers and writers (host-side numpy; a copy of
``gulon_tpu/utils/word2vec.py``, so the port stands alone).

Counterpart of reference ``WordVectors.scala``:

- the read-order matrix (``WordVectors.Unindexed``) and its grouping by
  coarse cluster (``WordVectors.Grouped``), which the IVF build uses;
- the text format with an optional ``"<count> <dim>"`` header, sniffed
  with pushback (``WordVectors.scala:141-160``), read in chunks with
  progress reports carrying a memory estimate (``:199-257``), optionally
  L2-normalized on read (``:221-234``);
- the original word2vec binary format, an extra over the reference.

Text files go through the native parser (``utils/native.py``, built
from ``native/word2vec_parser.cpp`` at first use) when it builds, else
through the Python reader; both give the same float32 arrays. This is
host IO: no path here touches the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, TextIO, Tuple

import numpy as np

DEFAULT_CHUNK_LINES = 10_000


@dataclasses.dataclass(frozen=True)
class ReadProgress:
    """Mirrors ``WordVectors.ProgressReport`` (``WordVectors.scala:199-209``)."""

    lines_read: int
    total_lines: Optional[int]  # None when the file had no header
    size_estimate_bytes: int

    @property
    def percentage(self) -> Optional[float]:
        if not self.total_lines:
            return None
        return 100.0 * self.lines_read / self.total_lines


@dataclasses.dataclass(frozen=True)
class WordVectors:
    """Keyed embedding matrix in read order (``WordVectors.Unindexed``)."""

    keys: np.ndarray  # [n] object (str)
    vectors: np.ndarray  # [n, d] f32

    def __post_init__(self):
        if len(self.keys) != len(self.vectors):
            raise ValueError("keys and vectors must have equal length")

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def dimension(self) -> int:
        return int(self.vectors.shape[1])

    def sorted(self) -> "WordVectors":
        """Sort by key, permuting rows (``WordVectors.scala:60-68``)."""
        order = np.argsort(self.keys, kind="stable")
        return WordVectors(self.keys[order], self.vectors[order])

    def normalized(self) -> "WordVectors":
        norms = np.linalg.norm(self.vectors, axis=1, keepdims=True)
        safe = np.where(norms > 0, norms, 1.0)
        return WordVectors(self.keys, np.where(norms > 0, self.vectors / safe, self.vectors))

    def grouped(self, centroids, assignments) -> "GroupedWordVectors":
        """Group rows by coarse cluster (``WordVectors.scala:24-58``).

        Rows sort stably by (cluster, key); empty clusters are dropped (and
        the surviving centroids renumbered), matching the reference's
        ``WordVectors.grouped``.
        """
        centroids = np.asarray(centroids, np.float32)
        assignments = np.asarray(assignments)
        if len(assignments) != len(self):
            raise ValueError("assignments must cover every row")
        order = np.lexsort((self.keys, assignments))
        keys_g = self.keys[order]
        x_g = self.vectors[order]
        assign_g = assignments[order]
        used = np.unique(assign_g)  # ascending
        remap = np.zeros(int(assignments.max()) + 1 if len(self) else 1,
                         np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        group_ids = remap[assign_g]
        change = np.nonzero(np.diff(group_ids))[0] + 1
        return GroupedWordVectors(
            keys=keys_g,
            vectors=x_g,
            centroids=centroids[used],
            group_ids=group_ids.astype(np.int32),
            group_offsets=change.astype(np.int32),
        )


@dataclasses.dataclass(frozen=True)
class GroupedWordVectors:
    """Rows grouped by coarse cluster (``WordVectors.Grouped``).

    ``group_offsets`` are the *internal* boundaries (num_groups - 1 entries,
    the ``centroids == offsets + 1`` invariant of ``Index.scala:241-242``).
    """

    keys: np.ndarray  # [n] object, sorted within each group
    vectors: np.ndarray  # [n, d] f32, grouped row order
    centroids: np.ndarray  # [G, d] f32, empty clusters dropped
    group_ids: np.ndarray  # [n] i32
    group_offsets: np.ndarray  # [G - 1] i32

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def num_groups(self) -> int:
        return len(self.centroids)

    def cluster_of(self, row: int) -> int:
        """Group containing ``row`` (``WordVectors.scala:110-113``)."""
        return int(self.group_ids[row])

    def residuals(self) -> np.ndarray:
        """``vector - its centroid`` (``WordVectors.scala:115-138``; computed
        on demand — the reference caches via WeakReference, same idea)."""
        return self.vectors - self.centroids[self.group_ids]


def _sniff_header(first_line: str) -> Optional[Tuple[int, int]]:
    """Header iff the line is exactly two base-10 ints (``WordVectors.scala:143-160``)."""
    parts = first_line.split()
    if len(parts) != 2:
        return None
    try:
        return int(parts[0]), int(parts[1])
    except ValueError:
        return None


def _parse_lines(
    lines: List[str], dimension: Optional[int]
) -> Tuple[List[str], np.ndarray]:
    """Parse 'word f f f ...' lines into (keys, [n, d] f32)."""
    keys: List[str] = []
    rows: List[np.ndarray] = []
    for line in lines:
        line = line.rstrip("\n")
        if not line:
            continue
        sep = line.find(" ")
        if sep < 0:
            raise ValueError(f"malformed word2vec line: {line!r}")
        keys.append(line[:sep])
        vec = np.array(line[sep + 1 :].split(), dtype=np.float32)
        if dimension is not None and len(vec) != dimension:
            raise ValueError(
                f"expected {dimension} dims, got {len(vec)} in line for {keys[-1]!r}"
            )
        rows.append(vec)
    if not rows:
        return keys, np.zeros((0, dimension or 0), np.float32)
    return keys, np.vstack(rows)


def read_word2vec(
    source: TextIO,
    normalize: bool = False,
    report_fn: Optional[Callable[[ReadProgress], None]] = None,
    chunk_lines: int = DEFAULT_CHUNK_LINES,
) -> WordVectors:
    """Stream-parse word2vec text from a file-like object.

    Counterpart of ``WordVectors.readWord2Vec`` (``WordVectors.scala:213-257``):
    header sniff with pushback, chunked parsing with progress callbacks,
    optional normalize-on-read.
    """
    first = source.readline()
    total: Optional[int] = None
    dimension: Optional[int] = None
    pushback: Optional[str] = None
    header = _sniff_header(first) if first else None
    if header is not None:
        total, dimension = header
    elif first:
        pushback = first

    all_keys: List[str] = []
    all_rows: List[np.ndarray] = []
    lines_read = 0
    size_estimate = 0

    def flush(chunk: List[str]):
        nonlocal lines_read, size_estimate, dimension
        keys, vecs = _parse_lines(chunk, dimension)
        if dimension is None and len(vecs):
            dimension = vecs.shape[1]
        all_keys.extend(keys)
        all_rows.append(vecs)
        lines_read += len(keys)
        size_estimate += vecs.nbytes + sum(len(k) for k in keys)
        if report_fn is not None:
            report_fn(ReadProgress(lines_read, total, size_estimate))

    chunk: List[str] = [pushback] if pushback else []
    for line in source:
        chunk.append(line)
        if len(chunk) >= chunk_lines:
            flush(chunk)
            chunk = []
    if chunk:
        flush(chunk)

    keys = np.array(all_keys, dtype=object)
    vectors = (
        np.vstack(all_rows)
        if all_rows
        else np.zeros((0, dimension or 0), np.float32)
    )
    wv = WordVectors(keys, vectors.astype(np.float32, copy=False))
    if normalize:
        wv = wv.normalized()
    return wv


def sniff_word2vec_binary(path: os.PathLike | str) -> bool:
    """True iff ``path`` is the *original word2vec binary* format (the C
    tool's ``-binary 1`` output, e.g. GoogleNews vectors): an ASCII
    ``"<count> <dim>\\n"`` header followed by ``word<space><dim x f32le>``
    records.

    An extra over the reference (text-only, ``WordVectors.scala:141-160``).
    Detection is deterministic for text files: a text file's first data
    line always parses as ``word`` + exactly ``dim`` ASCII floats; binary
    float bytes essentially never do.
    """
    with open(path, "rb") as f:
        head = f.read(8 << 20)  # enough for any header + one data line
    nl = head.find(b"\n")
    if nl <= 0:
        return False
    try:
        count_s, dim_s = head[:nl].decode("ascii").split()
        count, dim = int(count_s), int(dim_s)
    except (UnicodeDecodeError, ValueError):
        return False  # no header -> the binary format is impossible
    if count <= 0 or dim <= 0:
        return False
    nl2 = head.find(b"\n", nl + 1)
    line = head[nl + 1 : nl2 if nl2 != -1 else len(head)]
    try:
        toks = line.decode("utf-8").split()
        if len(toks) == dim + 1:
            for t in toks[1:]:
                float(t)
            return False  # a well-formed text data row
    except (UnicodeDecodeError, ValueError):
        pass
    return True


def read_word2vec_bin(
    path: os.PathLike | str,
    normalize: bool = False,
    report_fn: Optional[Callable[[ReadProgress], None]] = None,
) -> WordVectors:
    """Read the original word2vec *binary* format (an extra over the
    reference): ``"<count> <dim>\\n"`` ASCII header, then per record the
    UTF-8 word up to a space and ``dim`` little-endian f32 (records may be
    separated by a newline, which some writers emit and some do not).
    """
    import mmap

    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            nl = mm.find(b"\n")
            if nl <= 0:
                raise ValueError("binary word2vec file has no header line")
            count_s, dim_s = bytes(mm[:nl]).decode("ascii").split()
            count, dim = int(count_s), int(dim_s)
            keys = np.empty(count, dtype=object)
            vectors = np.empty((count, dim), np.float32)
            vbytes = 4 * dim
            pos = nl + 1
            end = len(mm)
            for i in range(count):
                while pos < end and mm[pos] in (0x0A, 0x0D, 0x20):
                    pos += 1  # inter-record separators vary by writer
                sp = mm.find(b" ", pos)
                if sp < 0 or sp + 1 + vbytes > end:
                    raise ValueError(
                        f"truncated binary word2vec record {i}/{count}"
                    )
                keys[i] = bytes(mm[pos:sp]).decode("utf-8")
                vectors[i] = np.frombuffer(mm, "<f4", dim, sp + 1)
                pos = sp + 1 + vbytes
                if report_fn is not None and (i + 1) % 200_000 == 0:
                    report_fn(
                        ReadProgress(i + 1, count, vectors.nbytes)
                    )
        finally:
            mm.close()
    if report_fn is not None:
        report_fn(ReadProgress(count, count, vectors.nbytes))
    wv = WordVectors(keys, vectors)
    return wv.normalized() if normalize else wv


def write_word2vec_bin(wv: WordVectors, path: os.PathLike | str) -> None:
    """Write the original word2vec binary format (round-trip helper)."""
    with open(path, "wb") as f:
        f.write(f"{len(wv)} {wv.dimension}\n".encode("ascii"))
        vecs = np.ascontiguousarray(wv.vectors, dtype="<f4")
        for key, row in zip(wv.keys, vecs):
            f.write(str(key).encode("utf-8"))
            f.write(b" ")
            f.write(row.tobytes())
            f.write(b"\n")


def read_word2vec_path(
    path: os.PathLike | str,
    normalize: bool = False,
    report_fn: Optional[Callable[[ReadProgress], None]] = None,
    chunk_lines: int = DEFAULT_CHUNK_LINES,
    use_native: bool = True,
    binary: Optional[bool] = None,
) -> WordVectors:
    """Read a word2vec file from disk (``WordVectors.readWord2VecPath``).

    Detects and reads both the text format and the original binary format
    (``binary=None`` sniffs; pass True/False to force). Text files prefer
    the native C parser when available (an order of magnitude faster on
    multi-GB files), falling back to the streaming Python reader.
    """
    if binary is None:
        binary = sniff_word2vec_binary(path)
    if binary:
        return read_word2vec_bin(path, normalize, report_fn)
    if use_native:
        try:
            from gulon_tpu_torch.utils import native

            if native.available():
                wv = native.read_word2vec(str(path), report_fn=report_fn)
                return wv.normalized() if normalize else wv
        except ImportError:
            pass
    with open(path, "r", encoding="utf-8") as f:
        return read_word2vec(f, normalize, report_fn, chunk_lines)


def write_word2vec(wv: WordVectors, sink: TextIO, header: bool = True) -> None:
    """Write word2vec text (round-trip helper for tests and the CLI)."""
    if header:
        sink.write(f"{len(wv)} {wv.dimension}\n")
    for key, row in zip(wv.keys, wv.vectors):
        sink.write(str(key))
        sink.write(" ")
        sink.write(" ".join(repr(float(v)) for v in row))
        sink.write("\n")
