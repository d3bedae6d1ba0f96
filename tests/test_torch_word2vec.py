"""Port parity: the word2vec readers and writers
(``gulon_tpu_torch/utils/word2vec.py``, ``utils/native.py``).

The same files go through the JAX package's readers and the port's:
text with and without the ``"<count> <dim>"`` header (through the native
parser, which the port builds from ``native/word2vec_parser.cpp`` into
its own build directory, and through the Python reader), the binary
format with and without record newlines, normalize-on-read, progress
reports and the binary sniff. Keys are equal and vectors bit-equal.
"""

import io

import numpy as np
import pytest

from gulon_tpu.utils import word2vec as jw2v
from gulon_tpu_torch.utils import native as tnative
from gulon_tpu_torch.utils import word2vec as tw2v


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(51)
    x = rng.normal(size=(700, 9)).astype(np.float32)
    x[3] = 0.0  # a zero row normalizes to itself
    keys = np.array([f"w{i}_é" for i in range(700)], dtype=object)
    return keys, x


def _same(a, b):
    assert list(a.keys) == list(b.keys)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    assert a.vectors.dtype == np.float32


@pytest.mark.parametrize("header", [True, False])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
def test_text_reader_matches_jax(corpus, tmp_path, header, use_native, normalize):
    keys, x = corpus
    path = tmp_path / "v.txt"
    with open(path, "w", encoding="utf-8") as f:
        tw2v.write_word2vec(tw2v.WordVectors(keys, x), f, header=header)
    seen = []
    got = tw2v.read_word2vec_path(
        path, normalize=normalize, use_native=use_native, report_fn=seen.append,
        chunk_lines=128,
    )
    ref = jw2v.read_word2vec_path(path, normalize=normalize, use_native=False)
    _same(got, ref)
    assert seen and seen[-1].lines_read == len(keys)
    np.testing.assert_array_equal(got.vectors if normalize else x, ref.vectors)


def test_native_parser_builds_in_the_port(corpus, tmp_path):
    keys, x = corpus
    assert tnative.available()
    lib = tnative.library_path()
    assert lib.exists() and lib.parent == tnative.BUILD_DIR
    assert "gulon_tpu_torch" in str(lib)
    path = tmp_path / "v.txt"
    with open(path, "w", encoding="utf-8") as f:
        tw2v.write_word2vec(tw2v.WordVectors(keys, x), f)
    _same(tnative.read_word2vec(str(path)), jw2v.read_word2vec_path(path, use_native=False))
    bad = tmp_path / "bad.txt"
    bad.write_text("2 3\nword 1 2 3\nnospace\n")
    with pytest.raises(ValueError):
        tw2v.read_word2vec_path(bad)


def test_stream_reader_matches_jax(corpus):
    keys, x = corpus
    buf = io.StringIO()
    jw2v.write_word2vec(jw2v.WordVectors(keys[:50], x[:50]), buf, header=False)
    text = buf.getvalue()
    _same(tw2v.read_word2vec(io.StringIO(text)), jw2v.read_word2vec(io.StringIO(text)))
    out = io.StringIO()
    tw2v.write_word2vec(tw2v.WordVectors(keys[:50], x[:50]), out, header=False)
    assert out.getvalue() == text


@pytest.mark.parametrize("newlines", [True, False])
def test_binary_reader_matches_jax(corpus, tmp_path, newlines):
    keys, x = corpus
    path = tmp_path / "v.bin"
    tw2v.write_word2vec_bin(tw2v.WordVectors(keys, x), path)
    jpath = tmp_path / "j.bin"
    jw2v.write_word2vec_bin(jw2v.WordVectors(keys, x), jpath)
    assert path.read_bytes() == jpath.read_bytes()
    if not newlines:  # the C tool's records carry no newline
        raw = f"{len(keys)} {x.shape[1]}\n".encode()
        raw += b"".join(k.encode() + b" " + row.tobytes() for k, row in zip(keys, x))
        path.write_bytes(raw)
    assert tw2v.sniff_word2vec_binary(path) and jw2v.sniff_word2vec_binary(path)
    _same(tw2v.read_word2vec_path(path), jw2v.read_word2vec_path(path))
    _same(tw2v.read_word2vec_bin(path, normalize=True), jw2v.read_word2vec_bin(path, normalize=True))


def test_sniff_matches_jax(corpus, tmp_path):
    keys, x = corpus
    cases = {
        "text_header.txt": None, "no_header.txt": None, "empty.txt": b"",
        "two_ints.txt": b"3 4\n", "bad_header.bin": b"x y\n\x00\x01",
    }
    for name, raw in cases.items():
        path = tmp_path / name
        if raw is None:
            with open(path, "w", encoding="utf-8") as f:
                tw2v.write_word2vec(tw2v.WordVectors(keys[:5], x[:5]), f, header="header" in name)
        else:
            path.write_bytes(raw)
        assert tw2v.sniff_word2vec_binary(path) == jw2v.sniff_word2vec_binary(path), name
    truncated = tmp_path / "cut.bin"
    tw2v.write_word2vec_bin(tw2v.WordVectors(keys[:5], x[:5]), truncated)
    truncated.write_bytes(truncated.read_bytes()[:-20])
    with pytest.raises(ValueError):
        tw2v.read_word2vec_bin(truncated)
