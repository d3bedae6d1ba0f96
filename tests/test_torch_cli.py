"""Port parity: the command line (``python -m gulon_tpu_torch.cli``).

Each verb of the port, run in process with ``device="cpu"``, prints what
the JAX package's CLI prints on the same index file: ``info``, ``query``
(every scan strategy it accepts), ``query-words``, ``test``, ``tune`` and
``serve``'s start line; ``add-vectors`` and ``remove-keys`` write the
same bytes. Indices the port builds (flat, partitioned, ``--exact``,
``--opq``, ``--kmeans-init kmeans++``, ``--limit-vectors``,
``--max-partition-size``) serve in the JAX CLI as in the port's.
``build-index --streaming`` writes the bytes of the in-memory build of the
same text file, and its errors are the JAX CLI's; ``export-aot`` prints
the JAX CLI's line and ``--aot`` serves what the live path serves, as
the JAX CLI's ``--aot`` does. ``query --mesh 2`` prints the JAX CLI's
lines (two logical CPU shards in the port, two virtual devices in the
JAX package), and ``--mesh`` beyond the devices exits 1. The corpus is
Gaussian, so rows have distinct codes and no equal-distance ties.
"""

import io
import json

import numpy as np
import pytest
import torch

from gulon_tpu import cli as jcli
from gulon_tpu_torch import cli as tcli
from gulon_tpu_torch.utils.word2vec import WordVectors, write_word2vec

torch.set_num_threads(2)

N, D = 1500, 16
BUILD = ["-k", "16", "-m", "8", "-n", "6"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(71)
    x = rng.normal(size=(N + 20, D)).astype(np.float32)
    keys = np.array([f"tok{i:05d}" for i in range(N + 20)], dtype=object)
    root = tmp_path_factory.mktemp("cli")
    paths = {name: str(root / name) for name in (
        "vecs.txt", "q.txt", "add.txt", "flat.pb", "ivf.pb", "exact.npz", "keys.txt",
    )}
    with open(paths["vecs.txt"], "w") as f:
        write_word2vec(WordVectors(keys[:N], x[:N]), f)
    with open(paths["q.txt"], "w") as f:
        write_word2vec(WordVectors(keys[:12], x[:12] + 0.01), f, header=False)
    with open(paths["add.txt"], "w") as f:
        write_word2vec(WordVectors(keys[N:], x[N:]), f)
    with open(paths["keys.txt"], "w") as f:
        f.write("\n".join(keys[100:110]) + "\n")
    for out, extra in (("flat.pb", []), ("ivf.pb", ["-p", "--partitions", "6", "--limit", "3"]),
                       ("exact.npz", ["--exact"])):
        assert jcli.main(["build-index", "--metric", "l2", *BUILD, *extra,
                          "-o", paths[out], paths["vecs.txt"]]) == 0
    return paths, keys


def _both(capsys, argv, monkeypatch=None, stdin=None):
    """(rc, stdout) of the port's CLI and of the JAX package's."""
    out = []
    for main in (lambda a: tcli.main(a, device="cpu"), jcli.main):
        if stdin is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        capsys.readouterr()
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("index", ["flat.pb", "ivf.pb", "exact.npz"])
def test_info_matches_jax(files, capsys, index):
    paths, _ = files
    port, ref = _both(capsys, ["info", "--index", paths[index]])
    assert port == ref and port[0] == 0 and "type:" in port[1]


@pytest.mark.parametrize("index,strategy", [
    ("flat.pb", None), ("flat.pb", "decode"), ("flat.pb", "lut"), ("flat.pb", "pallas"),
    ("flat.pb", "cached"), ("ivf.pb", None), ("ivf.pb", "pallas"), ("ivf.pb", "gathered"),
    ("ivf.pb", "bucketed"), ("exact.npz", None), ("exact.npz", "pallas"),
])
def test_query_matches_jax(files, capsys, index, strategy):
    paths, keys = files
    argv = ["query", "-k", "4", "--index", paths[index], paths["q.txt"]]
    if strategy:
        argv += ["--scan-strategy", strategy]
    port, ref = _both(capsys, argv)
    assert port == ref and port[0] == 0
    lines = port[1].strip().splitlines()
    assert [ln.split(": ")[0] for ln in lines] == list(keys[:12])


def test_query_words_matches_jax(files, capsys, monkeypatch):
    paths, keys = files
    stdin = f"{keys[7]}\nnot-a-word\n\n{keys[9]}\n"
    port, ref = _both(capsys, ["query-words", "-k", "3", "--index", paths["ivf.pb"]],
                      monkeypatch, stdin)
    assert port == ref
    assert port[1].splitlines()[1] == "not-a-word not found"


@pytest.mark.parametrize("index", ["flat.pb", "ivf.pb"])
def test_test_verb_matches_jax(files, capsys, index):
    paths, _ = files
    port, ref = _both(capsys, ["test", "--vectors", paths["vecs.txt"], "--index",
                               paths[index], "--sample", "60", "-e", "0.05"])
    assert port == ref and "R@1:" in port[1] and "R@1000:" in port[1]
    port, ref = _both(capsys, ["test", "--vectors", paths["vecs.txt"], "--index",
                               paths[index], "--queries", paths["q.txt"]])
    assert port == ref


def test_tune_matches_jax(files, capsys, tmp_path):
    paths, _ = files
    outs = []
    for tag in ("port", "jax"):
        outs.append(str(tmp_path / f"{tag}.pb"))
    argv = ["tune", "--vectors", paths["vecs.txt"], "--index", paths["ivf.pb"],
            "--target-recall", "0.3", "--sample", "64"]
    capsys.readouterr()
    assert tcli.main(argv + ["-o", outs[0]], device="cpu") == 0
    port = capsys.readouterr().out
    assert jcli.main(argv + ["-o", outs[1]]) == 0
    assert port == capsys.readouterr().out and "LimitGroups limit" in port
    assert open(outs[0], "rb").read() == open(outs[1], "rb").read()


@pytest.mark.parametrize("index", ["flat.pb", "ivf.pb", "exact.npz"])
def test_add_and_remove_write_jax_bytes(files, tmp_path, index):
    paths, keys = files
    out = {}
    for tag, main in (("port", lambda a: tcli.main(a, device="cpu")), ("jax", jcli.main)):
        added, removed = str(tmp_path / f"{tag}.add"), str(tmp_path / f"{tag}.rm")
        assert main(["add-vectors", "--index", paths[index], "-o", added, paths["add.txt"]]) == 0
        assert main(["remove-keys", "--index", added, "-o", removed, str(keys[3]),
                     "--keys-file", paths["keys.txt"]]) == 0
        out[tag] = (added, removed)
    if index == "exact.npz":  # npz archives carry timestamps: compare contents
        for p, j in zip(out["port"], out["jax"]):
            with np.load(p) as zp, np.load(j) as zj:
                for name in ("keys", "vectors", "metric"):
                    np.testing.assert_array_equal(zp[name], zj[name])
    else:
        for p, j in zip(out["port"], out["jax"]):
            assert open(p, "rb").read() == open(j, "rb").read()


@pytest.mark.parametrize("extra", [
    [], ["--metric", "cosine", "--kmeans-init", "kmeans++"], ["--opq", "2"],
    ["-p", "--partitions", "6", "--limit", "3"],
    ["-p", "--partitions", "6", "--limit-vectors", "600", "--max-partition-size", "400"],
    ["-p", "--partitions", "5", "--opq", "2", "--kmeans-init", "kmeans++"],
    ["--exact"],
])
def test_port_built_index_serves_in_jax(files, capsys, tmp_path, extra):
    paths, _ = files
    out = str(tmp_path / "built.idx")
    metric = [] if "--metric" in extra else ["--metric", "l2"]
    assert tcli.main(["build-index", *metric, *BUILD, *extra, "-o", out,
                      paths["vecs.txt"]], device="cpu") == 0
    port, ref = _both(capsys, ["query", "-k", "5", "--index", out, paths["q.txt"]])
    assert port == ref and port[0] == 0
    info = _both(capsys, ["info", "--index", out])
    assert info[0] == info[1]
    if "--opq" in extra:
        assert "opq:         learned rotation" in info[0][1]


def test_serve_start_line_matches_jax(files, capsys, monkeypatch):
    """``serve`` loads, warms and hands the index to the server; the
    server itself is ``tests/test_torch_server.py``'s."""
    paths, _ = files
    served = []

    def fake_serve(index, host, port, ready_fn, micro_batch_window_ms):
        served.append(type(index).__name__)
        ready_fn(host, 4242)

    monkeypatch.setattr("gulon_tpu_torch.server.serve", fake_serve)
    monkeypatch.setattr("gulon_tpu.server.serve", fake_serve)
    port, ref = _both(capsys, ["serve", "--index", paths["flat.pb"], "--batch-window-ms", "2"])
    assert port == ref == (0, "serving on 127.0.0.1:4242\n")
    assert served == ["FlatIndex", "FlatIndex"]


@pytest.mark.parametrize("index,strategy,rc", [
    ("flat.pb", None, 0), ("flat.pb", "decode", 0), ("flat.pb", "pallas", 0),
    ("ivf.pb", None, 0), ("ivf.pb", "masked", 0), ("ivf.pb", "pallas", 0),
    ("ivf.pb", "bucketed", 0), ("exact.npz", None, 0),
    # the sharded cache scan needs enable_cache() before sharding, and
    # 750 rows a shard are below the dense kernel's 256*k: both CLIs exit 1
    ("flat.pb", "cached", 1), ("exact.npz", "pallas", 1),
])
def test_query_mesh_matches_jax(files, capsys, index, strategy, rc):
    """``query --mesh 2`` serves through the sharded classes and prints
    the JAX CLI's lines."""
    paths, keys = files
    argv = ["query", "-k", "4", "--mesh", "2", "--index", paths[index], paths["q.txt"]]
    if strategy:
        argv += ["--scan-strategy", strategy]
    port, ref = _both(capsys, argv)
    assert port == ref and port[0] == rc
    if rc == 0:
        assert [ln.split(": ")[0] for ln in port[1].strip().splitlines()] == list(keys[:12])


def test_mesh_beyond_devices_exits_1(files, capsys):
    paths, _ = files
    capsys.readouterr()
    argv = ["query", "--mesh", "100000", "--index", paths["flat.pb"], paths["vecs.txt"]]
    assert tcli.main(argv, device="cpu") == 1
    err = capsys.readouterr().err
    assert "--mesh 100000 exceeds the" in err and "Traceback" not in err


def _both_err(capsys, argv):
    """(rc, stdout, stderr) of the port's CLI and of the JAX package's."""
    out = []
    for main in (lambda a: tcli.main(a, device="cpu"), jcli.main):
        capsys.readouterr()
        rc = main(list(argv))
        got = capsys.readouterr()
        out.append((rc, got.out, got.err))
    return out


@pytest.mark.parametrize("extra", [
    [], ["--metric", "cosine"], ["-p", "--partitions", "6", "--limit", "3"],
    ["-p", "--partitions", "6", "--limit-vectors", "600", "--max-partition-size", "400"],
])
def test_streaming_build_writes_the_in_memory_bytes(files, capsys, tmp_path, extra):
    """With the default (whole-corpus) training sample a streaming build
    is the in-memory build of the same text file, byte for byte; the JAX
    CLI serves it as the port does."""
    paths, _ = files
    metric = [] if "--metric" in extra else ["--metric", "l2"]
    built = {}
    for tag, flag in (("stream", ["--streaming"]), ("memory", [])):
        built[tag] = str(tmp_path / f"{tag}.pb")
        assert tcli.main(["build-index", *metric, *BUILD, *extra, *flag, "-o", built[tag],
                          paths["vecs.txt"]], device="cpu") == 0
    assert open(built["stream"], "rb").read() == open(built["memory"], "rb").read()
    port, ref = _both(capsys, ["query", "-k", "5", "--index", built["stream"], paths["q.txt"]])
    assert port == ref and port[0] == 0


@pytest.mark.parametrize("extra", [["--exact"], ["--opq", "2"], ["BINARY"], ["NO_PARSER"]])
def test_streaming_errors_match_jax(files, capsys, tmp_path, monkeypatch, extra):
    paths, keys = files
    vecs = paths["vecs.txt"]
    if extra == ["BINARY"]:
        vecs = str(tmp_path / "v.bin")
        x = np.ones((4, D), np.float32)
        from gulon_tpu_torch.utils.word2vec import write_word2vec_bin

        write_word2vec_bin(WordVectors(keys[:4], x), vecs)
    if extra == ["NO_PARSER"]:
        monkeypatch.setattr("gulon_tpu_torch.utils.native._load", lambda: None)
        monkeypatch.setattr("gulon_tpu.utils.native._load", lambda: None)
    flags = [a for a in extra if a not in ("BINARY", "NO_PARSER")]
    port, ref = _both_err(capsys, ["build-index", "--metric", "l2", "--streaming", *flags,
                                   "-o", str(tmp_path / "x.pb"), vecs])
    # the JAX CLI also reports its failed progress task (with a time)
    assert port[:2] == ref[:2] and port[0] == 1
    assert port[2].splitlines()[-1] == ref[2].splitlines()[-1]
    assert port[2].splitlines()[-1].startswith("error: ")
    assert not (tmp_path / "x.pb").exists()


def _masked(line, *paths):
    """export-aot's line without its byte count and paths (StableHLO and
    plans differ in size)."""
    for p in paths:
        line = line.replace(p, "SIDECAR")
    return line.split(" (")[0] + ";" + line.split(";", 1)[1]


@pytest.mark.parametrize("index", ["flat.pb", "ivf.pb", "exact.npz"])
def test_export_aot_and_aot_serving_match_jax(files, capsys, tmp_path, monkeypatch, index):
    paths, keys = files
    sidecars = {tag: str(tmp_path / f"{tag}.aot") for tag in ("port", "jax")}
    lines = []
    for tag, main in (("port", lambda a: tcli.main(a, device="cpu")), ("jax", jcli.main)):
        capsys.readouterr()
        assert main(["export-aot", "--index", paths[index], "-o", sidecars[tag],
                     "--batches", "1,16", "-k", "4,10"]) == 0
        lines.append(capsys.readouterr().out)
    assert _masked(lines[0], *sidecars.values()) == _masked(lines[1], *sidecars.values())
    assert lines[0].startswith("4 artifacts for platform cpu (")
    for verb in (["query", "-k", "4", "--index", paths[index], paths["q.txt"]],
                 ["test", "--vectors", paths["vecs.txt"], "--index", paths[index],
                  "--sample", "40"]):
        out = []
        for tag, main in (("port", lambda a: tcli.main(a, device="cpu")), ("jax", jcli.main)):
            capsys.readouterr()
            assert main(verb + ["--aot", sidecars[tag]]) == 0
            out.append(capsys.readouterr().out)
        capsys.readouterr()
        assert tcli.main(verb, device="cpu") == 0
        assert out[0] == out[1] == capsys.readouterr().out
    stdin = f"{keys[7]}\nnot-a-word\n"
    words = []
    for tag, main in (("port", lambda a: tcli.main(a, device="cpu")), ("jax", jcli.main)):
        monkeypatch.setattr("sys.stdin", __import__("io").StringIO(stdin))
        capsys.readouterr()
        assert main(["query-words", "-k", "3", "--index", paths[index],
                     "--aot", sidecars[tag]]) == 0
        words.append(capsys.readouterr().out)
    assert words[0] == words[1]


def test_aot_serve_and_mesh_error_match_jax(files, capsys, tmp_path, monkeypatch):
    paths, _ = files
    sidecar = str(tmp_path / "flat.aot")
    assert tcli.main(["export-aot", "--index", paths["flat.pb"], "-o", sidecar],
                     device="cpu") == 0
    served = []

    def fake_serve(index, host, port, ready_fn, micro_batch_window_ms):
        served.append(type(index).__name__)
        ready_fn(host, 4242)

    monkeypatch.setattr("gulon_tpu_torch.server.serve", fake_serve)
    capsys.readouterr()
    assert tcli.main(["serve", "--index", paths["flat.pb"], "--aot", sidecar],
                     device="cpu") == 0
    assert capsys.readouterr().out == "serving on 127.0.0.1:4242\n"
    assert served == ["AOTServing"]
    port, ref = _both_err(capsys, ["query", "--index", paths["flat.pb"], "--mesh", "2",
                                   "--aot", sidecar, paths["q.txt"]])
    assert port[:2] == ref[:2] and port[0] == 1
    assert port[2].splitlines()[-1] == ref[2].splitlines()[-1]
    assert "incompatible with --mesh" in port[2]


@pytest.mark.parametrize("argv", [
    ["build-index", "--metric", "l2", "--partitions", "4", "-o", "x.pb", "VECS"],
    ["build-index", "--metric", "l2", "-p", "--limit", "2", "--limit-vectors", "9", "-o",
     "x.pb", "VECS"],
    ["build-index", "--metric", "l2", "--exact", "-p", "-o", "x.pb", "VECS"],
    ["build-index", "--metric", "l2", "--exact", "--opq", "2", "-o", "x.pb", "VECS"],
    ["build-index", "--metric", "l2", "-o", "x.pb", "MISSING"],
    ["query", "--index", "FLAT", "--scan-strategy", "masked", "VECS"],
    ["query", "--index", "FLAT", "--pallas-winners", "7", "VECS"],
    ["query", "--index", "IVF", "--rerank-factor", "2", "VECS"],
    ["remove-keys", "--index", "FLAT", "-o", "x.pb", "not-a-key"],
    ["remove-keys", "--index", "FLAT", "-o", "x.pb"],
    ["tune", "--vectors", "VECS", "--index", "FLAT", "-o", "x.pb"],
])
def test_errors_match_jax(files, capsys, tmp_path, argv):
    paths, _ = files
    subst = {"VECS": paths["vecs.txt"], "FLAT": paths["flat.pb"], "IVF": paths["ivf.pb"],
             "MISSING": str(tmp_path / "nope.txt"), "x.pb": str(tmp_path / "x.pb")}
    argv = [subst.get(a, a) for a in argv]
    port, ref = _both(capsys, argv)
    assert port == ref and port[0] == 1


def test_parser_matches_jax():
    """Same verbs, flags and defaults."""
    def shape(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {
            verb: sorted((a.dest, json.dumps(a.default), tuple(a.option_strings))
                         for a in p._actions if a.dest != "help")
            for verb, p in sub.choices.items()
        }

    assert shape(tcli.build_parser()) == shape(jcli.build_parser())
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["build-index", "--metric", "l2", "-k", "65537",
                                        "-o", "x", "v"])


def test_profile_writes_a_chrome_trace(files, tmp_path, capsys):
    paths, _ = files
    prof = tmp_path / "prof"
    assert tcli.main(["query", "--profile", str(prof), "--index", paths["flat.pb"],
                      paths["q.txt"]], device="cpu") == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert "profiler trace written" in capsys.readouterr().err
