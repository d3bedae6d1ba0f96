"""The port stands alone: a fresh interpreter imports ``gulon_tpu_torch``,
builds, queries (fused, cached, exact and IVF paths), measures recall,
adds and removes rows, trains OPQ, packs codes, saves and loads index
files, reads word2vec files, builds from one as a stream, serves through
ahead-of-time plans, shards indices over a mesh of logical CPU shards and
builds over it (``gulon_tpu_torch.parallel``), drives the command line
(``--mesh`` too), answers a server request and runs the probes P1-P4
(``gulon_tpu_torch.probes``) on the CPU, and never loads ``jax``, any
module of the JAX package ``gulon_tpu``, the TPU harness ``benchmarks``
or ``google.protobuf`` (a GPU host need not have protobuf). The port's
sources (and ``chip_smoke.py``) import none of them."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(2)
import gulon_tpu_torch as gt

rng = np.random.default_rng(0)
x = rng.normal(size=(1200, 12)).astype(np.float32)
keys = np.array([f"k{i:05d}" for i in range(1200)], dtype=object)
index = gt.build_flat_index(
    keys, x, pq_config=gt.PQConfig(num_clusters=16, num_quantizers=4, max_iters=5),
    device="cpu",
)
assert index.query(3, x[7]).keys[0] == "k00007"
truth = gt.sample_ground_truth(keys, x, num_samples=50, ks=(1, 10), device="cpu")
index.scan_strategy = "pallas"
recall = gt.recall_of(index, truth, x, keys)
assert 0.0 < recall[10].mean <= 1.0
index.scan_strategy = "auto"
index.enable_cache()
assert index.resolve_strategy(64, 10) == "cached"
assert index.query_arrays(10, x[:64])[1].shape == (64, 10)

from gulon_tpu_torch.ops.cuda import dense

exact = gt.build_exact_index(keys, x, device="cpu")
exact.scan_strategy = "pallas"
assert exact.query(3, x[9]).keys[0] == "k00009"
exact.operand = "int8"
assert exact.resolved_operand == "int8"
assert exact.query(3, x[9]).keys[0] == "k00009"
assert gt.exact_index_from_numpy(keys, x, device="cpu").size == 1200

ivf = gt.build_ivf_index(
    keys, x, pq_config=gt.PQConfig(num_clusters=16, num_quantizers=4, max_iters=5),
    num_partitions=6, strategy=gt.LimitGroups(3), coarse_max_iters=5, device="cpu",
)
assert "k00005" in set(ivf.query(3, x[5]).keys)
for strategy in ("masked", "pallas", "gathered", "bucketed"):
    ivf.scan_strategy = strategy
    assert ivf.query_arrays(10, x[:16])[1].shape == (16, 10)
ivf.enable_cache()
assert ivf.query_arrays(10, x[:16])[1].shape == (16, 10)
assert gt.tune_probe_limit(ivf, x, keys, target_recall=0.1, num_samples=32).met

import io, json, os, socket, tempfile, threading
from contextlib import redirect_stdout
from gulon_tpu_torch import cli
from gulon_tpu_torch.server import QueryServer

tmp = tempfile.mkdtemp()
grown = ivf.add(["zz"], x[:1]).remove(["k00001"])
opq = gt.build_flat_index(
    keys, x, pq_config=gt.PQConfig(num_clusters=16, num_quantizers=4, max_iters=3),
    opq_iters=1, device="cpu",
)
for name, idx in (("ivf.pb", grown), ("opq.pb", opq)):
    gt.save_index(idx, os.path.join(tmp, name))
    back = gt.load_index(os.path.join(tmp, name), device="cpu")
    assert back.query_arrays(3, x[:4])[1].tolist() == idx.query_arrays(3, x[:4])[1].tolist()
vecs = os.path.join(tmp, "v.bin")
gt.write_word2vec_bin(gt.WordVectors(keys, x), vecs)
assert gt.sniff_word2vec_binary(vecs)
out = io.StringIO()
with redirect_stdout(out):
    assert cli.main(["build-index", "--metric", "l2", "-k", "16", "-m", "4", "-n", "3",
                     "-o", os.path.join(tmp, "f.pb"), vecs], device="cpu") == 0
    assert cli.main(["info", "--index", os.path.join(tmp, "f.pb")], device="cpu") == 0
assert "FlatIndex" in out.getvalue()
txt = os.path.join(tmp, "v.txt")
with open(txt, "w") as f:
    gt.write_word2vec(gt.WordVectors(keys, x), f)
cfg = gt.PQConfig(num_clusters=16, num_quantizers=4, max_iters=3)
streamed = gt.build_flat_index_streaming(txt, pq_config=cfg, encode_chunk=500, device="cpu")
memory = gt.build_flat_index(keys, gt.read_word2vec_path(txt).vectors, pq_config=cfg,
                             device="cpu")
assert torch.equal(streamed.codes, memory.codes)
assert gt.build_ivf_index_streaming(txt, pq_config=cfg, num_partitions=6,
                                    coarse_max_iters=3, device="cpu").size == 1200
with gt.Word2VecStream(txt) as s:
    assert s.rows(0, 2).shape == (2, 12)
packed = gt.build_flat_index(keys, x, pq_config=gt.PQConfig(num_clusters=4, num_quantizers=4,
                                                             max_iters=3), device="cpu")
ids = packed.query_arrays(3, x[:8])[1]
packed.pack_memory()
assert torch.equal(packed.query_arrays(3, x[:8])[1], ids)
ivf.scan_strategy = "auto"
gt.save_serving(os.path.join(tmp, "i.aot"), gt.export_serving(ivf, shapes=[(1, 3), (16, 3)]))
served = gt.load_serving(os.path.join(tmp, "i.aot"), ivf)
assert isinstance(served, gt.AOTServing)
assert torch.equal(served.query_arrays(3, x[:16])[1], ivf.query_arrays(3, x[:16])[1])
from gulon_tpu_torch import parallel as tpar

mesh = tpar.make_mesh(devices=["cpu"] * 4)
exact.scan_strategy = "auto"  # 300 rows a shard: below the kernel's 256*k
for idx in (ivf, exact, opq):
    assert tpar.shard_index(idx, mesh).query_arrays(10, x[:16])[1].shape == (16, 10)
meshed = gt.build_flat_index(keys, x, pq_config=cfg, mesh=mesh, device="cpu")
assert torch.equal(meshed.codes, memory.codes)
out = io.StringIO()
with redirect_stdout(out):
    assert cli.main(["query", "--mesh", "2", "--index", os.path.join(tmp, "f.pb"), txt],
                    device="cpu") == 0
assert len(out.getvalue().splitlines()) == 1200
srv = QueryServer(back, port=0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
with socket.create_connection(srv.address, timeout=30) as sock:
    f = sock.makefile("rwb")
    f.write(json.dumps({"k": 2, "vector": x[5].tolist()}).encode() + b"\n")
    f.flush()
    assert len(json.loads(f.readline())["keys"][0]) == 2
srv.shutdown()
from gulon_tpu_torch.ops.pq import subspace_bounds
from gulon_tpu_torch.probes import adc_probes, floor_probe, k1_stages, kernel_probe

cb = rng.normal(size=(4, 16, 3)).astype(np.float32)
codes = rng.integers(0, 16, size=(1200, 4)).astype(np.int32)
norms = (cb[np.arange(4)[None], codes] ** 2).sum((1, 2)).astype(np.float32)
ran = {}
assert adc_probes.adc_scan_probe(x[:2], cb, codes, norms, bounds=subspace_bounds(12, 4), k=3,
                                 pipe=True, device="cpu", resolved=ran)[1].shape == (2, 3)
assert ran["pipe"] is True
ops = kernel_probe.probe_operands(2048, 2, 16, 4, 8, 4, 1024, device="cpu")
assert kernel_probe.kernel_probe("full", *ops, tile_rows=1024, device="cpu")[0].shape == (16, 4)
f_ops = floor_probe.floor_operands(n=4096, device="cpu")
assert floor_probe.floor_probe("q only, out v [8]", *f_ops, device="cpu")[0].shape == (8, 1024)
s_ops = adc_probes.probe_scan_operands(*(torch.from_numpy(a) for a in (x[:2], cb, codes, norms)),
                                       bounds=subspace_bounds(12, 4))
assert k1_stages.k1_stage_scan(s_ops["codes_t"], s_ops["norms_hl"], s_ops["q_op"], s_ops["cb"],
                               stage="block_min", nblk=s_ops["nblk"]).shape == (
    2, s_ops["codes_t"].shape[1] // 128)
assert not [m for m in sys.modules if m == "benchmarks" or m.startswith("benchmarks.")]
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not [m for m in sys.modules if m.startswith("google.protobuf")]
ref = sorted(m for m in sys.modules if m == "gulon_tpu" or m.startswith("gulon_tpu."))
assert ref == [], ref
print("ok")
"""


def test_port_runs_without_importing_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _sources():
    sources = list((ROOT / "gulon_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    assert {"mesh.py", "ops.py", "index.py"} <= {
        p.name for p in sources if p.parent.name == "parallel"}
    assert {"adc_probes.py", "kernel_probe.py", "floor_probe.py", "k1_stages.py"} <= {
        p.name for p in sources if p.parent.name == "probes"}
    return sources


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in _sources() if pattern.search(p.read_text())]
    assert offenders == []


def test_port_sources_import_no_protobuf():
    """A GPU host need not have protobuf: the port reads and writes index
    files with its own codec (``proto/index_wire.py``)."""
    pattern = re.compile(
        r"^\s*(import google|from google|import \S*_pb2|from \S+ import .*_pb2)", re.M
    )
    offenders = [str(p) for p in _sources() if pattern.search(p.read_text())]
    assert offenders == []


def test_port_sources_import_no_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+gulon_tpu(\.|\s|$)", re.M)
    offenders = [str(p) for p in _sources() if pattern.search(p.read_text())]
    assert offenders == []


def test_port_sources_import_no_benchmarks():
    """The probes are the port's own: nothing in the port or in
    ``chip_smoke.py`` imports the TPU harness under ``benchmarks/``."""
    pattern = re.compile(r"^\s*(from|import)\s+benchmarks(\.|\s|$)", re.M)
    offenders = [str(p) for p in _sources() if pattern.search(p.read_text())]
    assert offenders == []
