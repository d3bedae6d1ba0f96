"""What the benchmark's files import: never JAX or the JAX package, and
the reference nothing of the program. Top-level module names are
compared whole (``gulon_tpu_torch`` is the code under test, not
``gulon_tpu``)."""

import ast
import subprocess
import sys
from pathlib import Path

import h100bench_tiny as tiny

HARNESS = tiny.REPO / "h100bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "gulon_tpu", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    return [p for p in (HARNESS / sub).rglob("*.py") if "tests" not in p.parts]


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not top_level_imports(path) & (FORBIDDEN | {"gulon_tpu_torch"}), path
    code = ("import sys; sys.path.insert(0, %r); import h100bench.reference.control, "
            "h100bench.reference.exact, h100bench.reference.recall, h100bench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(tiny.REPO), FORBIDDEN | {"gulon_tpu_torch"}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_a_whole_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import h100bench_tiny as tiny\nfrom pathlib import Path\n"
        "from h100bench.harness import forbidden_modules\n"
        "root = tiny.make_root(Path(%r))\n"
        "res, _, _ = tiny.run(root, 'sift128.ivf.batch1024')\n"
        "print(res['correct'], forbidden_modules(), 'gulon_tpu_torch' in sys.modules)\n"
    ) % (str(tiny.REPO), str(Path(__file__).parent), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "True [] True", out.stderr[-2000:]
