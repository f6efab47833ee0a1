"""Nothing the benchmark loads may be JAX or the JAX package, compared by
whole top-level module names (the port's ``mpi4torch_tpu_torch`` begins
with the JAX package's name and is not it); the references import nothing
of the port."""

import ast
import os
import pathlib
import subprocess
import sys

from benchmark import harness, spec

BENCH = pathlib.Path(spec.BENCH)
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_top_level_names_compare_whole():
    assert "mpi4torch_tpu" in harness.FORBIDDEN
    before = dict(sys.modules)
    try:
        sys.modules["mpi4torch_tpu_torch_probe"] = sys
        assert "mpi4torch_tpu" not in harness.forbidden_modules()
        sys.modules["jaxlib.xla_client"] = sys
        assert "jaxlib" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    bad = [(p.name, m) for p in FILES for m in _imports(p)
           if m.split(".")[0] in harness.FORBIDDEN]
    assert bad == []


def test_references_import_nothing_of_the_port():
    for p in sorted((BENCH / "reference").glob("*.py")):
        mods = list(_imports(p))
        assert not [m for m in mods
                    if m.split(".")[0] in harness.FORBIDDEN
                    or m.startswith("mpi4torch_tpu_torch")
                    or m.startswith("benchmark.") and
                    not m.startswith("benchmark.reference")], (p, mods)


def test_a_run_loads_no_forbidden_module():
    """A whole tiny run on the CPU, in a fresh interpreter, then the
    harness's own look at ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "from benchmark.conftest import tiny_cell\n"
        "cell = tiny_cell('mistral7b-l4-dp2-s4096')\n"
        "res, rows, _ = harness.run_cell(cell['workload']['name'], 5, 0.2,"
        " False, device='cpu', cell=cell)\n"
        "assert res['correct'], rows\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n" % spec.ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
