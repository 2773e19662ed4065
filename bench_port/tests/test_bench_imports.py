"""What the benchmark loads: nothing of JAX or of the JAX package, and the
reference nothing of the program either."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "occuseg_tpu"}


def _loaded(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


PRELUDE = f"import sys\nsys.path.insert(0, {ROOT!r})\n"
REPORT = "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"


def test_the_runs_import_graph_has_no_jax():
    metrics = os.path.join(ROOT, "bench_port", "metrics", "*.py")
    code = PRELUDE + (
        "import glob, importlib.util\n"
        "import bench_port.run, bench_port.traffic.train\n"
        "import bench_port.lib.faults\n"
        "import occuseg_tpu_torch.native.pool, occuseg_tpu_torch.train.loop\n"
        "import occuseg_tpu_torch.train.config\n"
        f"for f in glob.glob({metrics!r}):\n"
        "    s = importlib.util.spec_from_file_location('m', f)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
    ) + REPORT
    loaded = _loaded(code)
    assert "occuseg_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    code = PRELUDE + (
        "import bench_port.reference.train, bench_port.reference.model\n"
        "import bench_port.reference.loss, bench_port.reference.sparse\n"
    ) + REPORT
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"occuseg_tpu_torch"})


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    ROOT, "bench_port", "reference", "*.py"))))
def test_no_reference_file_names_the_program(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN | {"occuseg_tpu_torch"}
