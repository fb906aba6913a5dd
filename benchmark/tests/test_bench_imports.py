"""No module the harness or the reference loads is JAX, jaxlib, flax or the
JAX package (top-level names compared whole: `plotpointe_tpu_torch` is not
`plotpointe_tpu`), and the reference loads nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import core

FORBIDDEN = ("jax", "jaxlib", "flax", "plotpointe_tpu")
TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def loaded_by(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"import sys\nsys.path.insert(0, {str(core.REPO)!r})\n"
                          f"{code}\nprint({TOP})"], capture_output=True, text=True, check=True,
                         cwd=core.REPO, timeout=600)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax():
    code = ("import time\nfrom benchmark import core\nfrom benchmark.tests.conftest import CELLS\n"
            "b = core.load_benchmark()\n"
            "b['end_to_end'][1]['workloads'].append('tiny.gat.train')\n"
            "for m in b['per_layer']: m['workloads'].append('tiny.gat.train')\n"
            "core.run_cell('tiny.gat.train', 3, 0.5, True, time.time(), bench=b, root=CELLS, device='cpu')\n"
            "for m in b['per_layer']: core.load_reader(m['name'])\n"
            "import benchmark.tools.control, benchmark.tools.sweep, benchmark.drivers.serve_open_loop")
    top = loaded_by(code)
    assert "plotpointe_tpu_torch" in top
    assert not set(FORBIDDEN) & top


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_by("import benchmark.reference.data, benchmark.reference.sampling, "
                    "benchmark.reference.models, benchmark.reference.evaluate, "
                    "benchmark.reference.training, benchmark.reference.topk")
    assert not ({"plotpointe_tpu_torch"} | set(FORBIDDEN)) & top


@pytest.mark.parametrize("path", sorted((core.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_numpy_and_the_reference(path: Path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    for name in names:
        top = name.split(".")[0]
        assert top not in FORBIDDEN and top != "plotpointe_tpu_torch", name
        assert top in ("__future__", "contextlib", "dataclasses", "math", "typing", "numpy", "torch") \
            or name.startswith("benchmark.reference"), name
