"""On a card: one short run of each cell through `benchmark/run.py`, with
a correct result line (a cell that asks for more GPUs than the machine has
skips)."""
import json
import subprocess
import sys

import pytest

from benchmark import core


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in core.load_benchmark()["workloads"]])
def test_cell_on_the_card(cell):
    import torch

    chips = core.chips_of(core.load_benchmark(), cell)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} GPUs")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "12345",
                          "--seconds", "3", "--trace", "0"], cwd=core.REPO, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
