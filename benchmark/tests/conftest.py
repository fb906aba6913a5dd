"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the repository root (CPU; the tests marked `cuda` skip without a card)."""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = Path(__file__).resolve().parent / "cells"


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def tiny_bench():
    """BENCHMARK.json with each metric's cell list widened to the test-only
    tiny cells under `cells/` (tiny.<cell>)."""
    from benchmark import core

    bench = core.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + ["tiny." + w for w in m["workloads"]]
    bench["workloads"] = bench["workloads"] + [dict(w, name="tiny." + w["name"]) for w in bench["workloads"]]
    return bench


def run_tiny(bench, cell: str, trace: bool = False, seed: int = 2 ** 31 + 7) -> dict:
    import time

    from benchmark import core

    return core.run_cell(cell, seed, 1.0, trace, time.time(), bench=bench, root=CELLS, device="cpu")
