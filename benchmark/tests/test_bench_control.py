"""The control at a size a test holds: the reference one step lower in
precision, put in the program's place, fails one of the cell's numbers;
so do the planted faults the cells' limits are set against."""
import pytest
import torch

from benchmark import checks, core
from benchmark.tests.conftest import CELLS
from benchmark.tools import control


@pytest.mark.parametrize("cell", ["tiny.gat.train", "tiny.lightgcn.train", "tiny.gat.train.ref",
                                  "tiny.gat.train.mesh4"])
def test_training_control_and_half_batch_fail(cell):
    spec = core.load_cell(cell, CELLS)
    r = control.train_readings(spec, core.load_config(spec["config"], CELLS), 11, torch.device("cpu"))
    limits = spec["limits"]
    for reading in ("control", "half_batch"):
        assert not checks.verdict(r[reading], {k: v for k, v in limits.items() if k in r[reading]})
    assert r["control"]["embed_gap"] > limits["embed_gap"]


def test_serving_control_runs():
    """TF32 exists only on the card: on the CPU the control's products are
    f32, so its reading is only shown to come out of the same comparison."""
    spec = core.load_cell("tiny.gat.serve", CELLS)
    r = control.serve_readings(spec, core.load_config(spec["config"], CELLS), 11, torch.device("cpu"))
    assert r["replies"] > 0 and r["control"]["score_gap"] <= spec["limits"]["score_gap"]


def test_mesh_faults_fail_and_the_sound_program_passes():
    """The tool's readings of the mesh cell on 4 gloo ranks: the sound
    program within every limit, each fault over one."""
    spec = core.load_cell("tiny.gat.train.mesh4", CELLS)
    rows = control.mesh_readings(spec, core.load_config(spec["config"], CELLS), [3],
                                 ["grad_exchange_left_out", "overlay_stale"], torch.device("cpu"))
    verdicts = {r["fault"]: checks.verdict(r["numbers"], spec["limits"]) for r in rows}
    assert verdicts == {"none": True, "grad_exchange_left_out": False, "overlay_stale": False}
