"""hgt_dense_ms: the device intervals of the program's `hgt.project` (the
typed K/Q/V products and the relation transforms) and `hgt.update` (GELU,
the typed output products and the gated skip) spans (`models/hgt.py`, every
layer, in the forward and in the backward) that start inside a `train.step`
span of the traced fit, summed and divided by the steps, in ms. None
without such spans (a program without them)."""
from benchmark.program_spans import records


def read(obs):
    recs = records(obs, "hgt.project", "hgt.update", "train.step")
    steps = [(r.t0, r.t1) for r in recs if r.name == "train.step"]
    parts = [r.d1 - r.d0 for r in recs if r.name != "train.step" and r.d0 is not None
             and any(a <= r.t0 <= b for a, b in steps)]
    return sum(parts) / len(steps) * 1e3 if steps and parts else None
