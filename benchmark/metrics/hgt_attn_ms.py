"""hgt_attn_ms: the device intervals of the program's `attn.forward` and
`attn.backward` spans of kind "hgt" (`ops/hgt.py`: the HGT edge attention's
forward and backward, every layer) that start inside a `train.step` span of
the traced fit, summed and divided by the steps, in ms. The evals' forwards
lie outside every step and are left out. None without such spans (a
program without them)."""
from benchmark.program_spans import records


def read(obs):
    recs = records(obs, "attn.forward", "attn.backward", "train.step")
    steps = [(r.t0, r.t1) for r in recs if r.name == "train.step"]
    parts = [r.d1 - r.d0 for r in recs if r.name != "train.step" and r.meta.get("kind") == "hgt"
             and r.d0 is not None and any(a <= r.t0 <= b for a, b in steps)]
    return sum(parts) / len(steps) * 1e3 if steps and parts else None
