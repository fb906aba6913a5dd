"""step_idle_ms: the time inside the host intervals of the program's
`train.step` spans in which the device trace shows no operation running,
per step, in ms: the trainer's host path holding the device back."""
from benchmark.program_spans import covered, records
from benchmark.tracing import merged


def read(obs):
    steps = records(obs, "train.step")
    if obs.trace is None or not steps:
        return None
    busy = merged(obs.trace.ops)
    idle = sum((s.t1 - s.t0) - covered(busy, s.t0, s.t1) for s in steps)
    return idle / len(steps) * 1e3
