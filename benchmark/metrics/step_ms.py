"""step_ms: the training part of the measured window's epochs (`Trainer._epoch`
spans, synchronised at each end) over the optimizer steps they ran, in ms."""


def read(obs):
    spans = obs.spans.named("epoch", *obs.window)
    steps = len(spans) * obs.shapes["steps_per_epoch_run"]
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in spans) / steps * 1e3
