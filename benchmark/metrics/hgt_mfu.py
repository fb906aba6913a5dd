"""hgt_mfu: the model FLOPs of an HGT training step (`counts/hgt.py`, from
the shapes) over step_ms (the window's `Trainer._epoch` spans over their
steps) times the published peak of the type the configuration names, in %.
None for another model."""
from benchmark.counts import hgt, peaks


def read(obs):
    sh = obs.shapes
    if obs.kind not in peaks.GPU_SPECS or sh.get("model_family") != "hgt":
        return None
    spans = obs.spans.named("epoch", *obs.window)
    steps = len(spans) * sh["steps_per_epoch_run"]
    if not steps:
        return None
    step_s = sum(s.t1 - s.t0 for s in spans) / steps
    flops = hgt.step_flops(sh["n_users"], sh["n_items"], sh["n_edges"], sh["feat_dim"], sh["hidden_dim"],
                           sh["layers"], sh["heads"], sh["samples_per_epoch"])
    return 100.0 * flops / (step_s * peaks.peak_flops(obs.config["peak"]["dtype"], obs.kind))
