"""train_mfu: the model FLOPs a training step needs (`counts/flops.py`, from
the shapes) over step_ms times the published peak of the type the
configuration names, in %."""
from benchmark.counts import flops, peaks


def step_flops(sh):
    if sh["model_family"] == "gat":
        return flops.gat_step_flops(sh["n_users"], sh["n_items"], sh["n_edges"], sh["feat_dim"],
                                    sh["hidden_dim"], sh["layers"], sh["samples_per_epoch"])
    return flops.lightgcn_step_flops(sh["n_users"], sh["n_items"], sh["n_edges"], sh["embed_dim"],
                                     sh["n_prop_layers"], sh["batch_size"], sh["neg_per_pos"])


def read(obs):
    if obs.kind not in peaks.GPU_SPECS:
        return None
    spans = obs.spans.named("epoch", *obs.window)
    steps = len(spans) * obs.shapes["steps_per_epoch_run"]
    if not steps:
        return None
    step_s = sum(s.t1 - s.t0 for s in spans) / steps
    return 100.0 * step_flops(obs.shapes) / (step_s * peaks.peak_flops(obs.config["peak"]["dtype"], obs.kind))
