"""mesh_mfu: the model FLOPs of one global training step (`counts/flops.py`,
from the whole graph's shapes and the global batch) over the traced rank's
step time (its `Trainer._epoch` spans over their steps) times the chips of
the mesh times the published peak of the configuration's type, in %."""
from benchmark.counts import flops, peaks


def read(obs):
    if obs.kind not in peaks.GPU_SPECS:
        return None
    sh = obs.shapes
    spans = obs.spans.named("epoch", *obs.window)
    steps = len(spans) * sh["steps_per_epoch_run"]
    if not steps:
        return None
    step_s = sum(s.t1 - s.t0 for s in spans) / steps
    work = flops.gat_step_flops(sh["n_users"], sh["n_items"], sh["n_edges_global"], sh["feat_dim"],
                                sh["hidden_dim"], sh["layers"], sh["triples_per_step"])
    peak = peaks.peak_flops(obs.config["peak"]["dtype"], obs.kind) * sh["n_shards"]
    return 100.0 * work / (step_s * peak)
