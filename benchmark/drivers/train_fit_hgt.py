"""HGT training traffic: `train_fit`'s whole `Trainer.fit(checkpoint_path=None)`
calls on the same seeded data plus the item kNN graph of the seeded item
features, the configuration's `"model_family": "hgt"`, held to the HGT
reference (`reference/hgt.py`).

Set-up builds the data, the kNN relation (`hgt.knn_edges`, the configuration's
`knn`: k and min_similarity; its (row, col) arrays go to both sides, as the
interactions do), the program's typed graph (`graphs/hetero.py`), model and
trainer, and runs one fit. Window, traced fit and check are `train_fit`'s
(its `settings`, `StepCapture`, `steps_of`, `program_eval` and
`reference_metrics`), with this model's reference steps (`hgt.follow`),
forward (`hgt.embed`), launch counters (the three HGT kernels) and shapes.
The step protocol is the GAT's (`hgt.protocol`). A program without the HGT
cannot build the model: the run raises before it builds anything.

Cell parameters (`traffic`): `epochs`, `steps_per_epoch`."""
from __future__ import annotations

import gc
import importlib
import math
import os
import time

import torch

from benchmark import checks, data
from benchmark.core import Observation, Outcome
from benchmark.drivers.train_fit import (
    StepCapture, program_eval, reference_metrics, settings, steps_of, triples_per_step)
from benchmark.reference import hgt as ref_hgt
from benchmark.reference import training as ref
from benchmark.tracing import Profile

COUNTED = ("hgt_fwd", "hgt_bwd_dst", "hgt_bwd_src")


def require_hgt() -> None:
    try:
        for name in ("plotpointe_tpu_torch.graphs.hetero", "plotpointe_tpu_torch.models.hgt"):
            importlib.import_module(name)
    except ImportError as e:
        raise RuntimeError(f"this program has no HGT ({e}): it cannot train hgt-amazon") from e


def counts() -> dict:
    from plotpointe_tpu_torch.ops import cuda_build

    return {k: cuda_build.COUNTERS[k].count for k in COUNTED}


def inputs(ctx, s: dict):
    """The interactions, the item features and the kNN (rows, cols)."""
    inter = data.interactions_of(ctx.config, ctx.seed)
    feats = data.unit_rows(data.derive(ctx.seed, "features"), ctx.config["dataset"]["n_items"],
                           s["feat_dim"], ctx.device)
    knn = ref_hgt.knn_edges(feats, ctx.config["knn"]["k"], ctx.config["knn"]["min_similarity"])
    return inter, feats.cpu().numpy(), knn


def build(ctx, s: dict, inter: dict, feats, knn):
    """The program's trainer, built as `train_from_artifacts` builds an HGT's."""
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.hetero import build_hetero_graph
    from plotpointe_tpu_torch.pipeline import make_model
    from plotpointe_tpu_torch.train.trainer import Trainer

    known = set(TrainConfig.__dataclass_fields__)
    cfg = TrainConfig(**{k: v for k, v in s.items() if k in known}, seed=data.derive(ctx.seed, "train"))
    splits = build_splits(inter, *build_node_maps(inter))
    graph = build_hetero_graph(splits.train_u, splits.train_i, splits.n_users, splits.n_items, *knn)
    model = make_model(cfg, splits.n_users, splits.n_items, feats.shape[1], device=ctx.device)
    if model.config_dict().get("model_family") != "hgt":
        raise RuntimeError("the program built another model than the HGT")
    return Trainer(model, cfg, graph, splits, item_feats=feats, device=ctx.device), cfg


def run(ctx) -> Outcome:
    require_hgt()
    s = settings(ctx.config, ctx.cell)
    proto = ref_hgt.protocol(s)
    dev = ctx.device
    marks = [("start", ctx.t_start), ("torch and the harness imported", time.time())]
    inter, feats, knn = inputs(ctx, s)
    marks.append((f"data and the kNN relation generated ({len(knn[0])} edges)", time.time()))
    trainer, cfg = build(ctx, s, inter, feats, knn)
    marks.append(("program imported, splits, typed graph, model, trainer built", time.time()))
    capture = StepCapture(trainer, ref.steps_to_check(proto, trainer.splits.n_train))
    first = trainer.fit(checkpoint_path=None)
    capture.remove()
    marks.append(("first fit (builds and warms every kernel)", time.time()))
    ctx.log("setup pieces " + "; ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])))
    prog = {"losses": capture.losses, "grads": capture.grad_norms, "changes": capture.change_norms}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - ctx.t_start
    ctx.log(f"setup {setup_s:.3f} s; first fit {first['wall_time_s']:.3f} s")

    if ctx.trace:
        ctx.spans.wrap(trainer, "_epoch", "epoch")
        ctx.spans.wrap(trainer, "evaluate", "evaluate")
    fits = steps = failed = 0
    walls = []
    cpu0 = os.times()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while fits == 0 or time.perf_counter() < deadline:
        res = trainer.fit(checkpoint_path=None)
        walls.append(res["wall_time_s"])
        fits += 1
        n = steps_of(trainer, res)
        if all(math.isfinite(h["loss"]) for h in res["history"]):
            steps += n
        else:
            failed += n
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    cpu1 = os.times()
    ctx.log(f"window {wall:.3f} s: {fits} fits, {steps} steps; fit walls (s) "
            + " ".join(f"{w:.3f}" for w in walls)
            + f"; process CPU {cpu1.user - cpu0.user:.3f} s user, {cpu1.system - cpu0.system:.3f} s system")
    obs = None
    if ctx.trace:
        obs = trace_fit(ctx, trainer, s)
        obs.window = (t0, t0 + wall)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e = {"train_triples_per_s": steps * triples_per_step(proto) / wall}
    ctx.spans.unwrap()
    trainer.optimizer = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    prep = ref_hgt.prepare(inter, feats, *knn, dev)
    n_train = len(prep.splits.train_u)
    n_steps = ref.steps_to_check(proto, n_train)
    want = ref_hgt.follow(prep, s, cfg.seed, dev, steps=n_steps, rows=s["rows"])
    val_index = ref.epoch_of_step(proto, n_train, n_steps)
    got = program_eval(trainer, want.params, val_index)
    del trainer, capture
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(ctx, s, prep, want, prog, got, cfg.seed, val_index)
    ctx.log(f"reference check {time.perf_counter() - t_check:.3f} s ({n_steps} steps followed); "
            f"numbers {numbers}")
    return Outcome(setup_s, e2e, steps + failed, failed, numbers, peak, obs)


def trace_fit(ctx, trainer, s: dict) -> Observation:
    """`train_fit.trace_fit` with the HGT kernels' counters and the typed
    graph's shapes (its stacked rows and each relation's edges)."""
    g = trainer.graph
    shapes = {"n_users": trainer.n_users, "n_items": trainer.n_items, "n_nodes": g.n_nodes,
              "n_edges": g.n_edges, "n_rows": g.n_rows, "rel_edges": list(g.rel_edges),
              "triples_per_step": triples_per_step(ref_hgt.protocol(s)),
              "steps_per_epoch_run": steps_of(trainer, {"history": [None]}),
              "feat_dim": trainer.item_feats.shape[1], **s}
    obs = Observation(ctx.config, shapes, ctx.spans)
    for _ in range(2):
        before = counts()
        with Profile(ctx.device) as prof:
            res = trainer.fit(checkpoint_path=None)
        after = counts()
        if prof.trace is not None:
            obs.trace = prof.trace
            obs.counters = {k: after[k] - before[k] for k in COUNTED}
            obs.counters["steps"] = steps_of(trainer, res)
            obs.counters["evals"] = len(res["history"]) + 1
            break
    return obs


def compare(ctx, s: dict, prep, want, prog: dict, got: dict, seed: int, val_index: int) -> dict:
    """`train_fit.compare` on the HGT reference's forward."""
    dev = ctx.device
    numbers = {"loss_gap": checks.loss_gap(prog["losses"], want.losses),
               "grad_gap": checks.grad_gap(prog["grads"], want.grad_norms),
               "change_gap": checks.change_gap(prog["changes"], want.change_norms, want.grad_norms)}
    ctx.log(f"losses program {prog['losses'][:3]} ... {prog['losses'][-1:]}; "
            f"reference {want.losses[:3]} ... {want.losses[-1:]} ({len(want.losses)} steps)")
    ctx.log("leaf norms (first gradient, change) program / reference: " + "; ".join(
        f"{k} {prog['grads'].get(k, math.nan):.6g} / {want.grad_norms[k]:.6g}, "
        f"{prog['changes'].get(k, math.nan):.6g} / {want.change_norms[k]:.6g}" for k in want.grad_norms))
    if not got:
        return {**numbers, "embed_gap": math.inf, "eval_gap": math.inf}
    with torch.no_grad():
        z = ref_hgt.embed(want.params, prep, s, ref.ROW_TYPES[s["rows"]])
    numbers["embed_gap"] = checks.embed_gap(got["z"].to(dev), z)
    mine = reference_metrics(z, prep, s, seed, val_index, dev)
    del z
    numbers["eval_gap"] = checks.eval_gap(got["metrics"], mine)
    for split in mine:
        ctx.log(f"{split} metrics program {got['metrics'][split]}; reference {mine[split]}")
    return numbers
