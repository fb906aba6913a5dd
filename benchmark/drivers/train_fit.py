"""Training traffic: whole `Trainer.fit(checkpoint_path=None)` calls, the
port's normal path (what `cli train` runs), on seeded Amazon-shaped data.

Set-up builds the data, the program's splits, graph, model and trainer,
and runs one fit: it warms every shape the window uses, and wrappers on the
trainer instance read its first steps (each step's loss through the first
step of epoch 2, the optimizer's first moment after one step, the weights
after three); the wrappers are removed before the window. The window
starts fits while `--seconds` have not passed and ends when the last one
ends; `train_triples_per_s` is the triples of every completed step over the
window's wall time, so every val eval, the test eval, the best-state copies
and the optimizer set-up are in it.

A traced run wraps `Trainer._epoch` and `Trainer.evaluate` on the instance
for the window's spans, and traces the device over one more fit after the
window. After the window the optimizer's state is freed and the reference
follows the same steps from its own initial weights. The same trainer
object then evaluates the weights the reference reached (its `evaluate`, as
`fit` calls it, on the test users and on the val users of that epoch); the
program is freed, and the reference evaluates those weights itself.

Cell parameters (`traffic`): `epochs`, `steps_per_epoch` (GAT)."""
from __future__ import annotations

import gc
import math
import os
import time

import torch

from benchmark import checks, data
from benchmark.core import Observation, Outcome
from benchmark.reference import sampling
from benchmark.reference import training as ref
from benchmark.tracing import Profile

BETA1 = 0.9
COUNTED = ("gat_fwd", "gat_bwd_dst", "gat_bwd_src", "spmm_csr")


def settings(config: dict, cell: dict) -> dict:
    """The flat training settings of a cell: the configuration's model and
    training keys with the cell's fit length."""
    return {**config["model"], **config["training"], **cell["traffic"]}


def triples_per_step(s: dict) -> int:
    if s["model_family"] == "gat":
        return int(s["samples_per_epoch"])
    return int(s["batch_size"] * s["neg_per_pos"])


class StepCapture:
    """Reads the first fit's first steps off the trainer instance: the
    initial weights, the loss of each of the first `steps` steps, the first
    moment after step one (the first gradient, L2 term included, is it over
    1 - beta1) and each leaf's change over the first `ref.CHANGE_STEPS`."""

    def __init__(self, trainer, steps: int):
        self.tr, self.steps = trainer, steps
        self.losses, self.grad_norms, self.change_norms = [], {}, {}
        self._n = 0
        self._p0 = None
        init, step_opt = trainer._init_params, trainer._opt_step

        def init_params():
            init()
            self._p0 = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}

        def opt_step():
            step_opt()
            self._n += 1
            named = dict(trainer.model.named_parameters())
            if self._n == 1:  # a leaf the optimizer holds no moment of reads 0
                self.grad_norms = {k: float(torch.linalg.vector_norm(
                    trainer.optimizer.state.get(p, {}).get("exp_avg", torch.zeros(1))) / (1 - BETA1))
                    for k, p in named.items()}
            if self._n == ref.CHANGE_STEPS:
                self.change_norms = {k: float(torch.linalg.vector_norm(p.detach() - self._p0[k]))
                                     for k, p in named.items()}
                self._p0 = None

        trainer._init_params, trainer._opt_step = init_params, opt_step
        if trainer._spmm_op is None:
            step = trainer._train_step

            def train_step():
                loss = step()
                if len(self.losses) < steps:
                    self.losses.append(loss)
                return loss

            trainer._train_step = train_step
            self._wrapped = ("_init_params", "_opt_step", "_train_step")
        else:
            loss_of = trainer._lightgcn_loss

            def lightgcn_loss(*args):
                loss = loss_of(*args)
                if len(self.losses) < steps:
                    self.losses.append(loss.detach())
                return loss

            trainer._lightgcn_loss = lightgcn_loss
            self._wrapped = ("_init_params", "_opt_step", "_lightgcn_loss")

    def remove(self) -> None:
        for name in self._wrapped:
            delattr(self.tr, name)
        self.losses = [float(x) for x in self.losses]


def build(ctx, s: dict, inter: dict, feats):
    """The program's trainer, built as `train_from_artifacts` builds it."""
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.pipeline import make_model
    from plotpointe_tpu_torch.train.trainer import Trainer

    known = set(TrainConfig.__dataclass_fields__)
    cfg = TrainConfig(**{k: v for k, v in s.items() if k in known},
                      seed=data.derive(ctx.seed, "train"))
    splits = build_splits(inter, *build_node_maps(inter))
    graph = build_bipartite_graph(splits.train_u, splits.train_i, splits.n_users, splits.n_items,
                                  weight=splits.train_w)
    model = make_model(cfg, splits.n_users, splits.n_items,
                       0 if feats is None else feats.shape[1], device=ctx.device)
    return Trainer(model, cfg, graph, splits, item_feats=feats, device=ctx.device), cfg


def steps_of(trainer, result: dict) -> int:
    epochs = len(result["history"])
    if trainer._spmm_op is None:
        return epochs * max(1, trainer.cfg.steps_per_epoch)
    t, bs = trainer.splits.n_train, trainer.cfg.batch_size
    return epochs * (1 if t < bs else t // bs)


def counts() -> dict:
    from plotpointe_tpu_torch.ops import cuda_build

    return {k: cuda_build.COUNTERS[k].count for k in COUNTED}


def run(ctx) -> Outcome:
    s = settings(ctx.config, ctx.cell)
    dev = ctx.device
    marks = [("start", ctx.t_start), ("torch and the harness imported", time.time())]
    inter = data.interactions_of(ctx.config, ctx.seed)
    feats = None
    if s["model_family"] == "gat":
        feats = data.unit_rows(data.derive(ctx.seed, "features"), ctx.config["dataset"]["n_items"],
                               s["feat_dim"], dev).cpu().numpy()
    marks.append(("data generated", time.time()))
    trainer, cfg = build(ctx, s, inter, feats)
    marks.append(("program imported, splits, graph, model, trainer built", time.time()))
    capture = StepCapture(trainer, ref.steps_to_check(s, trainer.splits.n_train))
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
    cpu0, gc0 = os.times(), [g["collections"] for g in gc.get_stats()]
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
            + f"; process CPU {cpu1.user - cpu0.user:.3f} s user, {cpu1.system - cpu0.system:.3f} s system"
            + f"; garbage collections by generation "
            + str([g["collections"] - b for g, b in zip(gc.get_stats(), gc0)]))
    obs = None
    if ctx.trace:
        obs = trace_fit(ctx, trainer, s)
        obs.window = (t0, t0 + wall)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e = {"train_triples_per_s": steps * triples_per_step(s) / wall}
    ctx.spans.unwrap()
    trainer.optimizer = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    prep = ref.prepare(inter, feats, s["model_family"], dev)
    n_train = len(prep.splits.train_u)
    n_steps = ref.steps_to_check(s, n_train)
    want = ref.follow(prep, s, cfg.seed, dev, steps=n_steps, rows=s["rows"])
    val_index = ref.epoch_of_step(s, n_train, n_steps)
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
    """One more fit after the window, traced on the device (its spans name
    the idle gaps; the per-layer spans are the window's); retried once if
    the profiler recorded no device operation."""
    g = trainer.graph
    shapes = {"n_users": trainer.n_users, "n_items": trainer.n_items, "n_nodes": g.n_nodes,
              "n_edges": g.n_edges, "triples_per_step": triples_per_step(s),
              "steps_per_epoch_run": steps_of(trainer, {"history": [None]}), **s}
    if s["model_family"] == "gat":
        shapes["feat_dim"] = trainer.item_feats.shape[1]
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


def program_eval(trainer, params: dict, val_index: int) -> dict:
    """The trainer's own eval of weights `params` (loaded through the hook
    `fit` loads its best weights with): its test eval and the val eval of
    epoch `val_index`, as `fit` calls them, and the node embeddings of the
    first one's forward."""
    state = trainer.model.state_dict()
    if not set(params) <= set(state):
        return {}
    trainer._load_params({**state, **{k: v.to(state[k].dtype) for k, v in params.items()}})
    forward, seen = trainer._forward_eval, []

    def eval_forward():
        u, i = forward()
        if not seen:
            seen.append(torch.cat([u, i]).float())
        return u, i

    trainer._forward_eval = eval_forward
    try:
        sp = trainer.splits
        test = trainer.evaluate(sp.test_u, sp.test_i, sampling.TEST_EVAL_INDEX)
        val = trainer.evaluate(sp.val_u, sp.val_i, val_index)
    finally:
        del trainer._forward_eval
    return {"z": seen[0], "metrics": {"test": test, "val": val}}


def reference_metrics(z, prep, s: dict, seed: int, val_index: int, dev, tf32: bool = False) -> dict:
    return {"test": ref.evaluate_embeddings(z, prep, s, seed, "test", sampling.TEST_EVAL_INDEX, dev, tf32),
            "val": ref.evaluate_embeddings(z, prep, s, seed, "val", val_index, dev, tf32)}


def compare(ctx, s: dict, prep, want, prog: dict, got: dict, seed: int, val_index: int) -> dict:
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
        z = ref.embed(want.params, prep, s, ref.ROW_TYPES[s["rows"]])
    zp = got["z"].to(dev)
    numbers["embed_gap"] = checks.embed_gap(zp, z)
    mine = reference_metrics(z, prep, s, seed, val_index, dev)
    del z
    numbers["eval_gap"] = checks.eval_gap(got["metrics"], mine)
    for split in mine:
        ctx.log(f"{split} metrics program {got['metrics'][split]}; reference {mine[split]}")
    return numbers
