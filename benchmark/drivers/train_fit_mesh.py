"""Training traffic over a mesh of ranks: whole
`ShardedTrainer.fit(checkpoint_path=None)` calls, one process a rank and one
GPU each over NCCL, started by `parallel/multihost.spawn`, the launcher
`cli train --mesh data:N` uses.

Every rank builds the same data, splits, graph, item features and config
from the seed, and its `ShardedTrainer` (its block of the user table, its
local graph). Set-up runs one whole fit on every rank: it warms every shape
and the NCCL communicators, and rank 0 reads its first steps as `train_fit`
does, with the sharded table's first moment and change gathered whole.
`setup_s` runs from the run's start to rank 0's first timed unit.

The window: rank 0 decides, while `--seconds` have not passed, to start
another fit and broadcasts the decision; every rank starts each fit after
that broadcast, and rank 0 times the fits. `train_triples_per_s` is the
completed steps times the global batch (`samples_per_epoch` rounded up to
a multiple of the mesh) over the window's wall time, counted once.

A traced run wraps rank 0's `Trainer._epoch` and `Trainer.evaluate` for the
window's spans, then every rank runs one more fit under the harness's
`Profile` (which turns the program's spans on), rank 0 recording the
collectives of each of its steps (`parallel/collectives.record_collectives`).
The per-layer readers read rank 0's observation, shipped back with its
span records; the busy time is averaged over the ranks' traces.

The check: rank 0 frees its optimizer state (every rank does) and follows
the single-device reference (`benchmark/reference/training`: the sharded
fit is the single-device computation by design, `train/sharded.py`) through
the same steps, then broadcasts the weights it reached; every rank's trainer
evaluates them (its `evaluate`, as `fit` calls it), and rank 0 compares as
`train_fit` does.

The GAT's cells; parameters (`traffic`): `epochs`, `steps_per_epoch`,
`mesh` ("data:4", as many ranks as the cell's chips).
`run(ctx, plant)` plants a fault (`tools/faults.py`) on every rank before
the first fit: the harness's tests and `tools/control.py` use it."""
from __future__ import annotations

import gc
import math
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from benchmark import data
from benchmark.core import Observation, Outcome, forbidden_modules
from benchmark.drivers.train_fit import BETA1, StepCapture, compare, program_eval, settings, steps_of
from benchmark.reference import training as ref
from benchmark.tracing import Profile, Spans

SPAWN_TIMEOUT_S = 1100.0  # a first run compiles every kernel on every rank


class MeshStepCapture(StepCapture):
    """`StepCapture` on a sharded trainer: the replicated leaves as it reads
    them, and each row-sharded table's first moment and change gathered
    whole (a collective: every rank runs the capture)."""

    def __init__(self, trainer, steps: int):
        super().__init__(trainer, steps)
        init, step_opt = trainer._init_params, trainer._opt_step
        self._t0 = None

        def init_params():
            init()
            self._t0 = {k: getattr(trainer.model, k).detach().clone() for k in trainer.tables}

        def opt_step():
            step_opt()
            if self._n == 1:
                for k, rows in trainer.tables.items():  # a table the optimizer holds no moment of reads 0
                    m = trainer.optimizer.state.get(trainer.shards[k], {}).get("exp_avg")
                    m = torch.zeros_like(trainer.shards[k]) if m is None else m
                    whole = trainer._gather(m, rows)
                    self.grad_norms[k] = float(torch.linalg.vector_norm(whole)) / (1 - BETA1)
            if self._n == ref.CHANGE_STEPS:
                for k, rows in trainer.tables.items():
                    now = trainer._gather(trainer.shards[k], rows)
                    self.change_norms[k] = float(torch.linalg.vector_norm(now - self._t0[k]))
                self._t0 = None

        trainer._init_params, trainer._opt_step = init_params, opt_step


def build(s: dict, seed: int, inter: dict, feats, mesh):
    """The program's sharded trainer, built as `train_from_artifacts` builds
    it under a mesh."""
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.pipeline import make_model
    from plotpointe_tpu_torch.train.sharded import ShardedTrainer

    known = set(TrainConfig.__dataclass_fields__)
    cfg = TrainConfig(**{k: v for k, v in s.items() if k in known}, seed=data.derive(seed, "train"),
                      mesh_shape=s["mesh"])
    splits = build_splits(inter, *build_node_maps(inter))
    graph = build_bipartite_graph(splits.train_u, splits.train_i, splits.n_users, splits.n_items,
                                  weight=splits.train_w)
    model = make_model(cfg, splits.n_users, splits.n_items,
                       0 if feats is None else feats.shape[1], device=mesh.device)
    return ShardedTrainer(model, cfg, graph, splits, item_feats=feats, mesh=mesh), cfg


def _decide(flag: torch.Tensor, go: Optional[bool]) -> bool:
    """Rank 0's decision `go`, on every rank (a broadcast: each rank waits
    for it, so it is also a barrier)."""
    import torch.distributed as dist

    if go is not None:
        flag.fill_(int(go))
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _plain(r) -> SimpleNamespace:
    return SimpleNamespace(name=r.name, t0=r.t0, t1=r.t1, d0=r.d0, d1=r.d1, id=r.id, parent=r.parent,
                           rid=r.rid, thread=r.thread, meta=dict(r.meta))


def _traced_fit(trainer, s: dict, dev, lead: bool, log) -> dict:
    """One more fit on every rank under the harness's Profile (retried once,
    all ranks together, if rank 0's recorded no device operation); rank 0
    records each step's collectives. Returns this rank's readings."""
    from plotpointe_tpu_torch.parallel import collectives
    from plotpointe_tpu_torch.utils import tracing

    calls, step = [], trainer._train_step

    def recorded_step():
        with collectives.record_collectives() as mine:
            loss = step()
        calls.append(mine)
        return loss

    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {}
    for _ in range(2):
        calls.clear()
        if lead:
            trainer._train_step = recorded_step
        with Profile(dev) as prof:
            res = trainer.fit(checkpoint_path=None)
        if lead:
            del trainer._train_step
        trace = prof.trace
        out = {"busy": None if trace is None else (trace.busy_s(), trace.window_s)}
        if lead:
            g, local = trainer.graph, trainer.step.local
            out["shapes"] = {"n_users": trainer.n_users, "n_items": trainer.n_items, "n_nodes": g.n_nodes,
                             "n_edges": local.graph.n_edges, "n_edges_global": g.n_edges,
                             "n_shards": trainer.mesh.n_shards, "owned_rows": local.hi - local.lo,
                             "triples_per_step": int(trainer.n_samples),
                             "steps_per_epoch_run": steps_of(trainer, {"history": [None]}),
                             "feat_dim": trainer.item_feats.shape[1], **s}
            counters = {f"{op}_bytes": 0.0 for op in ("all_reduce", "all_gather", "reduce_scatter")}
            for c in (c for mine in calls for c in mine):
                counters[f"{c['op']}_bytes"] = counters.get(f"{c['op']}_bytes", 0.0) + c["bytes"]
            counters.update(recorded_steps=len(calls), collectives=sum(map(len, calls)),
                            steps=steps_of(trainer, res), evals=len(res["history"]) + 1)
            out["counters"], out["trace"] = counters, trace
            window = (trace.t0, trace.t1) if trace is not None else (float("-inf"), float("inf"))
            out["records"] = [_plain(r) for r in tracing.records(*window)]
            payload = {k: v for k, v in counters.items() if k.endswith("_bytes")}
            log(f"traced fit: {len(calls)} steps recorded, {counters['collectives']} collectives, "
                f"payload bytes by kind {payload}")
        if not _decide(flag, trace is None if lead else None):
            break
    return out


def _reference_eval(trainer, s: dict, inter: dict, feats, cfg, dev, lead: bool, cache: dict):
    """Rank 0 follows the reference (kept in `cache` for the next job of the
    same seed) and broadcasts the weights it reached; every rank's trainer
    evaluates them. Returns (what the trainer's eval gave, the val epoch)."""
    import torch.distributed as dist

    trainer.optimizer = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    n_train = trainer.splits.n_train
    n_steps = ref.steps_to_check(s, n_train)
    val_index = ref.epoch_of_step(s, n_train, n_steps)
    box = [None]
    if lead:
        if cache.get("seed") != cfg.seed:
            cache.clear()
            prep = ref.prepare(inter, feats, s["model_family"], dev)
            cache.update(seed=cfg.seed, prep=prep,
                         want=ref.follow(prep, s, cfg.seed, dev, steps=n_steps, rows=s["rows"]))
        box = [[(k, tuple(v.shape)) for k, v in sorted(cache["want"].params.items())]]
    dist.broadcast_object_list(box, src=0)
    params = {}
    for k, shape in box[0]:
        t = (cache["want"].params[k].float().contiguous() if lead
             else torch.empty(shape, dtype=torch.float32, device=dev))
        dist.broadcast(t, 0)
        params[k] = t
    return program_eval(trainer, params, val_index), val_index


def rank_main(cell: dict, config: dict, jobs: list, seconds: Optional[float], trace: bool,
              t_start: float, device) -> list:
    """One rank: for each (seed, plant) of `jobs`, the data, the sharded
    trainer, the set-up fit, the window (`seconds` None: none) and the
    check. Rank 0 returns each job's readings; the others their peaks."""
    from plotpointe_tpu_torch.parallel.mesh import make_mesh

    s = settings(config, cell)
    mesh = make_mesh(s["mesh"], device=device)
    dev, lead = mesh.device, mesh.rank == 0

    def log(msg: str) -> None:
        if lead:
            print(msg, file=sys.stderr, flush=True)

    cache, inputs, out = {}, {}, []
    for seed, plant in jobs:
        marks = [("start", t_start), ("rank's imports and group", time.time())]
        if inputs.get("seed") != seed:  # the next job of the same seed reuses them
            inputs = {"seed": seed, "inter": data.interactions_of(config, seed), "feats": None}
            if s["model_family"] == "gat":
                inputs["feats"] = data.unit_rows(data.derive(seed, "features"), config["dataset"]["n_items"],
                                                 s["feat_dim"], dev).cpu().numpy()
        inter, feats = inputs["inter"], inputs["feats"]
        marks.append(("data generated", time.time()))
        trainer, cfg = build(s, seed, inter, feats, mesh)
        marks.append(("splits, graph, model, sharded trainer built", time.time()))
        undo = plant(trainer) if plant is not None else None
        capture = MeshStepCapture(trainer, ref.steps_to_check(s, trainer.splits.n_train))
        first = trainer.fit(checkpoint_path=None)
        capture.remove()
        prog = {"losses": capture.losses, "grads": capture.grad_norms, "changes": capture.change_norms}
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        _decide(flag, True if lead else None)  # every rank set up
        marks.append(("first fit (builds and warms every kernel)", time.time()))
        log("setup pieces " + "; ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])))
        setup_s = time.time() - t_start
        log(f"setup {setup_s:.3f} s; first fit {first['wall_time_s']:.3f} s")
        row = {"seed": seed, "setup_s": setup_s, "steps": 0, "failed": 0, "wall": math.nan}
        spans = Spans(dev)
        if seconds is not None:
            if trace and lead:
                spans.wrap(trainer, "_epoch", "epoch")
                spans.wrap(trainer, "evaluate", "evaluate")
            fits, walls = 0, []
            cpu0 = os.times()
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while _decide(flag, (fits == 0 or time.perf_counter() < deadline) if lead else None):
                res = trainer.fit(checkpoint_path=None)
                h = res["history"]
                walls.append((res["wall_time_s"], sum(e["step_time_s"] for e in h),
                              sum(e["eval_time_s"] for e in h)))
                fits += 1
                n = steps_of(trainer, res)
                row["steps" if all(math.isfinite(e["loss"]) for e in h) else "failed"] += n
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            row["wall"] = time.perf_counter() - t0
            cpu1 = os.times()
            row["cpu"] = (cpu1.user - cpu0.user) + (cpu1.system - cpu0.system)
            row["window"] = (t0, t0 + row["wall"])
            log(f"window {row['wall']:.3f} s: {fits} fits, {row['steps']} steps; fit walls (s) "
                + " ".join(f"{w:.3f}" for w, _, _ in walls) + "; their epochs' steps / val evals (s) "
                + " ".join(f"{a:.3f}/{b:.3f}" for _, a, b in walls))
            if trace:
                row.update(_traced_fit(trainer, s, dev, lead, log))
                row["spans"] = spans.items
            spans.unwrap()
        row["peak"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        row["triples_per_step"] = int(trainer.n_samples)
        t_check = time.perf_counter()
        got, val_index = _reference_eval(trainer, s, inter, feats, cfg, dev, lead, cache)
        del trainer, capture
        if undo is not None:
            undo()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        row["numbers"] = None
        if lead:
            row["numbers"] = compare(SimpleNamespace(device=dev, log=log), s, cache["prep"], cache["want"],
                                     prog, got, cfg.seed, val_index)
            log(f"reference check {time.perf_counter() - t_check:.3f} s; numbers {row['numbers']}")
        del got
        row["forbidden"] = forbidden_modules()
        out.append(row if lead else {k: row[k] for k in ("peak", "busy", "cpu", "forbidden") if k in row})
    return out


def mesh_size(cell: dict) -> int:
    from plotpointe_tpu_torch.parallel.mesh import parse_mesh_shape

    return math.prod(parse_mesh_shape(cell["traffic"]["mesh"]).values())


def spawn_ranks(cell: dict, config: dict, jobs: list, seconds: Optional[float], trace: bool,
                t_start: float, device: torch.device) -> list:
    """Every rank's rows ([rank][job]), through `parallel/multihost.spawn`;
    raises if a rank loaded JAX or the JAX package."""
    from plotpointe_tpu_torch.parallel.multihost import spawn

    where = "cpu" if device.type == "cpu" else None
    n = mesh_size(cell)
    rows = spawn(rank_main, n, (cell, config, jobs, seconds, trace, t_start, where), device=where,
                 timeout_s=SPAWN_TIMEOUT_S)
    found = sorted({m for rank in rows for row in rank for m in row["forbidden"]})
    if found:
        raise RuntimeError(f"a rank loaded JAX or the JAX package: {found}")
    return rows


def run(ctx, plant: Optional[Callable] = None) -> Outcome:
    if mesh_size(ctx.cell) != ctx.chips:
        raise ValueError(f"the cell's mesh {ctx.cell['traffic']['mesh']} is not the {ctx.chips} chips "
                         "it asks for")
    rows = spawn_ranks(ctx.cell, ctx.config, [(ctx.seed, plant)], ctx.seconds, ctx.trace, ctx.t_start,
                       ctx.device)
    r0 = rows[0][0]
    peak = max(rank[0]["peak"] for rank in rows)
    ctx.log(f"peak memory by rank (bytes) {[rank[0]['peak'] for rank in rows]}; process CPU by rank over "
            f"the window (s) {[round(rank[0].get('cpu', math.nan), 3) for rank in rows]}")
    e2e = {"train_triples_per_s": r0["steps"] * r0["triples_per_step"] / r0["wall"]}
    obs = None
    if ctx.trace:
        ctx.spans.items.extend(r0["spans"])
        obs = Observation(ctx.config, r0["shapes"], ctx.spans, r0["counters"], r0["trace"],
                          window=r0["window"], records=r0["records"])
        busy = [rank[0]["busy"] for rank in rows if rank[0].get("busy") is not None]
        if busy:
            obs.device_busy = (sum(b for b, _ in busy) / len(busy), sum(w for _, w in busy) / len(busy))
            ctx.log(f"busy / traced wall by rank (s) {busy}")
    numbers = r0["numbers"] or {k: math.inf for k in ctx.cell["limits"]}
    return Outcome(r0["setup_s"], e2e, r0["steps"] + r0["failed"], r0["failed"], numbers, peak, obs)
