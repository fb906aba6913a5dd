"""The first training steps and the sampled evals of a fit, worked out
again from the inputs: the readings the program's are held to.

`follow(...)` takes the interactions, the item features (GAT), the
configuration and the trainer's seed, builds splits, graph and positives
itself, draws the initial weights and each step's samples from the stated
streams, and runs `steps` optimizer steps (`steps_to_check`: through the
first step of the second epoch, and at least three). It returns each step's
loss, the per-leaf norm of the first gradient as Adam gets it (with the L2
term), of each leaf's change over the first CHANGE_STEPS steps, and the
weights after the last step. `evaluate_embeddings(...)` gives the sampled
metrics of node embeddings on the val or test users.

`rows` and `tf32` set the precision: the configuration's row type with
TF32 off is the reference; one step lower (fp8 rows, TF32 products) is
the control. `keep_share` < 1 leaves out the rest of each batch, the mean
taken over what is kept: a fault the comparison must catch."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import data, models, sampling
from benchmark.reference.evaluate import sampled_eval

ROW_TYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float8_e4m3fn": torch.float8_e4m3fn}
POS_CAP = 512  # the trainer's cap on a user's positive-table row
CHANGE_STEPS = 3  # the leaves' change is compared over the first three steps


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@dataclass
class Prepared:
    splits: data.RefSplits
    graph: data.RefGraph
    table: torch.Tensor
    deg: torch.Tensor
    train_users: torch.Tensor
    feats: Optional[torch.Tensor]
    values: Optional[torch.Tensor]
    train_u: Optional[torch.Tensor] = None
    train_i: Optional[torch.Tensor] = None


def prepare(inter: dict, feats: Optional[np.ndarray], family: str, device) -> Prepared:
    s = data.splits(inter)
    g = data.graph(s, device)
    table, deg, users = data.positives(s, POS_CAP, device)
    f = None if feats is None else torch.as_tensor(np.asarray(feats, np.float32), device=device)
    prep = Prepared(s, g, table, deg, users, f, None)
    if family == "lightgcn":
        prep.values = data.symmetric_values(g)
        prep.train_u = torch.as_tensor(s.train_u.astype(np.int64), device=device)
        prep.train_i = torch.as_tensor(s.train_i.astype(np.int64), device=device)
    return prep


@dataclass
class Readings:
    losses: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)
    change_norms: Dict[str, float] = field(default_factory=dict)
    params: Dict[str, torch.Tensor] = field(default_factory=dict)  # after the steps


def steps_per_epoch(cfg: dict, n_train: int) -> int:
    if cfg["model_family"] == "gat":
        return max(1, cfg["steps_per_epoch"])
    return 1 if n_train < cfg["batch_size"] else n_train // cfg["batch_size"]


def steps_to_check(cfg: dict, n_train: int) -> int:
    """The steps the reference follows: CHANGE_STEPS, and through the first
    step of epoch 2 (the sampler reseeded for a new epoch)."""
    return max(CHANGE_STEPS, steps_per_epoch(cfg, n_train) + 1)


def epoch_of_step(cfg: dict, n_train: int, step: int) -> int:
    """The epoch (from 1) that step `step` (from 1) belongs to."""
    return (step - 1) // steps_per_epoch(cfg, n_train) + 1


def init_params(prep: Prepared, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = sampling.reseed(torch.Generator(device=device), seed, sampling.STREAM_INIT, 0)
    s = prep.splits
    if cfg["model_family"] == "gat":
        return models.gat_init(gen, s.n_users, prep.feats.shape[1], cfg["hidden_dim"], cfg["layers"])
    return models.lightgcn_init(gen, s.n_users, s.n_items, cfg["embed_dim"])


def embed(p, prep: Prepared, cfg: dict, rows, seeds=None, train: bool = False) -> torch.Tensor:
    if cfg["model_family"] == "gat":
        rate = cfg["attn_dropout"] if train else 0.0
        return models.gat_forward(p, prep.feats, prep.graph, cfg["layers"], rows, rate, seeds)
    return models.lightgcn_forward(p, prep.graph, prep.values, cfg["n_prop_layers"], rows)


def follow(prep: Prepared, cfg: dict, seed: int, device, steps: int = 3, rows: str = "bfloat16",
           tf32: bool = False, keep_share: float = 1.0) -> Readings:
    rt = ROW_TYPES[rows]
    s, U = prep.splits, prep.splits.n_users
    p = init_params(prep, cfg, seed, device)
    p0 = {k: v.clone() for k, v in p.items()}
    opt = models.Adam(p, cfg["lr"], cfg["l2"])
    gen = torch.Generator(device=device)
    out = Readings()
    gat = cfg["model_family"] == "gat"
    n_train, bs = len(s.train_u), cfg.get("batch_size", 0)
    per_epoch = steps_per_epoch(cfg, n_train)
    perm = None
    with matmul_precision(tf32):
        for step in range(steps):
            epoch, within = step // per_epoch + 1, step % per_epoch
            if within == 0:
                sampling.reseed(gen, seed, sampling.STREAM_TRAIN, epoch)
                if not gat:
                    perm = torch.randperm(n_train, generator=gen, device=device)
                    if n_train < bs:
                        perm = perm.repeat(-(-bs // n_train))[:bs]
            for v in p.values():
                v.requires_grad_(True)
            if gat:
                u, i, j = sampling.bpr_triples(gen, prep.train_users, prep.table, prep.deg,
                                               s.n_items, cfg["samples_per_epoch"])
                seeds = (sampling.layer_seeds(gen, cfg["layers"], device)
                         if cfg["attn_dropout"] > 0 else None)
                z = embed(p, prep, cfg, rt, seeds, train=True)
                keep = max(1, int(round(len(u) * keep_share)))
                u, i, j = u[:keep], i[:keep], j[:keep]
                zu, zi, zj = z[u], z[U + i], z[U + j]
                loss = models.bpr((zu * zi).sum(-1), (zu * zj).sum(-1))
            else:
                u, i, j = sampling.lightgcn_batch(gen, perm, within, prep.train_u, prep.train_i,
                                                  prep.table, prep.deg, s.n_items, bs,
                                                  cfg["neg_per_pos"])
                z = embed(p, prep, cfg, rt)
                keep = max(1, int(round(len(u) * keep_share)))
                u, i, j = u[:keep], i[:keep], j[:keep]
                zu, zi, zj = z[u], z[U + i], z[U + j]
                npp = j.shape[1]
                pos = (zu * zi).sum(-1)[:, None].expand(-1, npp).reshape(-1)
                neg = (zu[:, None, :] * zj).sum(-1).reshape(-1)
                loss = models.bpr(pos, neg)
            grads = torch.autograd.grad(loss, list(p.values()))
            out.losses.append(float(loss.detach()))
            for v in p.values():
                v.requires_grad_(False)
            opt.step(dict(zip(p.keys(), grads)))
            del z, grads, loss
            if step + 1 == CHANGE_STEPS:
                out.change_norms = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in p}
                p0 = None
    out.grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in opt.first_grad.items()}
    out.params = p
    return out


def evaluate_embeddings(z: torch.Tensor, prep: Prepared, cfg: dict, seed: int, split: str,
                        index: int, device, tf32: bool = False) -> Dict[str, float]:
    """Sampled metrics of node embeddings z [users | items]."""
    s = prep.splits
    users, pos = (s.val_u, s.val_i) if split == "val" else (s.test_u, s.test_i)
    gen = sampling.reseed(torch.Generator(device=device), seed, sampling.STREAM_EVAL, index)
    with torch.no_grad(), matmul_precision(tf32):
        return sampled_eval(z[:s.n_users], z[s.n_users:], users, pos, prep.table, prep.deg, gen,
                            cfg["eval_neg_k"], cfg["eval_chunk"])
