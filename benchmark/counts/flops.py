"""Model FLOPs of one training step, counted from the shapes (a multiply
and an add count two). The optimizer's element-wise update, the sampling
and the loss's element-wise terms are left out: they are not the model's
products and sums.

GAT step: the item projection (forward 2 I F H; backward only its weight
gradient, 2 I F H, since the features are no parameter), per layer the
row transform h = x W (forward 2 N H D; backward 2 N H D for W and, where
x depends on a parameter, which it does in every layer through the user
table, 2 N H D for x), the attention (forward: the logit terms 4 N D and
the weighted sum 2 E D; backward twice the forward), and the score dot
products of the loss (3 S H, twice over in the backward).

LightGCN step: per propagation round one SpMM, 2 E D forward and 2 E D
backward; the loss's dot products over b positives and b * npp negatives
(2 d each, twice over in the backward)."""
from __future__ import annotations


def gat_step_flops(n_users: int, n_items: int, n_edges: int, feat_dim: int, hidden: int,
                   layers: int, samples: int) -> float:
    n = n_users + n_items
    proj = 2 * n_items * feat_dim * hidden
    transform = 2 * n * hidden * hidden
    attention = 4 * n * hidden + 2 * n_edges * hidden
    loss = 2 * 2 * samples * hidden
    forward = proj + layers * (transform + attention) + loss
    backward = proj + layers * (2 * transform + 2 * attention) + 2 * loss
    return float(forward + backward)


def lightgcn_step_flops(n_users: int, n_items: int, n_edges: int, dim: int, rounds: int,
                        batch: int, neg_per_pos: int) -> float:
    spmm = 2 * n_edges * dim
    loss = 2 * dim * (batch + batch * neg_per_pos)
    return float(rounds * 2 * spmm + 3 * loss)
