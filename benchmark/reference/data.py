"""Splits, graph and positive tables from the interactions, in plain NumPy.

Splits: per user, rows in time order (ties keep the input order); three
or more rows give train = all but the last two, val = the second last,
test = the last; two rows give train = the first, test = the last; fewer
are dropped. Users and items are numbered in order of first appearance.

Graph: the symmetric user-item graph over nodes [users | items] with an
edge u -> U + i and U + i -> u per train row, the user-to-item edges
first; edges ordered by (destination, source), ties in input order, so
that an edge's id is its place in that order (the id the dropout hash
keys on)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def first_seen_order(values: np.ndarray) -> np.ndarray:
    """index of each value in order of first appearance."""
    uniq, first, inverse = np.unique(values, return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    return rank[inverse]


@dataclass
class RefSplits:
    n_users: int
    n_items: int
    train_u: np.ndarray
    train_i: np.ndarray
    val_u: np.ndarray
    val_i: np.ndarray
    test_u: np.ndarray
    test_i: np.ndarray


def splits(inter: dict) -> RefSplits:
    u = first_seen_order(np.asarray(inter["user_id"]))
    i = first_seen_order(np.asarray(inter["asin"]))
    order = np.lexsort((np.asarray(inter["ts"]), u))
    u, i = u[order], i[order]
    start = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
    count = np.diff(np.r_[start, len(u)])
    pos = np.arange(len(u)) - np.repeat(start, count)
    cnt = np.repeat(count, count)
    test = (cnt >= 2) & (pos == cnt - 1)
    val = (cnt >= 3) & (pos == cnt - 2)
    train = (cnt >= 2) & ~test & ~val
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return RefSplits(int(u.max()) + 1, int(i.max()) + 1, i32(u[train]), i32(i[train]),
                     i32(u[val]), i32(i[val]), i32(u[test]), i32(i[test]))


@dataclass
class RefGraph:
    src: torch.Tensor  # int64 [E], edge id = position
    dst: torch.Tensor
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def graph(s: RefSplits, device) -> RefGraph:
    src = np.concatenate([s.train_u.astype(np.int64), s.train_i.astype(np.int64) + s.n_users])
    dst = np.concatenate([s.train_i.astype(np.int64) + s.n_users, s.train_u.astype(np.int64)])
    order = np.lexsort((src, dst))
    return RefGraph(torch.as_tensor(src[order], device=device),
                    torch.as_tensor(dst[order], device=device), s.n_users + s.n_items)


def symmetric_values(g: RefGraph) -> torch.Tensor:
    """LightGCN's D^-1/2 A D^-1/2 edge values: 1 / sqrt(deg[src] deg[dst]),
    deg = max(in-degree, 1), the product in f32."""
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    deg = np.maximum(np.bincount(dst, minlength=g.n_nodes).astype(np.float32), 1.0)
    return torch.as_tensor((1.0 / np.sqrt(deg[src] * deg[dst])).astype(np.float32),
                           device=g.src.device)


def positives(s: RefSplits, cap: int, device):
    """(table [U, cap] of each user's distinct train items, ascending, padded
    with n_items; count [U] capped at cap; the users with a train item)."""
    pairs = np.unique(s.train_u.astype(np.int64) * s.n_items + s.train_i)
    pu, pi = pairs // s.n_items, pairs % s.n_items
    count = np.bincount(pu, minlength=s.n_users)
    start = np.r_[0, np.cumsum(count)[:-1]]
    col = np.arange(len(pu)) - start[pu]
    keep = col < cap
    table = np.full((s.n_users, cap), s.n_items, np.int64)
    table[pu[keep], col[keep]] = pi[keep]
    deg = np.minimum(count, cap)
    return (torch.as_tensor(table, device=device), torch.as_tensor(deg, device=device),
            torch.as_tensor(np.flatnonzero(count > 0), device=device))


def train_items_by_user(s: RefSplits) -> list:
    """Each user's train items (those with any), in the splits' order."""
    order = np.argsort(s.train_u, kind="stable")
    u, i = s.train_u[order], s.train_i[order]
    start = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
    return np.split(i.astype(np.int64), start[1:])
