"""The typed user-item-kNN graph the HGT trains on (port-only).

Node types user and item share the node space of `graphs/csr.py` (users
[0, U), items [U, U + I), N = U + I). Three relations, in this order:

  0 rates     user u -> item U + i   (a train interaction)
  1 rated_by  item U + i -> user u   (the same interaction, reversed)
  2 similar   item U + j -> item U + i   (j one of i's cosine kNN, from the
              `graphs/knn.knn_to_coo` arrays (row i, col j): an item gathers
              from its neighbours)

Each edge's source is a row of the relation-stacked source table of S = U
+ 2 I rows: the user rows under `rates` [0, U), the item rows under
`rated_by` [U, N) and the item rows under `similar` [N, N + I). So the first
N rows are the node table in node order, and an edge's relation follows from
its stacked row (`offsets`). The destination CSR (`row_ptr`, N + 1) groups
the edges by target; an edge's canonical id is its place in (target,
stacked row) order; the transpose CSR (`t_ptr` over the S stacked rows,
`t_dst`, `t_eid`) groups the same edges by stacked row. The sorting is
`graphs/csr.build_graph`'s over S rows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from plotpointe_tpu_torch.graphs.csr import build_graph

RELATIONS = ("rates", "rated_by", "similar")


@dataclass(frozen=True)
class HeteroGraph:
    src: torch.Tensor  # int32 [E] each edge's stacked source row, in canonical order
    dst: torch.Tensor  # int32 [E] each edge's target node
    rel: torch.Tensor  # int32 [E] each edge's relation
    row_ptr: torch.Tensor  # int32 [N + 1] CSR over targets
    t_ptr: torch.Tensor  # int32 [S + 1] CSR over stacked rows
    t_dst: torch.Tensor  # int32 [E] grouped by stacked row: each edge's target
    t_eid: torch.Tensor  # int32 [E] grouped by stacked row: each edge's canonical id
    n_users: int
    n_items: int
    rel_edges: tuple  # edges of each relation

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    @property
    def n_rows(self) -> int:
        """Rows of the relation-stacked source table."""
        return self.n_users + 2 * self.n_items

    @property
    def offsets(self) -> tuple:
        """Each relation's first stacked row, and the table's end."""
        u, n = self.n_users, self.n_nodes
        return 0, u, n, n + self.n_items

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "HeteroGraph":
        return dataclasses.replace(self, **{f: getattr(self, f).to(device) for f in (
            "src", "dst", "rel", "row_ptr", "t_ptr", "t_dst", "t_eid")})


def build_hetero_graph(train_u: np.ndarray, train_i: np.ndarray, n_users: int, n_items: int,
                       knn_rows: np.ndarray, knn_cols: np.ndarray) -> HeteroGraph:
    """The typed graph of the train interactions (u, i) and the kNN arrays
    (item i, its neighbour j), on the host."""
    u = np.asarray(train_u, np.int64)
    i = np.asarray(train_i, np.int64)
    rows = np.asarray(knn_rows, np.int64)
    cols = np.asarray(knn_cols, np.int64)
    if len(rows) != len(cols):
        raise ValueError(f"{len(rows)} kNN rows for {len(cols)} columns")
    if len(rows) and (min(rows.min(), cols.min()) < 0 or max(rows.max(), cols.max()) >= n_items):
        raise ValueError(f"kNN edges must index the {n_items} interacted items")
    n = n_users + n_items
    src = np.concatenate([u, n_users + i, n + cols])
    dst = np.concatenate([n_users + i, u, n_users + rows])
    g = build_graph(src, dst, n + n_items)
    s = g.src.numpy()
    rel = (s >= n_users).astype(np.int32) + (s >= n).astype(np.int32)
    return HeteroGraph(src=g.src, dst=g.dst, rel=torch.from_numpy(rel), row_ptr=g.row_ptr[:n + 1].clone(),
                       t_ptr=g.t_ptr, t_dst=g.t_dst, t_eid=g.t_eid, n_users=int(n_users),
                       n_items=int(n_items), rel_edges=(len(u), len(i), len(rows)))


def load_knn_coo(store, uri: str):
    """(rows, cols) of an `ii_edges_{name}.npz` artifact (`graphs/knn.py`)."""
    z = store.load_npz(uri)
    return np.asarray(z["row"], np.int64), np.asarray(z["col"], np.int64)
