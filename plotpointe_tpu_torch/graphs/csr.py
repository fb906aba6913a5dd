"""Graph layout: destination-sorted edge arrays plus a CSR `row_ptr`.

Counterpart of `plotpointe_tpu/graphs/csr.py` (`Graph`, `build_graph`,
`build_bipartite_graph`, `degrees`, `symmetric_normalized_weights`). Edges are sorted by (dst, src), so an
edge's id is its position in that order (the canonical id the hash dropout
mask keys on) and each destination's in-edges are one contiguous CSR row.

The TPU layout pieces are not carried over: no sentinel padding edges, no
chunk arrays. The attention kernels walk plain CSR rows (one warp a row,
or, in kernels 8 and B2, the piece plan of `ops/spmm_kernel.py` over the
CSR's entries), so they need neither. The backward's source-order pass walks a transpose
CSR (`t_ptr`, `t_dst`, `t_eid`): the same edges grouped by source, each
carrying its destination and its canonical id.

`with_tiling()` keeps only the mark: `tiling = (nb, eb)`. In the JAX package
a graph with chunk tiling and no aligned layout takes the legacy attention
contracts (v1, v2); the mark selects them here in the same way
(`ops/gat_kernel.py`). The tile sizes are recorded, not used: the port's
kernels walk CSR rows.

Node id convention: users occupy [0, n_users), items [n_users, n_users + n_items).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Graph:
    """Directed graph over `n_nodes` nodes; tensors live on one device."""

    src: torch.Tensor  # int32 [E], (dst, src)-sorted
    dst: torch.Tensor  # int32 [E]
    weight: torch.Tensor  # float32 [E]
    row_ptr: torch.Tensor  # int32 [n_nodes + 1], CSR over dst
    n_nodes: int
    t_ptr: torch.Tensor  # int32 [n_nodes + 1], CSR over src
    t_dst: torch.Tensor  # int32 [E], (src, dst)-sorted: each edge's destination
    t_eid: torch.Tensor  # int32 [E], each edge's canonical id: its position in (dst, src) order
    tiling: tuple[int, int] | None = None  # (nb, eb) of `with_tiling`: the legacy contracts

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "Graph":
        return dataclasses.replace(
            self,
            src=self.src.to(device),
            dst=self.dst.to(device),
            weight=self.weight.to(device),
            row_ptr=self.row_ptr.to(device),
            t_ptr=self.t_ptr.to(device),
            t_dst=self.t_dst.to(device),
            t_eid=self.t_eid.to(device),
        )

    def with_tiling(self, nb: int = 256, eb: int = 1024) -> "Graph":
        """A copy marked as tiled (nb destination nodes, eb edges per chunk),
        which attention serves with the legacy v1/v2 contracts."""
        if nb <= 0 or eb <= 0:
            raise ValueError(f"tile sizes must be positive; got nb={nb}, eb={eb}")
        return dataclasses.replace(self, tiling=(int(nb), int(eb)))


def _csr_ptr(keys: np.ndarray, n_nodes: int) -> np.ndarray:
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n_nodes)[:n_nodes], out=ptr[1:])
    return ptr.astype(np.int32)


def build_graph(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                weight: np.ndarray | None = None) -> Graph:
    """Sort edges by (dst, src) and build the CSR row_ptr and the transpose
    CSR, on the host. The (dst, src) order and row_ptr come from the native
    counting sort (`plotpointe_tpu_torch.native`, numpy lexsort without
    it); the transpose needs the sort's permutation, so it is a lexsort."""
    from plotpointe_tpu_torch import native

    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    src32, dst32, w, row_ptr = native.build_csr(src, dst, weight, n_nodes, len(src))
    t_order = np.lexsort((dst32, src32))  # canonical ids grouped by source
    return Graph(
        src=torch.from_numpy(src32),
        dst=torch.from_numpy(dst32),
        weight=torch.from_numpy(w),
        row_ptr=torch.from_numpy(np.ascontiguousarray(row_ptr[:n_nodes + 1])),
        n_nodes=int(n_nodes),
        t_ptr=torch.from_numpy(_csr_ptr(src32, n_nodes)),
        t_dst=torch.from_numpy(dst32[t_order]),
        t_eid=torch.from_numpy(t_order.astype(np.int32)),
    )


def build_bipartite_graph(train_u: np.ndarray, train_i: np.ndarray, n_users: int,
                          n_items: int, weight: np.ndarray | None = None) -> Graph:
    """Symmetric user<->item graph in the unified node space (u -> n_users+i and back)."""
    ui_src = np.asarray(train_u, dtype=np.int64)
    ui_dst = np.asarray(train_i, dtype=np.int64) + n_users
    w = None if weight is None else np.concatenate([weight, weight]).astype(np.float32)
    return build_graph(np.concatenate([ui_src, ui_dst]), np.concatenate([ui_dst, ui_src]),
                       n_users + n_items, weight=w)


def degrees(graph: Graph) -> np.ndarray:
    """In-degree per node."""
    rp = graph.row_ptr.cpu().numpy().astype(np.int64)
    return rp[1:] - rp[:-1]


def symmetric_normalized_weights(graph: Graph) -> np.ndarray:
    """LightGCN's D^-1/2 A D^-1/2 edge values [E] f32 in canonical (dst, src)
    order: 1 / sqrt(deg[src] * deg[dst]), deg = max(in-degree, 1). The
    product is taken in f32 before the square root, as the JAX package does,
    so the values are bit-equal to its `symmetric_normalized_weights` on the
    real edges."""
    src, dst = graph.src.cpu().numpy(), graph.dst.cpu().numpy()
    deg = np.clip(np.bincount(dst, minlength=graph.n_nodes).astype(np.float32), 1.0, None)
    return (1.0 / np.sqrt(deg[src] * deg[dst])).astype(np.float32)
