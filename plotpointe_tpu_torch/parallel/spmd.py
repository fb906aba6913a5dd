"""Sharded training over the mesh: graph partition by destination ranges,
the port's kernels on each rank's local graph, owned-row overlays, and the
sharded GAT and LightGCN steps.

Counterpart of `plotpointe_tpu/parallel/spmd.py` (`shard_graph_by_edges`,
`shard_layout_by_tiles`, `sharded_attention`, `sharded_attention_fused`,
`_overlay_combiner`, `make_sharded_gat_step_fused`,
`make_sharded_lightgcn_step`, `make_sharded_gat_step`,
`make_sharded_train_step`, `shard_spmm_weights`, `make_sharded_spmm`).

Partition. `shard_graph_by_edges` cuts the destination nodes into n
contiguous ranges balanced by edge count; rank k owns range k and ALL the
in-edges of its destinations (a contiguous run of canonical edge ids,
[e_lo, e_hi)), so its softmax denominators are complete on the rank, the
property JAX's tile partition (`shard_layout_by_tiles`) has. The port's
kernels walk CSR rows, not JAX's nb-row tiles, so one partition by node
range serves every step; JAX's edge re-padding for its XLA steps has no
counterpart. `local_graph` builds rank k's `Graph` once: all N nodes, the
local edges, `row_ptr` rebased to them (empty rows outside the range), the
local transpose (`t_ptr`, `t_dst`, `t_eid`), and `e_lo`. A destination's
edges keep their order, and the kernels cut a row into pieces by that row's
length alone (`ops/spmm_kernel.piece_plan`), so the owned rows of a local
forward are bit-equal to the unsharded forward's. Build it once per
trainer: the kernels cache their walk plans on the `row_ptr` tensor.

Every impl runs the kernels. The JAX package has an XLA path beside its
Pallas one; the port has none (its golden is a reference, not a path), so
`sharded_attention`, the XLA-golden steps (`make_sharded_gat_step`,
`make_sharded_train_step`, `make_sharded_lightgcn_step`) and the fused
ones all run kernels 1-3, 8, 9 (attention, through the dispatch of
`ops/gat_kernel.py`) and 7 (SpMM) on the local graph. The XLA steps'
f32 function is the kernels at f32 rows.

Dropout. The mask is a hash of the canonical edge id, so a rank passes
id_offset = e_lo and draws the single-device mask bit for bit: with dropout
on, the port's sharded fit equals its single-device fit (JAX's does not:
its padded shapes change its stream).

Collectives (`collectives.py`), per GAT step: the user table's all_gather
(backward reduce_scatter), one all_gather of each layer's owned rows
(padded to the largest range; backward reduce_scatter to the owners), the
loss all_reduce and one all_reduce of the replicated parameters' partial
gradients. B2 writes partial dh for every source row over the local
transpose: inside a step those partials reach the previous layer's
reduce_scatter; in the standalone ops (`sharded_attention*`,
`ShardedSpmm.__call__`) the input's gradient is all-reduced. No rank uses
float atomics.

Steps are functions of a flat parameter dict with the port's state_dict
keys (`user_emb`, `item_proj.w`, `layers.0.a_src`, ...); a sharded table
holds this rank's block of rows (`sharded_table.device_put_row_sharded`).
Every rank passes the same global batch; each scores its block of it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch import reference_active
from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel
from plotpointe_tpu_torch.ops.segment import gather_rows
from plotpointe_tpu_torch.ops.spmm_kernel import _csr_spmm, _padded
from plotpointe_tpu_torch.parallel.collectives import (
    all_gather_rows, all_reduce_grad, all_reduce_sum)
from plotpointe_tpu_torch.parallel.mesh import Mesh
from plotpointe_tpu_torch.train.losses import LOSSES

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardLayout:
    """Destination ranges [bounds[k], bounds[k+1]) and their canonical edge
    ranges [e_bounds[k], e_bounds[k+1]), k = 0..n-1."""

    bounds: Tuple[int, ...]
    e_bounds: Tuple[int, ...]

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def counts(self) -> Tuple[int, ...]:
        """Owned destination rows per shard."""
        return tuple(b - a for a, b in zip(self.bounds[:-1], self.bounds[1:]))


def shard_graph_by_edges(graph: Graph, n_shards: int) -> ShardLayout:
    """Contiguous destination ranges, one per shard, cut where the running
    in-edge count crosses k * E / n (JAX's edge balance of
    `shard_layout_by_tiles`, at node granularity)."""
    rp = graph.row_ptr.cpu().numpy().astype(np.int64)
    n, e = graph.n_nodes, int(rp[-1])
    cuts = np.searchsorted(rp, np.arange(1, n_shards) * (e / n_shards), side="left")
    bounds = np.maximum.accumulate(np.concatenate([[0], np.minimum(cuts, n), [n]])).astype(np.int64)
    return ShardLayout(tuple(int(b) for b in bounds), tuple(int(rp[b]) for b in bounds))


@dataclass(frozen=True)
class LocalGraph:
    """A rank's graph: `graph` over all N nodes with the in-edges of
    destinations [lo, hi) only, which are canonical ids [e_lo, e_lo + E_l)."""

    graph: Graph
    lo: int
    hi: int
    e_lo: int


def local_graph(graph: Graph, layout: ShardLayout, shard: int) -> LocalGraph:
    """Shard `shard`'s local graph, built on the graph's device: row_ptr
    rebased (rows outside the range empty), src/dst/weight sliced, and the
    local transpose (local edges in (src, dst) order, each with its local
    id; canonical id = e_lo + local id)."""
    lo, hi = layout.bounds[shard], layout.bounds[shard + 1]
    e_lo, e_hi = layout.e_bounds[shard], layout.e_bounds[shard + 1]
    n = graph.n_nodes
    src, dst = graph.src[e_lo:e_hi].contiguous(), graph.dst[e_lo:e_hi].contiguous()
    row_ptr = (graph.row_ptr.long().clamp(e_lo, e_hi) - e_lo).int()
    t_order = torch.argsort(src.long(), stable=True)  # (dst, src) order -> (src, dst) order
    t_ptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    t_ptr[1:] = torch.cumsum(torch.bincount(src.long(), minlength=n), 0)
    local = replace(graph, src=src, dst=dst, weight=graph.weight[e_lo:e_hi].contiguous(),
                    row_ptr=row_ptr.contiguous(), t_ptr=t_ptr.int(), t_dst=dst[t_order].contiguous(),
                    t_eid=t_order.int())
    return LocalGraph(local, lo, hi, e_lo)


def _local_for(mesh: Mesh, graph: Graph, layout: Optional[ShardLayout]) -> Tuple[ShardLayout, LocalGraph]:
    if graph.tiling is not None:
        raise ValueError("the sharded paths take an untiled graph (the legacy contracts are single-device)")
    layout = layout or shard_graph_by_edges(graph, mesh.n_shards)
    if layout.n_shards != mesh.n_shards:
        raise ValueError(f"layout has {layout.n_shards} shards, the mesh {mesh.n_shards}")
    return layout, local_graph(graph, layout, mesh.shard)


def _overlay_combiner(layout: ShardLayout, mesh: Mesh, overlay_dtype: Optional[torch.dtype],
                      partial_grads: bool = True) -> Callable[[torch.Tensor], torch.Tensor]:
    """combine(owned rows [hi - lo, W]) -> [N, W] on every rank: one
    all_gather of each rank's owned rows, padded to the largest range and
    sliced back; its backward reduce-scatters to the owners (with
    partial_grads=False, for a replicated cotangent, keeps the owned rows).
    The payload
    travels at `overlay_dtype` (None: the rows' own type, exact): the
    overlay has one writer per row, so a bf16 payload only rounds each
    written value."""
    counts = layout.counts

    def combine(owned: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(owned, mesh, counts, overlay_dtype, partial_grads)

    return combine


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _owned_attention(h, a_src, a_dst, local: LocalGraph, dropout_rate=0.0, seed=None,
                     hs_dtype=torch.float32) -> torch.Tensor:
    """The attention kernels on the local graph -> the owned rows
    [hi - lo, H, D]; the mask over canonical ids (id_offset = e_lo)."""
    out = segment_softmax_attention_kernel(h, a_src, a_dst, local.graph, dropout_rate, seed,
                                           hs_dtype, id_offset=local.e_lo)
    return out[local.lo:local.hi]


def sharded_attention(mesh: Mesh, h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                      graph: Graph, layout: Optional[ShardLayout] = None,
                      hs_dtype: torch.dtype = torch.float32,
                      overlay_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Partitioned attention, h [N, H, D] (the same on every rank) -> [N, H,
    D] on every rank; differentiable, with the full gradient of h, a_src and
    a_dst on every rank (B2's partial dh and the vectors' partials
    all-reduced). f32 rows by default: the function of JAX's XLA golden, on
    the kernels. The owned rows travel at `overlay_dtype` (None: exact)."""
    layout, local = _local_for(mesh, graph, layout)
    n, heads, d = h.shape
    h, a_src, a_dst = all_reduce_grad(mesh, h, a_src, a_dst)
    owned = _owned_attention(h, a_src, a_dst, local, hs_dtype=hs_dtype)
    combine = _overlay_combiner(layout, mesh, overlay_dtype, partial_grads=False)
    return combine(owned.reshape(-1, heads * d)).view(n, heads, d)


def sharded_attention_fused(mesh: Mesh, h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                            graph: Graph, layout: Optional[ShardLayout] = None,
                            hs_dtype: torch.dtype = torch.bfloat16,
                            overlay_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Single-head `sharded_attention` at `hs_dtype` rows (kernels 1, 2 and
    3 on the local graph), h [N, 1, D] -> [N, 1, D]."""
    if h.shape[1] != 1:
        raise ValueError(f"sharded_attention_fused is single-head; got heads={h.shape[1]}")
    return sharded_attention(mesh, h, a_src, a_dst, graph, layout, hs_dtype, overlay_dtype)


# ---------------------------------------------------------------------------
# the GAT steps
# ---------------------------------------------------------------------------


class ShardedGATStep:
    """One sharded GAT training step over this rank's local graph.

    `forward(params, item_feats, train, seeds)` -> node embeddings [N, H]
    on every rank (gradients partial, see `collectives.py`);
    `loss(params, item_feats, seeds, u, i, j)` -> the global batch's loss
    on every rank, differentiable in the parameters (backward() leaves each
    parameter's full gradient: a table block's own rows, a replicated
    parameter's all-reduced sum); `__call__` -> (grads, loss) of `loss`.
    seeds: those of `GATModel.dropout_seeds`, or None without dropout."""

    def __init__(self, model, loss_name: str, mesh: Mesh, n_users: int, n_items: int, graph: Graph,
                 layout: Optional[ShardLayout], hs_dtype: torch.dtype, dropout_rate: float,
                 overlay_dtype: Optional[torch.dtype], user_sharded: bool = True):
        self.layout, self.local = _local_for(mesh, graph, layout)
        self.mesh, self.loss_fn = mesh, LOSSES[loss_name]
        self.n_users, self.n_items = n_users, n_items
        self.n_layers, self.use_bias = model.n_layers, model.use_bias
        self.hs_dtype, self.dropout_rate = hs_dtype, dropout_rate
        self.user_sharded = user_sharded
        self.combine = _overlay_combiner(self.layout, mesh, overlay_dtype)

    def forward(self, params: Params, item_feats: torch.Tensor, train: bool = False,
                seeds: Optional[Sequence] = None) -> torch.Tensor:
        mesh, local = self.mesh, self.local
        names = [k for k in params if k != "user_emb" or not self.user_sharded]
        p = dict(params)
        p.update(zip(names, all_reduce_grad(mesh, *(params[k] for k in names))))
        if self.user_sharded:
            ue = all_gather_rows(p["user_emb"], mesh)[:self.n_users]
        else:
            ue = p["user_emb"]
        x = torch.cat([ue, item_feats @ p["item_proj.w"] + p["item_proj.b"]])
        drop = self.dropout_rate if train else 0.0
        for li in range(self.n_layers):
            h = torch.einsum("nf,fhd->nhd", x, p[f"layers.{li}.w"])
            seed = seeds[li] if (seeds is not None and drop > 0) else None
            owned = _owned_attention(h, p[f"layers.{li}.a_src"], p[f"layers.{li}.a_dst"], local,
                                     drop, seed, self.hs_dtype)
            x = self.combine(owned.mean(dim=1))  # head-mean of the owned rows, then the overlay
            if self.use_bias:
                x = x + p[f"layers.{li}.b"]
        return x

    def loss(self, params: Params, item_feats: torch.Tensor, seeds, u, i, j) -> torch.Tensor:
        z = self.forward(params, item_feats, train=True, seeds=seeds)
        return _bpr_block(self, z, u, i, j)

    def __call__(self, params: Params, item_feats: torch.Tensor, seeds, u, i, j):
        return _grads_and_loss(lambda p: self.loss(p, item_feats, seeds, u, i, j), params)


def _bpr_block(step, z, u, i, j) -> torch.Tensor:
    """This rank's block of the (u, i, j) batch scored on z, its mean over
    the block / n, summed over ranks: the global batch's mean loss."""
    n, k = step.mesh.n_shards, step.mesh.shard
    if u.shape[0] % n:
        raise ValueError(f"the batch ({u.shape[0]}) must divide the mesh ({n} shards)")
    b = u.shape[0] // n
    sl = slice(k * b, (k + 1) * b)
    nu = step.n_users
    rows = gather_rows(z, torch.cat([u[sl], i[sl] + nu, j[sl] + nu]))
    zu, zi, zj = rows.split(b)
    return all_reduce_sum(step.loss_fn((zu * zi).sum(-1), (zu * zj).sum(-1)) / n, step.mesh)


def _grads_and_loss(loss_of: Callable[[Params], torch.Tensor], params: Params):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_of(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return ({k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)},
            loss.detach())


def make_sharded_gat_step_fused(model, loss_name: str, mesh: Mesh, n_users: int, n_items: int,
                                graph: Graph, layout: Optional[ShardLayout] = None,
                                dropout_rate: float = 0.0, hs_dtype: torch.dtype = torch.bfloat16,
                                overlay_dtype: Optional[torch.dtype] = torch.bfloat16) -> ShardedGATStep:
    """The single-head GAT step on kernels 1-3 at `hs_dtype` rows: the user
    table row-sharded, the attention on the local graph, the batch split.
    As in JAX, the layer overlays travel at `overlay_dtype` (default bf16;
    None: exact f32). The table travels exact (JAX sends it at bf16 with
    bf16 rows)."""
    if model.heads != 1:
        raise ValueError(f"the fused step is single-head; got heads={model.heads}")
    return ShardedGATStep(model, loss_name, mesh, n_users, n_items, graph, layout, hs_dtype,
                          dropout_rate, overlay_dtype)


def make_sharded_gat_step(model, loss_name: str, mesh: Mesh, n_users: int, n_items: int,
                          graph: Graph, layout: Optional[ShardLayout] = None) -> ShardedGATStep:
    """The GAT step at any head count on the model's row type and dropout
    (kernels 1-3, or 8, 9 and 3 per head): the user table row-sharded, the
    attention on the local graph, the batch split, exact overlays."""
    return ShardedGATStep(model, loss_name, mesh, n_users, n_items, graph, layout, model.hs_dtype,
                          model.attn_dropout, None)


def make_sharded_train_step(model, loss_name: str, mesh: Mesh, n_users: int, n_items: int,
                            graph: Graph, layout: Optional[ShardLayout] = None) -> ShardedGATStep:
    """The legacy step: every parameter replicated (the user table too),
    the attention partitioned, the batch split, every gradient all-reduced;
    no dropout (the JAX step draws none)."""
    return ShardedGATStep(model, loss_name, mesh, n_users, n_items, graph, layout, model.hs_dtype,
                          0.0, None, user_sharded=False)


# ---------------------------------------------------------------------------
# SpMM (LightGCN's propagation)
# ---------------------------------------------------------------------------


def shard_spmm_weights(local: LocalGraph, values) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local edges' SpMM values in the local destination order and in
    the local transpose's order, on the local graph's device. `values` [E]
    is the full graph's canonical-order array."""
    g = local.graph
    v = torch.as_tensor(np.asarray(values, np.float32)[local.e_lo:local.e_lo + g.n_edges],
                        device=g.src.device)
    return v, v[g.t_eid.long()].contiguous()


class _OwnedSpmm(torch.autograd.Function):
    """Kernel 7 over the local graph -> the owned rows; backward: kernel 7
    over the local transpose from the owned rows' cotangent (rounded to the
    row type, as the single-device operator rounds it) -> partial dx for
    every source row."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op, ctx.plain = op, reference_active()
        g = op.local.graph
        y = _csr_spmm(x, op.values, g.row_ptr, g.src, op.xs_dtype, ctx.plain)
        return y[op.local.lo:op.local.hi]

    @staticmethod
    def backward(ctx, gy):
        op = ctx.op
        g, lo, hi = op.local.graph, op.local.lo, op.local.hi
        full = gy.new_zeros((g.n_nodes, gy.shape[1]))
        full[lo:hi] = gy
        return _csr_spmm(full, op.values_t, g.t_ptr, g.t_dst, op.xs_dtype, ctx.plain), None


class ShardedSpmm:
    """y = A x over the partition: kernel 7 per rank on its local graph and
    the owned-row overlay. `op(x)` takes x [N, F] the same on every rank
    and gives the full gradient of x (JAX's operator: the transpose's
    partials all-reduced in f32); `op.partial(x)` is the step's form (x's
    gradient partial, reduced by the caller's collectives)."""

    def __init__(self, mesh: Mesh, graph: Graph, values, layout: Optional[ShardLayout] = None,
                 xs_dtype: torch.dtype = torch.bfloat16,
                 overlay_dtype: Optional[torch.dtype] = torch.bfloat16):
        self.layout, self.local = _local_for(mesh, graph, layout)
        self.mesh, self.xs_dtype, self.overlay_dtype = mesh, xs_dtype, overlay_dtype
        self.values, self.values_t = shard_spmm_weights(self.local, values)

    def _apply(self, x: torch.Tensor, partial_grads: bool) -> torch.Tensor:
        d = x.shape[1]
        owned = _OwnedSpmm.apply(_padded(x), self)
        y = all_gather_rows(owned, self.mesh, self.layout.counts, self.overlay_dtype, partial_grads)
        return y[:, :d] if y.shape[1] != d else y

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(x, True)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        (x,) = all_reduce_grad(self.mesh, x)
        return self._apply(x, False)


def make_sharded_spmm(mesh: Mesh, graph: Graph, values, layout: Optional[ShardLayout] = None,
                      xs_dtype: torch.dtype = torch.bfloat16,
                      overlay_dtype: Optional[torch.dtype] = torch.bfloat16) -> ShardedSpmm:
    """The partitioned static SpMM operator of (graph, values [E])."""
    return ShardedSpmm(mesh, graph, values, layout, xs_dtype, overlay_dtype)


class ShardedLightGCNStep:
    """One sharded LightGCN step: both tables row-sharded and all-gathered
    into the propagation input, K rounds of the partitioned SpMM (partial
    form, exact overlays), the (u, i, j) pairs split. `loss(params, u, i,
    j)` and `__call__` as `ShardedGATStep`'s; `forward(params)` -> [N, D]."""

    def __init__(self, model, loss_name: str, mesh: Mesh, n_users: int, n_items: int, graph: Graph,
                 values, layout: Optional[ShardLayout] = None):
        self.spmm = ShardedSpmm(mesh, graph, values, layout, model.xs_dtype, None)
        self.mesh, self.loss_fn = mesh, LOSSES[loss_name]
        self.n_users, self.n_items, self.k = n_users, n_items, model.n_prop_layers

    def forward(self, params: Params) -> torch.Tensor:
        ue = all_gather_rows(params["user_emb"], self.mesh)[:self.n_users]
        ie = all_gather_rows(params["item_emb"], self.mesh)[:self.n_items]
        acc = out = torch.cat([ue, ie])
        for _ in range(self.k):
            out = self.spmm.partial(out)
            acc = acc + out
        return acc / (self.k + 1)

    def loss(self, params: Params, u, i, j) -> torch.Tensor:
        return _bpr_block(self, self.forward(params), u, i, j)

    def __call__(self, params: Params, u, i, j):
        return _grads_and_loss(lambda p: self.loss(p, u, i, j), params)


def make_sharded_lightgcn_step(model, loss_name: str, mesh: Mesh, n_users: int, n_items: int,
                               graph: Graph, values,
                               layout: Optional[ShardLayout] = None) -> ShardedLightGCNStep:
    """The LightGCN step on kernel 7 at the model's row type; u, i, j are
    the global (u, i, j) pairs (each positive repeated once per negative)."""
    return ShardedLightGCNStep(model, loss_name, mesh, n_users, n_items, graph, values, layout)
