"""The collectives of the sharded steps, written once, with their gradients.

Every collective of `sharded_table.py`, `spmd.py` and the sharded trainer
goes through this module, so `record_collectives` can list each call
(kind, shape, dtype, bytes) for the scaling audit. The gradient
convention is Megatron's, and JAX's inside `shard_map`: a tensor every rank
holds whole ("replicated") carries on each rank that rank's PARTIAL
gradient (what its own slice of the batch and its own graph shard gave);
the true gradient is the sum over ranks. So:

  all_gather_rows   rows -> all ranks' rows. Backward: a reduce_scatter
                    (sum the partial gradients, each rank keeps its rows):
                    JAX's transpose of a tiled all_gather.
  reduce_scatter_rows  the transpose of all_gather_rows: [n * r] partial
                    rows summed, each rank keeping its block. Backward: an
                    all_gather (JAX's `psum_scatter`).
  all_reduce_grad   identity forward; the backward all-reduces the
                    gradients, in one flat buffer: a replicated input (a
                    parameter, or h fed whole to a sharded op) gets its
                    full gradient.
  all_reduce_sum    each rank's term summed on every rank (the loss; the
                    rows of a replicated lookup); the backward passes the
                    cotangent through: each rank seeds its own term, or
                    holds the same cotangent of a replicated result.

Rows of unequal counts (owned destination ranges differ in size) are
padded to the largest count for the wire and sliced back. `wire_dtype`
(bf16, say) casts the payload both ways, as the JAX step's bf16 overlays
do.

Transport: NCCL moves CUDA tensors itself. gloo is the CPU's transport,
and also what two ranks on one GPU must use (NCCL refuses them): gloo
all-reduces CUDA tensors itself, and for the other kinds the wrapper
stages through host tensors, only when the group's backend is gloo and the
tensor is on CUDA (`STAGED` counts those calls). gloo reduce-scatters as
an all_reduce and a slice, and gathers with the list form of all_gather:
the one form of each that every torch version's gloo takes. The recorder
lists the collective the step asked for, not its transport.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from plotpointe_tpu_torch.ops.cuda_build import LaunchCounter
from plotpointe_tpu_torch.parallel.mesh import Mesh

STAGED = LaunchCounter()  # collectives staged through host tensors (gloo with CUDA tensors)
_recorder: Optional[List[dict]] = None


@contextlib.contextmanager
def record_collectives() -> Iterator[List[dict]]:
    """Inside the block every collective appends {"op", "shape", "dtype",
    "bytes"} to the yielded list; bytes are the operand's per-rank payload
    (all_gather: the local rows; reduce_scatter: the full buffer), the
    convention of the JAX audit's StableHLO count."""
    global _recorder
    prev, _recorder = _recorder, []
    try:
        yield _recorder
    finally:
        _recorder = prev


def _record(op: str, t: torch.Tensor) -> None:
    if _recorder is not None:
        _recorder.append({"op": op, "shape": "x".join(map(str, t.shape)) or "scalar",
                          "dtype": str(t.dtype).replace("torch.", ""),
                          "bytes": t.numel() * t.element_size()})


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `t` over the data axis, in place; returns t."""
    _record("all_reduce", t)
    if t.dtype == torch.bfloat16 and mesh.backend == "gloo":
        # sum in f32 (one rounding, as the NCCL sum of two ranks rounds once)
        f = t.float()
        dist.all_reduce(f, group=mesh.group)
        return t.copy_(f)
    dist.all_reduce(t, group=mesh.group)
    return t


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[r, ...] on each rank -> [n * r, ...], ranks in order."""
    _record("all_gather", x)
    n = mesh.n_shards
    x = x.contiguous()
    if mesh.backend != "gloo":
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out
    host = x.cpu() if x.is_cuda else x
    if x.is_cuda:
        STAGED.bump()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat(parts).to(x.device)


def _reduce_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[n * r, ...] on each rank -> the sum over ranks of block `shard`."""
    _record("reduce_scatter", x)
    n, r = mesh.n_shards, x.shape[0] // mesh.n_shards
    x = x.contiguous()
    if mesh.backend != "gloo":
        out = torch.empty((r,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=mesh.group)
        return out
    host = x.float().cpu() if x.is_cuda or x.dtype == torch.bfloat16 else x.clone()
    if x.is_cuda:
        STAGED.bump()
    dist.all_reduce(host, group=mesh.group)
    lo = mesh.shard * r
    return host[lo:lo + r].to(device=x.device, dtype=x.dtype)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, counts, wire_dtype, partial_grads):
        most = max(counts)
        ctx.mesh, ctx.counts, ctx.wire_dtype, ctx.dtype = mesh, counts, wire_dtype, x.dtype
        ctx.partial_grads = partial_grads
        payload = _pad_rows(x, most).to(wire_dtype or x.dtype)
        gathered = _all_gather(payload, mesh).to(x.dtype)
        if all(c == most for c in counts):
            return gathered
        return torch.cat([gathered[k * most:k * most + c] for k, c in enumerate(counts)])

    @staticmethod
    def backward(ctx, g):
        counts, most, mesh = ctx.counts, max(ctx.counts), ctx.mesh
        if not ctx.partial_grads:  # every rank holds the same full cotangent: keep own rows
            lo = sum(counts[:mesh.shard])
            return g[lo:lo + counts[mesh.shard]].to(ctx.dtype), None, None, None, None
        wire = ctx.wire_dtype or g.dtype
        if all(c == most for c in counts):
            full = g.to(wire)
        else:
            full = g.new_zeros((len(counts) * most,) + tuple(g.shape[1:]), dtype=wire)
            lo = 0
            for k, c in enumerate(counts):
                full[k * most:k * most + c] = g[lo:lo + c]
                lo += c
        mine = _reduce_scatter(full, mesh)
        return mine[:counts[mesh.shard]].to(ctx.dtype), None, None, None, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh, counts: Optional[Sequence[int]] = None,
                    wire_dtype: Optional[torch.dtype] = None,
                    partial_grads: bool = True) -> torch.Tensor:
    """This rank's rows x [counts[shard], ...] -> every rank's rows in rank
    order [sum(counts), ...] (counts None: x.shape[0] on every rank).
    Differentiable: the backward reduce-scatters the partial gradients.
    With partial_grads=False (an op whose output's cotangent is the same
    full tensor on every rank, as for an op called outside a sharded step)
    the backward keeps this rank's rows of it and communicates nothing."""
    counts = [x.shape[0]] * mesh.n_shards if counts is None else [int(c) for c in counts]
    if x.shape[0] != counts[mesh.shard]:
        raise ValueError(f"rank {mesh.shard} holds {x.shape[0]} rows, counts say {counts[mesh.shard]}")
    return _AllGatherRows.apply(x, mesh, tuple(counts), wire_dtype, partial_grads)


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce_scatter(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh), None


def reduce_scatter_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [n * r, ...] on each rank -> the sum over ranks of this rank's
    block [r, ...]. Differentiable: the backward all-gathers."""
    if x.shape[0] % mesh.n_shards:
        raise ValueError(f"{x.shape[0]} rows do not split over {mesh.n_shards} ranks")
    return _ReduceScatterRows.apply(x, mesh)


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
              for g, (s, dt, dev) in zip(gs, ctx.shapes)]
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        _all_reduce(flat, ctx.mesh)
        out, lo = [], 0
        for g in gs:
            out.append(flat[lo:lo + g.numel()].view(g.shape).to(g.dtype))
            lo += g.numel()
        return (None, *out)


def all_reduce_grad(mesh: Mesh, *xs: torch.Tensor):
    """The tensors themselves; their gradients are summed over the data
    axis in the backward (one all_reduce of one flat f32 buffer)."""
    return _AllReduceGrad.apply(mesh, *xs)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each rank's term summed on every rank; the gradient passes through
    (JAX's `psum` under `shard_map`, whose result is the same on every
    device)."""
    return _AllReduceSum.apply(x, mesh)
