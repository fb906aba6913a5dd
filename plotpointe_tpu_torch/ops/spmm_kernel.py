"""CSR SpMM (LightGCN's propagation): the CUDA kernel, its plain version, the
static operator and the generic op.

Counterpart of `plotpointe_tpu/ops/spmm_kernel.py`:
  `_wreduce_kernel` -> `csrc/spmm_csr.cu` (`spmm_csr`), kernel 7;
  `make_spmm`       -> `make_spmm`: a fixed (graph, values) pair, forward and
                       transpose backward both on kernel 7;
  `spmm_pallas`     -> `spmm`: values as an input, with a gradient.
`spmm_csr` walks any CSR (`ptr`, `idx`): over the destination CSR
(`row_ptr`, `src`) it is the forward y_d = sum_{s -> d} v_e x_s; over the
transpose CSR (`t_ptr`, `t_dst`, values in source order) it is the backward
dx_s = sum_{s -> d} v_e g_d. x rows are rounded to the row type before they
are gathered (bf16 rows halve the gather, as the JAX package casts before it
gathers) and summed in f32. The wrapper runs `spmm_csr_plain` for CPU
tensors and launches the kernel (or raises) for CUDA tensors.

D must be a multiple of 32 up to 512 for the kernel; the operators pad other
widths with zero columns (which add nothing) and slice them off. The JAX
package pads to 128 lanes; the port does not need to.

`spmm_gathered` runs the same kernel over rows gathered before the call
(row e of x belongs to CSR entry e, so no index stream is read), with
weights or unit weights, in column strips of <= 512: the legacy attention
contracts' reduces (kernels 13 and 15) call it with counters of their own.

The kernel walks a plan (`piece_plan`): each CSR row cut into pieces of at
most CAP entries, and the pieces in order grouped into units of about UNIT
entries, one lane group's walk each, so no lane group walks a hot row alone
and the groups of a warp walk about as many entries each. The pieces of a
split row are summed in f32 scratch rows, then combined in piece order. The
plan depends on `ptr` alone and is built once per `ptr` tensor (a graph is
fixed), on its device, and cached while that tensor lives.

The gathering attention kernels 8 and 3 (B2) walk the same plans: of
`row_ptr` and of `t_ptr`. `cached_walk` keeps, beside the plan of a `ptr`
tensor, each entry's row and the most entries a block of their walk
(WALK_UNITS units) holds, which sizes its shared memory. `piece_order_sum`
is the walks' order of sums in plain PyTorch, for the tests.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from plotpointe_tpu_torch import reference_active
from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops import cuda_build as cb

LAUNCHES = cb.COUNTERS["spmm_csr"]
CAP = 64  # the most entries of one row a piece holds: longer rows are split
UNIT = 64  # about the entries (each piece counted one more) one lane group walks


class PiecePlan(NamedTuple):
    """Pieces of at most `cap` consecutive entries of one CSR row, in entry
    order, grouped into units. piece_ptr [P + 1] int32: piece p is entries
    piece_ptr[p] .. piece_ptr[p + 1] - 1 (an empty row is one empty piece).
    piece_out [P] int32: the y row o >= 0 a whole-row piece writes, or
    -1 - slot for a piece of a split row. When every row is one piece, both
    are None: the pieces are the rows of `ptr`. unit_ptr [U + 1] int32:
    unit u is pieces unit_ptr[u] .. unit_ptr[u + 1] - 1, runs of about
    `unit` entries (a piece counted as its entries plus one), none empty.
    split_rows [S] int32 and split_ptr [S + 1] int32: y row split_rows[r]
    is the sum of scratch slots split_ptr[r] .. split_ptr[r + 1] - 1, in
    that order."""
    piece_ptr: Optional[torch.Tensor]
    piece_out: Optional[torch.Tensor]
    unit_ptr: torch.Tensor
    split_rows: torch.Tensor
    split_ptr: torch.Tensor
    n_pieces: int
    n_units: int
    n_slots: int

    def launch_args(self, ptr: torch.Tensor) -> tuple:
        """The C entry's plan arguments: piece_ptr (`ptr` itself when every
        row is one piece), piece_out, unit_ptr, scratch rows, split_rows,
        split_ptr, n_units, n_split, as ints (pointers by address)."""
        return ((ptr if self.piece_ptr is None else self.piece_ptr).data_ptr(),
                None if self.piece_out is None else self.piece_out.data_ptr(),
                self.unit_ptr.data_ptr(), self.n_slots, self.split_rows.data_ptr(),
                self.split_ptr.data_ptr(), self.n_units, self.split_rows.shape[0])


def _units(piece_len: torch.Tensor, unit: int) -> torch.Tensor:
    """unit_ptr over pieces of these lengths: a piece joins the unit its
    start falls in, each piece counted as its entries plus one."""
    cost = piece_len + 1
    of = (torch.cumsum(cost, 0) - cost) // unit
    starts = torch.nonzero(of[1:] != of[:-1]).flatten() + 1
    zero = torch.zeros(1, dtype=torch.long, device=piece_len.device)
    return torch.cat([zero, starts, zero + piece_len.shape[0]]).int()


def piece_plan(ptr: torch.Tensor, cap: int = CAP, unit: int = UNIT) -> PiecePlan:
    """The plan of the CSR row pointer `ptr` (int32, any device): rows of
    more than `cap` entries cut into ceil(len / cap) pieces of `cap` entries
    and a last one of the rest; the pieces grouped into units of about
    `unit`."""
    dev = ptr.device
    lens = (ptr[1:] - ptr[:-1]).long()
    n_rows = lens.shape[0]
    n_per = torch.clamp((lens + cap - 1) // cap, min=1)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    one_zero = torch.zeros(1, dtype=torch.int32, device=dev)
    if n_rows == 0:
        return PiecePlan(None, None, one_zero, none, one_zero, 0, 0, 0)
    if int(n_per.max()) == 1:
        units = _units(lens, unit)
        return PiecePlan(None, None, units, none, one_zero, n_rows, units.shape[0] - 1, 0)
    n_pieces = int(n_per.sum())
    row_of = torch.repeat_interleave(torch.arange(n_rows, device=dev), n_per, output_size=n_pieces)
    first = torch.cumsum(n_per, 0) - n_per  # each row's first piece
    k = torch.arange(n_pieces, device=dev) - first[row_of]  # the piece's place in its row
    piece_ptr = torch.cat([ptr.long()[row_of] + k * cap, ptr[-1:].long()])
    split = n_per > 1
    split_rows = torch.nonzero(split).flatten()
    split_ptr = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), torch.cumsum(n_per[split_rows], 0)])
    rank = torch.cumsum(split.long(), 0) - 1  # a split row's place among the split rows
    slot = split_ptr[rank.clamp(min=0)[row_of]] + k
    piece_out = torch.where(split[row_of], -1 - slot, row_of)
    units = _units(piece_ptr[1:] - piece_ptr[:-1], unit)
    return PiecePlan(piece_ptr.int(), piece_out.int(), units, split_rows.int(), split_ptr.int(),
                     n_pieces, units.shape[0] - 1, int(split_ptr[-1]))


def piece_order_sum(msg: torch.Tensor, ptr: torch.Tensor, cap: int = CAP) -> torch.Tensor:
    """[nnz, W] f32 per-entry rows -> [R, W] row sums in the order of the
    walk kernels: each piece of `piece_plan(ptr, cap)` summed alone in entry
    order, then each split row's pieces added in piece order. A plain
    function for the tests of that order; no wrapper calls it."""
    plan = piece_plan(ptr, cap)
    piece_ptr = ptr if plan.piece_ptr is None else plan.piece_ptr
    piece = torch.repeat_interleave(torch.arange(plan.n_pieces, device=msg.device),
                                    (piece_ptr[1:] - piece_ptr[:-1]).long(), output_size=msg.shape[0])
    sums = torch.zeros((plan.n_pieces, msg.shape[1]), dtype=msg.dtype, device=msg.device)
    sums.index_add_(0, piece, msg)
    if plan.piece_out is None:
        return sums
    y = torch.zeros((ptr.shape[0] - 1, msg.shape[1]), dtype=msg.dtype, device=msg.device)
    whole = plan.piece_out >= 0
    y[plan.piece_out[whole].long()] = sums[whole]
    slots = torch.empty((plan.n_slots, msg.shape[1]), dtype=msg.dtype, device=msg.device)
    slots[(-1 - plan.piece_out[~whole]).long()] = sums[~whole]
    for r, s0, s1 in zip(plan.split_rows.tolist(), plan.split_ptr[:-1].tolist(), plan.split_ptr[1:].tolist()):
        acc = torch.zeros_like(slots[s0])
        for s in range(s0, s1):
            acc = acc + slots[s]
        y[r] = acc
    return y


_plans: Dict[int, Tuple[weakref.ref, int, int, dict]] = {}
_plans_lock = threading.Lock()


def _memo(ptr: torch.Tensor, name: str, build):
    """`build()`, computed once per ptr tensor (and again if it was written
    in place) and kept under `name` until the tensor is freed."""
    key = id(ptr)
    hit = _plans.get(key)
    if hit is None or hit[0]() is not ptr or hit[1] != ptr._version or hit[2] != ptr.data_ptr():
        with _plans_lock:
            hit = (weakref.ref(ptr, lambda _, k=key: _plans.pop(k, None)), ptr._version,
                   ptr.data_ptr(), {})
            _plans[key] = hit
    if name not in hit[3]:
        hit[3][name] = build()
    return hit[3][name]


def _cached_plan(ptr: torch.Tensor) -> Tuple[PiecePlan, tuple]:
    """(piece_plan(ptr), its launch arguments), built once per ptr tensor."""
    def build():
        plan = piece_plan(ptr)
        return plan, plan.launch_args(ptr)
    return _memo(ptr, "plan", build)


WALK_UNITS = 8  # units one block of the attention walks takes (csrc/walk.cuh)


def entry_rows(ptr: torch.Tensor) -> torch.Tensor:
    """[nnz] int32: the row of each CSR entry (for the destination CSR, each
    edge's dst; for the transpose CSR, each entry's source)."""
    lens = (ptr[1:] - ptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(lens.shape[0], device=ptr.device, dtype=torch.int32),
                                   lens, output_size=int(ptr[-1]))


def block_entries(plan: PiecePlan, ptr: torch.Tensor) -> int:
    """The most entries that WALK_UNITS consecutive units of the plan hold:
    a block's share of the attention walk, which it stages in shared
    memory."""
    if plan.n_units == 0:
        return 0
    piece_ptr = ptr if plan.piece_ptr is None else plan.piece_ptr
    starts = piece_ptr[plan.unit_ptr[::WALK_UNITS].long()].long()
    ends = torch.cat([starts[1:], piece_ptr[-1:].long()])
    return int((ends - starts).max())


def cached_walk(ptr: torch.Tensor) -> Tuple[tuple, torch.Tensor, int]:
    """The attention walk's inputs for `ptr`, built once per ptr tensor: the
    plan's launch arguments, each entry's row (`entry_rows`) and the most
    entries a block holds (`block_entries`)."""
    plan, args = _cached_plan(ptr)
    return args, _memo(ptr, "rows", lambda: entry_rows(ptr)), \
        _memo(ptr, "block_entries", lambda: block_entries(plan, ptr))


def spmm_csr_plain(x: torch.Tensor, values: torch.Tensor, ptr: torch.Tensor, idx: torch.Tensor,
                   rows_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y [len(ptr) - 1, D] f32: y_r = sum over entries k of row r of
    values_k * round(x[idx_k]), round = to `rows_dtype` and back to f32."""
    n_rows = ptr.shape[0] - 1
    counts = (ptr[1:] - ptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n_rows, device=x.device), counts,
                                  output_size=idx.shape[0])
    rows = x.to(rows_dtype).float()[idx.long()]
    y = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    return y.index_add_(0, seg, values[:, None] * rows)


def _check(x, values, ptr, idx, rows_dtype):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be a float32 or bfloat16 [N, D] tensor; got {x.dtype} {tuple(x.shape)}")
    d = x.shape[1]
    if d % 32 != 0 or d > 512:
        raise ValueError(f"spmm_csr takes D a multiple of 32 up to 512; got D={d}")
    if rows_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rows_dtype must be float32 or bfloat16; got {rows_dtype}")
    for name, t, dt in (("values", values, torch.float32), ("ptr", ptr, torch.int32),
                        ("idx", idx, torch.int32)):
        if t.dim() != 1 or t.dtype != dt or t.device != x.device:
            raise ValueError(f"{name} must be a 1-d {dt} tensor on {x.device}")
    if values.shape != idx.shape or ptr.shape[0] < 1:
        raise ValueError("values and idx must have one entry per CSR entry, ptr at least one")


def spmm_csr(x: torch.Tensor, values: torch.Tensor, ptr: torch.Tensor, idx: torch.Tensor,
             rows_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel 7. x [N, D] f32 or bf16 (D a multiple of 32, <= 512), values
    [nnz] f32, ptr [R + 1] and idx [nnz] int32 (a CSR whose entries name x
    rows) -> y [R, D] f32. Launches `csrc/spmm_csr.cu` for CUDA tensors; runs
    `spmm_csr_plain` for CPU tensors."""
    _check(x, values, ptr, idx, rows_dtype)
    if x.is_cpu:
        return spmm_csr_plain(x, values, ptr, idx, rows_dtype)
    xs = cb.aligned(x.to(rows_dtype))  # the kernel reads rows in 16-byte loads
    return _launch(xs, values.contiguous(), ptr.contiguous(), idx.contiguous(), LAUNCHES)


def _launch(xs, values, ptr, idx, counter):
    """One call of `csrc/spmm_csr.cu` over x rows `xs` (a contiguous array,
    or a column strip of one: the row stride is passed), walking the cached
    piece plan of `ptr`; values or idx may be None (unit weights; entry e
    reads row e). One count on `counter`."""
    n_rows, d = ptr.shape[0] - 1, xs.shape[1]
    _, (piece_ptr, piece_out, unit_ptr, n_slots, split_rows, split_ptr, n_units, n_split) = \
        _cached_plan(ptr)
    dev = xs.device
    y = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_slots, d), dtype=torch.float32, device=dev) if n_split else None
    cb.launch("spmm_csr", dev, xs.data_ptr(), int(xs.dtype == torch.bfloat16), cb.ptr(values),
              piece_ptr, cb.ptr(idx), piece_out, unit_ptr, y.data_ptr(), cb.ptr(scratch),
              split_rows, split_ptr, n_units, n_split, d, xs.stride(0))
    counter.bump()
    return y


STRIP = 512  # the widest row kernel 7 takes


def spmm_gathered_plain(rows: torch.Tensor, values, ptr: torch.Tensor) -> torch.Tensor:
    """y [len(ptr) - 1, W] f32: y_r = sum over entries e of row r of
    values_e * rows[e] (values None: unit weights), rows [E, W] f32."""
    n_rows = ptr.shape[0] - 1
    counts = (ptr[1:] - ptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n_rows, device=rows.device), counts,
                                  output_size=rows.shape[0])
    msg = rows if values is None else values[:, None] * rows
    y = torch.zeros((n_rows, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return y.index_add_(0, seg, msg)


def spmm_gathered(rows: torch.Tensor, values, ptr: torch.Tensor, counter) -> torch.Tensor:
    """`spmm_gathered_plain`'s function on kernel 7 in its pre-gathered mode,
    one launch per column strip of <= 512 (the reduce is separable by
    column), each counted on `counter`. rows [E, W] f32 with E = ptr[-1];
    values [E] f32 or None; ptr int32. Runs the plain version for CPU
    tensors."""
    if rows.dim() != 2 or rows.dtype != torch.float32:
        raise ValueError(f"rows must be a float32 [E, W] tensor; got {rows.dtype} {tuple(rows.shape)}")
    if ptr.dim() != 1 or ptr.dtype != torch.int32 or ptr.device != rows.device or ptr.shape[0] < 1:
        raise ValueError(f"ptr must be a non-empty 1-d int32 tensor on {rows.device}")
    if values is not None and (values.shape != (rows.shape[0],) or values.dtype != torch.float32
                               or values.device != rows.device):
        raise ValueError(f"values must be float32 [{rows.shape[0]}] on {rows.device}")
    if rows.is_cpu:
        return spmm_gathered_plain(rows, values, ptr)
    w = rows.shape[1]
    xs = cb.aligned(_padded(rows))
    v = None if values is None else values.contiguous()
    p = ptr.contiguous()
    ys = [_launch(xs[:, c0:c0 + STRIP], v, p, None, counter) for c0 in range(0, xs.shape[1], STRIP)]
    y = ys[0] if len(ys) == 1 else torch.cat(ys, 1)
    return y[:, :w] if y.shape[1] != w else y


def _csr_spmm(x, values, ptr, idx, rows_dtype, plain):
    return (spmm_csr_plain if plain else spmm_csr)(x, values, ptr, idx, rows_dtype)


def _padded(x: torch.Tensor) -> torch.Tensor:
    pad = -x.shape[1] % 32
    return F.pad(x, (0, pad)) if pad else x


class _StaticSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op, ctx.plain = op, reference_active()
        g = op.graph
        return _csr_spmm(x, op.values, g.row_ptr, g.src, op.xs_dtype, ctx.plain)

    @staticmethod
    def backward(ctx, gy):
        op = ctx.op
        g = op.graph
        return _csr_spmm(gy.contiguous(), op.values_t, g.t_ptr, g.t_dst, op.xs_dtype, ctx.plain), None


class SpmmOperator:
    """y = A x for a fixed graph and edge values: the LightGCN propagation
    operator. The values are aligned on the host once, in canonical order
    for the destination CSR and in source order (`values[t_eid]`) for the
    transpose CSR the backward walks."""

    def __init__(self, graph: Graph, values, xs_dtype: torch.dtype = torch.bfloat16):
        v = np.asarray(values, dtype=np.float32)
        if v.shape != (graph.n_edges,):
            raise ValueError(f"values must be [{graph.n_edges}]; got {v.shape}")
        dev = graph.src.device
        self.graph, self.xs_dtype = graph, xs_dtype
        self.values = torch.as_tensor(v, device=dev)
        self.values_t = torch.as_tensor(v[graph.t_eid.cpu().numpy()], device=dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, D] f32 -> y [N, D] f32; differentiable in x. The backward
        rounds the cotangent to `xs_dtype`, as the JAX operator does."""
        d = x.shape[1]
        y = _StaticSpmm.apply(_padded(x), self)
        return y[:, :d] if y.shape[1] != d else y


def make_spmm(graph: Graph, values, xs_dtype: torch.dtype = torch.bfloat16) -> SpmmOperator:
    """The static operator of `graph` with edge `values` [E] (canonical
    order, host array or tensor)."""
    return SpmmOperator(graph, values, xs_dtype)


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, x, graph, xs_dtype):
        ctx.save_for_backward(values, x)
        ctx.graph = graph
        return spmm_csr(x, values, graph.row_ptr, graph.src, xs_dtype)

    @staticmethod
    def backward(ctx, gy):
        values, x = ctx.saved_tensors
        g = ctx.graph
        gy = gy.contiguous()
        dv = dx = None
        if ctx.needs_input_grad[0]:
            dv = (gy[g.dst.long()] * x[g.src.long()]).sum(1)
        if ctx.needs_input_grad[1]:
            dx = spmm_csr(gy, values[g.t_eid.long()], g.t_ptr, g.t_dst, torch.float32)
        return dv, dx, None, None


def spmm(graph: Graph, values: torch.Tensor, x: torch.Tensor,
         xs_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y[d] = sum over edges s -> d of values_e * x[s], [N, F] -> [N, F], with
    `values` [E] (canonical order) as an input: the counterpart of
    `spmm_pallas`. The forward is kernel 7 at `xs_dtype` rows; the gradient
    to x is kernel 7 over the transpose CSR at f32 rows and the gradient to
    values is dv_e = g_dst . x_src, the function JAX's backward (the XLA
    golden's) computes."""
    d = x.shape[1]
    y = _Spmm.apply(values, _padded(x), graph, xs_dtype)
    return y[:, :d] if y.shape[1] != d else y
