"""f32 dense products on the card's tensor cores, f32-faithful: three TF32
passes over a hi/lo split (3xTF32), for the HGT layer's typed products.

Port-only (the JAX package leaves dense products to XLA). Two entry points,
each differentiable in its inputs:
  linear_into(x, plan, w, b)  products of row blocks of x, each with its own
                              weight, their columns laid into new tables
                              (the HGT layer's typed products straight into
                              its q and kv tables, with no copy between)
  linear(x, w, b)             x @ w + b, the plan of one part and one table
For CPU tensors, and on any device inside `reference_versions()`, they are
`torch.addmm` (or `x @ w` without a bias), `split` and `cat`, autograd and
all. On the card the autograd op `LinearInto` launches
`csrc/dense_3xtf32.cu` for each product and its gradients:
  forward  y  = x w + b     `mm`, mode 0, on w's split transposed
                            (`split_weight`, a mode 2 launch), the bias in
                            the epilogue, y written through a table of
                            128-column blocks
  backward dx = g w^T       `mm_y`, mode 3, on w's split as it is (mode 2),
                            g read through the table
           dw = x^T g       `mm_tn`, mode 1, split over the rows (K) so that
                            about one block runs on each SM, the partial
                            slabs summed in split order by a second launch
           db = g.sum(0)    a torch reduction
`COUNTERS["dense_3xtf32"]` counts products (one a mode 0, 1 or 3 launch):
36 a HGT training step, 12 an eval forward. Each forward and dx product
also launches w's split, and each dw the slabs' sum (where K is split),
which are not counted: at hgt-amazon's sizes 72 device launches a training
step in all, 24 an eval forward.

The split (`tf32_split`, and the kernel's in registers): hi = x rounded to
the nearest TF32 value, ties away from zero (`cvt.rna.tf32.f32`), lo = x - hi
rounded the same way. A product sums lo_a hi_b + hi_a lo_b + hi_a hi_b in f32
(lo_a lo_b, at most 2^-22 |a b|, is dropped, as kernel 10 drops it); its
error against f64 is that of a plain f32 product (`mm_3xtf32_plain`, the
CPU emulation the tests hold to 2x plain f32's at K 256 and 63,001). The
tensor cores sum 32 of K at a time; the CUDA cores add those partials,
rounding to nearest (the tensor cores' own accumulation is not). TF32 stays
off for every other product (`torch.backends.cuda.matmul`).

On the card the kernel takes x [M, K] f32, any M >= 1, and w [K, N] with K
and N multiples of 128 (`takes`; dx's N is K): `LinearInto` raises
ValueError for any other shape or dtype, and there is no other path on the
card. The result is the same bits on every run: no atomics, and the split
of K depends only on the shapes and the device's SM count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from plotpointe_tpu_torch import reference_active
from plotpointe_tpu_torch.ops import cuda_build as cb

LAUNCHES = cb.COUNTERS["dense_3xtf32"]
TILE_M, TILE_N, TILE_K = 128, 128, 32  # a block's rows and columns of C, and K a stage
MIN_CHUNK = 256  # the fewest rows of K a block of the weight gradient sums
MAX_Y_BLOCKS = 16  # 128-column blocks a Y table holds (csrc: MAX_YB)

# A plan of `linear_into`: the tables (rows, width) and the parts; part p is
# (r0, r1, dests): rows r0..r1 of x times the p-th weight, the product's
# columns going dest by dest, in order, to rows row0.. of table o for each
# (o, row0) of dests (a dest takes its table's whole width).
Plan = Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[int, int, Tuple[Tuple[int, int], ...]], ...]]


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 x, both TF32 values: hi = x rounded to the nearest
    TF32 value (ties away from zero), lo = x - hi rounded the same way."""
    hi = _rna(x.float())
    return hi, _rna(x - hi)


def _rna(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a @ b from the TF32 splits
    of both, lo_a hi_b + hi_a lo_b + hi_a hi_b, each product in f32 (every
    product of two TF32 values is exact in f32)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def takes(k: int, n: int) -> bool:
    """Whether the kernel takes a weight [k, n]: both multiples of 128."""
    return k > 0 and n > 0 and k % TILE_N == 0 and n % TILE_N == 0


def _plain(x: torch.Tensor) -> bool:
    return x.is_cpu or reference_active()


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [M, K] @ w [K, N] (+ b [N]): `linear_into` with one part and one
    table."""
    m, n = x.shape[0], w.shape[1]
    return linear_into(x, (((m, n),), ((0, m, ((0, 0),)),)), w, b)[0]


def linear_into(x: torch.Tensor, plan: Plan, *wbs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tables of `plan` (see `Plan`) from x [N, K] and each part's weight
    [K, N_p] and bias [N_p] (`wbs`: w_0, b_0, w_1, b_1, ...); N_p is the sum
    of its dests' widths. On the card each product writes its columns into
    the tables (ValueError for weights the kernel does not `take`); on the
    CPU and inside `reference_versions()` `torch.addmm`, `split` and `cat`."""
    if not _plain(x):
        return LinearInto.apply(x, plan, *wbs)
    tables, parts = plan
    pieces = [[] for _ in tables]
    for (r0, r1, dests), w, b in zip(parts, wbs[0::2], wbs[1::2]):
        y = x[r0:r1] @ w if b is None else torch.addmm(b, x[r0:r1], w)
        for (o, row0), piece in zip(dests, y.split([tables[o][1] for o, _ in dests], 1)):
            pieces[o].append((row0, piece))
    ys = [[y for _, y in sorted(p, key=lambda e: e[0])] for p in pieces]
    return tuple(torch.cat(y) if len(y) > 1 else y[0] for y in ys)


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------


def _rows(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dim() != 2 or t.dtype != torch.float32 or not t.is_cuda:
        raise ValueError(f"{name} must be a 2-d float32 CUDA tensor; got {t.dtype} {tuple(t.shape)} on {t.device}")
    return cb.aligned(t)


def _need(cond: bool, what: str, shape) -> None:
    if not cond:
        raise ValueError(f"dense_3xtf32 takes {what}; got {tuple(shape)}")


def _table(views: Sequence[torch.Tensor]):
    """The kernel's Y table of `views` (f32 [rows, width] each, laid side by
    side): one (pointer, row stride) pair a 128-column block. Keep the
    returned array alive until the launch returns."""
    vals = []
    for v in views:
        _need(v.dim() == 2 and v.dtype == torch.float32 and v.stride(1) == 1 and v.data_ptr() % 16 == 0
              and v.stride(0) % 4 == 0 and v.shape[1] % TILE_N == 0 and v.shape[0] == views[0].shape[0],
              f"float32 row slices {TILE_N} columns wide, 16-byte aligned", v.shape)
        vals += [x for j in range(v.shape[1] // TILE_N) for x in (v.data_ptr() + 4 * TILE_N * j, v.stride(0))]
    _need(0 < len(vals) <= 2 * MAX_Y_BLOCKS, f"at most {MAX_Y_BLOCKS * TILE_N} columns", (len(vals) // 2,))
    return (ctypes.c_longlong * len(vals))(*vals)


def split_weight(w: torch.Tensor, transpose: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of w [R, C] (mode 2), as [R, C] or transposed [C, R]."""
    r, c = w.shape
    shape = (c, r) if transpose else (r, c)
    hi = torch.empty(shape, dtype=torch.float32, device=w.device)
    lo = torch.empty_like(hi)
    cb.launch("dense_3xtf32", w.device, 2, w.data_ptr(), hi.data_ptr(), lo.data_ptr(), None, None, None, None,
              r, c, int(transpose), 0, 0)
    return hi, lo


def mm(a: torch.Tensor, bt: Tuple[torch.Tensor, torch.Tensor], bias: Optional[torch.Tensor],
        out: Sequence[torch.Tensor]) -> None:
    """Mode 0: out = a [M, K] @ B (+ bias) with bt = the split of B^T, [N, K];
    out's views [M, width] side by side make up the N columns."""
    m, k = a.shape
    n = bt[0].shape[0]
    _need(m >= 1 and k >= TILE_K and k % TILE_K == 0 and n % TILE_N == 0,
          f"K a multiple of {TILE_K} and N of {TILE_N}", (m, k, n))
    table = _table(out)
    _need(len(table) == 2 * n // TILE_N and out[0].shape[0] == m, "outputs as wide and as long as C", (m, n))
    cb.launch("dense_3xtf32", a.device, 0, a.data_ptr(), bt[0].data_ptr(), bt[1].data_ptr(), cb.ptr(bias), None,
              None, ctypes.addressof(table), m, n, k, 1, 0)
    LAUNCHES.bump()


def mm_y(y: Sequence[torch.Tensor], bt: Tuple[torch.Tensor, torch.Tensor], out: torch.Tensor) -> None:
    """Mode 3: out [M, N] = Y @ B with Y the views [M, width] side by side (K
    columns) and bt = the split of B^T, [N, K]."""
    table = _table(y)
    m, k, n = y[0].shape[0], len(table) // 2 * TILE_N, bt[0].shape[0]
    _need(m >= 1 and n % TILE_N == 0 and tuple(out.shape) == (m, n) and out.is_contiguous()
          and out.data_ptr() % 16 == 0, f"N a multiple of {TILE_N} and a contiguous out", (m, k, n))
    cb.launch("dense_3xtf32", out.device, 3, None, bt[0].data_ptr(), bt[1].data_ptr(), None, out.data_ptr(), None,
              ctypes.addressof(table), m, n, k, 1, 0)
    LAUNCHES.bump()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_split(k: int, tiles: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk) of mode 1's K rows: about one block on each SM over
    the `tiles` output tiles, chunks a multiple of 32 rows, at least
    MIN_CHUNK, every split non-empty."""
    want = max(1, sms // tiles)
    chunk = max(MIN_CHUNK, -(-k // want))
    chunk = -(-chunk // TILE_K) * TILE_K
    return -(-k // chunk), chunk


def mm_tn(x: torch.Tensor, y: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mode 1: x [K, M]^T @ Y -> [M, N], Y the views [K, width] side by side
    (N columns)."""
    k, m = x.shape
    table = _table(y)
    n = len(table) // 2 * TILE_N
    _need(y[0].shape[0] == k and k >= 1 and m % TILE_M == 0,
          f"x^T Y with x's width a multiple of {TILE_M}", (k, m, n))
    splits, chunk = k_split(k, (m // TILE_M) * (n // TILE_N), _sm_count(x.device.index))
    c = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    cb.launch("dense_3xtf32", x.device, 1, x.data_ptr(), None, None, None, c.data_ptr(), cb.ptr(ws),
              ctypes.addressof(table), m, n, k, splits, chunk)
    LAUNCHES.bump()
    return c


def _tiles(spans, n: int) -> bool:
    """Whether the row ranges `spans` cover 0..n once each."""
    spans = sorted(spans)
    return (bool(spans) and spans[0][0] == 0 and spans[-1][1] == n
            and all(a[1] == b[0] for a, b in zip(spans, spans[1:])))


def _checked(x: torch.Tensor, wbs: Sequence[Optional[torch.Tensor]]):
    x = _rows("x", x)
    out = []
    for w, b in zip(wbs[0::2], wbs[1::2]):
        w = _rows("w", w)
        _need(x.shape[1] == w.shape[0] and takes(*w.shape),
              f"x [M, K] and w [K, N], K and N multiples of {TILE_N}", (*x.shape, *w.shape))
        if b is not None:
            b = cb.aligned(b)
            _need(b.shape == (w.shape[1],) and b.dtype == torch.float32, "a float32 bias [N]", b.shape)
        out += [w, b]
    return x, out


class LinearInto(torch.autograd.Function):
    """`linear_into` on the 3xTF32 kernel (CUDA tensors): each part's product
    written into the tables and, in the backward, its gradient read from the
    tables' gradients in place."""

    @staticmethod
    def forward(ctx, x, plan, *wbs):
        tables, parts = plan
        x, wbs = _checked(x, wbs)
        _need(_tiles([(r0, r1) for r0, r1, _ in parts], x.shape[0])
              and all(_tiles([(row0, row0 + r1 - r0) for r0, r1, dests in parts for o, row0 in dests if o == t],
                             rows) for t, (rows, _) in enumerate(tables)),
              "parts that cover x's rows and every table's rows once each", x.shape)
        outs = [torch.empty(shape, dtype=torch.float32, device=x.device) for shape in tables]
        for (r0, r1, dests), w, b in zip(parts, wbs[0::2], wbs[1::2]):
            _need(r1 > r0 and sum(tables[o][1] for o, _ in dests) == w.shape[1],
                  "a part's dests as wide as its weight", w.shape)
            mm(x[r0:r1], split_weight(w, transpose=True), b,
                [outs[o][row0:row0 + r1 - r0] for o, row0 in dests])
        ctx.save_for_backward(x, *wbs[0::2])
        ctx.plan, ctx.has_bias = plan, [b is not None for b in wbs[1::2]]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *g_outs):
        """dx (each part's rows written in place), and each part's dw and db
        from the views of its product's gradient in the tables' gradients."""
        x, *ws = ctx.saved_tensors
        _, parts = ctx.plan
        needs = ctx.needs_input_grad
        g_outs = [_rows("g", g) for g in g_outs]
        dx = torch.empty_like(x) if needs[0] else None
        dwbs = []
        for (r0, r1, dests), w, has_bias, need_w, need_b in zip(parts, ws, ctx.has_bias, needs[2::2], needs[3::2]):
            g = [g_outs[o][row0:row0 + r1 - r0] for o, row0 in dests]
            if dx is not None:
                mm_y(g, split_weight(w, transpose=False), dx[r0:r1])
            dwbs.append(mm_tn(x[r0:r1], g) if need_w else None)
            dwbs.append(torch.cat([v.sum(0) for v in g]) if has_bias and need_b else None)
        return (dx, None, *dwbs)
