"""The plan of kernel 7's row walk (`ops/spmm_kernel.piece_plan`) on the
CPU: every entry covered exactly once, in order, no piece longer than the
cap, each piece inside its row, units that tile the pieces with no lane
group walking more than UNIT + CAP entries; and the kernel's order of sums
(`_pieces_in_order`: pieces summed alone, split rows combined in piece
order) against the plain reduce, rtol 1e-5 / atol 1e-6 (the same f32
products summed in another order)."""
import gc

import numpy as np
import pytest
import torch

from plotpointe_tpu_torch.ops import spmm_kernel
from plotpointe_tpu_torch.ops.spmm_kernel import (
    CAP, UNIT, piece_order_sum, piece_plan, spmm_csr_plain, spmm_gathered_plain)

TOL = dict(rtol=1e-5, atol=1e-6)


def _pieces_in_order(x, values, ptr, idx, rows_dtype, cap):
    """csrc/spmm_csr.cu's function in its order of sums (`piece_order_sum`:
    each piece of `piece_plan(ptr, cap)` summed alone, then each split row's
    pieces added in piece order). values None: unit weights; idx None:
    entry e reads x row e."""
    rows = x.to(rows_dtype).float()[idx.long() if idx is not None else slice(0, int(ptr[-1]))]
    return piece_order_sum(rows if values is None else values[:, None] * rows, ptr, cap)


def _ptr(lens):
    return torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))


def _lens(rng):
    """A row of 10,000 entries (above any cap), a run of empty rows, a
    single-entry row, rows at and around the cap, and lognormal rows."""
    return np.concatenate([[10_000], np.zeros(5, int), [1], [CAP, CAP + 1, 2 * CAP, 0],
                           rng.lognormal(1.5, 1.5, 300).astype(int)])


@pytest.mark.parametrize("cap", [CAP, 7])
def test_plan_covers_every_entry_once_within_cap(cap):
    lens = _lens(np.random.default_rng(0))
    ptr = _ptr(lens)
    plan = piece_plan(ptr, cap)
    pp = plan.piece_ptr.numpy().astype(np.int64)
    assert pp[0] == 0 and pp[-1] == lens.sum() and plan.n_pieces == len(pp) - 1
    size = np.diff(pp)
    assert (size >= 0).all() and size.max() <= cap
    n_per = np.maximum(1, -(-lens // cap))
    assert plan.n_pieces == n_per.sum()
    out = plan.piece_out.numpy()
    split_rows, split_ptr = plan.split_rows.numpy(), plan.split_ptr.numpy()
    assert list(split_rows) == list(np.nonzero(n_per > 1)[0])
    assert plan.n_slots == split_ptr[-1] == n_per[n_per > 1].sum()
    row_of_slot = np.repeat(split_rows, np.diff(split_ptr))
    rows = np.where(out >= 0, out, row_of_slot[np.clip(-1 - out, 0, None)])
    assert (np.diff(rows) >= 0).all() and np.array_equal(np.unique(rows), np.arange(len(lens)))
    p = ptr.numpy()
    assert (pp[:-1] >= p[rows]).all() and (pp[1:] <= p[rows + 1]).all()
    whole = n_per[rows] == 1
    assert (out[whole] >= 0).all() and (out[~whole] < 0).all()
    assert np.array_equal(np.sort(-1 - out[~whole]), np.arange(plan.n_slots))
    _check_units(plan.unit_ptr.numpy(), size, cap)


def _check_units(unit_ptr, piece_len, cap):
    """Units tile the pieces in order, none empty, each walking at most
    UNIT + cap entries; a unit starts where the pieces' running cost (each
    piece its entries plus one) crosses a multiple of UNIT."""
    assert unit_ptr[0] == 0 and unit_ptr[-1] == len(piece_len) and (np.diff(unit_ptr) > 0).all()
    entries = np.add.reduceat(piece_len, unit_ptr[:-1])
    assert entries.max() <= UNIT + cap
    start = np.cumsum(piece_len + 1) - (piece_len + 1)
    assert np.array_equal(np.unique(start // UNIT, return_index=True)[1], unit_ptr[:-1])


def test_plan_without_long_rows_is_the_csr_itself():
    lens = np.tile([3, 0, CAP, 1, 0, 0, 17], 40)
    plan = piece_plan(_ptr(lens))
    assert plan.piece_ptr is None and plan.piece_out is None and plan.n_pieces == len(lens)
    assert plan.n_slots == 0 and plan.split_rows.numel() == 0
    assert plan.n_units == len(plan.unit_ptr) - 1 > 1
    _check_units(plan.unit_ptr.numpy(), lens, CAP)
    empty = piece_plan(_ptr([]))
    assert empty.n_pieces == empty.n_units == 0


@pytest.mark.parametrize("cap", [CAP, 7])
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
def test_pieces_in_order_equal_the_plain_reduce(cap, rows_dtype):
    rng = np.random.default_rng(1)
    lens = _lens(rng)
    ptr = _ptr(lens)
    e, n = int(lens.sum()), len(lens)
    x = torch.as_tensor(rng.normal(size=(500, 32)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 500, e).astype(np.int32))
    # each row's weights sum to 1, as the operator's normalized values keep
    # the 10,000-entry row's sum within f32 reach of its terms
    v = torch.as_tensor((1.0 / np.repeat(np.maximum(lens, 1), lens)).astype(np.float32))
    got = _pieces_in_order(x, v, ptr, idx, rows_dtype, cap)
    torch.testing.assert_close(got, spmm_csr_plain(x, v, ptr, idx, rows_dtype), **TOL)
    assert torch.all(got[1:6] == 0)
    rows = torch.as_tensor(rng.normal(size=(e, 64)).astype(np.float32))
    for vals in (v, None):  # the pre-gathered modes: kernels 13 and 15
        want = spmm_gathered_plain(rows if vals is not None else rows * v[:, None], vals, ptr)
        got = _pieces_in_order(rows if vals is not None else rows * v[:, None], vals, ptr, None,
                                torch.float32, cap)
        torch.testing.assert_close(got, want, **TOL)


def test_plan_cache_is_per_ptr_tensor():
    ptr = _ptr([2 * CAP, 1, 0])
    first, args = spmm_kernel._cached_plan(ptr)
    assert spmm_kernel._cached_plan(ptr)[0] is first
    assert args == first.launch_args(ptr) and args[-2:] == (first.n_units, 1)
    assert spmm_kernel._cached_plan(ptr.clone())[0] is not first
    ptr[1:] += 1  # written in place: the plan is built again
    again = spmm_kernel._cached_plan(ptr)[0]
    assert again is not first and int(again.piece_ptr[-1]) == 2 * CAP + 2
    key = id(ptr)
    del ptr, first, again
    gc.collect()
    assert key not in spmm_kernel._plans


def test_walk_inputs_are_cached_beside_the_plan():
    """`cached_walk` (kernels 8 and 3): the plan's launch arguments, each
    entry's row and the most entries WALK_UNITS consecutive units hold, kept
    under the same ptr tensor as kernel 7's plan and rebuilt with it; other
    ptr tensors keep their own."""
    lens = _lens(np.random.default_rng(2))
    ptr = _ptr(lens)
    args, rows, most = spmm_kernel.cached_walk(ptr)
    plan = spmm_kernel._cached_plan(ptr)[0]
    assert args == plan.launch_args(ptr)
    assert np.array_equal(rows.numpy(), np.repeat(np.arange(len(lens)), lens))
    pp, up = plan.piece_ptr.numpy(), plan.unit_ptr.numpy()
    starts = pp[up[::spmm_kernel.WALK_UNITS]]
    assert most == np.diff(np.append(starts, pp[-1])).max() <= spmm_kernel.WALK_UNITS * (UNIT + CAP)
    again = spmm_kernel.cached_walk(ptr)
    assert again[1] is rows and again[2] == most
    other = _ptr(lens[::-1].copy())
    assert not torch.equal(spmm_kernel.cached_walk(other)[1], rows)
    assert spmm_kernel.cached_walk(ptr)[1] is rows
    ptr[1:] += 1  # written in place: everything is built again
    assert spmm_kernel.cached_walk(ptr)[1] is not rows
