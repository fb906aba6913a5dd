"""Kernel 10's numerics on the CPU: the 3xTF32 split of the wrapper
(`split_tf32`) and a plain emulation of the kernel's three TF32 passes
(lo.hi^T + hi.lo^T + hi.hi^T, lo truncated to TF32 as the tensor core reads
it), held to f32 scores, to kernel 10's plain version and, through the exact
re-score, to the JAX package's `cosine_knn` (Pallas in interpret mode).

Tolerances: the three passes summed in f64 within 1e-6 of the f64 product
on unit rows (the dropped lo.lo^T term is <= 2^-22, lo's truncation
<= 2^-21); summed in f32 within 2e-6 of f32 x.x^T (each side's own f32
rounding reaches ~1e-6 at d = 384, in another order of sums); candidate
columns equal wherever no tie within 1e-5 straddles a place
(`chip_smoke.py`'s TIE_TOL); similarities rtol 1e-4 / atol 1e-5 against
JAX (tests/test_knn.py:54).
"""
import numpy as np
import pytest
import torch

from plotpointe_tpu.graphs import knn as jknn
from plotpointe_tpu_torch.graphs.knn import l2_normalize
from plotpointe_tpu_torch.ops.knn_kernel import (
    NEG_INF, knn_candidates_plain, order_keys, rescore_topk, split_tf32)

LOW13 = 0x1FFF


def _knn_rows(n, d, seed):
    """The card tests' rows: clusters around n // 30 centres, 5% copies of
    other rows (exact ties) and one zero row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(max(1, n // 30), d))[rng.integers(0, max(1, n // 30), n)]
    x = (x + 0.65 * rng.normal(size=(n, d))).astype(np.float32)
    src, dst = rng.choice(n, size=(2, max(1, n // 20)), replace=False)
    x[dst] = x[src]
    x[n // 2] = 0.0
    return x


def _truncate_tf32(x):
    return (x.contiguous().view(torch.int32) & ~LOW13).view(torch.float32)


def _scores_3xtf32(xn, dtype=torch.float32):
    """The kernel's three passes, each product of two TF32 values exact in
    f32, summed in `dtype` in the kernel's order of terms."""
    hi, lo = split_tf32(xn)
    hi, lo = hi.to(dtype), _truncate_tf32(lo).to(dtype)
    return lo @ hi.T + hi @ lo.T + hi @ hi.T


def _candidates_3xtf32(xn, r):
    """Kernel 10's function on the emulated scores: the top-R columns by the
    total order, self excluded, -1 / -1e30 where a row has fewer."""
    n = xn.shape[0]
    s = _scores_3xtf32(xn)
    s.fill_diagonal_(float("-inf"))
    m = min(r, n)
    top = torch.topk(order_keys(s, torch.arange(n).expand_as(s)), m, dim=1).indices
    v = torch.gather(s, 1, top)
    real = v > NEG_INF / 2
    ci = torch.full((n, r), -1, dtype=torch.int32)
    cs = torch.full((n, r), NEG_INF)
    ci[:, :m] = torch.where(real, top, -1).to(torch.int32)
    cs[:, :m] = torch.where(real, v, NEG_INF)
    return ci, cs


def test_split_is_exact_and_tf32(rng):
    x = np.concatenate([rng.normal(size=5000), rng.normal(size=500) * 1e-30, [0.0, -0.0, 1.0, -3.5]])
    x = torch.as_tensor(x.astype(np.float32))
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert (hi.view(torch.int32) & LOW13 == 0).all()
    assert torch.equal(hi + lo, x)
    assert (lo.abs() <= x.abs() * 2.0 ** -11).all()
    # round to nearest: no TF32 value lies closer to x than hi
    assert (lo.abs() <= (x - _truncate_tf32(x)).abs()).all()


@pytest.mark.parametrize("n,d", [(300, 64), (777, 384), (517, 128)])
def test_emulated_3xtf32_matches_f32_and_the_plain_version(n, d):
    xn = l2_normalize(torch.as_tensor(_knn_rows(n, d, n + d)))
    x64 = xn.double()
    torch.testing.assert_close(_scores_3xtf32(xn, torch.float64), x64 @ x64.T, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(_scores_3xtf32(xn), xn @ xn.T, rtol=0.0, atol=2e-6)
    r = 28
    got_i, got_s = _candidates_3xtf32(xn, r)
    want_i, want_s = knn_candidates_plain(xn, r + 1)
    torch.testing.assert_close(got_s, want_s[:, :r], rtol=0.0, atol=2e-6)
    gap = (want_s[:, :-1] - want_s[:, 1:]).abs() <= 1e-5
    tied = gap.clone()
    tied[:, 1:] |= gap[:, :-1]
    assert int(((got_i != want_i[:, :r]) & ~tied).sum()) == 0


def test_emulated_3xtf32_edges_match_jax_cosine_knn():
    n, d, k, min_sim = 300, 64, 10, 0.3
    x = _knn_rows(n, d, 3)
    xn = l2_normalize(torch.as_tensor(x))
    ci, _ = _candidates_3xtf32(xn, k + 8)  # R of exact mode
    idx, sim = rescore_topk(xn, ci, k)
    idx, sim = idx.numpy(), sim.numpy()
    valid = (sim >= min_sim) & (idx >= 0)
    ji, js, jv = jknn.cosine_knn(x, k=k, min_similarity=min_sim, impl="pallas")
    np.testing.assert_allclose(sim, js, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(valid, jv)
    # indices agree wherever no tie within 1e-5 straddles a place
    tied = np.zeros_like(valid)
    gap = np.abs(np.diff(js, axis=1)) <= 1e-5
    tied[:, :-1] |= gap
    tied[:, 1:] |= gap
    assert ((idx != ji) & ~tied).sum() == 0
