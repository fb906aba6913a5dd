"""Kernel 4's numerics on the CPU: a plain emulation of the tensor-core
phase 1 of `csrc/topk_chunkmax.cu` for f32 tables, three TF32 passes over
the hi/lo split of `split_tf32` (lo_x.hi_q + hi_x.lo_q + hi_x.hi_q, each lo
truncated to TF32 as the tensor core reads it), held to the plain chunk max
and, run through `topk_mips` in place of `chunk_max`, to the JAX package's
XLA top-K (`topk_mips_xla`, as tests/test_torch_topk.py calls it).

Tolerances: chunk maxima within SCORE_TOL of the f32 ones (rtol 1e-5 /
atol 1e-4, `chip_smoke.py`: f32 scores of width 64-128 in another order of
sums; the dropped lo.lo term is <= 2**-22 of each product, lo's truncation
<= 2**-21), and within 1e-5 of the f64 scores at unit-scale rows; top-k
scores rtol 1e-4 / atol 1e-5 against JAX (tests/test_torch_topk.py) and
indices equal wherever no tie within 1e-5 straddles a place.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plotpointe_tpu.ops.topk_kernel import topk_mips_xla
from plotpointe_tpu_torch.ops import topk_kernel
from plotpointe_tpu_torch.ops.knn_kernel import split_tf32
from plotpointe_tpu_torch.ops.topk_kernel import (
    CHUNK, NEG_INF, chunk_max_plain, n_chunks_of, untied)

SCORE_TOL = dict(rtol=1e-5, atol=1e-4)
TOL = dict(rtol=1e-4, atol=1e-5)
LOW13 = 0x1FFF


def _truncate_tf32(x):
    return (x.contiguous().view(torch.int32) & ~LOW13).view(torch.float32)


def scores_3xtf32(items, queries, dtype=torch.float32):
    """[B, N]: the kernel's three passes, each product of two TF32 values
    exact in f32, summed in `dtype`, the small terms first."""
    hx, lx = split_tf32(items.float())
    hq, lq = split_tf32(queries.float())
    hx, hq = hx.to(dtype), hq.to(dtype)
    lx, lq = _truncate_tf32(lx).to(dtype), _truncate_tf32(lq).to(dtype)
    return hq @ lx.T + lq @ hx.T + hq @ hx.T


def chunk_max_3xtf32(items, queries):
    """Phase 1 on the emulated scores: [B, ceil(N / 128)] f32 chunk maxima."""
    s = scores_3xtf32(items, queries)
    pad = n_chunks_of(items.shape[0]) * CHUNK - items.shape[0]
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    return s.view(s.shape[0], -1, CHUNK).amax(dim=2)


def _table(n, d, seed, ties=0):
    """Normal rows; `ties` of them copies of others (exact ties in every
    query's scores)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if ties:
        src, dst = rng.choice(n, size=(2, ties), replace=False)
        x[dst] = x[src]
    return x, rng.normal(size=(16, d)).astype(np.float32)


@pytest.mark.parametrize("n,d", [(1037, 128), (3000, 64), (700, 32)])
def test_emulated_phase1_matches_f32_and_f64(n, d):
    x, q = map(torch.from_numpy, _table(n, d, n + d))
    got = chunk_max_3xtf32(x, q)
    torch.testing.assert_close(got, chunk_max_plain(x, q), **SCORE_TOL)
    s64 = scores_3xtf32(x, q, torch.float64)
    torch.testing.assert_close(s64, q.double() @ x.double().T, rtol=0.0, atol=1e-5)
    assert got.shape == (16, n_chunks_of(n))


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_topk_with_emulated_phase1_matches_jax_xla(monkeypatch, mode):
    """A 3,037-item catalog (a ragged last chunk of 93 items) with 150
    planted copies: `topk_mips` with the emulated phase 1 returns JAX's
    top-k, the copies' tied places aside."""
    n, d, k = 3037, 64, 20
    x, q = _table(n, d, 11, ties=150)
    q[0] = x[n - 1] * 2.0  # a query whose best item lies in the ragged tail chunk
    monkeypatch.setattr(topk_kernel, "chunk_max", chunk_max_3xtf32)
    gi, gv = topk_kernel.topk_mips(torch.from_numpy(x), torch.from_numpy(q), k, mode=mode)
    ji, jv = map(np.asarray, topk_mips_xla(jnp.asarray(x), jnp.asarray(q), k + 1))
    # the (k + 1)-th score shows a tie at the last place
    keep = untied(torch.from_numpy(jv), rtol=0.0, atol=1e-5).numpy()
    ji, jv = ji[:, :k], jv[:, :k]
    np.testing.assert_allclose(gv.numpy(), jv, **TOL)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(gi.numpy()[keep], ji[keep])
    assert int(gi[0, 0]) == n - 1 or np.array_equal(x[int(gi[0, 0])], x[n - 1])
