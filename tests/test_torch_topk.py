"""Port top-K retrieval (plain path on the CPU) against brute force and the
JAX package's `topk_mips_pallas` (interpret mode) and `topk_mips_xla`.
Mirrors tests/test_topk_kernel.py. Scores are compared, not indices, since
ties may resolve to either index. Tolerance rtol 1e-4 / atol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plotpointe_tpu.ops.topk_kernel import topk_mips_pallas, topk_mips_xla
from plotpointe_tpu_torch.ops.topk_kernel import (
    chunk_max, n_chunks_of, rescore, topk_mips, topk_mips_ref)

TOL = dict(rtol=1e-4, atol=1e-5)


def _port(items, q, k, **kw):
    i, v = topk_mips(torch.from_numpy(items), torch.from_numpy(q), k, **kw)
    return i.numpy(), v.numpy()


@pytest.mark.parametrize("n,b,k", [(1000, 4, 10), (5000, 1, 20), (2048, 8, 5)])
def test_topk_matches_brute_and_jax(rng, n, b, k):
    items = rng.normal(size=(n, 64)).astype(np.float32)
    q = rng.normal(size=(b, 64)).astype(np.float32)
    gi, gv = _port(items, q, k)
    scores = q @ items.T
    want_i = np.argsort(-scores, axis=1)[:, :k]
    want_v = np.take_along_axis(scores, want_i, axis=1)
    np.testing.assert_allclose(gv, want_v, **TOL)
    assert (np.diff(gv, axis=1) <= 1e-6).all()
    np.testing.assert_allclose(np.take_along_axis(scores, gi.astype(np.int64), axis=1), want_v, **TOL)
    _, jv = topk_mips_pallas(jnp.asarray(items), jnp.asarray(q), k, block_items=512)
    np.testing.assert_allclose(gv, np.asarray(jv), **TOL)
    _, xv = topk_mips_xla(jnp.asarray(items), jnp.asarray(q), k)
    np.testing.assert_allclose(gv, np.asarray(xv), **TOL)


def test_reference_matches_jax_xla(rng):
    items = rng.normal(size=(3000, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    _, v = topk_mips_ref(torch.from_numpy(items), torch.from_numpy(q), 15)
    _, xv = topk_mips_xla(jnp.asarray(items), jnp.asarray(q), 15)
    np.testing.assert_allclose(v.numpy(), np.asarray(xv), **TOL)


def test_padding_not_selected(rng):
    items = rng.normal(size=(700, 16)).astype(np.float32)
    q = rng.normal(size=(2, 16)).astype(np.float32)
    gi, _ = _port(items, q, 10)
    assert (gi < 700).all() and (gi >= 0).all()


def test_tail_chunk_boundary(rng):
    """An item in the final, partial chunk must be retrievable: a planted
    max-aligned item at n - 1 surfaces at rank 1."""
    n, d = 1037, 32
    items = rng.normal(size=(n, d)).astype(np.float32)
    items[-1] = 3.0
    q = np.concatenate([items[-1:], rng.normal(size=(3, d)).astype(np.float32)])
    gi, _ = _port(items, q, 5)
    assert int(gi[0, 0]) == n - 1
    assert (gi < n).all() and (gi >= 0).all()
    ji, _ = topk_mips_pallas(jnp.asarray(items), jnp.asarray(q), 5, block_items=512)
    assert int(np.asarray(ji)[0, 0]) == n - 1


def test_fast_mode_matches_exact_at_serving_shapes(rng):
    items = rng.normal(size=(120_000, 64)).astype(np.float32)
    q = rng.normal(size=(16, 64)).astype(np.float32)
    xi, xv = topk_mips_xla(jnp.asarray(items), jnp.asarray(q), 20)
    fi, fv = _port(items, q, 20, mode="fast")
    ei, ev = _port(items, q, 20, mode="exact")
    np.testing.assert_allclose(ev, np.asarray(xv), **TOL)
    hit = np.mean([len(set(fi[r].tolist()) & set(np.asarray(xi[r]).tolist())) / 20 for r in range(16)])
    assert hit >= 0.98, hit
    np.testing.assert_allclose(fv[:, 0], np.asarray(xv[:, 0]), rtol=1e-5)


def test_bf16_table(rng):
    items = rng.normal(size=(3000, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    ti, tq = torch.from_numpy(items).bfloat16(), torch.from_numpy(q).bfloat16()
    gi, gv = topk_mips(ti, tq, 10)
    wi, wv = topk_mips_ref(ti, tq, 10)
    torch.testing.assert_close(gv, wv, **TOL)


def test_phases_shapes_and_tail(rng):
    n, b = 1037, 3
    items = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(b, 16)).astype(np.float32))
    cm = chunk_max(items, q)
    assert cm.shape == (b, n_chunks_of(n)) == (b, 9)
    scores = q @ items.T
    torch.testing.assert_close(cm[:, -1], scores[:, 1024:].amax(dim=1), **TOL)
    sc = rescore(items, q, torch.full((b, 2), 8, dtype=torch.int32))
    assert sc.shape == (b, 2, 128)
    assert torch.all(sc[:, :, n - 1024:] == -1e30)
    torch.testing.assert_close(sc[:, 0, : n - 1024], scores[:, 1024:], **TOL)
    with pytest.raises(ValueError):
        topk_mips(items, q, n + 1)
    with pytest.raises(ValueError):
        chunk_max(items, q.double())
