"""The top-K selections of the port (`csrc/topk_select.cu`'s plain versions
on the CPU) against `jax.lax.top_k`, and `topk_mips`'s tie rule against
`lax.top_k` over the JAX score matrix.

The select kernel ranks by (value descending, position ascending) and only
compares and moves values, so its plain version must give `lax.top_k`'s
values and indices exactly, ties included. `topk_mips` lists the selected
chunks in ascending order, so its final selection breaks ties by item
index: on integer-valued rows (every score exact in f32, in any order of
sums, so both packages score alike) its indices are those of
`lax.top_k(q @ X.T, k)` at every place; on normal rows with copied rows,
wherever copies tie and wherever no near-tie of two different rows (within
rtol 1e-5 / atol 1e-4, the f32 band of two orders of sums) straddles a
place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotpointe_tpu_torch.ops.topk_kernel import (
    CHUNK, NEG_INF, select_chunks, select_chunks_plain, select_items, select_items_plain,
    select_topk_plain, topk_mips)

BAND = dict(rtol=1e-5, atol=1e-4)


def _rows(rng, kind, b, w):
    if kind == "ties":  # integer values: many exact ties in every row
        return rng.integers(-4, 5, size=(b, w)).astype(np.float32)
    x = rng.normal(size=(b, w)).astype(np.float32)
    if kind == "neg_inf":  # the rescore's fill past N, and ties among it
        x[rng.random((b, w)) < 0.4] = NEG_INF
        x[:, -5:] = NEG_INF
    return x


@pytest.mark.parametrize("kind", ["ties", "neg_inf", "normal"])
@pytest.mark.parametrize("w,r", [(3893, 40), (1000, 1), (77, 77), (517, 300), (5120, 32)])
def test_select_topk_plain_matches_lax_top_k(rng, kind, w, r):
    x = _rows(rng, kind, 6, w)
    v, pos = select_topk_plain(torch.from_numpy(x), r)
    jv, ji = jax.lax.top_k(jnp.asarray(x), r)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ji))


def test_select_chunks_clamps_and_orders_by_chunk():
    # 5 chunks of a 530-item catalog (the last, chunk 4, holds 18 items)
    cm = torch.tensor([[0.5, 3.0, 3.0, -1.0, 7.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0]])
    # the top 3 of row 0 are chunks 4, 1, 2 (the tie to the smaller); of row 1, 0, 1, 2
    torch.testing.assert_close(select_chunks_plain(cm, 3, 530),
                               torch.tensor([[1, 2, 4], [0, 1, 2]], dtype=torch.int32))
    # a catalog whose last chunk is 3: position 4 clamps to it
    torch.testing.assert_close(select_chunks_plain(cm, 2, 4 * CHUNK),
                               torch.tensor([[1, 3], [0, 1]], dtype=torch.int32))
    torch.testing.assert_close(select_chunks(cm, 3, 530), select_chunks_plain(cm, 3, 530))


def test_select_items_maps_positions_to_items_with_minus_one_fill():
    chunk_id = torch.tensor([[7, 2]], dtype=torch.int32)
    scores = torch.full((1, 2 * CHUNK), NEG_INF)
    scores[0, 3] = 1.0          # item 7 * 128 + 3
    scores[0, CHUNK + 5] = 4.0  # item 2 * 128 + 5
    scores[0, CHUNK + 6] = 1.0  # item 2 * 128 + 6: ties with position 3, which comes first
    ids, v = select_items_plain(scores, chunk_id, 4)
    torch.testing.assert_close(ids, torch.tensor([[2 * CHUNK + 5, 7 * CHUNK + 3, 2 * CHUNK + 6, -1]],
                                                 dtype=torch.int32))
    torch.testing.assert_close(v, torch.tensor([[4.0, 1.0, 1.0, NEG_INF]]))
    got = select_items(scores, chunk_id, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, (ids, v)))


def test_select_wrappers_reject_bad_arguments():
    x = torch.zeros((2, 256))
    with pytest.raises(ValueError):
        select_chunks(x, 0, 1000)
    with pytest.raises(ValueError):
        select_chunks(x, 257, 1000)
    with pytest.raises(ValueError):
        select_chunks(x.double(), 3, 1000)
    with pytest.raises(ValueError):  # chunk_id must be [B, W / 128]
        select_items(x, torch.zeros((2, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        select_items(x, torch.zeros((2, 2), dtype=torch.int64), 4)


def _catalog(rng, kind, n, d, copies):
    if kind == "integer":
        x = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
    src, dst = rng.choice(n, size=(2, copies), replace=False)
    x[dst] = x[src]
    return x


@pytest.mark.parametrize("n,b,k,mode", [(3000, 4, 20, "exact"), (1037, 8, 64, "exact"),
                                        (5000, 3, 10, "fast")])
def test_topk_mips_ties_follow_lax_top_k_on_exact_scores(rng, n, b, k, mode):
    """Integer rows and queries: every score is exact, ties are everywhere,
    and the port's indices equal `lax.top_k`'s over the JAX score matrix."""
    items = _catalog(rng, "integer", n, 16, 300)
    q = rng.integers(-2, 3, size=(b, 16)).astype(np.float32)
    gi, gv = topk_mips(torch.from_numpy(items), torch.from_numpy(q), k, mode=mode)
    jv, ji = jax.lax.top_k(jnp.asarray(q) @ jnp.asarray(items).T, k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))


def test_topk_mips_copies_tie_to_the_smaller_index_as_lax_top_k(rng):
    """Normal rows, 400 of 4,000 copied: where two copies tie at neighbouring
    places the port puts the smaller index first, as `lax.top_k` does, and
    it gives JAX's index wherever no near-tie of two different rows
    straddles a place."""
    items = _catalog(rng, "normal", 4000, 32, 400)
    # queries near copied rows, so copies rank high
    q = items[rng.choice(4000, 6)] + 0.1 * rng.normal(size=(6, 32)).astype(np.float32)
    k = 30
    gi, gv = topk_mips(torch.from_numpy(items), torch.from_numpy(q), k)
    jv, ji = jax.lax.top_k(jnp.asarray(q) @ jnp.asarray(items).T, k + 1)
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(gv.numpy(), jv[:, :k], **BAND)
    gap = np.abs(jv[:, :-1] - jv[:, 1:])
    near = (gap > 0) & (gap <= BAND["atol"] + BAND["rtol"] * np.abs(jv[:, :-1]))
    straddled = np.zeros_like(jv, dtype=bool)
    straddled[:, :-1] |= near
    straddled[:, 1:] |= near
    keep = ~straddled[:, :k]
    np.testing.assert_array_equal(gi.numpy()[keep], ji[:, :k][keep])
    copies = (gap[:, :k - 1] == 0) & keep[:, :k - 1] & keep[:, 1:]
    assert copies.sum() > 0  # the rows do hold tied copies at checked places
    g = gi.numpy()
    assert (g[:, :k - 1][copies] < g[:, 1:][copies]).all()
