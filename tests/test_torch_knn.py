"""The port's cosine kNN (plain versions on the CPU) against numpy brute force
and the JAX package: `cosine_knn` with impl "pallas" (JAX in interpret mode)
and "xla", the fast mode's recall, the candidate contract (tie rule, self,
tails) and the graph artifacts. Mirrors tests/test_knn.py.

Tolerances: similarities rtol 1e-4 / atol 1e-5 (tests/test_knn.py:54; f32
dot products summed in another order). Indices are compared only where no
tie straddles a place: random normal rows have none; duplicate rows do.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotpointe_tpu.graphs import knn as jknn
from plotpointe_tpu.ops.knn_kernel import knn_topk_pallas
from plotpointe_tpu.utils.artifacts import ArtifactStore as JaxStore
from plotpointe_tpu_torch.graphs import knn as tknn
from plotpointe_tpu_torch.ops.knn_kernel import (
    K_PAD, NEG_INF, knn_candidates, knn_candidates_fast, knn_candidates_plain, knn_topk,
    n_candidates, order_keys, rescore_topk)

TOL = dict(rtol=1e-4, atol=1e-5)


def _brute_force(x, k, min_sim):
    xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)
    s = xn.astype(np.float64) @ xn.T.astype(np.float64)
    np.fill_diagonal(s, -np.inf)
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    sim = np.take_along_axis(s, idx, axis=1)
    return idx, sim, sim >= min_sim


def _normalized(x):
    return torch.from_numpy(x) / (torch.linalg.vector_norm(torch.from_numpy(x), dim=1, keepdim=True)
                                  + 1e-8)


@pytest.mark.parametrize("n,d,k", [(300, 32, 6), (300, 32, 12), (77, 16, 5), (77, 16, 12)])
def test_pallas_impl_matches_jax_and_brute_force(rng, n, d, k):
    x = rng.normal(size=(n, d)).astype(np.float32)
    pi, ps, pv = tknn.cosine_knn(x, k=k, min_similarity=0.1, impl="pallas", device="cpu")
    ji, js, jv = jknn.cosine_knn(x, k=k, min_similarity=0.1, impl="pallas")
    bi, bs, bv = _brute_force(x, k, 0.1)
    assert pi.dtype == np.int32 and ps.dtype == np.float32 and pi.shape == (n, k)
    np.testing.assert_allclose(ps, bs, **TOL)
    np.testing.assert_allclose(ps, js, **TOL)
    np.testing.assert_array_equal(pi, bi)  # no ties in random normal rows
    np.testing.assert_array_equal(pi, ji)
    assert pv.sum() == jv.sum() == bv.sum()
    assert not (pi == np.arange(n)[:, None]).any()
    assert (np.diff(ps, axis=1) <= 0).all()


@pytest.mark.parametrize("n,d,k,block_rows", [(300, 32, 6, 64), (57, 16, 5, 16), (77, 16, 12, 32)])
def test_xla_impl_matches_jax_and_brute_force(rng, n, d, k, block_rows):
    x = rng.normal(size=(n, d)).astype(np.float32)
    pi, ps, pv = tknn.cosine_knn(x, k=k, min_similarity=0.1, block_rows=block_rows, impl="xla",
                                 device="cpu")
    ji, js, jv = jknn.cosine_knn(x, k=k, min_similarity=0.1, block_rows=block_rows, impl="xla")
    bi, bs, bv = _brute_force(x, k, 0.1)
    np.testing.assert_allclose(np.sort(ps, axis=1), np.sort(js, axis=1), **TOL)
    np.testing.assert_allclose(ps, bs, **TOL)
    np.testing.assert_array_equal(pi, bi)
    assert pv.sum() == jv.sum() == bv.sum()


def _duplicates_and_zero_row(rng, n=120, d=24):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[10] = x[3]
    x[11] = x[3]
    x[40] = x[77]
    x[5] = 0.0  # similarity 0 to everything
    return x


def test_duplicates_and_zero_row_match_brute_force(rng):
    x = _duplicates_and_zero_row(rng)
    k = 8
    ji, js, _ = jknn.cosine_knn(x, k=k, min_similarity=-2.0, impl="pallas")
    for impl in ("pallas", "xla"):
        pi, ps, pv = tknn.cosine_knn(x, k=k, min_similarity=-2.0, impl=impl, device="cpu")
        bi, bs, _ = _brute_force(x, k, -2.0)
        np.testing.assert_allclose(ps, bs, **TOL)
        np.testing.assert_allclose(ps, js, **TOL)
        assert pv.all()
        np.testing.assert_allclose(ps[5], 0.0, atol=1e-7)  # the zero row
        # the duplicates of row 3 are each other's best neighbours, at 1.0
        assert set(pi[3, :2]) == {10, 11} and set(pi[10, :2]) == {3, 11}
        assert pi[40, 0] == 77 and pi[77, 0] == 40
        # index sets agree wherever no tie within 1e-6 straddles the k-th place
        full = _brute_force(x, k + 1, -2.0)[1]
        untied = np.abs(full[:, k - 1] - full[:, k]) > 1e-6
        for r in np.flatnonzero(untied):
            assert set(pi[r]) == set(bi[r]), r


def test_exact_path_orders_ties_by_smaller_index(rng):
    x = _duplicates_and_zero_row(rng)
    xn = _normalized(x)
    ci, _ = knn_candidates_plain(xn, 20)
    group = [3, 10, 11]  # one row three times: every row scores them equally
    for r in range(len(x)):
        present = [c for c in ci[r].tolist() if c in group and c != r]
        want = [c for c in group if c != r]
        assert present == want[:len(present)], r
    idx, sim = knn_topk(xn, 18)
    for r in range(len(x)):
        for j in range(17):
            if sim[r, j] == sim[r, j + 1]:
                assert idx[r, j] < idx[r, j + 1]
    # the zero row's candidates all score 0: the smallest columns win
    np.testing.assert_array_equal(ci[5].numpy(), [c for c in range(21) if c != 5][:20])


@pytest.mark.parametrize("fn", [knn_candidates, knn_candidates_fast])
def test_candidate_contract_on_cpu(rng, fn):
    n = 7
    xn = _normalized(rng.normal(size=(n, 16)).astype(np.float32))
    ci, cs = fn(xn, 9)  # more candidates than a row has columns
    assert ci.shape == cs.shape == (n, 9) and ci.dtype == torch.int32 and cs.dtype == torch.float32
    assert (ci[:, n - 1:] == -1).all() and (cs[:, n - 1:] == NEG_INF).all()
    assert ((ci[:, :n - 1] >= 0) & (ci[:, :n - 1] < n)).all()
    assert not (ci == torch.arange(n)[:, None]).any()
    assert (cs[:, :n - 1].diff(dim=1) <= 0).all()
    idx, sim = rescore_topk(xn, ci, 8)
    assert (idx[:, n - 1:] == -1).all() and (sim[:, n - 1:] == NEG_INF).all()


def test_rescore_matches_brute_force(rng):
    x = rng.normal(size=(90, 20)).astype(np.float32)
    xn = _normalized(x)
    ci, _ = knn_candidates_plain(xn, 15)
    idx, sim = rescore_topk(xn, ci, 7)
    bi, bs, _ = _brute_force(x, 7, 0.0)
    np.testing.assert_allclose(sim.numpy(), bs, **TOL)
    np.testing.assert_array_equal(idx.numpy(), bi)


def test_order_keys_rank_score_then_smaller_column():
    s = torch.tensor([[0.5, 0.5, -0.0, 0.0, -1.0, 0.7, NEG_INF]])
    c = torch.tensor([[4, 2, 1, 0, 3, 9, -1]])
    order = torch.argsort(order_keys(s, c), dim=1, descending=True)
    assert c[0, order[0]].tolist() == [9, 2, 4, 0, 1, 3, -1]


def test_fast_mode_recall_matches_jax(rng):
    n, k = 300, 6
    x = rng.normal(size=(n, 32)).astype(np.float32)
    xn = _normalized(x)
    bi, _, _ = _brute_force(x, k, -2.0)
    fi, fs = knn_topk(xn, k, mode="fast")
    ji, _ = knn_topk_pallas(jnp.asarray(xn.numpy()), k, mode="fast")

    def recall(idx):
        return np.mean([len(set(idx[r].tolist()) & set(bi[r].tolist())) / k for r in range(n)])

    jax_recall, port_recall = recall(np.asarray(ji)), recall(fi.numpy())
    assert port_recall >= jax_recall - 0.01, (port_recall, jax_recall)
    # every kept neighbour carries its exact f32 similarity
    exact = (xn[fi.long()] * xn[:, None, :]).sum(-1)
    torch.testing.assert_close(fs, exact, **TOL)
    assert n_candidates(k, "fast") == n_candidates(k, "exact") + 1 == k + 9


def test_k_above_128_raises():
    xn = _normalized(np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32))
    with pytest.raises(ValueError):
        knn_topk(xn, K_PAD + 1)
    with pytest.raises(ValueError):
        tknn.cosine_knn(xn.numpy(), k=K_PAD + 1, impl="pallas", device="cpu")
    with pytest.raises(ValueError):
        knn_candidates(xn, K_PAD + 1)
    idx, _ = knn_topk(xn, K_PAD)
    assert idx.shape == (200, K_PAD)


def test_cosine_knn_needs_a_card_unless_cpu_is_asked():
    x = np.random.default_rng(0).normal(size=(20, 8)).astype(np.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tknn.cosine_knn(x, k=3)
    with pytest.raises(RuntimeError):
        tknn.cosine_knn_graph(x, k=3)


def test_graph_artifacts_match_jax(tmp_path, rng):
    x = rng.normal(size=(150, 24)).astype(np.float32)
    kw = dict(feature_name="txt", k=7, min_similarity=0.2, block_rows=64)
    (pr, pc, pd), pstats = tknn.cosine_knn_graph(x, out_prefix=str(tmp_path / "port"),
                                                 device="cpu", **kw)
    (jr, jc, jd), jstats = jknn.cosine_knn_graph(x, out_prefix=str(tmp_path / "jax"), **kw)
    store = JaxStore()
    port = store.load_npz(str(tmp_path / "port" / "ii_edges_txt.npz"))
    want = store.load_npz(str(tmp_path / "jax" / "ii_edges_txt.npz"))
    assert sorted(port) == sorted(want) == ["col", "data", "format", "row", "shape"]
    for key in ("row", "col", "shape", "format"):
        assert port[key].dtype == want[key].dtype
        np.testing.assert_array_equal(port[key], want[key])
    assert port["data"].dtype == np.float32
    np.testing.assert_allclose(port["data"], want["data"], rtol=0, atol=1e-6)
    got_stats = store.load_json(str(tmp_path / "port" / "ii_txt_stats.json"))
    want_stats = json.loads((tmp_path / "jax" / "ii_txt_stats.json").read_text())
    assert got_stats.keys() == want_stats.keys()
    for key in want_stats:
        if key != "build_time_sec":
            assert got_stats[key] == pytest.approx(want_stats[key], rel=1e-6, abs=1e-6), key
    assert pstats["n_edges"] == len(pd) == len(jd)


def test_pallas_graph_edges_within_threshold_band(rng):
    """Edges kept by one impl and dropped by the other lie within 1e-5 of
    the min-similarity threshold (one f32 rounding apart)."""
    x = rng.normal(size=(200, 12)).astype(np.float32)
    _, ps, pv = tknn.cosine_knn(x, k=10, min_similarity=0.3, impl="pallas", device="cpu")
    _, xs, xv = tknn.cosine_knn(x, k=10, min_similarity=0.3, impl="xla", device="cpu")
    differ = pv != xv
    assert (np.abs(ps[differ] - 0.3) <= 1e-5).all()
    np.testing.assert_allclose(ps, xs, **TOL)
