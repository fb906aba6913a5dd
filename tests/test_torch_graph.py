"""Port graph layout and splits against the JAX package: exact equality."""
import numpy as np
import pytest

from plotpointe_tpu.data.splits import build_node_maps as jax_node_maps
from plotpointe_tpu.data.splits import build_splits as jax_splits
from plotpointe_tpu.graphs.csr import build_bipartite_graph as jax_bipartite
from plotpointe_tpu.graphs.csr import build_graph as jax_graph
from plotpointe_tpu.graphs.csr import degrees as jax_degrees
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits, first_occurrence_unique
from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph, build_graph, degrees


def _edges(rng, kind, n=400, e=5000):
    src = rng.integers(0, n, e)
    if kind == "random":
        dst = rng.integers(0, n, e)
    elif kind == "skewed":
        dst = np.where(rng.random(e) < 0.5, 7, rng.integers(0, n, e))
    else:  # isolated: nodes >= n // 2 have no edges at all
        src, dst = src % (n // 2), rng.integers(0, n // 2, e)
    return src, dst, n


def _assert_same_graph(g, jg):
    e = jg.n_edges
    assert g.n_edges == e and g.n_nodes == jg.n_nodes
    np.testing.assert_array_equal(g.src.numpy(), np.asarray(jg.src)[:e])
    np.testing.assert_array_equal(g.dst.numpy(), np.asarray(jg.dst)[:e])
    np.testing.assert_array_equal(g.weight.numpy(), np.asarray(jg.weight)[:e])
    np.testing.assert_array_equal(g.row_ptr.numpy(), np.asarray(jg.row_ptr)[: g.n_nodes + 1])
    np.testing.assert_array_equal(degrees(g), jax_degrees(jg))


@pytest.mark.parametrize("kind", ["random", "skewed", "isolated"])
def test_build_graph_matches_jax(rng, kind):
    src, dst, n = _edges(rng, kind)
    w = rng.random(len(src)).astype(np.float32)
    _assert_same_graph(build_graph(src, dst, n, weight=w), jax_graph(src, dst, n, weight=w))
    _assert_same_graph(build_graph(src, dst, n), jax_graph(src, dst, n))


def test_bipartite_graph_matches_jax(tiny_dataset):
    u2i, i2i = jax_node_maps(tiny_dataset)
    s = jax_splits(tiny_dataset, u2i, i2i)
    g = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    jg = jax_bipartite(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    _assert_same_graph(g, jg)


def test_first_occurrence_matches_pd_unique(rng):
    import pandas as pd

    for col in (rng.integers(0, 50, 500), np.array([f"U{x}" for x in rng.integers(0, 50, 500)],
                                                   dtype=object)):
        np.testing.assert_array_equal(first_occurrence_unique(col), pd.unique(col))


@pytest.mark.parametrize("as_dict", [False, True])
def test_node_maps_and_splits_match_jax(tiny_dataset, as_dict):
    inter = ({c: tiny_dataset[c].to_numpy() for c in ("user_id", "asin", "ts", "rating")}
             if as_dict else tiny_dataset)
    u2i, i2i = build_node_maps(inter)
    ju2i, ji2i = jax_node_maps(tiny_dataset)
    assert list(u2i.items()) == list(ju2i.items())
    assert list(i2i.items()) == list(ji2i.items())
    s, js = build_splits(inter, u2i, i2i), jax_splits(tiny_dataset, ju2i, ji2i)
    assert (s.n_users, s.n_items) == (js.n_users, js.n_items)
    for f in ("train_u", "train_i", "train_w", "val_u", "val_i", "test_u", "test_i"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f), err_msg=f)
        assert getattr(s, f).dtype == getattr(js, f).dtype, f


def test_splits_without_rating_and_unknown_ids():
    inter = {"user_id": np.array([1, 1, 1, 2, 2, 3]), "asin": np.array([5, 6, 7, 5, 6, 7]),
             "ts": np.array([3, 1, 2, 1, 2, 1])}
    u2i, i2i = build_node_maps(inter)
    s = build_splits(inter, u2i, i2i)
    assert s.train_w.tolist() == [1.0, 1.0]  # user 1 -> [6], user 2 -> [5]
    assert s.test_i.tolist() == [i2i[5], i2i[6]] and s.val_i.tolist() == [i2i[7]]
    with pytest.raises(KeyError):
        build_splits({**inter, "asin": np.array([5, 6, 7, 5, 6, 99])}, u2i, i2i)
