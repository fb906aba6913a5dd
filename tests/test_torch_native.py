"""The port's native host runtime (plotpointe_tpu_torch/native.py over
csrc/graphcore.cpp) against the JAX package's `native` module and against
its own numpy versions, bit for bit, and `graphs/csr.build_graph` on it
against the two-lexsort build it replaces."""
import numpy as np
import pytest
import torch

from plotpointe_tpu import native as jax_native
from plotpointe_tpu.data.splits import Splits, padded_positives
from plotpointe_tpu_torch import native
from plotpointe_tpu_torch.graphs.csr import _csr_ptr, build_bipartite_graph, build_graph, degrees
from plotpointe_tpu_torch.ops.cuda_build import BUILD_DIR


@pytest.fixture()
def numpy_only(monkeypatch):
    """The library's absence (PLOTPOINTE_NO_NATIVE or no g++): every entry
    point takes its numpy version."""
    monkeypatch.setattr(native, "_load", lambda: None)


def test_library_builds_into_the_port_build_dir():
    assert native.backend() == "native"
    assert native.lib_path().parent == BUILD_DIR and native.lib_path().exists()
    assert native._load().ppt_abi_version() == 1


@pytest.mark.parametrize("weighted", [False, True])
def test_build_csr_matches_jax_and_numpy(rng, weighted):
    n_nodes, e, e_pad = 500, 4000, 4096
    src = rng.integers(0, n_nodes, e).astype(np.int64)
    dst = rng.integers(0, n_nodes, e).astype(np.int64)
    src[:50], dst[:50] = src[50:100], dst[50:100]  # duplicate edges keep their input order
    w = rng.random(e).astype(np.float32) if weighted else None
    got = native.build_csr(src, dst, w, n_nodes, e_pad)
    want = jax_native.build_csr(src, dst, w, n_nodes, e_pad)
    plain = native.build_csr_numpy(src, dst, w, n_nodes, e_pad)
    for g, j, p in zip(got, want, plain):
        assert g.dtype == j.dtype == p.dtype
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, p)
    order = np.lexsort((src, dst))
    np.testing.assert_array_equal(got[0][:e], src[order])
    assert (got[0][e:] == n_nodes).all() and (got[2][e:] == 0).all() and got[3][-1] == e_pad


def test_leave_last2_matches_jax_and_numpy(rng, numpy_only):
    n_users, n = 200, 3000
    u = rng.integers(0, n_users, n).astype(np.int32)
    ts = rng.integers(0, 50, n).astype(np.int64)  # many ties: within a user they keep row order
    assert native.backend() == "numpy"
    np.testing.assert_array_equal(native.leave_last2_roles(u, ts, n_users),
                                  jax_native.leave_last2_roles(u, ts, n_users))


def test_leave_last2_library_matches_numpy(rng, monkeypatch):
    n_users, n = 200, 3000
    u = rng.integers(0, n_users, n).astype(np.int32)
    ts = rng.integers(0, 50, n).astype(np.int64)
    got = native.leave_last2_roles(u, ts, n_users)
    np.testing.assert_array_equal(got, jax_native.leave_last2_roles(u, ts, n_users))
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_array_equal(got, native.leave_last2_roles(u, ts, n_users))


def test_padded_positives_native(rng):
    n_users, n_items, t = 50, 40, 600
    tu = rng.integers(0, n_users, t).astype(np.int32)
    ti = rng.integers(0, n_items, t).astype(np.int32)
    s = Splits(n_users=n_users, n_items=n_items, train_u=tu, train_i=ti,
               train_w=np.ones(t, np.float32),
               val_u=np.array([], np.int32), val_i=np.array([], np.int32),
               test_u=np.array([], np.int32), test_i=np.array([], np.int32))
    table_np, deg_np = padded_positives(s)
    table, deg = native.padded_positives_native(tu, ti, n_users, n_items, table_np.shape[1])
    np.testing.assert_array_equal(table, table_np)
    np.testing.assert_array_equal(deg, deg_np)


def test_padded_positives_without_the_library_is_none(numpy_only):
    assert native.backend() == "numpy"
    assert native.padded_positives_native(np.zeros(3, np.int32), np.zeros(3, np.int32), 1, 4, 2) is None


@pytest.mark.parametrize("ids", [[-1, 0], [0, 100]])
def test_ids_outside_the_node_range_are_refused(ids):
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 100\)"):
        native.build_csr(np.array(ids), np.array([0, 1]), None, 100, 2)


def _lexsort_graph(src, dst, n, weight=None):
    """The build `build_graph` had before the native sort: two lexsorts."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    w = np.ones(len(src), np.float32) if weight is None else np.asarray(weight, np.float32)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    t_order = np.lexsort((dst, src))
    return {"src": src.astype(np.int32), "dst": dst.astype(np.int32), "weight": w[order],
            "row_ptr": _csr_ptr(dst, n), "t_ptr": _csr_ptr(src, n),
            "t_dst": dst[t_order].astype(np.int32), "t_eid": t_order.astype(np.int32)}


@pytest.mark.parametrize("library", [True, False])
@pytest.mark.parametrize("n,e,weighted", [(100, 900, False), (300, 5000, True), (7, 0, False),
                                          (2000, 3, True)])
def test_build_graph_bit_equal_with_and_without_the_library(rng, monkeypatch, library, n, e, weighted):
    if not library:
        monkeypatch.setattr(native, "_load", lambda: None)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) if weighted else None
    g = build_graph(src, dst, n, weight=w)
    for k, v in _lexsort_graph(src, dst, n, w).items():
        t = getattr(g, k)
        assert t.dtype == torch.from_numpy(v).dtype and np.array_equal(t.numpy(), v), k
    assert (np.diff(g.dst.numpy()) >= 0).all() and degrees(g).sum() == e


def test_bipartite_graph_feeds_from_the_library(rng):
    tu, ti = rng.integers(0, 30, 400), rng.integers(0, 20, 400)
    g = build_bipartite_graph(tu, ti, 30, 20, weight=rng.random(400).astype(np.float32))
    assert g.n_edges == 800 and degrees(g).sum() == 800 and g.row_ptr.shape == (51,)
