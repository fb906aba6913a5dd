"""The port's graph-build stage against the JAX package on the same inputs:
`build_ui_artifacts`, `build_interacted_subset`, `node_maps_json`,
`KnnConfig`, the artifact store's readers, and the `build-ui`,
`build-subset` and `build-knn` commands (on the CPU). Every file the port
writes is read back by the JAX package's `ArtifactStore`.

Exact where the values are exact: COO indices, weights, node maps, subsets
and asin lists are equal; kNN similarities within 1e-6 (f32 dot products
summed in another order); stats equal apart from `build_time_sec`.
"""
import dataclasses
import json

import numpy as np
import pytest

from plotpointe_tpu.config import KnnConfig as JaxKnnConfig
from plotpointe_tpu.data.splits import build_node_maps as jax_node_maps
from plotpointe_tpu.data.splits import node_maps_json as jax_node_maps_json
from plotpointe_tpu.data.subset import build_interacted_subset as jax_subset
from plotpointe_tpu.data.synthetic import synthetic_catalog, synthetic_interactions
from plotpointe_tpu.graphs.knn import cosine_knn_graph as jax_knn_graph
from plotpointe_tpu.graphs.ui_graph import build_ui_artifacts as jax_ui
from plotpointe_tpu.utils.artifacts import ArtifactStore as JaxStore
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.config import KnnConfig
from plotpointe_tpu_torch.data.splits import build_node_maps, node_maps_json
from plotpointe_tpu_torch.data.subset import build_interacted_subset
from plotpointe_tpu_torch.graphs import build_ui_artifacts, cosine_knn_graph, ui_stats
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

JSTORE = JaxStore()


@pytest.fixture(scope="module")
def staged():
    inter = synthetic_interactions(n_users=120, n_items=80, n_interactions=1500, seed=3)
    items = synthetic_catalog(inter, n_extra_items=25, seed=3)
    return inter, items


def _columns(df, names):
    return {c: df[c].to_numpy() for c in names}


def _assert_npz_equal(got_path, want_path, data_atol=0.0):
    got, want = JSTORE.load_npz(str(got_path)), JSTORE.load_npz(str(want_path))
    assert sorted(got) == sorted(want) == ["col", "data", "format", "row", "shape"]
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        if key == "data":
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=data_atol)
        else:
            np.testing.assert_array_equal(got[key], want[key])


def _assert_json_equal(got_path, want_path, skip=("build_time_sec",)):
    got, want = JSTORE.load_json(str(got_path)), JSTORE.load_json(str(want_path))
    if isinstance(want, dict):
        for key in skip:
            got.pop(key, None), want.pop(key, None)
    assert got == want


def test_node_maps_json_matches_jax(staged):
    inter, _ = staged
    got = node_maps_json(*build_node_maps(inter))
    want = jax_node_maps_json(*jax_node_maps(inter))
    assert got == want
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


@pytest.mark.parametrize("table", ["dataframe", "columns"])
def test_build_ui_artifacts_match_jax(tmp_path, staged, table):
    inter, _ = staged
    src = inter if table == "dataframe" else _columns(inter, ["user_id", "asin", "ts", "rating"])
    uris, stats = build_ui_artifacts(src, str(tmp_path / "port"))
    _, want_stats = jax_ui(inter, str(tmp_path / "jax"))
    _assert_npz_equal(tmp_path / "port" / "ui_edges.npz", tmp_path / "jax" / "ui_edges.npz")
    for name in ("node_maps.json", "ui_stats.json"):
        _assert_json_equal(tmp_path / "port" / name, tmp_path / "jax" / name)
    assert set(uris) == {"ui_edges", "node_maps", "ui_stats"}
    assert {k: v for k, v in stats.items() if k != "build_time_sec"} == \
        {k: v for k, v in want_stats.items() if k != "build_time_sec"}


def test_ui_weights_default_to_one_without_ratings(tmp_path, staged):
    inter, _ = staged
    cols = _columns(inter, ["user_id", "asin", "ts"])
    build_ui_artifacts(cols, str(tmp_path / "port"))
    jax_ui(inter.drop(columns=["rating"]), str(tmp_path / "jax"))
    _assert_npz_equal(tmp_path / "port" / "ui_edges.npz", tmp_path / "jax" / "ui_edges.npz")
    assert (JSTORE.load_npz(str(tmp_path / "port" / "ui_edges.npz"))["data"] == 1.0).all()


def test_ui_stats_matches_hand_count():
    rows, cols = np.array([0, 0, 1]), np.array([1, 2, 2])
    vals = np.array([1.0, 0.5, 0.25], np.float32)
    s = ui_stats(rows, cols, vals, n_users=2, n_items=3)
    assert s["n_edges"] == 3 and s["sparsity"] == pytest.approx(0.5)
    assert s["user_degree_max"] == 1 and s["item_degree_min"] == 0
    assert s["item_degree_mean"] == pytest.approx(1.75 / 3)


@pytest.mark.parametrize("table", ["dataframe", "columns"])
def test_build_interacted_subset_matches_jax(tmp_path, staged, table):
    inter, items = staged
    full = np.random.default_rng(0).normal(size=(len(items), 12)).astype(np.float32)
    it = items if table == "dataframe" else _columns(items, ["asin"])
    ia = inter if table == "dataframe" else _columns(inter, ["user_id", "asin", "ts"])
    got, got_asins = build_interacted_subset(full, it, ia, out_prefix=str(tmp_path / "port"),
                                             feature_name="fused")
    want, want_asins = jax_subset(full, items, inter, out_prefix=str(tmp_path / "jax"),
                                  feature_name="fused")
    np.testing.assert_array_equal(got, want)
    assert got_asins == want_asins
    np.testing.assert_array_equal(JSTORE.load_npy(str(tmp_path / "port" / "fused_interacted.npy")), want)
    _assert_json_equal(tmp_path / "port" / "interacted_items.json",
                       tmp_path / "jax" / "interacted_items.json")


def test_build_interacted_subset_checks_alignment(staged):
    inter, items = staged
    full = np.zeros((len(items), 4), np.float32)
    with pytest.raises(ValueError, match="must align"):
        build_interacted_subset(full[:-1], items, inter)
    short = items[items["asin"] != inter["asin"].iloc[0]]
    with pytest.raises(KeyError, match="1 interacted asins missing"):
        build_interacted_subset(full[:len(short)], short, inter)


def test_knn_config_matches_jax():
    assert dataclasses.asdict(KnnConfig()) == dataclasses.asdict(JaxKnnConfig())
    assert KnnConfig(k=5).to_dict() == JaxKnnConfig(k=5).to_dict()


def test_store_reads_items_npz_then_parquet_and_maps_npy(tmp_path, staged):
    _, items = staged
    items.to_parquet(tmp_path / "items.parquet", index=False)
    store = ArtifactStore()
    assert list(store.load_items(str(tmp_path))["asin"]) == list(items["asin"])
    np.savez(tmp_path / "items.npz", asin=items["asin"].to_numpy().astype(str))
    assert store.load_items(str(tmp_path))["asin"].tolist() == list(items["asin"])
    np.save(tmp_path / "x.npy", np.arange(6.0).reshape(3, 2))
    m = store.load_npy(str(tmp_path / "x.npy"), mmap=True)
    assert isinstance(m, np.memmap) and m[2, 1] == 5.0


def _stage(tmp_path, inter, items, fmt):
    staging = tmp_path / "staging"
    staging.mkdir()
    if fmt == "npz":
        # column arrays of plain numpy types (strings as unicode, no pickles)
        np.savez(staging / "interactions.npz",
                 **{c: np.asarray(inter[c].tolist()) for c in ("user_id", "asin", "ts", "rating")})
        np.savez(staging / "items.npz", asin=np.asarray(items["asin"].tolist()))
    else:
        inter.to_parquet(staging / "interactions.parquet", index=False)
        items.to_parquet(staging / "items.parquet", index=False)
    return staging


@pytest.mark.parametrize("fmt", ["npz", "parquet"])
def test_cli_graph_build_commands_match_jax(tmp_path, staged, fmt, capsys):
    inter, items = staged
    staging = _stage(tmp_path, inter, items, fmt)
    rng = np.random.default_rng(1)
    full = rng.normal(size=(len(items), 16)).astype(np.float32)
    np.save(tmp_path / "fused.npy", full)
    out, emb = tmp_path / "graphs", tmp_path / "embeddings"

    cli.main(["build-ui", "--staging-prefix", str(staging), "--output-prefix", str(out)])
    cli.main(["build-subset", "--staging-prefix", str(staging), "--features", str(tmp_path / "fused.npy"),
              "--output-prefix", str(emb), "--feature-name", "fused"])
    cli.main(["build-knn", "--features", str(emb / "fused_interacted.npy"), "--output-prefix", str(out),
              "--k", "6", "--min-similarity", "0.1", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert '"n_interacted"' in printed and '"avg_similarity"' in printed

    ref = tmp_path / "jax"
    jax_ui(inter, str(ref))
    sub, _ = jax_subset(full, items, inter, out_prefix=str(ref), feature_name="fused")
    jax_knn_graph(sub, out_prefix=str(ref), feature_name="fused", k=6, min_similarity=0.1)
    _assert_npz_equal(out / "ui_edges.npz", ref / "ui_edges.npz")
    _assert_json_equal(out / "node_maps.json", ref / "node_maps.json")
    _assert_json_equal(out / "ui_stats.json", ref / "ui_stats.json")
    np.testing.assert_array_equal(JSTORE.load_npy(str(emb / "fused_interacted.npy")), sub)
    _assert_json_equal(emb / "interacted_items.json", ref / "interacted_items.json")
    _assert_npz_equal(out / "ii_edges_fused.npz", ref / "ii_edges_fused.npz", data_atol=1e-6)
    got = JSTORE.load_json(str(out / "ii_fused_stats.json"))
    want = JSTORE.load_json(str(ref / "ii_fused_stats.json"))
    assert got.keys() == want.keys()
    for key in want:
        if key != "build_time_sec":
            assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-6), key


def test_cosine_knn_graph_returns_coo_and_stats(tmp_path):
    x = np.random.default_rng(2).normal(size=(40, 8)).astype(np.float32)
    (rows, cols, vals), stats = cosine_knn_graph(x, k=3, min_similarity=0.0, block_rows=8,
                                                 device="cpu")
    assert rows.dtype == cols.dtype == np.int64 and vals.dtype == np.float32
    assert (rows != cols).all() and (vals >= 0.0).all()
    assert stats["n_edges"] == len(vals) and stats["k"] == 3 and stats["n_items"] == 40
    assert not (tmp_path / "ii_edges_fused.npz").exists()
