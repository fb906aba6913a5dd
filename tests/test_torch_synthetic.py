"""The port's data stage against the JAX package's on the CPU: the synthetic
generator (`data/synthetic.py`) gives the JAX DataFrame's rows, columns and
values to the bit at mini shapes, in every mode `cli synth` and the anchor
use; `cli synth` writes the same parquet; `validate` gives the same report
and catches a violation; `stage` mirrors `tests/test_stage.py`. Equal bits,
no tolerance: the port draws from the same numpy generator in the same order.
"""
import gzip
import json

import numpy as np
import pandas as pd
import pytest

from plotpointe_tpu import cli as jax_cli
from plotpointe_tpu.data import synthetic as jax_syn
from plotpointe_tpu.data.validate import validate as jax_validate
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.data import synthetic as syn
from plotpointe_tpu_torch.data.splits import first_of_each_key
from plotpointe_tpu_torch.data.stage import (
    apply_contract, parse_loose_json_gz, stage, to_interactions_df, to_items_df)
from plotpointe_tpu_torch.data.validate import validate, validate_interactions

GENERATOR_CASES = {
    "default": dict(n_users=300, n_items=200, n_interactions=6000, seed=3),
    # clusters with category browsing (the anchor's regime), amazon ratings, recency ts
    "clusters_bias_amazon_recency": dict(
        n_users=400, n_items=250, n_interactions=8000, seed=5, n_clusters=8,
        cluster_pool_bias=0.6, candidate_pool=32, affinity_strength=14.0,
        user_cluster_sigma=0.35, rating_marginal="amazon", ts_mode="recency",
        user_sigma=0.83, item_sigma=1.52),
    "clusters_no_bias": dict(n_users=200, n_items=150, n_interactions=4000, seed=2, n_clusters=5),
    # few users and items: many duplicate (user, asin, ts) rows to drop
    "duplicates": dict(n_users=30, n_items=12, n_interactions=3000, seed=1, ts_mode="recency"),
}


def _assert_table_equal(port, frame):
    assert list(port) == list(frame.columns)
    for c in frame.columns:
        want = frame[c].to_numpy()
        got = port[c]
        if want.dtype != object:
            assert got.dtype == want.dtype, c
        assert len(got) == len(want) and np.array_equal(got, want), c


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_synthetic_interactions_and_factors_equal_jax(case):
    kw = GENERATOR_CASES[case]
    frame, (ju, ji) = jax_syn.synthetic_interactions(return_factors=True, **kw)
    table, (pu, pi) = syn.synthetic_interactions(return_factors=True, **kw)
    _assert_table_equal(table, frame)
    assert np.array_equal(pu, ju) and np.array_equal(pi, ji)
    _assert_table_equal(syn.synthetic_interactions(**kw), jax_syn.synthetic_interactions(**kw))
    if case == "duplicates":
        assert len(frame) < kw["n_interactions"]


def test_amazon_calibrated_interactions_equal_jax():
    kw = dict(n_users=500, n_items=300, n_interactions=6000, seed=7, affinity_strength=14.0,
              n_clusters=16, candidate_pool=64, user_cluster_sigma=0.35, cluster_pool_bias=0.6)
    frame, (ju, ji) = jax_syn.amazon_calibrated_interactions(return_factors=True, **kw)
    table, (pu, pi) = syn.amazon_calibrated_interactions(return_factors=True, **kw)
    _assert_table_equal(table, frame)
    assert np.array_equal(pu, ju) and np.array_equal(pi, ji)


@pytest.mark.parametrize("with_factors", [False, True])
def test_synthetic_features_equal_jax(with_factors):
    fac = np.random.default_rng(0).normal(size=(90, 8)).astype(np.float32) if with_factors else None
    want = jax_syn.synthetic_features(80, 24, seed=4, factors=fac, noise=0.02)
    got = syn.synthetic_features(80, 24, seed=4, factors=fac, noise=0.02)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("with_factors", [False, True])
def test_synthetic_catalog_equals_jax(with_factors):
    kw = dict(n_users=120, n_items=60, n_interactions=1500, seed=9, return_factors=True)
    frame, (_, fac) = jax_syn.synthetic_interactions(**kw)
    table, _ = syn.synthetic_interactions(**kw)
    item_factors = fac if with_factors else None
    want = jax_syn.synthetic_catalog(frame, n_extra_items=7, seed=9, item_factors=item_factors)
    got = syn.synthetic_catalog(table, n_extra_items=7, seed=9, item_factors=item_factors)
    assert list(got) == list(want.columns)
    pd.testing.assert_frame_equal(pd.DataFrame(got), want)  # a missing image_url: None -> NaN
    assert [u is None for u in got["image_url"]] == want["image_url"].isna().tolist()


def test_first_of_each_key_is_drop_duplicates():
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 4, 500), rng.integers(0, 3, 500)
    want = ~pd.DataFrame({"a": a, "b": b}).duplicated().to_numpy()
    assert np.array_equal(first_of_each_key(a, b), want)
    assert first_of_each_key(np.zeros(0, int)).shape == (0,)


def test_cli_synth_parquet_equals_jax(tmp_path, capsys):
    flags = ["--users", "80", "--items", "50", "--interactions", "900", "--extra-items", "6",
             "--seed", "5", "--clusters", "4", "--candidate-pool", "24", "--affinity", "14",
             "--cluster-pool-bias", "0.6", "--user-cluster-sigma", "0.35"]
    jax_cli.main(["synth", "--out", str(tmp_path / "jax")] + flags)
    cli.main(["synth", "--out", str(tmp_path / "port")] + flags)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["n_interactions"] == json.loads(lines[1])["n_interactions"]
    for name in ("interactions", "items"):
        want = pd.read_parquet(tmp_path / "jax" / f"{name}.parquet")
        got = pd.read_parquet(tmp_path / "port" / f"{name}.parquet")
        pd.testing.assert_frame_equal(got, want)


def test_cli_synth_without_pandas_names_the_data_extra(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pandas(name, *args, **kwargs):
        if name == "pandas" or name.startswith("pandas."):
            raise ImportError("No module named 'pandas'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    with pytest.raises(ImportError, match="`data` extra"):
        cli.main(["synth", "--out", str(tmp_path / "s"), "--users", "20", "--items", "10",
                  "--interactions", "100"])
    assert not (tmp_path / "s").exists()


def _frames(seed=1):
    df = jax_syn.synthetic_interactions(n_users=50, n_items=30, n_interactions=500, seed=seed)
    return df, jax_syn.synthetic_catalog(df)


def _violations(df, items):
    bad, bad_items = df.copy(), items.copy()
    bad.loc[0, "rating"] = 9.0
    bad.loc[1, "ts"] = 5
    bad.loc[2, "user_id"] = None
    bad.loc[3, "asin"] = "ZZZ"
    bad = pd.concat([bad, bad.iloc[[10, 11]]], ignore_index=True)
    bad_items.loc[0, "price"] = -1.0
    bad_items = pd.concat([bad_items, bad_items.iloc[[4]]], ignore_index=True)
    return bad, bad_items


def test_validate_report_equals_jax_and_catches_violations():
    df, items = _frames()
    table = syn.synthetic_interactions(n_users=50, n_items=30, n_interactions=500, seed=1)
    catalog = syn.synthetic_catalog(table)
    rep = validate(table, catalog)
    assert rep.passed and rep.to_dict() == jax_validate(df, items).to_dict()
    assert validate(df, items).to_dict() == rep.to_dict()

    bad, bad_items = _violations(df, items)
    got, want = validate(bad, bad_items).to_dict(), jax_validate(bad, bad_items).to_dict()
    assert got == want and not got["passed"]
    failed = {c["name"] for c in got["checks"] if not c["passed"]}
    assert failed == {"non_null_keys", "rating_bounds", "ts_bounds", "uniqueness_user_asin_ts",
                      "fk_asin_in_items", "unique_asin", "price_non_negative"}
    one = validate_interactions({k: bad[k].to_numpy() for k in bad.columns})
    assert {c.name: c.passed for c in one.checks}["rating_bounds"] is False


def test_cli_synth_validate_buildui(tmp_path, capsys):
    cli.main(["synth", "--out", str(tmp_path / "s"), "--users", "50", "--items", "40",
              "--interactions", "600", "--extra-items", "5"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n_interactions"] == 600
    with pytest.raises(SystemExit) as e:
        cli.main(["validate", "--prefix", str(tmp_path / "s")])
    assert e.value.code == 0
    port_report = json.loads(capsys.readouterr().out)
    with pytest.raises(SystemExit) as e:
        jax_cli.main(["validate", "--prefix", str(tmp_path / "s")])
    assert json.loads(capsys.readouterr().out) == port_report

    cli.main(["build-ui", "--staging-prefix", str(tmp_path / "s"), "--output-prefix",
              str(tmp_path / "g")])
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["n_edges"] == 600

    bad = pd.read_parquet(tmp_path / "s" / "interactions.parquet")
    bad.loc[0, "rating"] = 0.0
    bad.to_parquet(tmp_path / "s" / "interactions.parquet", index=False)
    with pytest.raises(SystemExit) as e:
        cli.main(["validate", "--prefix", str(tmp_path / "s")])
    assert e.value.code == 2


# -- staging (mirrors tests/test_stage.py) -----------------------------------


def _write_loose(path, records, as_python_literal=False):
    with gzip.open(path, "wt") as f:
        for r in records:
            f.write((repr(r) if as_python_literal else json.dumps(r)) + "\n")


def test_parse_both_formats(tmp_path):
    recs = [{"asin": "A1", "overall": 5.0}, {"asin": "A2", "overall": 3.0}]
    _write_loose(tmp_path / "json.gz", recs)
    _write_loose(tmp_path / "pyliteral.gz", recs, as_python_literal=True)
    assert list(parse_loose_json_gz(tmp_path / "json.gz")) == recs
    assert list(parse_loose_json_gz(tmp_path / "pyliteral.gz")) == recs


def test_contract_filters():
    from plotpointe_tpu.data import stage as jax_stage

    reviews = [
        {"reviewerID": "u1", "asin": "A1", "overall": 5.0, "unixReviewTime": 1_300_000_000},
        {"reviewerID": None, "asin": "A1", "overall": 4.0, "unixReviewTime": 1_300_000_000},
        {"reviewerID": "u2", "asin": "A1", "overall": 9.0, "unixReviewTime": 1_300_000_000},
        {"reviewerID": "u3", "asin": "A1", "overall": 4.0, "unixReviewTime": 1},
        {"reviewerID": "u4", "asin": "ZZZ", "overall": 4.0, "unixReviewTime": 1_300_000_000},
    ]
    meta = [{"asin": "A1", "title": "t", "categories": [["Electronics", "TV"]]}]
    clean, items_clean, rejects = apply_contract(to_interactions_df(reviews), to_items_df(meta))
    assert len(clean) == 1 and clean.iloc[0]["user_id"] == "u1"
    assert sorted(rejects["reject_reason"]) == ["fk_asin", "null_key", "rating_bounds", "ts_bounds"]
    assert items_clean.iloc[0]["categories"] == ["Electronics", "TV"]
    want = jax_stage.apply_contract(jax_stage.to_interactions_df(reviews), jax_stage.to_items_df(meta))
    for got_frame, want_frame in zip((clean, items_clean, rejects), want):
        pd.testing.assert_frame_equal(got_frame, want_frame)


def test_stage_end_to_end_equals_jax(tmp_path, capsys):
    reviews = [
        {"reviewerID": f"u{i}", "asin": f"A{i % 3}", "overall": 4.0, "unixReviewTime": 1_300_000_000 + i}
        for i in range(10)
    ] + [{"reviewerID": "u9", "asin": "A9", "overall": 4.0, "unixReviewTime": 1_300_000_000}]
    meta = [{"asin": f"A{j}", "title": f"item {j}", "price": 9.99} for j in range(3)]
    rp, mp = tmp_path / "reviews.json.gz", tmp_path / "meta.json.gz"
    _write_loose(rp, reviews)
    _write_loose(mp, meta, as_python_literal=True)

    uris, stats = stage(rp, mp, str(tmp_path / "staged"))
    assert stats == {"n_interactions": 10, "n_items": 3, "n_rejects": 1}
    df = pd.read_parquet(uris["interactions"])
    assert set(df.columns) == {"user_id", "asin", "rating", "ts", "verified", "helpful"}

    cli.main(["stage", "--reviews", str(rp), "--meta", str(mp), "--out", str(tmp_path / "port")])
    jax_cli.main(["stage", "--reviews", str(rp), "--meta", str(mp), "--out", str(tmp_path / "jax")])
    out = capsys.readouterr().out
    assert out.count('"n_rejects": 1') == 2
    for name in ("interactions", "items", "rejects"):
        pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "port" / f"{name}.parquet"),
                                      pd.read_parquet(tmp_path / "jax" / f"{name}.parquet"))
