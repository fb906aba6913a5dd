"""The port's MLOps tools against the JAX package's on the CPU: the promotion
gate (the same records and exit codes on the same files), the manifest
registry and `validate-manifests`, the experiment tracker, `timed`, the
seeding helpers, the quality anchor at micro scale (its dataset block and
generator config equal what JAX's generator gives; the pinned hash of the
port's baseline file) and `cli ablate` at a micro shape. Mirrors
`tests/test_infra.py`, `tests/test_mlops.py` and `tests/test_cli.py`.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from plotpointe_tpu.config import FeatureManifest as JaxManifest
from plotpointe_tpu.data import synthetic as jax_syn
from plotpointe_tpu.tools.promotion_gate import GateSpec as JaxGateSpec
from plotpointe_tpu.utils.experiments import ExperimentTracker as JaxTracker
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.config import FeatureManifest, load_manifest, load_registry
from plotpointe_tpu_torch.data.splits import first_occurrence_unique
from plotpointe_tpu_torch.data.synthetic import synthetic_features, synthetic_interactions
from plotpointe_tpu_torch.tools import anchor
from plotpointe_tpu_torch.tools.manifest_validate import validate_manifest
from plotpointe_tpu_torch.tools.promotion_gate import GateSpec, evaluate
from plotpointe_tpu_torch.utils.experiments import ExperimentTracker
from plotpointe_tpu_torch.utils.logging import timed
from plotpointe_tpu_torch.utils.prng import host_rng, key_seq, set_seeds

ROOT = Path(__file__).resolve().parents[1]


def _metrics(tmp_path, name, **test):
    p = tmp_path / name
    p.write_text(json.dumps({"val": {"ndcg@20": 0.5}, "test": test}))
    return p


@pytest.mark.parametrize("mode,tol", [("improve_or_equal", 0.0), ("improve_or_equal", 0.01),
                                      ("no_regression", 0.04), ("no_regression", 0.0)])
def test_gate_records_equal_jax(tmp_path, mode, tol):
    cur = json.loads(_metrics(tmp_path, "c.json", **{"ndcg@20": 0.02, "recall@20": 0.05}).read_text())
    for base_ndcg in (0.016, 0.02, 0.05):
        base = {"test": {"ndcg@20": base_ndcg, "recall@20": 0.05}}
        spec = dict(split="test", metrics=["ndcg@20", "recall@20"], mode=mode, tol=tol)
        assert GateSpec(**spec).check(cur, base) == JaxGateSpec(**spec).check(cur, base)
    with pytest.raises(KeyError, match="Metric not in metrics"):
        GateSpec(metrics=["mrr"]).check(cur, base)
    with pytest.raises(KeyError, match="Split not in metrics"):
        GateSpec(split="train").check(cur, base)
    with pytest.raises(ValueError, match="Unknown mode"):
        GateSpec(mode="bigger").check(cur, base)


def test_gate_evaluate_and_cli_exit_codes(tmp_path, capsys):
    cur = _metrics(tmp_path, "cur.json", **{"ndcg@20": 0.02, "recall@20": 0.06})
    base = _metrics(tmp_path, "base.json", **{"ndcg@20": 0.016, "recall@20": 0.05})
    ok, rec = evaluate(cur, base, "test", "ndcg@20", "improve_or_equal", 0.0)
    assert ok and rec["pass"] and set(rec) == {"metric", "split", "mode", "tolerance", "current",
                                               "baseline", "pass", "reason"}
    with pytest.raises(SystemExit) as e:
        cli.main(["gate", "--current", str(cur), "--baseline", str(base)])
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out) == rec
    with pytest.raises(SystemExit) as e:
        cli.main(["gate", "--current", str(cur), "--baseline", str(base),
                  "--metric", "ndcg@20,recall@20"])
    assert e.value.code == 0
    both = json.loads(capsys.readouterr().out)
    assert both["pass"] is True and [r["metric"] for r in both["checks"]] == ["ndcg@20", "recall@20"]
    worse = _metrics(tmp_path, "worse.json", **{"ndcg@20": 0.9, "recall@20": 0.05})
    with pytest.raises(SystemExit) as e:
        cli.main(["gate", "--current", str(cur), "--baseline", str(worse)])
    assert e.value.code == 3
    assert json.loads(capsys.readouterr().out)["pass"] is False
    with pytest.raises(SystemExit) as e:
        cli.main(["gate", "--current", str(cur), "--baseline", str(worse),
                  "--mode", "no_regression", "--tol", "0.9"])
    assert e.value.code == 0


def _registry(tmp_path, graphs_exists):
    good = tmp_path / "exists"
    good.mkdir(exist_ok=True)
    graphs = good if graphs_exists else tmp_path / "missing"
    man = tmp_path / "m.json"
    man.write_text(json.dumps({
        "id": "t", "dataset": "d", "defaults": {},
        "paths": {"staging_prefix": str(good), "embeddings_prefix": str(good),
                  "graphs_prefix": str(graphs)}}))
    reg = tmp_path / "registry.json"
    reg.write_text(json.dumps({"manifests": {"t": str(man)}}))
    return reg


@pytest.mark.parametrize("graphs_exists,code", [(True, 0), (False, 2)])
def test_validate_manifests_exit_codes(tmp_path, capsys, graphs_exists, code):
    reg = _registry(tmp_path, graphs_exists)
    with pytest.raises(SystemExit) as e:
        cli.main(["validate-manifests", "--registry", str(reg)])
    assert e.value.code == code
    (rep,) = json.loads(capsys.readouterr().out)
    assert rep["ok"] is graphs_exists and rep["paths"]["staging_prefix"]["exists"] is True
    with pytest.raises(SystemExit) as e:
        cli.main(["validate-manifests", "--registry", str(reg), "--manifest-id", "t"])
    assert e.value.code == code


def test_manifest_validator(tmp_path):
    good = tmp_path / "exists"
    good.mkdir()
    m = FeatureManifest(id="t", dataset="d", paths={
        "staging_prefix": str(good), "embeddings_prefix": str(good),
        "graphs_prefix": str(tmp_path / "missing")})
    rep = validate_manifest(m)
    assert not rep["ok"]
    assert rep["paths"]["graphs_prefix"]["exists"] is False
    assert rep["paths"]["staging_prefix"]["exists"] is True


def test_manifest_registry_and_errors_match_jax(tmp_path):
    reg = load_registry(ROOT / "manifests/registry.json")
    assert "amazon_electronics_v1" in reg and "synthetic_smoke" in reg
    for mid in reg:
        m = load_manifest(mid, ROOT / "manifests/registry.json")
        want = JaxManifest.from_dict(json.loads((ROOT / reg[mid]).read_text()))
        assert m.resolve_paths() == want.resolve_paths()
        assert set(m.resolve_paths()) == {"staging_prefix", "embeddings_prefix", "graphs_prefix",
                                          "item_features"}
    bad = [{"id": "x", "dataset": "y", "paths": {}, "defaults": {}},
           {"id": "x", "dataset": "y", "paths": {"staging_prefix": "a", "embeddings_prefix": "b",
                                                 "graphs_prefix": "c"}},
           {"dataset": "y"}]
    for d in bad:
        with pytest.raises(ValueError) as got:
            FeatureManifest.from_dict(d)
        with pytest.raises(ValueError) as want:
            JaxManifest.from_dict(d)
        assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match="Manifest id not found"):
        load_manifest("nope", ROOT / "manifests/registry.json")
    (tmp_path / "r.json").write_text("{}")
    with pytest.raises(ValueError, match="Registry missing 'manifests'"):
        load_registry(tmp_path / "r.json")


def test_experiment_tracker_roundtrip_matches_jax(tmp_path):
    def drive(tr):
        tr.start_run("runA")
        tr.log_params({"lr": 1e-3, "layers": 2})
        tr.log_metrics({"ndcg@20": 0.016})
        tr.log_time_series({"loss": 0.5}, step=1)
        tr.log_artifact("tmp/x.npz")
        tr.end_run()
        return tr.read_run("runA")

    got = drive(ExperimentTracker("exp1", root=str(tmp_path / "port")))
    want = drive(JaxTracker("exp1", root=str(tmp_path / "jax")))
    strip = [{k: v for k, v in r.items() if k != "ts"} for r in got]
    assert strip == [{k: v for k, v in r.items() if k != "ts"} for r in want]
    assert [r["type"] for r in got] == ["run_start", "params", "metrics", "time_series",
                                        "artifact", "run_end"]
    tr = ExperimentTracker("exp1", root=str(tmp_path / "port"))
    assert tr.list_runs() == ["runA"]
    with pytest.raises(RuntimeError):
        tr.log_metrics({"x": 1})  # no active run
    with ExperimentTracker("exp2", root=str(tmp_path / "port")) as ctx:
        ctx.log_metrics({"a": 2})
    assert ctx.read_run(ctx.list_runs()[0])[-1]["status"] == "complete"


def test_timed_records_and_emits(capsys):
    sink = {}
    with timed("step", sink=sink, emit=True):
        time.sleep(0.01)
    assert sink["step"] >= 0.01
    line = json.loads(capsys.readouterr().out)
    assert line["event"] == "timing" and line["name"] == "step" and line["seconds"] == sink["step"]
    with pytest.raises(ZeroDivisionError), timed("boom", sink=sink):
        1 / 0
    assert "boom" in sink


def test_seeding_helpers():
    root = set_seeds(7)
    a = np.random.rand(3)
    assert np.array_equal(a, np.random.RandomState(7).rand(3))
    assert torch.equal(torch.rand(3), torch.rand(3, generator=torch.Generator().manual_seed(7)))
    keys = key_seq(root)
    g1, g2 = next(keys), next(keys)
    x1, x2 = torch.rand(4, generator=g1), torch.rand(4, generator=g2)
    assert not torch.equal(x1, x2)
    again = key_seq(set_seeds(7))
    assert torch.equal(torch.rand(4, generator=next(again)), x1)
    assert np.array_equal(host_rng(3).random(2), np.random.default_rng(3).random(2))


# -- the quality anchor ------------------------------------------------------


def _jax_dataset_block(cfg):
    """The JAX anchor's `dataset` block (tools/anchor.py `realized`) from JAX's
    generator alone, with pandas as the JAX anchor computes it."""
    df = jax_syn.amazon_calibrated_interactions(
        **cfg["shape"], seed=cfg["seed"], affinity_strength=cfg["affinity"], return_factors=True,
        n_clusters=cfg["n_clusters"], candidate_pool=cfg["candidate_pool"],
        item_cluster_sigma=cfg["item_cluster_sigma"], user_cluster_sigma=cfg["user_cluster_sigma"],
        cluster_pool_bias=cfg["cluster_pool_bias"])[0]
    pairs = df.drop_duplicates(subset=["user_id", "asin"])
    ud = pairs.groupby("user_id").size().values
    idg = pairs.groupby("asin").size().values
    return {
        "rows": int(len(df)), "users": int(df.user_id.nunique()), "items": int(df.asin.nunique()),
        "user_deg_mean": round(float(ud.mean()), 2), "user_deg_std": round(float(ud.std()), 2),
        "item_deg_mean": round(float(idg.mean()), 2), "item_deg_std": round(float(idg.std()), 2),
        "reference_marginals": {"user": [7.07, 6.97], "item": [21.60, 65.34],
                                "note": "reference stats are over the TRAIN split's deduped pairs"},
    }


def test_anchor_micro_smoke_matches_jax_generator(tmp_path):
    """`cli anchor --scale micro` on the CPU with a gate file, in a process
    where pandas cannot be imported (the card's machine may lack it): every
    leg reported, the gate PASS, the dataset block and generator config
    equal to what JAX's generator gives for that config."""
    gate = tmp_path / "gate.json"
    gate.write_text(json.dumps({"min": {"popularity.ndcg@20": 0.001,
                                        "gat_beyond_parity_32steps.ndcg@20": 0.9}}))
    argv = ["anchor", "--scale", "micro", "--epochs", "1", "--skip-beyond", "--device", "cpu",
            "--out", str(tmp_path / "a"), "--gate-baseline", str(gate)]
    code = ("import sys\nsys.modules['pandas'] = None\n"
            f"from plotpointe_tpu_torch.cli import main\nmain({argv!r})\n")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}  # light on a shared test machine
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True, env=env).stdout
    res = json.loads((tmp_path / "a" / "anchor.json").read_text())
    for k in ("chance", "popularity", "inverse_popularity", "factor_oracle", "gat_init",
              "gat_reference_protocol", "dataset"):
        assert k in res, k
    assert json.loads(out.strip().splitlines()[-1]) == {
        "anchor_gate": "PASS", "skipped": ["gat_beyond_parity_32steps.ndcg@20"]}
    cfg = res["generator_config"]
    assert cfg == {"shape": {"n_users": 2000, "n_items": 1000, "n_interactions": 20_000},
                   "seed": 0, "affinity": 14.0, "n_clusters": 64, "candidate_pool": 64,
                   "item_cluster_sigma": 0.35, "user_cluster_sigma": 0.35,
                   "cluster_pool_bias": 0.6, "feature_noise": 0.02}
    assert res["dataset"] == _jax_dataset_block(cfg)
    assert res["generator_hash"] == anchor.generator_hash(cfg)
    assert 0.0 <= res["gat_init"]["ndcg@20"] <= 1.0 and "corr_log_norm_vs_log_degree" in res["gat_init"]
    assert np.isfinite(res["gat_reference_protocol"]["ndcg@20"])
    assert res["popularity"]["ndcg@20"] > res["chance"]["ndcg@20"]


def test_anchor_gate_fails_with_exit_3(tmp_path, capsys):
    results = {"generator_hash": "abc", "popularity": {"ndcg@20": 0.05}}
    spec = {"generator_hash": "abc", "min": {"popularity.ndcg@20": 0.1, "chance.ndcg@20": 0.0}}
    assert anchor.gate(results, spec) == (["popularity.ndcg@20: 0.05 < 0.1"], ["chance.ndcg@20"])
    assert anchor.gate(results, {"generator_hash": "xyz", "min": {}})[0] == [
        "generator_hash: abc != pinned xyz"]
    assert anchor.gate(results, {"min": {"chance.ndcg@20": 0.0}}) == (
        ["all gated sections skipped"], ["chance.ndcg@20"])
    gate = tmp_path / "gate.json"
    gate.write_text(json.dumps({"min": {"popularity.ndcg@20": 0.999}}))
    with pytest.raises(SystemExit) as e:
        cli.main(["anchor", "--scale", "micro", "--epochs", "1", "--skip-reference",
                  "--skip-beyond", "--device", "cpu", "--out", str(tmp_path / "a"),
                  "--gate-baseline", str(gate)])
    assert e.value.code == 3
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["anchor_gate"] == "FAIL"


def test_port_baseline_pins_its_own_generator_hash():
    """The port's baseline file: the JAX baseline's bands and generator
    config, and the hash of that config with the port's generator source."""
    mine = json.loads(anchor.BASELINE.read_text())
    jax_base = json.loads((ROOT / "manifests/anchor_baseline.json").read_text())
    assert mine["min"] == jax_base["min"]
    assert mine["generator_config"] == jax_base["generator_config"]
    assert mine["generator_hash"] == anchor.generator_hash(mine["generator_config"])
    flags = anchor.build_parser(__import__("argparse").ArgumentParser()).parse_args([])
    assert anchor.generator_config(
        flags.scale, flags.seed, flags.affinity, flags.clusters, flags.candidate_pool,
        flags.item_cluster_sigma, flags.user_cluster_sigma, flags.cluster_pool_bias,
        flags.feature_noise) == mine["generator_config"]


def test_cli_ablate_micro(tmp_path, capsys):
    """`cli ablate --only fused_bpr_l2_h1,lightgcn` on a micro data set on
    the CPU: each variant trains and reports test metrics, and the report
    file is written."""
    inter, (_, i_fac) = synthetic_interactions(120, 60, 1500, seed=2, return_factors=True)
    staging, emb = tmp_path / "staging", tmp_path / "emb"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz", **inter)
    n_items = len(first_occurrence_unique(inter["asin"]))
    np.save(emb / "fused_interacted.npy", synthetic_features(n_items, 16, seed=2))
    cli.main(["ablate", "--staging-prefix", str(staging), "--embeddings-prefix", str(emb),
              "--models-prefix", str(tmp_path / "m"), "--hidden-dim", "16", "--epochs", "1",
              "--samples-per-epoch", "400", "--eval-neg-k", "20",
              "--only", "fused_bpr_l2_h1,lightgcn", "--device", "cpu"])
    report = json.loads((tmp_path / "m" / "ablations_report.json").read_text())
    assert sorted(report) == ["fused_bpr_l2_h1", "lightgcn"]
    for name, r in report.items():
        assert "error" not in r, (name, r)
        assert 0.0 <= r["test"]["ndcg@20"] <= 1.0 and np.isfinite(r["best_val_ndcg@20"])
    assert "fused_bpr_l2_h1" in capsys.readouterr().out


def test_cli_ablate_exits_1_when_a_variant_fails(tmp_path, capsys):
    inter = synthetic_interactions(60, 30, 600, seed=1)
    (tmp_path / "s").mkdir()
    np.savez(tmp_path / "s" / "interactions.npz", **inter)
    with pytest.raises(SystemExit, match="fused_bpr_l2_h1"):  # no features to read
        cli.main(["ablate", "--staging-prefix", str(tmp_path / "s"), "--embeddings-prefix",
                  str(tmp_path / "e"), "--models-prefix", str(tmp_path / "m"), "--epochs", "1",
                  "--only", "fused_bpr_l2_h1", "--device", "cpu"])
    assert "error" in json.loads((tmp_path / "m" / "ablations_report.json").read_text())[
        "fused_bpr_l2_h1"]
