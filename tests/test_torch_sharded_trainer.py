"""ShardedTrainer.fit() on 2 gloo CPU ranks against the port's
single-device Trainer; mirrors tests/test_sharded_trainer.py, with its
bands: losses rtol 2e-4 (5e-4 on bf16 rows, 5e-3 for LightGCN on bf16
rows), metrics atol 2e-3, exported item rows rtol 5e-3 / atol 5e-5. With
attention dropout on, the sharded fit equals the single-device fit too
(the hash mask over canonical edge ids). Then `cli train --mesh data:2
--device cpu` end to end against `cli train --device cpu`. One spawn of 2
ranks runs every fit."""
import json

import numpy as np
import pytest
import torch

from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.config import TrainConfig
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
from plotpointe_tpu_torch.data.synthetic import synthetic_features, synthetic_interactions
from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
from plotpointe_tpu_torch.parallel.cases import run_cases
from plotpointe_tpu_torch.parallel.multihost import spawn
from plotpointe_tpu_torch.pipeline import make_model
from plotpointe_tpu_torch.train.checkpoint import load_checkpoint
from plotpointe_tpu_torch.train.trainer import Trainer

METRICS_ATOL = 2e-3
EXPORT = dict(rtol=5e-3, atol=5e-5)
GAT = dict(hidden_dim=16, layers=2, epochs=3, samples_per_epoch=64, eval_neg_k=32,
           attn_dropout=0.0, seed=11)
# batch 32 (JAX's test: 8): ~20 steps an epoch keep the file light under `-n 6`
LIGHTGCN = dict(model_family="lightgcn", embed_dim=16, n_prop_layers=2, epochs=3, batch_size=32,
                neg_per_pos=5, eval_neg_k=32, seed=13)
# name: (problem seed, config, loss rtol)
FITS = {
    "gat": (3, GAT, 2e-4),
    "gat_fused": (7, GAT | dict(epochs=2, seed=17, attn_impl="pallas"), 5e-4),  # bf16 rows
    "gat_2_heads": (3, GAT | dict(heads=2), 2e-4),
    "gat_dropout": (3, GAT | dict(attn_dropout=0.1), 2e-4),
    "lightgcn": (5, LIGHTGCN, 2e-4),
    "lightgcn_fused": (5, LIGHTGCN | dict(spmm_impl="pallas"), 5e-3),  # bf16 rows
}


def _problem(seed, n_users=80, n_items=60, n_inter=900, feat_dim=24):
    df = synthetic_interactions(n_users=n_users, n_items=n_items, n_interactions=n_inter, seed=seed)
    s = build_splits(df, *build_node_maps(df))
    return df, s, synthetic_features(s.n_items, feat_dim, seed=seed)


def _single(seed, cfg_kw):
    """The single-device fit on one thread, as each rank runs (tiny ops on
    many threads crawl when the test run loads every core)."""
    df, s, feats = _problem(seed)
    cfg = TrainConfig(**cfg_kw)
    feats = feats if cfg.model_family == "gat" else None
    model = make_model(cfg, s.n_users, s.n_items, 0 if feats is None else feats.shape[1], device="cpu")
    g = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = Trainer(model, cfg, g, s, item_feats=feats, device="cpu")
        return tr.fit(), tr.export_item_embeddings()
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def resume_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_resume") / "resume.pt")


@pytest.fixture(scope="module")
def ranks(resume_path):
    cases = {}
    for name, (seed, cfg, _) in FITS.items():
        df, s, feats = _problem(seed)
        cases[name] = dict(kind="fit", interactions=df, cfg=cfg,
                           feats=feats if cfg.get("model_family", "gat") == "gat" else None)
    # the uninterrupted "gat" run, cut after epoch 2 and resumed for epoch 3
    cases["resume_a"] = dict(cases["gat"], cfg=GAT | dict(epochs=2), resume=resume_path)
    cases["resume_b"] = dict(cases["gat"], resume=resume_path)
    out = spawn(run_cases, 2, (list(cases.values()),), device="cpu", timeout_s=400)
    return [dict(zip(cases, r)) for r in out]


@pytest.mark.multihost
@pytest.mark.parametrize("name", list(FITS))
def test_sharded_fit_matches_single_device(ranks, name):
    seed, cfg, loss_rtol = FITS[name]
    want, want_items = _single(seed, cfg)
    for r in ranks:
        got = r[name]
        assert [h["epoch"] for h in got["history"]] == [h["epoch"] for h in want["history"]]
        for hg, hw in zip(got["history"], want["history"]):
            np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(got["best_val_ndcg@20"], want["best_val_ndcg@20"], atol=METRICS_ATOL)
        for k, v in want["test"].items():
            np.testing.assert_allclose(got["test"][k], v, atol=METRICS_ATOL, err_msg=k)
        np.testing.assert_allclose(got["items"], want_items, **EXPORT)
    # every rank ends with the same numbers
    assert ranks[0][name]["test"] == ranks[1][name]["test"]
    np.testing.assert_array_equal(ranks[0][name]["items"], ranks[1][name]["items"])


@pytest.mark.multihost
def test_sharded_resume_gives_the_uninterrupted_run(ranks):
    """Cut after epoch 2 (the state gathered, rank 0 writes it), resumed for
    epoch 3: the same epoch-3 loss and test metrics as the straight run."""
    straight, resumed = ranks[0]["gat"], ranks[0]["resume_b"]
    assert [h["epoch"] for h in resumed["history"]] == [3]
    np.testing.assert_allclose(resumed["history"][0]["loss"], straight["history"][2]["loss"], rtol=1e-6)
    for k, v in straight["test"].items():
        np.testing.assert_allclose(resumed["test"][k], v, atol=1e-6, err_msg=k)


def _write_staging(tmp_path, seed=3):
    df, s, feats = _problem(seed)
    staging, emb = tmp_path / "staging", tmp_path / "emb"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz", **{c: np.asarray(df[c]) for c in df})
    np.save(emb / "txt_interacted.npy", feats)
    return staging, emb


@pytest.mark.multihost
@pytest.mark.parametrize("family", ["gat", "lightgcn"])
def test_cli_train_mesh_data2_on_cpu(tmp_path, capsys, family):
    """`train --mesh data:2 --device cpu` spawns 2 gloo ranks and writes what
    `train` writes: one checkpoint (the best parameters, whole) and one
    metrics JSON, whose losses, metrics and parameters match the
    single-device run's."""
    staging, emb = _write_staging(tmp_path)
    base = ["train", "--model-family", family, "--staging-prefix", str(staging),
            "--embeddings-prefix", str(emb), "--item-features", "txt", "--device", "cpu",
            "--epochs", "2", "--samples-per-epoch", "128", "--eval-neg-k", "32", "--hidden-dim", "16"]
    runs = {}
    for mesh in (None, "data:2"):
        models = tmp_path / f"models_{mesh or 'single'}"
        cli.main(base + ["--models-prefix", str(models)] + (["--mesh", mesh] if mesh else []))
        printed = json.loads(capsys.readouterr().out)
        (ckpt,) = (models / "checkpoints").glob("*.npz")
        (metrics,) = models.glob("metrics_*.json")
        runs[mesh] = printed, load_checkpoint(ckpt), json.loads(metrics.read_text())
    (p1, (c1, cfg1), m1), (p2, (c2, cfg2), m2) = runs[None], runs["data:2"]
    assert set(c1) == set(c2) and cfg1["model_family"] == cfg2["model_family"] == family
    assert cfg2["train_config"]["mesh_shape"] == "data:2"
    for k in c1:
        assert c1[k].shape == c2[k].shape, k
        np.testing.assert_allclose(c2[k], c1[k], **EXPORT, err_msg=k)
    for h1, h2 in zip(m1["history"], m2["history"]):
        np.testing.assert_allclose(h2["loss"], h1["loss"], rtol=2e-4)
    for k, v in p1["test"].items():
        np.testing.assert_allclose(p2["test"][k], v, atol=METRICS_ATOL, err_msg=k)
