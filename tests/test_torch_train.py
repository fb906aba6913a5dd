"""The port's training path on the CPU against the JAX package: one training
step (loss and every gradient), the optimizers, the positives table, exact
negative sampling, the evaluation sums, and the trainer end to end
(learning, JAX-readable checkpoints, resume, `cli train`)."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from plotpointe_tpu.data.splits import padded_positives as jax_padded_positives
from plotpointe_tpu.data.synthetic import synthetic_features, synthetic_interactions
from plotpointe_tpu.graphs.csr import build_bipartite_graph as jax_bipartite
from plotpointe_tpu.models.gat import GATModel as JaxGAT
from plotpointe_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from plotpointe_tpu.train.checkpoint import load_config as jax_load_config
from plotpointe_tpu.train.evaluate import _eval_chunk
from plotpointe_tpu.train.losses import LOSSES as JAX_LOSSES
from plotpointe_tpu.train.sampling import _rank_to_item
from plotpointe_tpu.train.sampling import sample_eval_negatives as jax_eval_negatives
from plotpointe_tpu.train.trainer import make_optimizer as jax_make_optimizer
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.config import TrainConfig
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits, padded_positives
from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.train.checkpoint import params_from_jax
from plotpointe_tpu_torch.train.evaluate import eval_from_negatives
from plotpointe_tpu_torch.train.sampling import (
    rank_to_item, sample_bpr_triples, sample_eval_negatives)
from plotpointe_tpu_torch.train.trainer import Trainer, make_optimizer


@pytest.fixture(scope="module")
def setup():
    """The data of tests/test_train_e2e.py: factor-structured interactions
    and 32-d item features in index order."""
    df, (_, i_fac) = synthetic_interactions(n_users=400, n_items=250, n_interactions=9000, seed=3,
                                           return_factors=True)
    u2i, i2i = build_node_maps(df)
    s = build_splits(df, u2i, i2i)
    idx_of_item = np.empty(s.n_items, dtype=np.int64)
    for asin, idx in i2i.items():
        idx_of_item[idx] = int(asin[1:])
    feats = synthetic_features(i_fac.shape[0], 32, seed=3, factors=i_fac)[idx_of_item]
    return df, s, feats.astype(np.float32)


def _trainer(s, feats, **cfg_kw):
    kw = dict(epochs=2, samples_per_epoch=5000, eval_neg_k=50, eval_chunk=128, hidden_dim=16)
    cfg = TrainConfig(**(kw | cfg_kw))
    model = GATModel(s.n_users, s.n_items, feats.shape[1], hidden_dim=cfg.hidden_dim,
                     n_layers=cfg.layers, attn_dropout=cfg.attn_dropout)
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    return Trainer(model, cfg, graph, s, item_feats=feats, device="cpu")


# -- one training step --------------------------------------------------------


@pytest.mark.parametrize("loss", ["bpr", "bce"])
def test_one_step_loss_and_grads_match_jax(setup, loss):
    """JAX `GATModel(attn_impl="pallas")` (bf16 rows, hash dropout, Pallas
    B1/B2 in interpret mode) and the port's trainer loss on the same
    parameters, triples and per-layer dropout seeds. Tolerance: rtol 5e-4 and
    an atol of 1e-3 times each gradient's largest entry (the gradients of a
    mean over 3,000 triples are ~1e-5 in size, so a fixed atol would hold
    nothing), and rtol 1e-5 on the loss. The band is wider than the
    attention op's (test_torch_attention_bwd.py): the two packages' first
    layers differ in the last f32 bit, so a few second-layer rows round to
    another bf16 value, and sums with cancellation over every item (the
    item_proj.b gradient) show it at ~2e-4 of their largest entry."""
    _, s, feats = setup
    nu, ni = s.n_users, s.n_items
    jm = JaxGAT(nu, ni, feats.shape[1], hidden_dim=32, n_layers=2, heads=1, attn_dropout=0.1,
                attn_impl="pallas")
    params = jm.init(jax.random.key(0))
    jg = jax_bipartite(s.train_u, s.train_i, nu, ni, weight=s.train_w).with_layout().to_device()
    rng = np.random.default_rng(4)
    users = np.flatnonzero(np.bincount(s.train_u, minlength=nu))
    u = rng.choice(users, 3000).astype(np.int32)
    i = rng.integers(0, ni, 3000).astype(np.int32)
    j = rng.integers(0, ni, 3000).astype(np.int32)
    k_drop = jax.random.key(7)

    def loss_fn(p):
        z = jm.apply(p, jnp.asarray(feats), jg, train=True, rng=k_drop)
        U, I = z[:nu], z[nu:]
        return JAX_LOSSES[loss](jnp.sum(U[u] * I[i], -1), jnp.sum(U[u] * I[j], -1))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    seeds = [int(jax.random.bits(jax.random.fold_in(k_drop, li), (), jnp.uint32)) for li in range(2)]

    tr = _trainer(s, feats, hidden_dim=32, loss=loss)
    tr.model.hs_dtype = torch.bfloat16
    flat = {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tr.model.load_state_dict(params_from_jax(flat))
    got = tr._loss(*(torch.from_numpy(x) for x in (u, i, j)), seeds)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want_loss), rtol=1e-5)
    want = params_from_jax({jax.tree_util.keystr(kp): np.asarray(v)
                            for kp, v in jax.tree_util.tree_flatten_with_path(want_grads)[0]})
    named = dict(tr.model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(named[name].grad.numpy(), w.numpy(), rtol=5e-4,
                                   atol=1e-3 * scale, err_msg=name)


# -- optimizers ----------------------------------------------------------------


@pytest.mark.parametrize("name,warmup", [("adam", 0), ("adamw", 0), ("adam", 10), ("adamw", 10)])
def test_optimizer_updates_match_optax(name, warmup):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=w.shape).astype(np.float32) for _ in range(3)]
    tx = jax_make_optimizer(1e-2, 1e-2, name, warmup)
    jw, st = jnp.asarray(w), None
    st = tx.init(jw)
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt, sched = make_optimizer([p], 1e-2, 1e-2, name, warmup)
    assert (sched is None) == (warmup == 0)
    for g in grads:  # the first update, then two more (moments, bias correction, ramp)
        upd, st = tx.update(jnp.asarray(g), st, jw)
        jw = optax.apply_updates(jw, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
        if sched is not None:
            sched.step()
        # rtol 1e-6, and atol 3e-7: ~2 ulp of these ~1-sized f32 weights, where
        # the two implementations round the moments differently (torch's lerp
        # against optax's multiply-add) and an update leaves a weight near 0
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=3e-7)


def test_adam_collapses_and_adamw_holds_on_a_plateau():
    """tests/test_train_e2e.py:96-122: with zero gradients, coupled L2 shrinks
    weights ~lr per step; decoupled decay only by lr * l2 per step."""
    finals = {}
    for name in ("adam", "adamw"):
        p = torch.nn.Parameter(torch.ones(4))
        opt, _ = make_optimizer([p], 1e-2, 1e-4, name)
        for _ in range(100):
            p.grad = torch.zeros(4)
            opt.step()
        finals[name] = float(p[0])
    assert finals["adam"] < 0.25, finals
    assert finals["adamw"] > 0.99, finals


# -- positives table and samplers ----------------------------------------------


@pytest.mark.parametrize("max_degree", [None, 512, 3])
def test_padded_positives_equal_jax(setup, max_degree):
    _, s, _ = setup
    table, deg = padded_positives(s, max_degree=max_degree)
    want_table, want_deg = jax_padded_positives(s, max_degree=max_degree)
    assert table.dtype == want_table.dtype and deg.dtype == want_deg.dtype
    np.testing.assert_array_equal(table, want_table)
    np.testing.assert_array_equal(deg, want_deg)


def _sorted_rows(rng, rows, width, n_items):
    out = np.full((rows, width), n_items, np.int32)
    for r in range(rows):
        c = int(rng.integers(0, min(width, n_items) + 1))
        out[r, :c] = np.sort(rng.choice(n_items, c, replace=False))
    if width >= n_items:
        out[0, :n_items] = np.arange(n_items)  # every item avoided: the walk runs into the pads
    return out


def test_rank_to_item_equals_jax_walk():
    rng = np.random.default_rng(2)
    n_items = 40
    avoid = _sorted_rows(rng, 300, 48, n_items)
    r = rng.integers(0, n_items + 5, 300).astype(np.int32)  # reachable ranks and beyond
    want = np.asarray(_rank_to_item(jnp.asarray(r), jnp.asarray(avoid)))
    np.testing.assert_array_equal(rank_to_item(torch.from_numpy(r), torch.from_numpy(avoid)).numpy(),
                                  want)
    rk = rng.integers(0, n_items, (300, 7)).astype(np.int32)  # [C, K] ranks against [C, A] rows
    want = np.asarray(_rank_to_item(jnp.asarray(rk), jnp.asarray(avoid)))
    np.testing.assert_array_equal(rank_to_item(torch.from_numpy(rk), torch.from_numpy(avoid)).numpy(),
                                  want)


def _tables(s):
    table, deg = padded_positives(s)
    train_users = torch.from_numpy(np.flatnonzero(deg > 0).astype(np.int32))
    return torch.from_numpy(table), torch.from_numpy(deg), train_users


def test_bpr_triples_are_exact(setup):
    _, s, _ = setup
    table, deg, train_users = _tables(s)
    u, i, j = sample_bpr_triples(torch.Generator().manual_seed(0), train_users, table, deg,
                                 s.n_items, 5000)
    assert u.dtype == i.dtype == j.dtype == torch.int32
    rows = table[u.long()]
    assert bool(((j >= 0) & (j < s.n_items)).all())
    assert bool((rows == i[:, None]).any(1).all())  # i is one of u's positives
    assert not bool((rows == j[:, None]).any(1).any())  # j is none of them


def test_bpr_users_uniform_and_positives_uniform(setup):
    _, s, _ = setup
    table, deg, train_users = _tables(s)
    u, i, _ = sample_bpr_triples(torch.Generator().manual_seed(1), train_users, table, deg,
                                 s.n_items, 60_000)
    counts = np.bincount(u.numpy(), minlength=s.n_users)[train_users.numpy()]
    expected = 60_000 / len(train_users)
    assert counts.min() > 0 and counts.std() < 5 * np.sqrt(expected)
    # one user with three positives: each drawn a third of the time
    one = torch.tensor([0], dtype=torch.int32)
    t1 = torch.tensor([[2, 5, 7, 10]], dtype=torch.int32)
    _, i1, _ = sample_bpr_triples(torch.Generator().manual_seed(2), one, t1,
                                  torch.tensor([3], dtype=torch.int32), 10, 30_000)
    c = np.bincount(i1.numpy(), minlength=10)[[2, 5, 7]]
    assert (np.abs(c - 10_000) < 5 * np.sqrt(10_000)).all()


def test_negatives_uniform_over_complement():
    table = torch.tensor([[2, 5, 7, 10]], dtype=torch.int32)
    _, _, j = sample_bpr_triples(torch.Generator().manual_seed(3), torch.tensor([0], dtype=torch.int32),
                                 table, torch.tensor([3], dtype=torch.int32), 10, 70_000)
    j = j.numpy()
    assert set(np.unique(j)) == {0, 1, 3, 4, 6, 8, 9}
    counts = np.bincount(j, minlength=10)[[0, 1, 3, 4, 6, 8, 9]]
    assert (np.abs(counts - 10_000) < 5 * np.sqrt(10_000)).all()


def test_eval_negatives_avoid_positives(setup):
    _, s, _ = setup
    table, deg, _ = _tables(s)
    negs = sample_eval_negatives(torch.Generator().manual_seed(4), torch.from_numpy(s.val_u),
                                 torch.from_numpy(s.val_i), table, deg, s.n_items, 200).numpy()
    assert negs.shape == (len(s.val_u), 200)
    assert ((negs >= 0) & (negs < s.n_items)).all()
    tbl = table.numpy()
    for r in range(len(s.val_u)):
        u, pos = int(s.val_u[r]), int(s.val_i[r])
        assert pos not in negs[r]
        assert not np.isin(negs[r], tbl[u][tbl[u] < s.n_items]).any()
    # the eval positive is also a train positive: the avoid set counts it once
    negs = sample_eval_negatives(torch.Generator().manual_seed(5), torch.tensor([0], dtype=torch.int32),
                                 torch.tensor([3], dtype=torch.int32),
                                 torch.tensor([[1, 3, 8, 8]], dtype=torch.int32),
                                 torch.tensor([2], dtype=torch.int32), 8, 4000).numpy()
    assert set(np.unique(negs)) == {0, 2, 4, 5, 6, 7}


# -- evaluation ----------------------------------------------------------------


def test_eval_sums_equal_jax_eval_chunk():
    """`eval_from_negatives` fed the negatives JAX draws inside `_eval_chunk`
    (same key): every sum equal, with a NaN user (ranked last) and collapsed
    users (every negative ties)."""
    rng = np.random.default_rng(6)
    n_users, n_items, c, neg_k = 50, 300, 64, 100
    U = rng.normal(size=(n_users, 16)).astype(np.float32)
    I = rng.normal(size=(n_items, 16)).astype(np.float32)
    U[3] = np.nan
    U[4:6] = 0.0
    users = rng.integers(0, n_users, c).astype(np.int32)
    users[:3] = [3, 4, 5]
    pos = rng.integers(0, n_items, c).astype(np.int32)
    valid = (rng.random(c) < 0.9).astype(np.float32)
    valid[:3] = 1.0
    table = _sorted_rows(rng, n_users, 20, n_items)
    table[0] = n_items
    deg = (table < n_items).sum(1).astype(np.int32)
    key = jax.random.key(3)
    ja = [jnp.asarray(x) for x in (U, I, users, pos, valid, table, deg)]
    want = jax.tree.map(float, _eval_chunk(*ja, key, neg_k, (10, 20)))
    negs = np.asarray(jax_eval_negatives(key, ja[2], ja[3], ja[5], ja[6], n_items, neg_k))
    got = eval_from_negatives(*(torch.from_numpy(x) for x in (U, I, users, pos, negs, valid)),
                              ks=(10, 20))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-6, err_msg=k)
    assert want["tie_frac_sum"] >= 2.0  # the collapsed users


# -- trainer end to end ----------------------------------------------------------


def test_gat_training_learns(setup):
    """tests/test_train_e2e.py:36-52 with the port's Trainer on the CPU."""
    _, s, feats = setup
    tr = _trainer(s, feats, epochs=8, samples_per_epoch=20_000, eval_neg_k=100, hidden_dim=32)
    tr.model.init_params(torch.Generator().manual_seed(9))
    untrained = tr.evaluate(s.test_u, s.test_i, 0)
    results = tr.fit()
    assert results["test"]["ndcg@20"] > untrained["ndcg@20"]
    assert results["best_val_ndcg@20"] > 0
    losses = [h["loss"] for h in results["history"]]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_best_checkpoint_reads_in_jax(setup, tmp_path):
    _, s, feats = setup
    tr = _trainer(s, feats)
    ckpt = tmp_path / "best.npz"
    tr.fit(checkpoint_path=str(ckpt))
    config = jax_load_config(ckpt)
    assert config["model_family"] == "gat" and config["train_config"] == tr.cfg.to_dict()
    jm = JaxGAT.from_config(config)
    params, _ = jax_load_checkpoint(ckpt, jm.init(jax.random.key(0)))
    state = tr.model.state_dict()  # the best parameters after fit
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        dotted = ".".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in kp)
        np.testing.assert_array_equal(np.asarray(leaf), state[dotted].numpy())


def test_resume_gives_the_uninterrupted_history(setup, tmp_path):
    _, s, feats = setup
    keys = ("epoch", "loss", "val_recall@20", "val_ndcg@20", "val_tie_fraction")
    straight = _trainer(s, feats, epochs=4).fit()
    resume = str(tmp_path / "resume.pt")
    first = _trainer(s, feats, epochs=2).fit(resume_path=resume)
    second = _trainer(s, feats, epochs=4).fit(resume_path=resume)
    assert [h["epoch"] for h in second["history"]] == [3, 4]
    got = [[h[k] for k in keys] for h in first["history"] + second["history"]]
    assert got == [[h[k] for k in keys] for h in straight["history"]]
    assert second["test"] == straight["test"]


def test_cli_train_on_cpu(setup, tmp_path, capsys):
    df, s, feats = setup
    staging, emb, models = tmp_path / "staging", tmp_path / "emb", tmp_path / "models"
    staging.mkdir()
    emb.mkdir()
    cols = {c: df[c].to_numpy() for c in ("user_id", "asin", "ts", "rating")}
    np.savez(staging / "interactions.npz",
             **{c: v.astype(str) if v.dtype == object else v for c, v in cols.items()})
    np.save(emb / "txt_interacted.npy", feats)
    base = ["train", "--staging-prefix", str(staging), "--embeddings-prefix", str(emb),
            "--models-prefix", str(models), "--item-features", "txt", "--device", "cpu"]
    cli.main(base + ["--epochs", "2", "--samples-per-epoch", "2000", "--eval-neg-k", "50",
                     "--hidden-dim", "32", "--loss", "bce", "--optimizer", "adamw"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"best_val_ndcg@20", "test"} and "ndcg@20" in out["test"]
    ckpts = list((models / "checkpoints").glob("*.npz"))
    assert len(ckpts) == 1 and len(list(models.glob("metrics_*.json"))) == 1
    assert jax_load_config(ckpts[0])["train_config"]["loss"] == "bce"
    # LightGCN trains from the same command line (it reads no features)
    lg_models = tmp_path / "lg_models"
    lg = ["train", "--model-family", "lightgcn", "--staging-prefix", str(staging),
          "--embeddings-prefix", str(tmp_path / "none"), "--models-prefix", str(lg_models),
          "--epochs", "2", "--eval-neg-k", "50", "--device", "cpu"]
    cli.main(lg)
    assert "ndcg@20" in json.loads(capsys.readouterr().out)["test"]
    (lg_ckpt,) = (lg_models / "checkpoints").glob("*.npz")
    assert jax_load_config(lg_ckpt)["model_family"] == "lightgcn"
    # --mesh trains over 2 spawned gloo ranks and writes the same artifacts
    # (the numbers against this run: tests/test_torch_sharded_trainer.py)
    mesh_models = tmp_path / "mesh_models"
    cli.main(base[:-6] + ["--models-prefix", str(mesh_models), "--item-features", "txt",
                          "--device", "cpu", "--mesh", "data:2", "--epochs", "1",
                          "--samples-per-epoch", "500", "--eval-neg-k", "50", "--hidden-dim", "32"])
    assert "ndcg@20" in json.loads(capsys.readouterr().out)["test"]
    (mesh_ckpt,) = (mesh_models / "checkpoints").glob("*.npz")
    assert jax_load_config(mesh_ckpt)["train_config"]["mesh_shape"] == "data:2"
    assert len(list(mesh_models.glob("metrics_*.json"))) == 1
