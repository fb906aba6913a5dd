"""The port's LightGCN path on the CPU against the JAX package: the
normalized edge values, the CSR SpMM (kernel 7's plain version, the static
operator and the generic op; Pallas in interpret mode on the JAX side), the
propagation, one training step, the negatives, learning, the export and
checkpoints in both directions.

Tolerances: forward and gradient to x rtol 1e-4 / atol 1e-5
(tests/test_gat_fused.py:185), at f32 and bf16 rows alike: both packages
round the same rows (and, in the backward, the same cotangent) to bf16 and
sum in f32, so only the summation order differs. One training step: loss
rtol 1e-5, gradients rtol 5e-4 / atol 1e-4.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.data.synthetic import synthetic_interactions
from plotpointe_tpu.graphs.csr import build_bipartite_graph as jax_bipartite
from plotpointe_tpu.graphs.csr import build_graph as jax_build_graph
from plotpointe_tpu.graphs.csr import symmetric_normalized_weights as jax_weights
from plotpointe_tpu.models.lightgcn import LightGCNModel as JaxLightGCN
from plotpointe_tpu.ops.segment import spmm as jax_spmm
from plotpointe_tpu.ops.spmm_kernel import make_spmm as jax_make_spmm
from plotpointe_tpu.tools.export import export_item_embeddings as jax_export
from plotpointe_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from plotpointe_tpu.train.checkpoint import load_config as jax_load_config
from plotpointe_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from plotpointe_tpu.train.losses import LOSSES as JAX_LOSSES
from plotpointe_tpu.train.sampling import _rank_to_item
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.config import TrainConfig
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
from plotpointe_tpu_torch.graphs.csr import (
    build_bipartite_graph, build_graph, symmetric_normalized_weights)
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.models.lightgcn import LightGCNModel
from plotpointe_tpu_torch.ops.segment import spmm as plain_spmm
from plotpointe_tpu_torch.ops.spmm_kernel import make_spmm, spmm, spmm_csr, spmm_csr_plain
from plotpointe_tpu_torch.tools.export import export_item_embeddings
from plotpointe_tpu_torch.train.checkpoint import (
    load_checkpoint, params_from_jax, params_to_jax, save_checkpoint)
from plotpointe_tpu_torch.train.sampling import rank_to_item
from plotpointe_tpu_torch.train.trainer import Trainer

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
N, E = 180, 1400


@pytest.fixture(scope="module")
def graphs():
    """Skewed in-degrees (40% of edges into node 3), isolated nodes (150..)."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 150, E)
    dst = np.where(rng.random(E) < 0.4, 3, rng.integers(0, 150, E))
    jg = jax_build_graph(src, dst, N, pad_multiple=512).with_layout(nb=64, eb=128).to_device()
    return build_graph(src, dst, N), jg


@pytest.fixture(scope="module")
def setup():
    """The data of tests/test_train_e2e.py (factor-structured interactions)."""
    df = synthetic_interactions(n_users=400, n_items=250, n_interactions=9000, seed=3)
    s = build_splits(df, *build_node_maps(df))
    return df, s


def _jax_flat(params):
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def test_symmetric_normalized_weights_bit_equal_to_jax(graphs, setup):
    g, jg = graphs
    got = symmetric_normalized_weights(g)
    assert got.dtype == np.float32 and got.shape == (g.n_edges,)
    np.testing.assert_array_equal(got, np.asarray(jax_weights(jg))[: g.n_edges])
    _, s = setup  # the bipartite graph, with duplicate (u, i) edges
    bg = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items)
    jbg = jax_bipartite(s.train_u, s.train_i, s.n_users, s.n_items)
    np.testing.assert_array_equal(symmetric_normalized_weights(bg),
                                  np.asarray(jax_weights(jbg))[: bg.n_edges])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("xs_dtype", ["float32", "bfloat16"])
def test_spmm_matches_jax_make_spmm(graphs, d, xs_dtype):
    g, jg = graphs
    rng = np.random.default_rng(d)
    vals = rng.random(E).astype(np.float32)
    x = rng.normal(size=(N, d)).astype(np.float32)
    ct = rng.normal(size=(N, d)).astype(np.float32)
    jop = jax_make_spmm(jg, vals, xs_dtype=getattr(jnp, xs_dtype))
    want = np.asarray(jop(jnp.asarray(x)))
    want_gx = np.asarray(jax.grad(lambda xx: (jop(xx) * ct).sum())(jnp.asarray(x)))

    dt = getattr(torch, xs_dtype)
    v, xt, ctt = map(torch.from_numpy, (vals, x, ct))
    # kernel 7's plain version in both directions (the wrapper on the CPU)
    fwd = spmm_csr_plain(xt, v, g.row_ptr, g.src, dt)
    bwd = spmm_csr_plain(ctt, v[g.t_eid.long()], g.t_ptr, g.t_dst, dt)
    np.testing.assert_allclose(fwd.numpy(), want, **TOL)
    np.testing.assert_allclose(bwd.numpy(), want_gx, **TOL)
    assert torch.equal(spmm_csr(xt, v, g.row_ptr, g.src, dt), fwd)
    # the static operator, forward and autograd
    op = make_spmm(g, vals, dt)
    xg = xt.clone().requires_grad_()
    y = op(xg)
    (y * ctt).sum().backward()
    assert torch.equal(y.detach(), fwd) and torch.equal(xg.grad, bwd)
    assert np.all(y.detach().numpy()[150:] == 0)  # isolated nodes receive nothing


def test_generic_spmm_grads_match_jax_grad(graphs):
    g, jg = graphs
    rng = np.random.default_rng(3)
    vals = rng.random(E).astype(np.float32)
    x = rng.normal(size=(N, 64)).astype(np.float32)
    ct = rng.normal(size=(N, 64)).astype(np.float32)
    vpad = jnp.asarray(np.concatenate([vals, np.zeros(jg.n_padded - E, np.float32)]))
    want_y = np.asarray(jax_spmm(jg, vpad, jnp.asarray(x)))
    gv, gx = jax.grad(lambda v, xx: (jax_spmm(jg, v, xx) * ct).sum(), argnums=(0, 1))(
        vpad, jnp.asarray(x))
    tv, tx = (torch.from_numpy(a).requires_grad_() for a in (vals, x))
    y = spmm(g, tv, tx, torch.float32)
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv)[:E], **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    # the plain golden's autograd gives the same gradients
    pv, px = (torch.from_numpy(a).requires_grad_() for a in (vals, x))
    (plain_spmm(g, pv, px) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(pv.grad.numpy(), tv.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(px.grad.numpy(), tx.grad.numpy(), **GRAD_TOL)
    with pytest.raises(ValueError, match="multiple of 32"):
        spmm_csr(tx.detach()[:, :40], tv.detach(), g.row_ptr, g.src)


def _jax_lightgcn(s, impl, k=3, d=64):
    jm = JaxLightGCN(n_users=s.n_users, n_items=s.n_items, embed_dim=d, n_prop_layers=k,
                     spmm_impl=impl)
    jg = jax_bipartite(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    if impl == "pallas":
        jg = jg.with_layout()
    jg = jg.to_device()
    vals = jax_weights(jg)
    kw = {"spmm_op": jax_make_spmm(jg, vals)} if impl == "pallas" else {"norm_values": jnp.asarray(vals)}
    return jm, jg, kw


def _port_trainer(s, xs_dtype, **cfg_kw):
    cfg = TrainConfig(**({"model_family": "lightgcn", "epochs": 2, "eval_neg_k": 50,
                          "eval_chunk": 128, "batch_size": 512, "neg_per_pos": 3} | cfg_kw))
    model = LightGCNModel(s.n_users, s.n_items, cfg.embed_dim, cfg.n_prop_layers, xs_dtype=xs_dtype)
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    return Trainer(model, cfg, graph, s, device="cpu")


@pytest.mark.parametrize("impl,xs_dtype", [("xla", torch.float32), ("pallas", torch.bfloat16)])
def test_propagate_matches_jax(setup, impl, xs_dtype):
    _, s = setup
    jm, jg, kw = _jax_lightgcn(s, impl)
    params = jm.init(jax.random.key(0))
    want_u, want_i = (np.asarray(a) for a in jm.propagate(params, jg, kw.get("norm_values"),
                                                          spmm_op=kw.get("spmm_op")))
    tr = _port_trainer(s, xs_dtype)
    tr.model.load_state_dict(params_from_jax(_jax_flat(params)))
    with torch.no_grad():
        got_u, got_i = tr.model.propagate(tr._spmm_op)
    np.testing.assert_allclose(got_u.numpy(), want_u, **TOL)
    np.testing.assert_allclose(got_i.numpy(), want_i, **TOL)


@pytest.mark.parametrize("impl,xs_dtype", [("xla", torch.float32), ("pallas", torch.bfloat16)])
@pytest.mark.parametrize("loss", ["bpr", "bce"])
def test_one_step_loss_and_grads_match_jax(setup, impl, xs_dtype, loss):
    """The loss of JAX `_lightgcn_batch_step_jit` on the same (u, i, j)."""
    _, s = setup
    jm, jg, kw = _jax_lightgcn(s, impl)
    params = jm.init(jax.random.key(1))
    rng = np.random.default_rng(2)
    bs, npp = 400, 3
    idx = rng.integers(0, s.n_train, bs)
    u, i = s.train_u[idx], s.train_i[idx]
    j = rng.integers(0, s.n_items, (bs, npp)).astype(np.int32)
    nu = s.n_users

    def loss_fn(p):
        z = jm.apply(p, None, jg, **kw)
        U, I = z[:nu], z[nu:]
        pos = jnp.sum(U[u] * I[i], axis=-1)
        neg = jnp.sum(U[u][:, None, :] * I[j], axis=-1)
        return JAX_LOSSES[loss](jnp.repeat(pos[:, None], npp, axis=1).reshape(-1), neg.reshape(-1))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    tr = _port_trainer(s, xs_dtype, loss=loss)
    tr.model.load_state_dict(params_from_jax(_jax_flat(params)))
    got = tr._lightgcn_loss(*(torch.from_numpy(a) for a in (u, i, j)))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want_loss), rtol=1e-5)
    want = params_from_jax(_jax_flat(want_grads))
    named = dict(tr.model.named_parameters())
    assert sorted(named) == sorted(want) == ["item_emb", "user_emb"]
    for name, w in want.items():
        assert float(w.abs().max()) > 0, name
        np.testing.assert_allclose(named[name].grad.numpy(), w.numpy(), err_msg=name, **GRAD_TOL)


def test_negatives_are_exact_and_rank_to_item_equals_jax(setup):
    _, s = setup
    tr = _port_trainer(s, torch.float32, batch_size=1024, neg_per_pos=5)
    tr.generator.manual_seed(0)
    perm, n_steps = tr._lightgcn_perm()
    assert n_steps == s.n_train // 1024 and sorted(perm.tolist()) == list(range(s.n_train))
    u, i, j = tr._lightgcn_sample(perm, 1)
    assert u.shape == i.shape == (1024,) and j.shape == (1024, 5)
    np.testing.assert_array_equal(u.numpy(), s.train_u[perm[1024:2048].numpy()])
    rows = tr.user_pos_padded[u.long()]
    assert bool((rows == i[:, None]).any(1).all())  # i is a positive of u
    assert not bool((rows[:, None, :] == j[:, :, None]).any())  # no negative is
    assert bool(((j >= 0) & (j < s.n_items)).all())
    rk = torch.from_numpy(np.random.default_rng(4).integers(0, s.n_items - 40, (1024, 5)).astype(np.int32))
    want = np.asarray(_rank_to_item(jnp.asarray(rk.numpy()), jnp.asarray(rows.numpy())))
    np.testing.assert_array_equal(rank_to_item(rk, rows).numpy(), want)
    # fewer interactions than a batch: one step over the permutation wrapped around
    small = _port_trainer(s, torch.float32, batch_size=s.n_train + 50)
    perm, n_steps = small._lightgcn_perm()
    assert n_steps == 1 and perm.shape == (s.n_train + 50,)
    assert torch.equal(perm[s.n_train:], perm[:50])


def test_lightgcn_training_learns(setup):
    """tests/test_train_e2e.py:55-64 with the port's Trainer on the CPU."""
    _, s = setup
    tr = _port_trainer(s, torch.float32, epochs=8, eval_neg_k=100, embed_dim=32,
                       batch_size=8192, neg_per_pos=5)
    results = tr.fit()
    losses = [h["loss"] for h in results["history"]]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert results["test"]["ndcg@20"] > 0


def test_export_matches_jax_and_checkpoints_cross_both_ways(setup, tmp_path):
    df, s = setup
    tr = _port_trainer(s, torch.float32, epochs=2)
    ckpt = tmp_path / "lg.npz"
    tr.fit(checkpoint_path=str(ckpt))
    # the port's checkpoint in the JAX package
    config = jax_load_config(ckpt)
    assert config["model_family"] == "lightgcn" and config["train_config"] == tr.cfg.to_dict()
    jm = JaxLightGCN.from_config(config)
    params, _ = jax_load_checkpoint(ckpt, jm.init(jax.random.key(0)))
    state = tr.model.state_dict()
    for name in ("user_emb", "item_emb"):
        np.testing.assert_array_equal(np.asarray(params[name]), state[name].numpy())
    # both exports of the same checkpoint
    want = jax_export(ckpt, df, None, str(tmp_path / "jax.npy"))
    got = export_item_embeddings(ckpt, df, None, str(tmp_path / "port.npy"), device="cpu")
    assert got.shape == want.shape == (s.n_items, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # a JAX checkpoint in the port, and back through params_to_jax
    jparams = jm.init(jax.random.key(5))
    jpath = jax_save_checkpoint(tmp_path / "jax_lg.npz", jparams, jm.config_dict())
    flat, jconfig = load_checkpoint(jpath)
    model = LightGCNModel.from_config(jconfig)
    model.load_state_dict(params_from_jax(flat))
    back = params_to_jax(model.state_dict())
    assert sorted(back) == ["['item_emb']", "['user_emb']"]
    for k, v in _jax_flat(jparams).items():
        np.testing.assert_array_equal(back[k], v)


def test_cli_export_lightgcn_without_features(setup, tmp_path, capsys):
    df, s = setup
    tr = _port_trainer(s, torch.float32, epochs=1)
    ckpt = tmp_path / "lg.npz"
    tr.fit(checkpoint_path=str(ckpt))
    np.savez(tmp_path / "interactions.npz",
             **{c: np.asarray(df[c].tolist()) for c in ("user_id", "asin", "ts", "rating")})
    cli.main(["export", "--checkpoint", str(ckpt), "--staging-prefix", str(tmp_path),
              "--out", str(tmp_path / "items.npy"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["shape"] == [s.n_items, 64]
    want = export_item_embeddings(ckpt, df, None, str(tmp_path / "direct.npy"), device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "items.npy"), want)
    # a GAT checkpoint still needs its features
    gm = GATModel(s.n_users, s.n_items, 8, hidden_dim=32, n_layers=1)
    gat_ckpt = save_checkpoint(tmp_path / "gat.npz", params_to_jax(gm.state_dict()), gm.config_dict())
    with pytest.raises(ValueError, match="item features"):
        export_item_embeddings(gat_ckpt, df, None, str(tmp_path / "x.npy"), device="cpu")
