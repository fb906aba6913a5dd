"""The port's multi-head attention on the CPU against the JAX package: the
head-packed op `attention_v3_mh` (kernels 8 and 9 and B2 per head; Pallas
in interpret mode on the JAX side) forward and gradients, the dispatch for
up to 8 heads and above, the plain versions, and the 2-head GAT's forward,
training step and CLI path.

Tolerances: forward rtol 1e-4 / atol 1e-5 (tests/test_gat_fused.py:34) and
gradients rtol 5e-4 / atol 1e-4 (:53-55), at f32 and bf16 rows alike: both
packages round the same rows (and, in B2, the same cotangent) to bf16 and
sum in f32, so only the summation order differs.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.graphs.csr import build_bipartite_graph as jax_bipartite
from plotpointe_tpu.graphs.csr import build_graph as jax_build_graph
from plotpointe_tpu.models.gat import GATModel as JaxGAT
from plotpointe_tpu.ops.gat_fused import attention_v3_mh as jax_attention_v3_mh
from plotpointe_tpu.ops.gat_kernel import segment_softmax_attention_pallas
from plotpointe_tpu.tools.export import export_item_embeddings as jax_export
from plotpointe_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from plotpointe_tpu.train.checkpoint import load_config as jax_load_config
from plotpointe_tpu.train.losses import LOSSES as JAX_LOSSES
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops.gat_fused import (
    attention_bwd_dst_mh, attention_bwd_dst_mh_plain, attention_bwd_mh_plain, attention_fwd_mh,
    attention_fwd_mh_plain, attention_v3_mh, dropout_mask_mh, hash_mask, node_terms_mh_plain,
    reference_versions)
from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel
from plotpointe_tpu_torch.ops.segment import segment_softmax_attention
from plotpointe_tpu_torch.train.checkpoint import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
N, E = 200, 1500


@pytest.fixture(scope="module")
def graphs():
    """Skewed in-degrees (60% of edges into node 3) and isolated nodes
    (150..199 touch no edge), in both packages."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 150, E)
    dst = np.where(rng.random(E) < 0.6, 3, rng.integers(0, 150, E))
    jg = jax_build_graph(src, dst, N, pad_multiple=512).with_layout(nb=64, eb=128).to_device()
    return build_graph(src, dst, N), jg


def _inputs(heads, d, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, heads, d)).astype(np.float32)
    a_s = (rng.normal(size=(heads, d)) * 0.3).astype(np.float32)
    a_d = (rng.normal(size=(heads, d)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(N, heads, d)).astype(np.float32)
    return h, a_s, a_d, ct


def _jax_out_and_grads(fn, h, a_s, a_d, ct):
    args = tuple(map(jnp.asarray, (h, a_s, a_d)))
    out = np.asarray(fn(*args))
    grads = jax.grad(lambda *a: (fn(*a) * ct).sum(), argnums=(0, 1, 2))(*args)
    return out, [np.asarray(x) for x in grads]


def _port_out_and_grads(fn, h, a_s, a_d, ct):
    x = [torch.from_numpy(a).requires_grad_() for a in (h, a_s, a_d)]
    out = fn(*x)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in x]


def _assert_match(got, want):
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **TOL)
    for name, a, b in zip(("dh", "da_src", "da_dst"), got[1], want[1]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("hs_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_attention_v3_mh_matches_jax(graphs, heads, hs_dtype, dropout):
    g, jg = graphs
    h, a_s, a_d, ct = _inputs(heads, 128)
    key = jax.random.key(5)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    want = _jax_out_and_grads(lambda *a: jax_attention_v3_mh(
        *a, jg, dropout_rate=dropout, rng=key, hs_dtype=getattr(jnp, hs_dtype)), h, a_s, a_d, ct)
    got = _port_out_and_grads(lambda *a: attention_v3_mh(
        *a, g, dropout_rate=dropout, seed=seed, hs_dtype=getattr(torch, hs_dtype)), h, a_s, a_d, ct)
    _assert_match(got, want)
    assert np.all(got[1][0][150:] == 0)  # isolated nodes get no gradient


@pytest.mark.parametrize("heads,d", [(2, 64), (3, 40), (9, 32)])
def test_dispatch_matches_jax_dispatch(graphs, heads, d):
    """`segment_softmax_attention_pallas` (D lane-padded to 128; bf16 rows;
    heads > 8 one pass per head with the seed bits(fold_in(rng, head)))
    against the port's dispatch (D padded to a power of two, per-head seeds
    passed in above 8 heads)."""
    g, jg = graphs
    h, a_s, a_d, ct = _inputs(heads, d, seed=heads)
    key = jax.random.key(8)
    if heads > 8:
        seed = [int(jax.random.bits(jax.random.fold_in(key, k), (), jnp.uint32)) for k in range(heads)]
    else:
        seed = int(jax.random.bits(key, (), jnp.uint32))
    want = _jax_out_and_grads(lambda *a: segment_softmax_attention_pallas(
        *a, jg, dropout_rate=0.2, rng=key), h, a_s, a_d, ct)
    got = _port_out_and_grads(lambda *a: segment_softmax_attention_kernel(
        *a, g, dropout_rate=0.2, seed=seed), h, a_s, a_d, ct)
    _assert_match(got, want)
    if heads > 8:
        with pytest.raises(ValueError, match="one dropout seed per head"):
            segment_softmax_attention_kernel(*map(torch.from_numpy, (h, a_s, a_d)), g,
                                             dropout_rate=0.2, seed=seed[0])


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_wide_heads_run_one_pass_per_head_like_jax_packed(graphs, dropout):
    """4 heads of D 512 (packed width 2,048, above the packed kernels'
    1,024): the dispatch runs one `attention_v3` pass per head with head
    k's ids offset by k * 2**27, and matches JAX's `attention_v3_mh` (which
    has no width limit) at bf16 rows, forward and gradients."""
    g, jg = graphs
    h, a_s, a_d, ct = _inputs(4, 512, seed=11)
    key = jax.random.key(6)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    want = _jax_out_and_grads(lambda *a: jax_attention_v3_mh(*a, jg, dropout_rate=dropout, rng=key),
                              h, a_s, a_d, ct)
    got = _port_out_and_grads(lambda *a: segment_softmax_attention_kernel(
        *a, g, dropout_rate=dropout, seed=seed), h, a_s, a_d, ct)
    _assert_match(got, want)


def test_plain_backward_matches_autograd_of_golden(graphs):
    g, _ = graphs
    h, a_s, a_d, ct = _inputs(2, 64, seed=2)
    th, ts, td = (torch.from_numpy(x).requires_grad_() for x in (h, a_s, a_d))
    (segment_softmax_attention(th, ts, td, g) * torch.from_numpy(ct)).sum().backward()
    want = [t.grad.numpy() for t in (th, ts, td)]
    h_, s_, d_, ct_ = map(torch.from_numpy, (h, a_s, a_d, ct))
    out, den = attention_fwd_mh_plain(h_, s_, d_, g, hs_dtype=torch.float32)
    got = attention_bwd_mh_plain(h_, s_, d_, g, ct_, out, den, hs_dtype=torch.float32)
    for name, a, b in zip(("dh", "da_src", "da_dst"), got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **GRAD_TOL)
    via_op = _port_out_and_grads(lambda *a: attention_v3_mh(*a, g, hs_dtype=torch.float32),
                                 h, a_s, a_d, ct)[1]
    with reference_versions():
        via_ref = _port_out_and_grads(lambda *a: attention_v3_mh(*a, g, hs_dtype=torch.float32),
                                      h, a_s, a_d, ct)[1]
    for name, a, b, c in zip(("dh", "da_src", "da_dst"), via_op, via_ref, got):
        np.testing.assert_array_equal(a, c.numpy(), err_msg=name)
        np.testing.assert_array_equal(b, c.numpy(), err_msg=name)


@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrappers_on_cpu_are_their_plain_versions(graphs, hs_dtype):
    g, _ = graphs
    h, a_s, a_d, ct = (torch.from_numpy(x) for x in _inputs(2, 64, seed=3))
    mask = dropout_mask_mh(g, 0.3, 9, 2, "cpu")
    assert mask.shape == (2, g.n_edges)
    assert torch.equal(mask[1], hash_mask(9, torch.arange(g.n_edges) + 2**27, 0.3))
    out, den = attention_fwd_mh(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    want = attention_fwd_mh_plain(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    assert torch.equal(out, want[0]) and torch.equal(den, want[1]) and den.shape == (N, 2)
    rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, hs_dtype)
    args = (rows, gs, gd, ct, out, den, g, mask)
    for a, b in zip(attention_bwd_dst_mh(*args), attention_bwd_dst_mh_plain(*args)):
        assert torch.equal(a, b)
    for bad in ((h[:, :1], a_s[:1], a_d[:1]), (h[..., :48], a_s[:, :48], a_d[:, :48]),
                (torch.zeros(N, 4, 512), torch.zeros(4, 512), torch.zeros(4, 512))):
        with pytest.raises(ValueError, match="head-packed"):
            attention_fwd_mh(*bad, g)
    with pytest.raises(ValueError, match="mask"):
        attention_fwd_mh(h, a_s, a_d, g, mask=mask[0])


def _gat_setup(tiny_dataset, heads):
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph

    s = build_splits(tiny_dataset, *build_node_maps(tiny_dataset))
    feats = np.random.default_rng(2).normal(size=(s.n_items, 24)).astype(np.float32)
    jm = JaxGAT(s.n_users, s.n_items, 24, hidden_dim=32, n_layers=2, heads=heads, attn_dropout=0.1,
                attn_impl="pallas")
    params = jm.init(jax.random.key(0))
    flat = {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    jg = jax_bipartite(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    return s, feats, jm, params, flat, graph, jg.with_layout().to_device()


def test_two_head_gat_forward_and_step_match_jax(tiny_dataset):
    """The forward at f32 rows against JAX's golden; then JAX
    `GATModel(heads=2, attn_impl="pallas")` (bf16 rows, per-head hash
    dropout, kernels 8/9 and B2 in interpret mode) against the port's trainer
    on the same parameters, triples and per-layer seeds. The step's band is
    test_torch_train.py's, for its reason (a last-bit difference in layer 1
    rounds a few layer-2 rows to another bf16 value): rtol 5e-4, atol 1e-3
    of each gradient's largest entry, loss rtol 1e-5."""
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.train.trainer import Trainer

    s, feats, jm, params, flat, graph, jg = _gat_setup(tiny_dataset, 2)
    nu = s.n_users
    model = GATModel.from_config(jm.config_dict())  # f32 rows: the function of JAX's golden
    model.load_state_dict(params_from_jax(flat))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), graph).numpy()
    want = JaxGAT.from_config(jm.config_dict(), attn_impl="xla").apply(params, jnp.asarray(feats), jg)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    model.hs_dtype = torch.bfloat16  # the JAX trainer's kernel path

    rng = np.random.default_rng(4)
    u = rng.choice(np.unique(s.train_u), 2000).astype(np.int32)
    i, j = (rng.integers(0, s.n_items, 2000).astype(np.int32) for _ in range(2))
    k_drop = jax.random.key(7)

    def loss_fn(p):
        z = jm.apply(p, jnp.asarray(feats), jg, train=True, rng=k_drop)
        return JAX_LOSSES["bpr"](jnp.sum(z[:nu][u] * z[nu:][i], -1), jnp.sum(z[:nu][u] * z[nu:][j], -1))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    seeds = [int(jax.random.bits(jax.random.fold_in(k_drop, li), (), jnp.uint32)) for li in range(2)]
    cfg = TrainConfig(hidden_dim=32, heads=2, eval_neg_k=50, eval_chunk=128)
    tr = Trainer(model, cfg, graph, s, item_feats=feats, device="cpu")
    loss = tr._loss(*(torch.from_numpy(x) for x in (u, i, j)), seeds)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = params_from_jax({jax.tree_util.keystr(kp): np.asarray(v)
                            for kp, v in jax.tree_util.tree_flatten_with_path(want_grads)[0]})
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=5e-4,
                                   atol=1e-3 * scale, err_msg=name)


def test_trainer_draws_one_seed_per_head_above_eight(tiny_dataset):
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.train.trainer import Trainer

    s, feats, *_, graph, _ = _gat_setup(tiny_dataset, 2)
    cfg = TrainConfig(hidden_dim=32, heads=10, samples_per_epoch=500)
    tr = Trainer(GATModel(s.n_users, s.n_items, 24, hidden_dim=32, heads=10), cfg, graph, s,
                 item_feats=feats, device="cpu")
    tr.model.init_params(tr._reseed(0, 0))
    *uij, seeds = tr._sample()
    assert len(seeds) == 2 and all(len(x) == 10 for x in seeds)
    loss = tr._loss(*uij, seeds)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert tr.model.layers[0].w.grad.abs().sum() > 0


def test_cli_train_two_heads_and_export(tiny_dataset, tmp_path, capsys):
    cols = {c: tiny_dataset[c].to_numpy() for c in ("user_id", "asin", "ts", "rating")}
    staging, emb, models = tmp_path / "staging", tmp_path / "emb", tmp_path / "models"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz",
             **{c: v.astype(str) if v.dtype == object else v for c, v in cols.items()})
    s_items = len(np.unique(cols["asin"]))
    feats = np.random.default_rng(0).normal(size=(s_items, 16)).astype(np.float32)
    np.save(emb / "fused_interacted.npy", feats)
    cli.main(["train", "--staging-prefix", str(staging), "--embeddings-prefix", str(emb),
              "--models-prefix", str(models), "--heads", "2", "--hidden-dim", "32", "--epochs", "2",
              "--samples-per-epoch", "2000", "--eval-neg-k", "50", "--device", "cpu"])
    assert "ndcg@20" in json.loads(capsys.readouterr().out)["test"]
    (ckpt,) = (models / "checkpoints").glob("*.npz")
    config = jax_load_config(ckpt)
    assert config["heads"] == 2
    jm = JaxGAT.from_config(config)
    jax_load_checkpoint(ckpt, jm.init(jax.random.key(0)))  # every key and shape in the JAX layout
    cli.main(["export", "--checkpoint", str(ckpt), "--staging-prefix", str(staging),
              "--features", str(emb / "fused_interacted.npy"), "--out", str(tmp_path / "o.npy"),
              "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["shape"] == [s_items, 32]
    want = jax_export(ckpt, tiny_dataset, feats, str(tmp_path / "jax.npy"), attn_impl="xla")
    np.testing.assert_allclose(np.load(tmp_path / "o.npy"), want, **TOL)
