"""Weight carry-over: a JAX checkpoint loads into the port's GATModel through
`params_from_jax`, and the full-graph forwards agree at f32 tolerance
(rtol 1e-4 / atol 1e-5, tests/test_gat_fused.py:34)."""
import numpy as np
import pytest
import torch

import jax

from plotpointe_tpu.graphs.csr import build_bipartite_graph as jax_bipartite
from plotpointe_tpu.models.gat import GATModel as JaxGAT
from plotpointe_tpu.train.checkpoint import load_checkpoint as jax_load
from plotpointe_tpu.train.checkpoint import save_checkpoint as jax_save
from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.train.checkpoint import (
    load_checkpoint, load_config, params_from_jax, save_checkpoint)


def _setup(rng, use_bias, heads, tmp_path):
    n_users, n_items, feat_dim = 120, 80, 48
    u = rng.integers(0, n_users, 900)
    i = np.where(rng.random(900) < 0.3, 2, rng.integers(0, n_items - 10, 900))  # hot item, 10 cold
    w = rng.random(900).astype(np.float32)
    jm = JaxGAT(n_users, n_items, feat_dim, hidden_dim=32, n_layers=2, heads=heads, use_bias=use_bias)
    params = jm.init(jax.random.key(0))
    if use_bias:  # non-zero biases so the bias path is exercised
        for layer in params["layers"]:
            layer["b"] = jax.numpy.asarray(rng.normal(size=layer["b"].shape).astype(np.float32))
    path = jax_save(tmp_path / "ckpt.npz", params, jm.config_dict())
    feats = rng.normal(size=(n_items, feat_dim)).astype(np.float32)
    return jm, params, path, feats, (u, i, w, n_users, n_items)


@pytest.mark.parametrize("use_bias", [False, True])
def test_jax_checkpoint_forward_parity(rng, tmp_path, use_bias):
    jm, params, path, feats, (u, i, w, nu, ni) = _setup(rng, use_bias, 1, tmp_path)
    want = np.asarray(jm.apply(params, feats, jax_bipartite(u, i, nu, ni, weight=w).to_device()))

    flat, config = load_checkpoint(path)
    assert config == load_config(path) == jm.config_dict()
    model = GATModel.from_config(config)
    model.load_state_dict(params_from_jax(flat))  # strict: every key, every shape
    with torch.no_grad():
        got = model(torch.from_numpy(feats), build_bipartite_graph(u, i, nu, ni, weight=w)).numpy()
    assert got.shape == (nu + ni, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_multihead_checkpoint_forward_parity_on_cpu(rng, tmp_path):
    jm, params, path, feats, (u, i, w, nu, ni) = _setup(rng, False, 2, tmp_path)
    want = np.asarray(jm.apply(params, feats, jax_bipartite(u, i, nu, ni).to_device()))
    flat, config = load_checkpoint(path)
    model = GATModel.from_config(config)
    model.load_state_dict(params_from_jax(flat))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), build_bipartite_graph(u, i, nu, ni)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_key_strings_round_trip(rng, tmp_path):
    _, params, path, _, _ = _setup(rng, True, 1, tmp_path)
    flat, config = load_checkpoint(path)
    assert sorted(flat) == sorted(jax.tree_util.keystr(kp) for kp, _ in
                                  jax.tree_util.tree_flatten_with_path(params)[0])
    assert "['layers'][1]['a_src']" in flat and "['item_proj']['w']" in flat
    sd = params_from_jax(flat)
    assert "layers.1.a_src" in sd and "item_proj.w" in sd and "user_emb" in sd
    # the port writes the same format: the JAX loader restores it
    save_checkpoint(tmp_path / "again.npz", flat, config)
    back, config2 = jax_load(tmp_path / "again.npz", params)
    assert config2 == config
    for (kp, leaf), (_, got) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                    jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf))
        dotted = ".".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in kp)
        np.testing.assert_array_equal(sd[dotted].numpy(), np.asarray(leaf))
    with pytest.raises(ValueError):
        params_from_jax({"layers.0.w": np.zeros(1)})
