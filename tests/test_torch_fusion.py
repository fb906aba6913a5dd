"""The port's fusion MLP and InfoNCE against the JAX package on the CPU:
the loss against brute force and against JAX, `train_fusion`'s trajectory
from the same parameters (dropout 0, one batch of all n: the loss is then
order-free, so both packages take the same Adam steps; params rtol 1e-4),
`fuse_all_items` with the mean-image fallback, and `FusionConfig`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotpointe_tpu.config import FusionConfig as JaxFusionConfig
from plotpointe_tpu.models import fusion as jfusion
from plotpointe_tpu_torch.config import FusionConfig
from plotpointe_tpu_torch.models.fusion import (
    FusionModel, dropout_keep, fuse_all_items, fusion_loss, fusion_params_from_jax,
    infonce_fusion_loss, train_fusion)

F32 = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(text_dim=24, img_dim=16, output_dim=8, hidden_dim=32)


def _flat(params) -> dict:
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _brute_infonce(fused, txt, img, T=0.07):
    def norm(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)

    f, t, i = norm(fused), norm(txt), norm(img)
    n = len(f)

    def xent(sim):
        m = sim.max(axis=1, keepdims=True)
        logz = m[:, 0] + np.log(np.exp(sim - m).sum(axis=1))
        return float(np.mean(logz - sim[np.arange(n), np.arange(n)]))

    lt, li = xent(f @ t.T / T), xent(f @ i.T / T)
    return (lt + li) / 2, lt, li


def test_infonce_matches_brute_force_and_jax(rng):
    n, d = 32, 16
    fused, txt, img = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(3))
    got = [float(x) for x in infonce_fusion_loss(*map(torch.as_tensor, (fused, txt, img)))]
    np.testing.assert_allclose(got, _brute_infonce(fused, txt, img), rtol=1e-4)
    want = [float(x) for x in jfusion.infonce_fusion_loss(*map(jnp.asarray, (fused, txt, img)))]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_model_forward_matches_jax_on_carried_params(rng):
    cfg = FusionConfig(**SMALL)
    params = jfusion.FusionModel(JaxFusionConfig(**SMALL)).init(jax.random.key(1))
    model = FusionModel(cfg)
    model.load_state_dict(fusion_params_from_jax(_flat(params)))
    txt, img = rng.normal(size=(20, 24)).astype(np.float32), rng.normal(size=(20, 16)).astype(np.float32)
    want = np.asarray(jfusion.FusionModel(JaxFusionConfig(**SMALL)).apply(params, txt, img))
    np.testing.assert_allclose(model(torch.as_tensor(txt), torch.as_tensor(img)).detach().numpy(), want, **F32)
    # one batch's loss with JAX's projections
    loss, _, _ = fusion_loss(model, torch.as_tensor(txt), torch.as_tensor(img))
    tproj = txt @ params["txt_proj"]["w"] + params["txt_proj"]["b"]
    iproj = img @ params["img_proj"]["w"] + params["img_proj"]["b"]
    np.testing.assert_allclose(float(loss.detach()), float(jfusion.infonce_fusion_loss(want, tproj, iproj)[0]),
                               rtol=1e-5)


@pytest.mark.parametrize("n,epochs", [(48, 3), (64, 5)])
def test_train_fusion_follows_jax_from_the_same_params(rng, n, epochs):
    """Dropout 0 and batch_size >= n: one step of all n rows an epoch, in
    the order each package draws, and InfoNCE over the whole batch does not
    depend on that order. Adam (torch's and optax's updates are one
    formula) from the same parameters: the same trajectory."""
    kw = dict(SMALL, dropout=0.0, epochs=epochs, batch_size=4 * n, lr=1e-2)
    txt = rng.normal(size=(n + 8, 24)).astype(np.float32)
    img = rng.normal(size=(n, 16)).astype(np.float32)
    img_row = np.concatenate([rng.permutation(n), np.full(8, -1)])  # 8 items without an image
    key = jax.random.key(9)
    jparams, jhist = jfusion.train_fusion(txt, img, img_row, JaxFusionConfig(**kw), key=key)
    start = jfusion.FusionModel(JaxFusionConfig(**kw)).init(jax.random.split(key)[0])
    model, hist = train_fusion(txt, img, img_row, FusionConfig(**kw),
                               init_params=fusion_params_from_jax(_flat(start)), device="cpu")
    assert list(hist) == list(jhist) == [f"epoch_{e}_loss" for e in range(1, epochs + 1)]
    np.testing.assert_allclose(list(hist.values()), list(jhist.values()), rtol=1e-5)
    want = fusion_params_from_jax(_flat(jparams))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_fusion_training_decreases_loss(rng):
    n = 256
    cfg = FusionConfig(**SMALL, epochs=4, batch_size=64)
    txt = rng.normal(size=(n, 24)).astype(np.float32)
    img = rng.normal(size=(n, 16)).astype(np.float32)
    model, hist = train_fusion(txt, img, np.arange(n), cfg, device="cpu")
    losses = [hist[f"epoch_{e}_loss"] for e in range(1, 5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    again, hist2 = train_fusion(txt, img, np.arange(n), cfg, device="cpu")
    assert hist2 == hist  # the same seed, the same draws
    # n // bs steps an epoch, the remainder dropped; dropout scales the kept units
    keep = dropout_keep((64, 32), 0.1, torch.Generator().manual_seed(0))
    assert keep.dtype == torch.bool and 0.8 < keep.float().mean() < 1.0
    assert dropout_keep((4, 4), 0.0, torch.Generator()) is None


def test_fuse_all_items_equals_jax_with_mean_fallback(rng):
    cfg = FusionConfig(text_dim=8, img_dim=6, output_dim=4, hidden_dim=16)
    params = jfusion.FusionModel(JaxFusionConfig(**dataclasses.asdict(cfg))).init(jax.random.key(0))
    model = FusionModel(cfg)
    model.load_state_dict(fusion_params_from_jax(_flat(params)))
    n = 50
    txt = rng.normal(size=(n, 8)).astype(np.float32)
    img = rng.normal(size=(10, 6)).astype(np.float32)
    img_row = np.full(n, -1, dtype=np.int64)
    img_row[:10] = rng.permutation(10)
    got = fuse_all_items(model, txt, img, img_row, batch_size=16)
    want = jfusion.fuse_all_items(params, txt, img, img_row, JaxFusionConfig(**dataclasses.asdict(cfg)),
                                  batch_size=16)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4)
    txt2 = txt.copy()
    txt2[20] = txt[30]  # without images, the same text gives the same row
    again = fuse_all_items(model, txt2, img, img_row, batch_size=16)
    np.testing.assert_allclose(again[20], again[30], atol=1e-6)
    assert fuse_all_items(model, txt[:0], img, img_row[:0]).shape == (0, 4)


def test_fusion_config_matches_jax(monkeypatch):
    assert FusionConfig().to_dict() == JaxFusionConfig().to_dict()
    monkeypatch.setenv("FUSION_EPOCHS", "7")
    monkeypatch.setenv("FUSION_LR", "0.5")
    assert FusionConfig.from_env(batch_size=64).to_dict() == JaxFusionConfig.from_env(batch_size=64).to_dict()
    assert FusionConfig.from_env().epochs == 7
