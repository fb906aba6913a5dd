"""Multichip dry run: each sharded step builder once on a tiny problem.

Counterpart of `__graft_entry__.py::dryrun_multichip`. On n ranks it runs,
in order: the legacy replicated step (`make_sharded_train_step`) and one
Adam update; the LightGCN step with row-sharded tables; the partitioned
SpMM operator and its gradient; the row-sharded GAT step
(`make_sharded_gat_step`); the fused single-head step, whose loss must lie
within 1e-3 of the row-sharded step's; and a `ShardedTrainer` fit of 2
epochs. Every loss and gradient must be finite. Without a process group it
spawns n ranks (gloo with device="cpu", one GPU each otherwise); under one
(the card's world of one, say) it runs in this process.

    python -m plotpointe_tpu_torch.tools.multichip_dryrun 2 --device cpu
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _tiny_problem(seed=0, n_users=64, n_items=48, n_inter=600, feat_dim=32):
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.data.synthetic import synthetic_features, synthetic_interactions
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph

    df = synthetic_interactions(n_users=n_users, n_items=n_items, n_interactions=n_inter, seed=seed)
    s = build_splits(df, *build_node_maps(df))
    feats = synthetic_features(s.n_items, feat_dim, seed=seed)
    g = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    return s, g, feats


def _finite(*ts) -> bool:
    import torch

    return all(bool(torch.isfinite(t).all()) for t in ts)


def dryrun_rank(n_devices: int, device=None) -> dict:
    """The dry run on this rank of a mesh of `n_devices` ranks."""
    import torch

    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.graphs.csr import symmetric_normalized_weights
    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.models.lightgcn import LightGCNModel
    from plotpointe_tpu_torch.parallel.mesh import make_mesh
    from plotpointe_tpu_torch.parallel.sharded_table import device_put_row_sharded
    from plotpointe_tpu_torch.parallel.spmd import (
        make_sharded_gat_step, make_sharded_gat_step_fused, make_sharded_lightgcn_step,
        make_sharded_spmm, make_sharded_train_step)
    from plotpointe_tpu_torch.train.sharded import ShardedTrainer
    from plotpointe_tpu_torch.train.trainer import make_optimizer

    mesh = make_mesh({"data": n_devices}, device=device)
    dev = mesh.device
    s, g_host, feats_np = _tiny_problem()
    g = g_host.to(dev)
    nu, ni = s.n_users, s.n_items
    model = GATModel(n_users=nu, n_items=ni, feat_dim=feats_np.shape[1], hidden_dim=32, n_layers=2,
                     attn_dropout=0.0).to(dev)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    params = {k: v.detach() for k, v in model.named_parameters()}
    feats = torch.as_tensor(feats_np, device=dev)
    rng = np.random.default_rng(0)
    b = 32 * n_devices
    u, i, j = (torch.as_tensor(rng.integers(0, n, b).astype(np.int32), device=dev)
               for n in (nu, ni, ni))

    grads, loss = make_sharded_train_step(model, "bpr", mesh, nu, ni, g)(params, feats, None, u, i, j)
    opt, _ = make_optimizer(model.parameters(), 1e-3, 1e-4)
    for (k, p), gr in zip(model.named_parameters(), grads.values()):
        p.grad = gr
    opt.step()  # one real optimizer update: the whole train step runs
    assert np.isfinite(float(loss)), f"non-finite loss {float(loss)}"

    lg = LightGCNModel(n_users=nu, n_items=ni, embed_dim=16, n_prop_layers=2).to(dev)
    lg.init_params(torch.Generator(device=dev).manual_seed(1))
    vals = symmetric_normalized_weights(g)
    lg_params = {k: device_put_row_sharded(v.detach(), mesh) for k, v in lg.named_parameters()}
    lg_grads, lg_loss = make_sharded_lightgcn_step(lg, "bpr", mesh, nu, ni, g, vals)(lg_params, u, i, j)
    assert np.isfinite(float(lg_loss)) and _finite(*lg_grads.values()), "non-finite lightgcn step"

    op = make_sharded_spmm(mesh, g, vals, xs_dtype=torch.float32)
    x0 = torch.cat([lg.user_emb, lg.item_emb]).detach().requires_grad_()
    y = op(x0)
    y.sum().backward()
    assert _finite(y, x0.grad), "non-finite sharded spmm"

    sharded = dict(params, user_emb=device_put_row_sharded(params["user_emb"], mesh))
    rs_grads, rs_loss = make_sharded_gat_step(model, "bpr", mesh, nu, ni, g)(sharded, feats, None, u, i, j)
    assert np.isfinite(float(rs_loss)) and _finite(rs_grads["user_emb"]), "non-finite row-sharded step"
    fused = make_sharded_gat_step_fused(model, "bpr", mesh, nu, ni, g, hs_dtype=torch.float32)
    f_grads, f_loss = fused(sharded, feats, None, u, i, j)
    assert np.isfinite(float(f_loss)) and _finite(f_grads["user_emb"]), "non-finite fused step"
    assert abs(float(f_loss) - float(rs_loss)) < 1e-3, (float(f_loss), float(rs_loss))

    s2, g2, feats2 = _tiny_problem(seed=1)
    cfg = TrainConfig(hidden_dim=32, layers=2, epochs=2, samples_per_epoch=64 * n_devices,
                      eval_neg_k=16, attn_dropout=0.0)
    m2 = GATModel(n_users=s2.n_users, n_items=s2.n_items, feat_dim=feats2.shape[1], hidden_dim=32,
                  n_layers=2, attn_dropout=0.0)
    fit = ShardedTrainer(m2, cfg, g2, s2, item_feats=feats2, mesh=mesh).fit()
    assert all(np.isfinite(v) for v in fit["test"].values()), fit["test"]
    return {"n_devices": n_devices, "gat_loss": float(loss), "gat_rowsharded_loss": float(rs_loss),
            "gat_fused_loss": float(f_loss), "lightgcn_loss": float(lg_loss),
            "sharded_fit_test_ndcg@20": fit["test"].get("ndcg@20", 0.0), "ok": True}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run on n ranks (rank 0's summary): in this process under a
    running process group, else on n spawned ranks."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dryrun_rank(n_devices, device)
    from plotpointe_tpu_torch.parallel.multihost import spawn

    return spawn(dryrun_rank, n_devices, (n_devices, device), device=device)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None, help="default: cuda (one GPU a rank)")
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n_devices, args.device)))


if __name__ == "__main__":
    main()
