"""Sharded computations a spawned rank runs on host inputs: numpy arrays
in, numpy arrays out.

`run_cases(cases)` runs each case on this rank, in order, and returns
their results; `multihost.spawn(run_cases, n, (cases,), device=...)` runs
a whole list on n ranks in one spawn (each rank imports this module and
what it imports, nothing else). The tests feed the same numpy inputs to
the JAX package in their own process and compare.

A case is a dict {"kind": ..., ...}; graphs arrive as edge arrays
(`src`, `dst`, `n_nodes`) and parameters as {JAX key-path string: array}
(what `train/checkpoint.py` reads), so the JAX side's parameters carry
across. Kinds:

  attention      `sharded_attention` (or `_fused` with "hs_dtype") of h,
                 a_src, a_dst: the output and the gradients of
                 sum(out * ct)
  spmm           `make_sharded_spmm`'s operator on x: y and the gradient of
                 sum(y * ct)
  gat_step       `make_sharded_gat_step_fused` / `make_sharded_gat_step` /
                 `make_sharded_train_step` ("builder"): loss and gradients,
                 the user table's gathered whole, and the step's recorded
                 collectives
  lightgcn_step  `make_sharded_lightgcn_step`: loss and both tables'
                 gradients, gathered
  lookup         `lookup_replicated` / `lookup_batch_sharded` /
                 `lookup_batch_dedup` ("scheme") of ids in a row-sharded
                 table: the rows (gathered) and the table's gradient of
                 sum(rows * w)
  fit            `ShardedTrainer(...).fit()` and the exported item rows
  mesh           this rank's place on the mesh
  dryrun         `tools/multichip_dryrun.dryrun_rank` over the mesh
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _graph(case, dev):
    from plotpointe_tpu_torch.graphs.csr import build_graph

    return build_graph(case["src"], case["dst"], int(case["n_nodes"])).to(dev)


def _t(a, dev):
    return torch.as_tensor(np.asarray(a), device=dev)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _gat_model(cfg: Dict[str, Any]):
    from plotpointe_tpu_torch.models.gat import GATModel

    m = GATModel.from_config({"model_family": "gat", **cfg})
    m.hs_dtype = _DTYPES[cfg.get("hs_dtype", "float32")]
    return m


def _attention(case, mesh):
    from plotpointe_tpu_torch.parallel.spmd import sharded_attention, sharded_attention_fused

    dev = mesh.device
    g = _graph(case, dev)
    h, a_s, a_d = (_t(case[k], dev).requires_grad_() for k in ("h", "a_src", "a_dst"))
    if case.get("hs_dtype"):
        out = sharded_attention_fused(mesh, h, a_s, a_d, g, hs_dtype=_DTYPES[case["hs_dtype"]])
    else:
        out = sharded_attention(mesh, h, a_s, a_d, g)
    (out * _t(case["ct"], dev)).sum().backward()
    return {"out": _np(out), "dh": _np(h.grad), "da_src": _np(a_s.grad), "da_dst": _np(a_d.grad)}


def _spmm(case, mesh):
    from plotpointe_tpu_torch.parallel.spmd import make_sharded_spmm

    dev = mesh.device
    g = _graph(case, dev)
    op = make_sharded_spmm(mesh, g, case["values"], xs_dtype=_DTYPES[case.get("xs_dtype", "float32")],
                           overlay_dtype=_DTYPES[case.get("overlay_dtype")])
    x = _t(case["x"], dev).requires_grad_()
    y = op(x)
    (y * _t(case["ct"], dev)).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad)}


def _gathered(grads, mesh, tables):
    from plotpointe_tpu_torch.parallel.multihost import host_gather

    return {k: host_gather(g, mesh) if k in tables else _np(g) for k, g in grads.items()}


def _params(case, mesh, tables):
    from plotpointe_tpu_torch.parallel.sharded_table import device_put_row_sharded
    from plotpointe_tpu_torch.train.checkpoint import params_from_jax

    p = {k: v.to(mesh.device) for k, v in params_from_jax(case["params"]).items()}
    return {k: device_put_row_sharded(v, mesh) if k in tables else v for k, v in p.items()}


def _gat_step(case, mesh):
    from plotpointe_tpu_torch.parallel import spmd
    from plotpointe_tpu_torch.parallel.collectives import record_collectives

    dev = mesh.device
    g = _graph(case, dev)
    model = _gat_model(case["model"])
    nu, ni = model.n_users, model.n_items
    builder = case.get("builder", "make_sharded_gat_step")
    kw = {k: _DTYPES[case[k]] for k in ("hs_dtype",) if k in case}
    if "overlay_dtype" in case:
        kw["overlay_dtype"] = _DTYPES[case["overlay_dtype"]]
    if "dropout_rate" in case:
        kw["dropout_rate"] = case["dropout_rate"]
    step = getattr(spmd, builder)(model, "bpr", mesh, nu, ni, g, **kw)
    tables = () if builder == "make_sharded_train_step" else ("user_emb",)
    u, i, j = (_t(case[k], dev) for k in "uij")
    with record_collectives() as colls:
        grads, loss = step(_params(case, mesh, tables), _t(case["item_feats"], dev),
                           case.get("seeds"), u, i, j)
    return {"loss": float(loss), "grads": _gathered(grads, mesh, tables), "collectives": colls}


def _lightgcn_step(case, mesh):
    from plotpointe_tpu_torch.graphs.csr import symmetric_normalized_weights
    from plotpointe_tpu_torch.models.lightgcn import LightGCNModel
    from plotpointe_tpu_torch.parallel.spmd import make_sharded_lightgcn_step

    dev = mesh.device
    g = _graph(case, dev)
    model = LightGCNModel.from_config(case["model"])
    model.xs_dtype = _DTYPES[case.get("xs_dtype", "float32")]
    step = make_sharded_lightgcn_step(model, "bpr", mesh, model.n_users, model.n_items, g,
                                      symmetric_normalized_weights(g))
    tables = ("user_emb", "item_emb")
    grads, loss = step(_params(case, mesh, tables), *(_t(case[k], dev) for k in "uij"))
    return {"loss": float(loss), "grads": _gathered(grads, mesh, tables)}


def _lookup(case, mesh):
    from plotpointe_tpu_torch.parallel import sharded_table as st
    from plotpointe_tpu_torch.parallel.multihost import host_gather

    dev = mesh.device
    table = st.device_put_row_sharded(np.asarray(case["table"]), mesh).requires_grad_()
    ids = _t(case["ids"], dev)
    scheme = case["scheme"]
    if scheme == "replicated":
        rows = st.lookup_replicated(mesh, table, ids)
        w = _t(case["w"], dev)
    else:
        b = ids.shape[0] // mesh.n_shards
        sl = slice(mesh.shard * b, (mesh.shard + 1) * b)
        kw = {"unique_capacity": case["capacity"]} if "capacity" in case else {}
        fn = st.lookup_batch_sharded if scheme == "batch_sharded" else st.lookup_batch_dedup
        rows = fn(mesh, table, ids[sl], **kw)
        w = _t(case["w"], dev)[sl]
    (rows * w).sum().backward()
    with torch.no_grad():
        got = rows if scheme == "replicated" else torch.as_tensor(host_gather(rows, mesh))
    return {"rows": _np(got), "grad": host_gather(table.grad, mesh)}


def _fit(case, mesh):
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.pipeline import make_model
    from plotpointe_tpu_torch.train.sharded import ShardedTrainer

    inter = case["interactions"]
    s = build_splits(inter, *build_node_maps(inter))
    g = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    cfg = TrainConfig(**case["cfg"])
    feats = case.get("feats")
    model = make_model(cfg, s.n_users, s.n_items, 0 if feats is None else feats.shape[1],
                       device=mesh.device)
    tr = ShardedTrainer(model, cfg, g, s, item_feats=feats, mesh=mesh)
    res = tr.fit(checkpoint_path=case.get("checkpoint"), resume_path=case.get("resume"))
    return {"history": [{k: h[k] for k in ("epoch", "loss")} for h in res["history"]],
            "best_val_ndcg@20": res["best_val_ndcg@20"], "test": res["test"],
            "items": tr.export_item_embeddings()}


def _mesh(case, mesh):
    return {"rank": mesh.rank, "coords": mesh.coords, "shard": mesh.shard,
            "n_shards": mesh.n_shards, "backend": mesh.backend}


def _dryrun(case, mesh):
    from plotpointe_tpu_torch.tools.multichip_dryrun import dryrun_rank

    return dryrun_rank(mesh.n_shards, mesh.device)


KINDS = {"attention": _attention, "spmm": _spmm, "gat_step": _gat_step,
         "lightgcn_step": _lightgcn_step, "lookup": _lookup, "fit": _fit, "mesh": _mesh,
         "dryrun": _dryrun}


def run_cases(cases: List[Dict[str, Any]], mesh_shape=None, device="cpu") -> List[Dict[str, Any]]:
    """Run every case on this rank (a spawned rank of the mesh `mesh_shape`,
    default one data axis over the group) and return the results."""
    from plotpointe_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_shape, device=device)
    return [KINDS[c["kind"]](c, mesh) for c in cases]
