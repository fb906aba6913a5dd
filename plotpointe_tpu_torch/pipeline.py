"""End-to-end training glue: artifacts -> splits -> graph -> trainer ->
checkpoint + metrics JSON.

Counterpart of `plotpointe_tpu/pipeline.py` (`make_model`,
`train_from_artifacts`) for the GAT and LightGCN. Interactions come from
`{staging}/interactions.npz` (column arrays) when present, else the parquet
file; the GAT's item features from `{embeddings}/fused_interacted.npy` or
`txt_interacted.npy` (`item_features`), else `fused.npy` / `txt.npy`.
LightGCN reads no features. The HGT (port-only) reads the GAT's features
and the item kNN artifact `cfg.knn_edges` and trains over the typed graph
(`graphs/hetero.py`) on one device.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from plotpointe_tpu_torch import resolve_device
from plotpointe_tpu_torch.config import TrainConfig
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
from plotpointe_tpu_torch.graphs.hetero import build_hetero_graph, load_knn_coo
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.models.hgt import HGTModel
from plotpointe_tpu_torch.models.lightgcn import LightGCNModel
from plotpointe_tpu_torch.ops.gat_kernel import resolve_hs_dtype
from plotpointe_tpu_torch.train.trainer import Trainer
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore


def _check_family(cfg: TrainConfig) -> None:
    if cfg.model_family not in ("gat", "lightgcn", "hgt"):
        raise ValueError(f"unknown model_family {cfg.model_family}")


def make_model(cfg: TrainConfig, n_users: int, n_items: int, feat_dim: int, device=None):
    """The model of `cfg`, with the row type its `attn_impl` (GAT, HGT) or
    `spmm_impl` (LightGCN) means on `device`; the GAT's layers are
    `cfg.attention`'s (gat or gatv2)."""
    _check_family(cfg)
    if cfg.model_family == "hgt":
        return HGTModel(n_users=n_users, n_items=n_items, feat_dim=feat_dim, hidden_dim=cfg.hidden_dim,
                        n_layers=cfg.layers, heads=cfg.heads,
                        hs_dtype=resolve_hs_dtype(cfg.attn_impl, resolve_device(device)))
    if cfg.model_family == "lightgcn":
        return LightGCNModel(n_users=n_users, n_items=n_items, embed_dim=cfg.embed_dim,
                             n_prop_layers=cfg.n_prop_layers,
                             xs_dtype=resolve_hs_dtype(cfg.spmm_impl, resolve_device(device)))
    return GATModel(n_users=n_users, n_items=n_items, feat_dim=feat_dim, hidden_dim=cfg.hidden_dim,
                    n_layers=cfg.layers, heads=cfg.heads, attn_dropout=cfg.attn_dropout,
                    hs_dtype=resolve_hs_dtype(cfg.attn_impl, resolve_device(device)),
                    attention=cfg.attention)


def _features(store: ArtifactStore, cfg: TrainConfig, embeddings_prefix: str, n_items: int):
    name = "fused" if cfg.item_features == "fused" else "txt"
    uri = f"{embeddings_prefix}/{name}_interacted.npy"
    if not store.exists(uri):  # fall back to the full-catalog name
        uri = f"{embeddings_prefix}/{name}.npy"
    feats = np.asarray(store.load_npy(uri), dtype=np.float32)
    if feats.shape[0] != n_items:
        raise ValueError(f"features rows ({feats.shape[0]}) must align to interacted items ({n_items})")
    return feats


def train_from_artifacts(cfg: TrainConfig, staging_prefix: str, embeddings_prefix: str,
                         models_prefix: str, store: Optional[ArtifactStore] = None,
                         resume: bool = False, device=None) -> Dict[str, Any]:
    """Interactions + features -> `{models}/checkpoints/{run_id}.npz` (best by
    val, JAX format) and `{models}/metrics_{run_id}.json`. With `resume`,
    `{models}/resume.pt` is read if present and rewritten every epoch.
    Returns the trainer's results plus `checkpoint_uri` and `trainer`.

    With `cfg.mesh_shape` the run is a `ShardedTrainer` over that mesh:
    under a running process group (or a torchrun / PLOTPOINTE_* launch)
    this process is one rank; otherwise a mesh of one rank starts its own
    group and a larger one spawns its ranks here (`multihost.spawn`) and
    returns rank 0's results, without `trainer`. Rank 0 writes the files."""
    _check_family(cfg)
    if cfg.model_family == "hgt" and not cfg.knn_edges:
        raise ValueError("model_family hgt needs knn_edges (an ii_edges_{name}.npz artifact)")
    if cfg.mesh_shape:
        ranks = _ranks_to_spawn(cfg.mesh_shape)
        if ranks:
            from plotpointe_tpu_torch.parallel.multihost import spawn

            cfg.run_id = cfg.run_id or f"{cfg.model_family}_d{cfg.hidden_dim}_{int(time.time())}"
            return spawn(_train_rank, ranks, (cfg, staging_prefix, embeddings_prefix, models_prefix,
                                              store, resume, device), device=device)[0]
    dev = resolve_device(device)
    store = store or ArtifactStore()
    interactions = store.load_interactions(staging_prefix)
    u2i, i2i = build_node_maps(interactions)
    splits = build_splits(interactions, u2i, i2i)
    if cfg.model_family == "hgt":
        graph = build_hetero_graph(splits.train_u, splits.train_i, splits.n_users, splits.n_items,
                                   *load_knn_coo(store, cfg.knn_edges))
    else:
        graph = build_bipartite_graph(splits.train_u, splits.train_i, splits.n_users, splits.n_items,
                                      weight=splits.train_w)
    feats = (_features(store, cfg, embeddings_prefix, splits.n_items)
             if cfg.model_family in ("gat", "hgt") else None)
    model = make_model(cfg, splits.n_users, splits.n_items, 0 if feats is None else feats.shape[1],
                       device=dev)
    if cfg.mesh_shape:
        from plotpointe_tpu_torch.parallel.mesh import make_mesh
        from plotpointe_tpu_torch.train.sharded import ShardedTrainer

        trainer = ShardedTrainer(model, cfg, graph, splits, item_feats=feats,
                                 mesh=make_mesh(cfg.mesh_shape, device=device))
        cfg.run_id = _same_on_every_rank(cfg.run_id or f"{cfg.model_family}_d{cfg.hidden_dim}_"
                                         f"{int(time.time())}")
    else:
        trainer = Trainer(model, cfg, graph, splits, item_feats=feats, device=dev)
        cfg.run_id = cfg.run_id or f"{cfg.model_family}_d{cfg.hidden_dim}_{int(time.time())}"
    ckpt_uri = f"{models_prefix}/checkpoints/{cfg.run_id}.npz"
    resume_path = store.target(f"{models_prefix}/resume.pt") if resume else None
    ckpt_local = store.target(ckpt_uri)
    results = trainer.fit(checkpoint_path=str(ckpt_local),
                          resume_path=None if resume_path is None else str(resume_path))
    metrics = {k: results[k] for k in ("best_val_ndcg@20", "val", "test", "config", "notes",
                                       "history", "wall_time_s")}
    if trainer.writes:
        store.publish(ckpt_local, ckpt_uri)
        store.save_json(metrics, f"{models_prefix}/metrics_{cfg.run_id}.json")
    results["checkpoint_uri"] = ckpt_uri
    results["trainer"] = trainer
    return results


def _ranks_to_spawn(mesh_shape: str) -> int:
    """How many ranks `train_from_artifacts` must spawn for `mesh_shape`:
    none under a running or launched process group, or for one rank."""
    import numpy as np
    import torch.distributed as dist

    from plotpointe_tpu_torch.parallel.mesh import parse_mesh_shape
    from plotpointe_tpu_torch.parallel.multihost import maybe_initialize_distributed

    if dist.is_initialized() or maybe_initialize_distributed():
        return 0
    total = int(np.prod(list(parse_mesh_shape(mesh_shape).values())))
    return total if total > 1 else 0


def _same_on_every_rank(value):
    """Rank 0's `value` on every rank."""
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _train_rank(cfg, staging_prefix, embeddings_prefix, models_prefix, store, resume, device):
    """One spawned rank of `train_from_artifacts` (its results, without the trainer)."""
    results = train_from_artifacts(cfg, staging_prefix, embeddings_prefix, models_prefix, store,
                                   resume, device)
    results.pop("trainer")
    return results
