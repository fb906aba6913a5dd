"""Item-embedding export: checkpoint -> item_embeddings.npy.

Counterpart of `plotpointe_tpu/tools/export.py`: rebuild the train split and
the bipartite graph exactly as training did, restore the model from the
checkpoint's embedded config, run one full-graph forward, keep the item half,
save float32. Both families run at f32 rows, the function the JAX export
computes: on the GPU the GAT's attention layers run the fused kernels (kernel
1, or 8 for 2 to 8 heads; a GATv2 checkpoint, `csrc/gatv2_fwd.cu`; an HGT
checkpoint, `csrc/hgt_fwd.cu` over the typed graph of the train split and
the item kNN artifact, given or else the one its training config names),
LightGCN's propagation runs kernel 7. LightGCN takes no item features.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from plotpointe_tpu_torch import resolve_device
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
from plotpointe_tpu_torch.graphs.hetero import build_hetero_graph, load_knn_coo
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.models.hgt import HGTModel
from plotpointe_tpu_torch.models.lightgcn import LightGCNModel
from plotpointe_tpu_torch.train.checkpoint import load_checkpoint, params_from_jax
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore


def export_item_embeddings(checkpoint_path: str | Path, interactions,
                           item_feats: Optional[np.ndarray], out_uri: str,
                           store: Optional[ArtifactStore] = None, device=None,
                           knn_edges: Optional[str] = None) -> np.ndarray:
    """Returns the exported [n_items, hidden] matrix and writes it to out_uri.
    `item_feats` is needed for a GAT or HGT checkpoint and ignored for
    LightGCN; `knn_edges` (an HGT checkpoint's kNN artifact) defaults to the
    one its training config names."""
    dev = resolve_device(device)
    store = store or ArtifactStore()
    flat, config = load_checkpoint(checkpoint_path)
    family = config.get("model_family", "gat")
    if family not in ("gat", "lightgcn", "hgt"):
        raise ValueError(f"unknown model_family {family}")
    if family != "lightgcn" and item_feats is None:
        raise ValueError(f"a {family.upper()} checkpoint needs item features to export")
    knn_edges = knn_edges or config.get("train_config", {}).get("knn_edges")
    if family == "hgt" and not knn_edges:
        raise ValueError("an HGT checkpoint needs the item kNN artifact (knn_edges) to export")

    u2i, i2i = build_node_maps(interactions)
    s = build_splits(interactions, u2i, i2i)
    if s.n_users != config["n_users"] or s.n_items != config["n_items"]:
        raise ValueError(
            f"checkpoint was trained on n_users={config['n_users']}, n_items={config['n_items']} "
            f"but interactions give {s.n_users}/{s.n_items}")
    if family == "hgt":
        graph = build_hetero_graph(s.train_u, s.train_i, s.n_users, s.n_items,
                                   *load_knn_coo(store, knn_edges)).to(dev)
    else:
        graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items,
                                      weight=s.train_w).to(dev)

    model = {"gat": GATModel, "lightgcn": LightGCNModel, "hgt": HGTModel}[family].from_config(config)
    model.load_state_dict(params_from_jax(flat))
    model.to(dev)
    with torch.no_grad():
        if family == "lightgcn":
            z = model(model.operator(graph))
        else:
            z = model(torch.as_tensor(np.asarray(item_feats, np.float32), device=dev), graph)
    item_emb = z[s.n_users:].cpu().numpy().astype(np.float32)
    store.save_npy(item_emb, out_uri)
    return item_emb
