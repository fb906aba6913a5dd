"""U-I bipartite graph artifacts: ui_edges.npz + node_maps.json + ui_stats.json.

Counterpart of `plotpointe_tpu/graphs/ui_graph.py`, numpy only: the
interactions may be a pandas DataFrame or a dict of column arrays. COO users
x items with edge weight (rating - 1) / 4 (1 without ratings), node maps in
first-occurrence order, stats with weighted-degree mean/std/min/max and
sparsity. The files are the JAX package's: the same npz fields and JSON keys.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

from plotpointe_tpu_torch.data.splits import (
    _column, _has_column, _map_ids, build_node_maps, node_maps_json)
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore


def build_ui_coo(interactions, user_to_idx: Dict, item_to_idx: Dict):
    """COO arrays (rows = user idx, cols = item idx, vals = (rating - 1) / 4)."""
    rows = _map_ids(_column(interactions, "user_id"), user_to_idx)
    cols = _map_ids(_column(interactions, "asin"), item_to_idx)
    if _has_column(interactions, "rating"):
        vals = (_column(interactions, "rating").astype(np.float32) - 1.0) / 4.0
    else:
        vals = np.ones(len(rows), dtype=np.float32)
    return rows, cols, vals.astype(np.float32)


def ui_stats(rows, cols, vals, n_users: int, n_items: int, build_time_sec: float = 0.0) -> Dict:
    """Weighted-degree statistics of the U-I graph."""
    user_deg = np.bincount(rows, weights=vals, minlength=n_users)
    item_deg = np.bincount(cols, weights=vals, minlength=n_items)
    n_edges = len(vals)
    return {
        "n_users": int(n_users),
        "n_items": int(n_items),
        "n_edges": int(n_edges),
        "sparsity": float(1 - n_edges / (n_users * n_items)) if n_users and n_items else 0.0,
        "user_degree_mean": float(user_deg.mean()),
        "user_degree_std": float(user_deg.std()),
        "user_degree_min": int(user_deg.min()),
        "user_degree_max": int(user_deg.max()),
        "item_degree_mean": float(item_deg.mean()),
        "item_degree_std": float(item_deg.std()),
        "item_degree_min": int(item_deg.min()),
        "item_degree_max": int(item_deg.max()),
        "build_time_sec": float(build_time_sec),
    }


def build_ui_artifacts(interactions, out_prefix: str, store=None) -> Tuple[Dict, Dict]:
    """Node maps + COO npz + stats under `out_prefix`. Returns (uris, stats)."""
    store = store or ArtifactStore()
    t0 = time.time()
    user_to_idx, item_to_idx = build_node_maps(interactions)
    rows, cols, vals = build_ui_coo(interactions, user_to_idx, item_to_idx)
    n_users, n_items = len(user_to_idx), len(item_to_idx)
    stats = ui_stats(rows, cols, vals, n_users, n_items, build_time_sec=time.time() - t0)

    uris = {
        "ui_edges": f"{out_prefix}/ui_edges.npz",
        "node_maps": f"{out_prefix}/node_maps.json",
        "ui_stats": f"{out_prefix}/ui_stats.json",
    }
    # scipy.sparse.save_npz's field layout, so either side can read it
    store.save_npz(
        {
            "row": rows.astype(np.int32),
            "col": cols.astype(np.int32),
            "data": vals,
            "shape": np.array([n_users, n_items], dtype=np.int64),
            "format": np.array(b"coo"),
        },
        uris["ui_edges"],
    )
    store.save_json(node_maps_json(user_to_idx, item_to_idx), uris["node_maps"])
    store.save_json(stats, uris["ui_stats"])
    return uris, stats
