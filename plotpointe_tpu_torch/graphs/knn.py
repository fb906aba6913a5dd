"""Item-item cosine kNN graph: neighbours, min-similarity filter, COO edges
and the ii_edges_{name}.npz + ii_{name}_stats.json artifacts.

Counterpart of `plotpointe_tpu/graphs/knn.py`. Rows are L2-normalised once
(x / (|x| + 1e-8), so a zero row has similarity 0 to everything), then:
  impl "pallas"  `ops/knn_kernel.knn_topk`: on CUDA the candidate kernel
                 (kernel 10, or 11 with mode="fast") fused with a running
                 top-(k + 8), then an exact f32 re-score; on the CPU its plain
                 versions;
  impl "xla"     the blocked plain path, for JAX's `_knn_blocks` with
                 `_hierarchical_topk`: kernel 10's plain version run with R = k
                 (`knn_candidates_plain`: per strip of `block_rows` rows, f32
                 scores against every row with TF32 off, self masked, top-k
                 with the smaller-index tie rule); `mode` is ignored, as in JAX;
  impl "auto"    "pallas" on CUDA, "xla" on the CPU (JAX's rule, with the card
                 in the TPU's place).
Entry points run on CUDA unless given `device="cpu"`. Results are numpy
arrays: they are the artifact contract.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch import resolve_device
from plotpointe_tpu_torch.ops import knn_kernel
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def cosine_knn(
    features,
    k: int = 20,
    min_similarity: float = 0.3,
    block_rows: int = 512,
    normalize: bool = True,
    impl: str = "auto",
    mode: str = "exact",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k cosine neighbours per row of features [N, d] (numpy or torch).
    Returns (idx [N, k], sim [N, k], valid [N, k] bool where sim >=
    min_similarity and idx is a real row)."""
    dev = resolve_device(device)
    if isinstance(features, torch.Tensor):
        x = features.to(device=dev, dtype=torch.float32)
    else:
        x = torch.as_tensor(np.asarray(features, dtype=np.float32)).to(dev)
    n = x.shape[0]
    if normalize:
        x = l2_normalize(x)
    if impl == "auto":
        impl = "pallas" if dev.type == "cuda" else "xla"
    if impl == "pallas":
        idx, sim = knn_kernel.knn_topk(x, k, mode=mode)
    elif impl == "xla":
        idx, sim = knn_kernel.knn_candidates_plain(x, k, block_rows)
    else:
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla'; got {impl!r}")
    idx, sim = idx.cpu().numpy(), sim.cpu().numpy()
    valid = (sim >= min_similarity) & (idx < n) & (idx >= 0)
    return idx, sim, valid


def knn_to_coo(idx: np.ndarray, sim: np.ndarray, valid: np.ndarray):
    """Flatten kNN results to COO edge arrays (row -> neighbour)."""
    n, k = idx.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)[valid.ravel()]
    cols = idx.ravel()[valid.ravel()].astype(np.int64)
    vals = sim.ravel()[valid.ravel()].astype(np.float32)
    return rows, cols, vals


def knn_stats(rows, cols, vals, n_items: int, k: int, min_similarity: float,
              build_time_sec: float) -> Dict:
    """The stats JSON: the JAX package's keys."""
    deg = np.bincount(rows, minlength=n_items)
    return {
        "n_items": int(n_items),
        "n_edges": int(len(vals)),
        "k": int(k),
        "min_similarity": float(min_similarity),
        "avg_similarity": float(vals.mean()) if len(vals) else 0.0,
        "min_similarity_observed": float(vals.min()) if len(vals) else 0.0,
        "max_similarity": float(vals.max()) if len(vals) else 0.0,
        "avg_neighbors_per_item": float(deg.mean()),
        "items_with_full_k": int((deg == k).sum()),
        "build_time_sec": float(build_time_sec),
    }


def cosine_knn_graph(
    features,
    out_prefix: Optional[str] = None,
    feature_name: str = "fused",
    k: int = 20,
    min_similarity: float = 0.3,
    block_rows: int = 512,
    store=None,
    device=None,
) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], Dict]:
    """Build the item-item kNN graph and (optionally) write the
    ii_edges_{feature_name}.npz + ii_{feature_name}_stats.json artifacts."""
    t0 = time.time()
    idx, sim, valid = cosine_knn(features, k=k, min_similarity=min_similarity,
                                 block_rows=block_rows, device=device)
    rows, cols, vals = knn_to_coo(idx, sim, valid)
    n = features.shape[0]
    stats = knn_stats(rows, cols, vals, n, k, min_similarity, time.time() - t0)

    if out_prefix is not None:
        store = store or ArtifactStore()
        store.save_npz(
            {
                "row": rows.astype(np.int32),
                "col": cols.astype(np.int32),
                "data": vals,
                "shape": np.array([n, n], dtype=np.int64),
                "format": np.array(b"coo"),
            },
            f"{out_prefix}/ii_edges_{feature_name}.npz",
        )
        store.save_json(stats, f"{out_prefix}/ii_{feature_name}_stats.json")
    return (rows, cols, vals), stats
