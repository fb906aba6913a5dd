"""Serving runtime: mean-history user vector -> top-K dot-product retrieval.

Counterpart of `plotpointe_tpu/serving/runtime.py`. The user vector is the
f32 mean of the history's item rows (computed on the host, so an id out of
range raises IndexError in every path); history items never come back.

Paths, chosen by the config:
  use_device=False: numpy (argpartition), no GPU.
  use_device=True, use_kernel_topk: the two-level top-K kernels
      (`ops/topk_kernel.topk_mips`), retrieving k + |history| and dropping
      the history. Auto (None) is True on CUDA.
  use_device=True, not use_kernel_topk: one f32 score matrix and
      `torch.topk`, history masked to -1e9.
The table lives on `device` (None = the GPU) in `table_dtype`.

Spans of the batched path (`utils/tracing.py`): `serve.queries` (the host
history means and their copy to the device), `serve.topk` (with a device
interval), `serve.fetch` (the reads back to the host), `serve.filter` (the
history dropped).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch import resolve_device
from plotpointe_tpu_torch.ops.topk_kernel import topk_mips
from plotpointe_tpu_torch.serving.batching import bucket_size
from plotpointe_tpu_torch.utils import tracing
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

_TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ServingConfig:
    item_embeddings_uri: str
    item_index_map_uri: Optional[str] = None
    topk: int = 20
    project_id: Optional[str] = None  # the gs:// client's project (utils/artifacts.py)
    use_device: bool = True  # False -> pure numpy (no GPU)
    device: Optional[str] = None  # None -> cuda (raises without a GPU); "cpu" runs plain versions
    use_kernel_topk: Optional[bool] = None  # None = auto: the top-K kernels on CUDA
    topk_mode: str = "exact"  # "fast" = phase-2 chunk margin 2 instead of 8
    table_dtype: str = "float32"  # "bfloat16" halves the table and its stream
    # (scores stay f32; ranks can differ by bf16 rounding on near-ties)


class RecommenderRuntime:
    def __init__(self, cfg: ServingConfig, store: Optional[ArtifactStore] = None):
        if cfg.table_dtype not in _TABLE_DTYPES:
            raise ValueError(f"table_dtype must be one of {sorted(_TABLE_DTYPES)}")
        self.cfg = cfg
        self.store = store or ArtifactStore(project_id=cfg.project_id)
        self.item_vecs: Optional[np.ndarray] = None
        self._table: Optional[torch.Tensor] = None
        self.item_to_idx: Optional[dict] = None

    def _kernel_topk(self) -> bool:
        if self.cfg.use_kernel_topk is not None:
            return self.cfg.use_kernel_topk
        return self._table.device.type == "cuda"

    def startup(self) -> None:
        self.item_vecs = np.asarray(self.store.load_npy(self.cfg.item_embeddings_uri), dtype=np.float32)
        if self.cfg.use_device:
            dev = resolve_device(self.cfg.device)
            self._table = torch.as_tensor(self.item_vecs, device=dev).to(
                _TABLE_DTYPES[self.cfg.table_dtype])
        if self.cfg.item_index_map_uri:
            self.item_to_idx = self.store.load_json(self.cfg.item_index_map_uri)

    def _ensure_started(self):
        if self.item_vecs is None:
            raise RuntimeError("Runtime not started. Call startup().")

    def _queries(self, histories: List[np.ndarray]) -> torch.Tensor:
        """[B, D] f32 history means on the host -> the table's device and dtype."""
        q = np.stack([self.item_vecs[np.asarray(h, np.int32)].mean(axis=0) for h in histories])
        return torch.as_tensor(q, device=self._table.device).to(self._table.dtype)

    def top_k_for_user_items(self, item_ids: List[int], k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure_started()
        if len(item_ids) == 0:
            raise ValueError("Need at least one item id from user history")
        K = int(k or self.cfg.topk)
        ids = np.asarray(item_ids, dtype=np.int32)
        if not self.cfg.use_device:
            return self._topk_numpy(ids, K)

        q = self._queries([ids])
        n = self.item_vecs.shape[0]
        if self._kernel_topk():
            # retrieve K + |history| then drop history (the kernels are history-agnostic)
            kk = min(K + len(ids), n)
            idx, scores = topk_mips(self._table, q, kk, mode=self.cfg.topk_mode)
            idx, scores = idx[0].cpu().numpy(), scores[0].cpu().numpy()
            keep = ~np.isin(idx, ids % n)
            return idx[keep][:K], scores[keep][:K]

        scores = (q.float() @ self._table.float().T)[0]
        scores[torch.as_tensor(ids.astype(np.int64), device=scores.device)] = -1e9
        top_scores, top_idx = torch.topk(scores, K)
        return top_idx.cpu().numpy(), top_scores.cpu().numpy()

    def validate_history(self, ids: np.ndarray) -> None:
        """Raise IndexError for ids the numpy gather would reject (negative
        ids wrap), so the micro-batcher can reject a bad request on its own
        instead of failing a whole coalesced batch."""
        self._ensure_started()
        n = self.item_vecs.shape[0]
        a = np.asarray(ids)
        if a.size and (int(a.max()) >= n or int(a.min()) < -n):
            bad = a[(a >= n) | (a < -n)][0]
            raise IndexError(f"index {int(bad)} is out of bounds for axis 0 with size {n}")

    def top_k_for_batch(self, histories: List[np.ndarray], ks: List[int],
                        max_batch: int = 64) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Score many users' histories in ONE batched call (the micro-batching
        path). Per-query semantics match the kernel branch of
        top_k_for_user_items: retrieve k + |history|, drop history items.
        max_batch: the batcher's coalescing cap, the largest batch bucket."""
        self._ensure_started()
        if not self.cfg.use_device:
            return [self._topk_numpy(np.asarray(h, np.int32), int(k))
                    for h, k in zip(histories, ks)]
        n = self.item_vecs.shape[0]
        # kk rounded up to a multiple of 32 so the selection sees few shapes
        kk_raw = int(max(ks)) + max(len(h) for h in histories)
        kk = min(-(-kk_raw // 32) * 32, n)
        b = len(histories)
        bp = bucket_size(b, max_batch)
        padded = list(histories) + [histories[-1]] * (bp - b)
        with tracing.span("serve.queries", batch=bp):
            q = self._queries(padded)
        with tracing.span("serve.topk", device=self._table.device, k=kk):
            if self._kernel_topk():
                idx, scores = topk_mips(self._table, q, kk, mode=self.cfg.topk_mode)
            else:
                scores, idx = torch.topk(q.float() @ self._table.float().T, kk, dim=1)
        with tracing.span("serve.fetch"):
            idx_np, sc_np = idx[:b].cpu().numpy(), scores[:b].cpu().numpy()
        with tracing.span("serve.filter"):
            out = []
            for r, (h, k) in enumerate(zip(histories, ks)):
                keep = ~np.isin(idx_np[r], np.asarray(h) % n)  # numpy's negative-id wrap
                out.append((idx_np[r][keep][: int(k)], sc_np[r][keep][: int(k)]))
        return out

    def _topk_numpy(self, ids: np.ndarray, K: int) -> Tuple[np.ndarray, np.ndarray]:
        user_vec = self.item_vecs[ids].mean(axis=0)
        scores = self.item_vecs @ user_vec
        scores[ids] = -1e9
        top_idx = np.argpartition(scores, -K)[-K:]
        order = np.argsort(scores[top_idx])[::-1]
        top_idx = top_idx[order]
        return top_idx, scores[top_idx]
