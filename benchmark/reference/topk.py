"""Exact top-k retrieval as stated for `/recommend`: the query is the f32
mean of the history's item rows; every item's score is its f32 dot product
with the query; the history's items are left out; the k best scores,
descending. Computed in blocks of queries."""
from __future__ import annotations

from typing import List, Tuple

import torch

from benchmark.reference.training import matmul_precision


def exact(table: torch.Tensor, histories: List[List[int]], served: List[List[int]], k: int,
          tf32: bool = False, block: int = 64) -> List[Tuple[list, list, list, list]]:
    """Per history: (the exact score of each served item, the exact top-k
    scores, the exact top-k items). A served id outside the catalog reads
    item 0's score (the comparison refuses such a reply on its own)."""
    out = []
    dev = table.device
    with torch.no_grad(), matmul_precision(tf32):
        for b in range(0, len(histories), block):
            hs = histories[b:b + block]
            q = torch.stack([table[torch.as_tensor(h, device=dev)].mean(0) for h in hs])
            scores = q @ table.T
            for r, h in enumerate(hs):
                scores[r, torch.as_tensor(h, device=dev)] = -torch.inf
            top_v, top_i = torch.topk(scores, k, dim=1)
            for r, h in enumerate(hs):
                ids = torch.as_tensor(served[b + r], device=dev, dtype=torch.int64)
                at = scores[r, torch.where((ids >= 0) & (ids < table.shape[0]), ids, 0)]
                out.append((at.tolist(), top_v[r].tolist(), top_i[r].tolist()))
    return out
