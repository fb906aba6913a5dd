"""The sampled evaluation as stated: per eval user one positive and neg_k
negatives drawn outside the user's train positives and the positive; rank =
1 + the negatives scoring strictly higher (a non-finite positive score
ranks last); recall@K = [rank <= K], NDCG@K = 1 / log2(rank + 1) on a hit;
means over the users. Users go in chunks (the stated chunk, cut to the
eval's size rounded up to 128), padded with user 0, each chunk drawing its
negatives from the eval stream in turn; scores are f32 products of the
whole chunk."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.sampling import eval_negatives

KS = (10, 20)


def sampled_eval(U, I, users: np.ndarray, pos: np.ndarray, table, deg, gen, neg_k: int,
                 chunk: int) -> Dict[str, float]:
    n = len(users)
    chunk = min(chunk, ((n + 127) // 128) * 128)
    n_pad = -(-n // chunk) * chunk
    dev = U.device
    uu = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    pp = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    uu[:n] = torch.as_tensor(users.astype(np.int64), device=dev)
    pp[:n] = torch.as_tensor(pos.astype(np.int64), device=dev)
    sums = {f"{m}@{k}": 0.0 for k in KS for m in ("recall", "ndcg")}
    for c in range(0, n_pad, chunk):
        u, p = uu[c:c + chunk], pp[c:c + chunk]
        negs = eval_negatives(gen, u, p, table, deg, I.shape[0], neg_k)
        real = min(chunk, n - c)
        if real <= 0:
            continue
        scores = (U[u] @ I.T)[:real]  # the whole chunk's product, as the chunk is stated
        u, p, negs = u[:real], p[:real], negs[:real]
        ps = scores.gather(1, p[:, None])
        rank = 1 + (scores.gather(1, negs) > ps).sum(1)
        rank = torch.where(torch.isfinite(ps[:, 0]), rank, torch.full_like(rank, neg_k + 2))
        for k in KS:
            hit = rank <= k
            sums[f"recall@{k}"] += float(hit.sum())
            sums[f"ndcg@{k}"] += float(torch.where(hit, 1.0 / torch.log2(rank.double() + 1.0),
                                                   torch.zeros_like(rank, dtype=torch.float64)).sum())
    return {k: v / max(n, 1) for k, v in sums.items()}
