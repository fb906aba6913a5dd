"""Sampled-negative Recall@K / NDCG@K evaluation.

Counterpart of `plotpointe_tpu/train/evaluate.py`: per eval user, one
positive and `neg_k` negatives drawn uniformly over items outside the user's
train positives and the positive itself; rank = 1 + (number of negatives
scoring strictly higher); recall@K = 1[rank <= K]; ndcg@K = 1/log2(rank + 1)
on a hit; macro mean. A non-finite positive score counts as unranked (a
diverged model would otherwise rank first everywhere), and `tie_fraction`
reports the share of negatives exactly tying the positive.

Users go in chunks of `chunk`. Each chunk's ranks and ties come from one
launch of `ops/eval_kernel.eval_rank`, which scores just the positive and the
negatives of each user, each as one f32 FMA chain (f32 throughout, as the JAX
package asks for HIGH precision: a rank comparison is sensitive to rounding);
on the CPU its plain version scores all items with one f32 matrix product and
gathers the candidates. Rows whose width is not a multiple of 4 (the anchor's
one-column baselines) are padded with zero columns first, which leaves every
score as it was. Spans (`utils/tracing.py`): per chunk
`eval.negatives` and `eval.scores` (the ranks and the sums, with its device
interval), then `eval.read` (the totals' reads).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch.ops.eval_kernel import eval_rank
from plotpointe_tpu_torch.train.sampling import sample_eval_negatives
from plotpointe_tpu_torch.utils import tracing


def eval_from_negatives(U: torch.Tensor, I: torch.Tensor, users: torch.Tensor, pos: torch.Tensor,
                        negs: torch.Tensor, valid: torch.Tensor,
                        ks: Sequence[int] = (10, 20)) -> Dict[str, torch.Tensor]:
    """Sums over one chunk (`_eval_chunk`'s outputs): `tie_frac_sum`,
    `recall@k_sum`, `ndcg@k_sum`, `count`. users/pos [C], negs [C, neg_k],
    valid [C] float {0, 1}."""
    rank, ties = eval_rank(U, I, users, pos, negs)
    ties = ties.to(torch.float32) / negs.shape[1]
    out = {"tie_frac_sum": (ties * valid).sum()}
    rank_f = rank.to(torch.float32)
    for k in ks:
        hit = rank <= k
        out[f"recall@{k}_sum"] = (hit.to(torch.float32) * valid).sum()
        ndcg = torch.where(hit, 1.0 / torch.log2(rank_f + 1.0), torch.zeros_like(rank_f))
        out[f"ndcg@{k}_sum"] = (ndcg * valid).sum()
    out["count"] = valid.sum()
    return out


def sampled_eval(U: torch.Tensor, I: torch.Tensor, eval_users: np.ndarray, eval_pos: np.ndarray,
                 user_pos_padded: torch.Tensor, user_deg: torch.Tensor,
                 generator: torch.Generator, neg_k: int = 1000, ks: Tuple[int, ...] = (10, 20),
                 chunk: int = 512) -> Dict[str, float]:
    """Macro-averaged sampled metrics over (eval_users, eval_pos)."""
    n = len(eval_users)
    if n == 0:
        return {f"{m}@{k}": 0.0 for k in ks for m in ("recall", "ndcg")}
    chunk = min(chunk, ((n + 127) // 128) * 128)  # don't pad tiny evals to a full chunk
    n_pad = ((n + chunk - 1) // chunk) * chunk
    dev = U.device
    users = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    pos = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    users[:n] = torch.as_tensor(np.asarray(eval_users, np.int32), device=dev)
    pos[:n] = torch.as_tensor(np.asarray(eval_pos, np.int32), device=dev)
    valid[:n] = 1.0
    if U.shape[1] % 4:  # the rank kernel reads rows in 16-byte loads; zero columns add exact zeros
        U, I = (torch.nn.functional.pad(x, (0, -U.shape[1] % 4)) for x in (U, I))

    sums: Dict[str, torch.Tensor] = {}
    for c in range(0, n_pad, chunk):
        sl = slice(c, c + chunk)
        with tracing.span("eval.negatives"):
            negs = sample_eval_negatives(generator, users[sl], pos[sl], user_pos_padded,
                                         user_deg, I.shape[0], neg_k)
        with tracing.span("eval.scores", device=dev):
            part = eval_from_negatives(U, I, users[sl], pos[sl], negs, valid[sl], ks)
            for k, v in part.items():
                sums[k] = sums[k] + v if k in sums else v
    with tracing.span("eval.read"):
        totals = {k: float(v) for k, v in sums.items()}
    count = max(totals["count"], 1.0)
    metrics = {}
    for k in ks:
        metrics[f"recall@{k}"] = totals[f"recall@{k}_sum"] / count
        metrics[f"ndcg@{k}"] = totals[f"ndcg@{k}_sum"] / count
    metrics["tie_fraction"] = totals["tie_frac_sum"] / count
    return metrics
