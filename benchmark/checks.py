"""The numbers that decide `correct`, each the gap between what the timed
path produced and what the reference works out; each is held to the limit
its cell file states.

Training (the first fit's first steps, through the first step of epoch 2,
of the trainer object the window then drives; then that object's eval of
the weights the reference reached on its own after those steps):
  loss_gap    max over the steps of |loss - reference loss| / |reference loss|
  grad_gap    worst leaf of | |g| - |g_ref| | / max(|g_ref|, median leaf |g_ref|),
              g the first gradient as the optimizer got it (from its first
              moment after one step, with the L2 term)
  change_gap  the same of each leaf's change over the first three steps,
              leaves whose reference gradient is under a thousandth of the
              median leaf's left out (they move under Adam by round-off alone)
  embed_gap   |Z - Z_ref| / |Z_ref| (Frobenius) of the node embeddings of the
              program's eval forward of the reference's weights, against the
              reference's forward of them
  eval_gap    max |metric - reference metric| over recall@10, recall@20,
              NDCG@10 and NDCG@20 of the program's test and val evals of the
              reference's weights, against the reference's evals of its own
              forward (negatives drawn again from the same streams)
Serving (a sample of the window's replies, drawn from the seed):
  score_gap   max over the sampled replies of the gap between each rank's
              served score and the exact f32 top-k's, and between each served
              item's score and its exact score; a reply that is not k
              distinct items outside the history counts as infinite."""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import numpy as np

EVAL_KEYS = ("recall@10", "recall@20", "ndcg@10", "ndcg@20")
ZERO_GRAD_SHARE = 1e-3


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    if len(got) != len(want):
        return math.inf
    return max((abs(g - w) / abs(w) if math.isfinite(g) else math.inf) for g, w in zip(got, want))


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves: Iterable[str]) -> float:
    leaves = list(leaves)
    if set(got) != set(want) or not leaves:
        return math.inf
    med = float(np.median([want[k] for k in want]))
    worst = 0.0
    for k in leaves:
        if not math.isfinite(got[k]):
            return math.inf
        worst = max(worst, abs(got[k] - want[k]) / max(want[k], med, 1e-30))
    return worst


def grad_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    return _leaf_gap(got, want, want)


def moving_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grads.values())))
    return [k for k, v in ref_grads.items() if v >= ZERO_GRAD_SHARE * med]


def change_gap(got: Dict[str, float], want: Dict[str, float], ref_grads: Dict[str, float]) -> float:
    return _leaf_gap(got, want, moving_leaves(ref_grads))


def embed_gap(got, want) -> float:
    import torch

    if got.shape != want.shape:
        return math.inf
    gap = float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()))
    return gap if math.isfinite(gap) else math.inf


def eval_gap(got: Dict[str, Dict[str, float]], want: Dict[str, Dict[str, float]]) -> float:
    """Over the splits of `want` ({"test": metrics, "val": metrics})."""
    if set(got) != set(want):
        return math.inf
    gaps = [abs(got[s][k] - want[s][k]) for s in want for k in EVAL_KEYS]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def reply_gap(indices: Sequence[int], scores: Sequence[float], history: Sequence[int], k: int,
              n_items: int, exact_at: np.ndarray, exact_top: np.ndarray) -> float:
    """One reply against the exact scores: `exact_at` of each served item
    (in the reply's order) and `exact_top`, the exact top k of all items
    outside the history, descending."""
    idx = np.asarray(indices, np.int64)
    sc = np.asarray(scores, np.float64)
    if (len(idx) != k or len(sc) != k or len(set(idx.tolist())) != k or idx.min() < 0
            or idx.max() >= n_items or set(idx.tolist()) & set(int(h) for h in history)
            or not np.all(np.isfinite(sc))):
        return math.inf
    by_item = np.max(np.abs(sc - np.asarray(exact_at, np.float64)))
    by_rank = np.max(np.abs(np.sort(sc)[::-1] - np.asarray(exact_top, np.float64)[:k]))
    return float(max(by_item, by_rank))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared is finite and within its limit."""
    return all(math.isfinite(numbers.get(k, math.inf)) and numbers[k] <= lim
               for k, lim in limits.items())
