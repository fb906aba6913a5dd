"""The sampled eval's ranks in one kernel (`csrc/eval_rank.cu`).

For each user of an eval chunk, the kernel scores the user's positive and
its `neg_k` negatives in f32 and returns the positive's rank (1 + the
negatives scoring strictly above it, `neg_k + 2` where its score is not
finite) and its exact ties. It replaces the dense [C, n_items] product and
the two gathers of the JAX package's `_eval_chunk`, which computed every
item's score to keep 1 + neg_k of them; no Pallas kernel did this work.

Each score is one f32 FMA chain over d = 0 .. D-1 in ascending order, the
order a non-split-K f32 product on the CUDA cores accumulates in, and the
positive and the negatives go through the same code, so copied rows tie
exactly. The plain version, taken for CPU tensors, is the dense product and
the gathers.

A launch made while the current stream captures a CUDA graph (the eval's
`G_scores`, `train/evaluate.py`) is not counted: it runs at each replay, and
the replay counts it. `EVAL_GRAPH_CAPTURES` and `EVAL_GRAPH_REPLAYS` count
the eval's captures (one a key) and its graph replays (two a chunk).
"""
from __future__ import annotations

from typing import Tuple

import torch

from plotpointe_tpu_torch.ops import cuda_build as cb

EVAL_RANK_LAUNCHES = cb.COUNTERS["eval_rank"]
EVAL_GRAPH_CAPTURES = cb.LaunchCounter()
EVAL_GRAPH_REPLAYS = cb.LaunchCounter()


def eval_rank_plain(U: torch.Tensor, I: torch.Tensor, users: torch.Tensor, pos: torch.Tensor,
                    negs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rank, ties), both int32 [C], from the dense product U[users] @ I.T
    and gathers of its positive and negative columns."""
    neg_k = negs.shape[1]
    scores = U[users.long()] @ I.T  # [C, n_items]
    pos_score = torch.gather(scores, 1, pos.long()[:, None])  # [C, 1]
    neg_scores = torch.gather(scores, 1, negs.long())  # [C, neg_k]
    rank = 1 + torch.sum(neg_scores > pos_score, dim=1)
    rank = torch.where(torch.isfinite(pos_score[:, 0]), rank, torch.full_like(rank, neg_k + 2))
    ties = torch.sum(neg_scores == pos_score, dim=1)
    return rank.to(torch.int32), ties.to(torch.int32)


def _check(U, I, users, pos, negs) -> None:
    if U.dim() != 2 or I.dim() != 2 or U.shape[1] != I.shape[1]:
        raise ValueError(f"need U [n_users, D] and I [n_items, D]; got {tuple(U.shape)} and {tuple(I.shape)}")
    if U.dtype != torch.float32 or I.dtype != torch.float32:
        raise ValueError(f"U and I must be float32; got {U.dtype} and {I.dtype}")
    if U.shape[1] % 4 or U.shape[1] == 0:
        raise ValueError(f"D must be a positive multiple of 4 (16-byte row loads); got {U.shape[1]}")
    c = users.shape[0] if users.dim() == 1 else -1
    if c <= 0 or tuple(pos.shape) != (c,) or negs.dim() != 2 or negs.shape[0] != c or negs.shape[1] < 1:
        raise ValueError(f"need users [C], pos [C] and negs [C, neg_k >= 1]; got {tuple(users.shape)}, "
                         f"{tuple(pos.shape)} and {tuple(negs.shape)}")
    if any(x.dtype != torch.int32 for x in (users, pos, negs)):
        raise ValueError(f"users, pos and negs must be int32; got {users.dtype}, {pos.dtype}, {negs.dtype}")
    if any(x.device != U.device for x in (I, users, pos, negs)):
        raise ValueError("U, I, users, pos and negs must be on one device")
    if not all(x.is_contiguous() for x in (U, I, users, pos, negs)):
        raise ValueError("U, I, users, pos and negs must be contiguous")
    if U.device.type == "cuda" and (U.data_ptr() % 16 or I.data_ptr() % 16):
        raise ValueError("U and I must start 16-byte aligned")


def eval_rank(U: torch.Tensor, I: torch.Tensor, users: torch.Tensor, pos: torch.Tensor,
              negs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """U [n_users, D] and I [n_items, D] float32 (D a multiple of 4), users
    and pos [C] and negs [C, neg_k] int32 ids in range -> (rank, ties), both
    int32 [C]. One launch on the card (counted unless captured); the plain
    version on the CPU."""
    _check(U, I, users, pos, negs)
    if U.is_cpu:
        return eval_rank_plain(U, I, users, pos, negs)
    c, (neg_k, d) = users.shape[0], (negs.shape[1], U.shape[1])
    cb.require_smem("eval_rank", d)
    rank = torch.empty(c, dtype=torch.int32, device=U.device)
    ties = torch.empty(c, dtype=torch.int32, device=U.device)
    cb.launch("eval_rank", U.device, U.data_ptr(), I.data_ptr(), users.data_ptr(), pos.data_ptr(),
              negs.data_ptr(), rank.data_ptr(), ties.data_ptr(), c, d, neg_k)
    if not torch.cuda.is_current_stream_capturing():
        EVAL_RANK_LAUNCHES.bump()
    return rank, ties
