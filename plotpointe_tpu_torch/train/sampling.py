"""Exact negative sampling on the device, no rejection loops.

Counterpart of `plotpointe_tpu/train/sampling.py`, with the same
distributions:
  u ~ Uniform(train users)  (not degree-proportional)
  i ~ Uniform(positives of u)
  j ~ Uniform(items minus positives(u))
and for evaluation, i.i.d. negatives ~ Uniform(items minus (positives(u) and
the eval positive)).

A rank r ~ Uniform[0, n_items - |avoid|) maps to the r-th smallest item not
in the sorted avoid row. The JAX package walks the row (`j += (a_k <= j)`,
P steps); here one batched `torch.searchsorted` gives the same answer: the
walk stops at the first k with a_k - k > r, so j = r + (number of leading
k with cummax(a - k)_k <= r). The running max keys the padding entries
(n_items, repeated) past every rank they cannot reach, and keeps the answer
exact even where the walk runs into them.

The draws come from a `torch.Generator`, so they are not the JAX package's
draws; the tests compare distributions, and the rank-to-item map exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch


def uniform_ranks(generator: torch.Generator, shape, bound: torch.Tensor) -> torch.Tensor:
    """r ~ Uniform[0, bound) per element, int32 (bound <= 0 clamps to rank 0)."""
    bound = torch.clamp(bound.to(torch.int32), min=1)
    u = torch.rand(shape, generator=generator, device=bound.device, dtype=torch.float32)
    r = torch.floor(u * bound.to(torch.float32)).to(torch.int32)
    return torch.minimum(r, bound - 1)


def rank_to_item(r: torch.Tensor, sorted_avoid: torch.Tensor) -> torch.Tensor:
    """Map ranks over the complement to item ids, exactly as the JAX
    package's `_rank_to_item`. r: [S] with sorted_avoid [S, A], or [C, K]
    with sorted_avoid [C, A]; rows ascending, padded with n_items."""
    a = sorted_avoid.to(torch.int32)
    keys = torch.cummax(a - torch.arange(a.shape[-1], device=a.device, dtype=torch.int32), dim=-1)[0]
    vals = r.to(torch.int32)
    flat = vals.dim() == a.dim() - 1
    if flat:
        vals = vals[..., None]
    j = vals + torch.searchsorted(keys, vals, right=True).to(torch.int32)
    return j[..., 0] if flat else j


def sample_bpr_triples(generator: torch.Generator, train_users: torch.Tensor,
                       user_pos_padded: torch.Tensor, user_deg: torch.Tensor, n_items: int,
                       n_samples: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, i, j) int32 [n_samples] on the tables' device. train_users: users
    with >= 1 train positive; user_pos_padded [n_users, P] sorted, pad =
    n_items; user_deg [n_users] unique-positive counts."""
    dev = train_users.device
    sel = torch.randint(0, train_users.shape[0], (n_samples,), generator=generator, device=dev)
    u = train_users[sel]
    deg_u = user_deg[u]
    pos_table = user_pos_padded[u]  # [S, P] sorted
    slot = uniform_ranks(generator, (n_samples,), deg_u)
    i = torch.gather(pos_table, 1, slot[:, None].long())[:, 0]
    r = uniform_ranks(generator, (n_samples,), n_items - deg_u)
    j = rank_to_item(r, pos_table)
    return u.to(torch.int32), i.to(torch.int32), j.to(torch.int32)


def sample_eval_negatives(generator: torch.Generator, eval_users: torch.Tensor,
                          eval_pos: torch.Tensor, user_pos_padded: torch.Tensor,
                          user_deg: torch.Tensor, n_items: int, neg_k: int) -> torch.Tensor:
    """[C, neg_k] int32 i.i.d. negatives avoiding each user's train positives
    and its eval positive."""
    c = eval_users.shape[0]
    pos_table = user_pos_padded[eval_users]  # [C, P]
    deg = user_deg[eval_users]
    # merge the eval positive into the sorted avoid row (as a pad if already there)
    in_table = torch.any(pos_table == eval_pos[:, None], dim=1)
    extra = torch.where(in_table, torch.full_like(eval_pos, n_items), eval_pos).to(pos_table.dtype)
    avoid = torch.sort(torch.cat([pos_table, extra[:, None]], dim=1), dim=1)[0]  # [C, P + 1]
    avoid_count = deg + (~in_table).to(deg.dtype)
    bound = (n_items - avoid_count)[:, None].expand(c, neg_k)
    return rank_to_item(uniform_ranks(generator, (c, neg_k), bound), avoid)
