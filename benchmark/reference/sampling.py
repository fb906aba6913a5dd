"""The trainer's stated draws, worked out again from the seed.

Every use of the trainer's generator is seeded by `stream_seed(seed,
stream, index)` (streams 0 init, 1 an epoch's steps, 2 an eval; the test
eval's index is 10,000), and each draw is a uniform rank r in [0, bound)
taken as floor(u * bound) of a uniform f32 u, clamped to bound - 1. A rank
over the complement of a user's sorted avoid row is mapped to the r-th item
outside the row, here by the fixed point j = r + #{a in row : a <= j}.

  GAT step   u ~ Uniform(users with a train item), i ~ Uniform(u's
             positives), j ~ Uniform(items outside u's positives); then one
             uint32 dropout seed per layer.
  LightGCN   an epoch's permutation of the train rows; per step b rows and
             npp negatives per row outside the user's positives.
  eval       per chunk of users, neg_k negatives outside the user's
             positives and the eval positive."""
from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
STREAM_INIT, STREAM_TRAIN, STREAM_EVAL = 0, 1, 2
TEST_EVAL_INDEX = 10_000


def stream_seed(seed: int, stream: int, index: int) -> int:
    x = (seed * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9
         + (index + 1) * 0x94D049BB133111EB) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) >> 1


def reseed(gen: torch.Generator, seed: int, stream: int, index: int) -> torch.Generator:
    return gen.manual_seed(stream_seed(seed, stream, index))


def ranks(gen: torch.Generator, shape, bound: torch.Tensor) -> torch.Tensor:
    bound = torch.clamp(bound.to(torch.int32), min=1)
    u = torch.rand(shape, generator=gen, device=bound.device, dtype=torch.float32)
    r = torch.floor(u * bound.to(torch.float32)).to(torch.int32)
    return torch.minimum(r, bound - 1).to(torch.int64)


def nth_outside(r: torch.Tensor, avoid: torch.Tensor) -> torch.Tensor:
    """The r-th (0-based) item not in the sorted row `avoid` (padded with
    values above every answer). r [..., K] against avoid [..., A]."""
    avoid = avoid.contiguous()
    j = r.clone()
    while True:
        nxt = r + torch.searchsorted(avoid, j, right=True)
        if torch.equal(nxt, j):
            return j
        j = nxt


def bpr_triples(gen, train_users, table, deg, n_items: int, n: int):
    sel = torch.randint(0, train_users.shape[0], (n,), generator=gen, device=train_users.device)
    u = train_users[sel]
    du = deg[u]
    i = table[u, ranks(gen, (n,), du)]
    j = nth_outside(ranks(gen, (n,), n_items - du)[:, None], table[u])[:, 0]
    return u, i, j


def layer_seeds(gen, layers: int, device) -> list:
    return torch.randint(0, 1 << 32, (layers,), generator=gen, device=device,
                         dtype=torch.int64).tolist()


def lightgcn_batch(gen, perm, step: int, train_u, train_i, table, deg, n_items: int,
                   bs: int, npp: int):
    idx = perm[step * bs:(step + 1) * bs]
    u, i = train_u[idx], train_i[idx]
    bound = (n_items - deg[u])[:, None].expand(bs, npp)
    return u, i, nth_outside(ranks(gen, (bs, npp), bound), table[u])


def eval_negatives(gen, users, pos, table, deg, n_items: int, neg_k: int):
    rows = table[users]
    listed = (rows == pos[:, None]).any(1)
    extra = torch.where(listed, torch.full_like(pos, n_items), pos)
    avoid = torch.sort(torch.cat([rows, extra[:, None]], 1), 1)[0]
    bound = (n_items - (deg[users] + (~listed).long()))[:, None].expand(users.shape[0], neg_k)
    return nth_outside(ranks(gen, (users.shape[0], neg_k), bound), avoid)
