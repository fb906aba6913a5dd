"""The seeded inputs every cell hands to the program and to the reference.

`amazon_shaped_interactions` is a frozen copy of the port's smoke-script
generator: lognormal user and item degree weights, every user and item in
at least one row. Item features and the served table are unit rows drawn
on the device from a `torch.Generator`, in a few large calls.

Each use of `--seed` takes its own derived seed (`derive`), so the
interactions, the features, the trainer's seed and the traffic are
independent streams of one run seed."""
from __future__ import annotations

import numpy as np
import torch

_M64 = (1 << 64) - 1
STREAMS = {"interactions": 1, "features": 2, "train": 3, "table": 4, "traffic": 5, "sample": 6}


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of the run seed (splitmix64)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (STREAMS[stream] + 1) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) >> 1


def amazon_shaped_interactions(seed: int, n_users: int, n_items: int, n: int) -> dict:
    """Interactions as column arrays: lognormal user/item degree weights, and
    every user and item in at least one row (the reference's counts are of
    users and items that interacted)."""
    rng = np.random.default_rng(seed)
    wu = rng.lognormal(0.0, 0.83, n_users)
    wi = rng.lognormal(0.0, 1.52, n_items)
    inter = {
        "user_id": rng.choice(n_users, n, p=wu / wu.sum()).astype(np.int64),
        "asin": rng.choice(n_items, n, p=wi / wi.sum()).astype(np.int64),
        "ts": rng.integers(1_100_000_000, 1_500_000_000, n),
        "rating": rng.integers(1, 6, n).astype(np.float64),
    }
    inter["user_id"][:n_users] = rng.permutation(n_users)
    inter["asin"][:n_items] = rng.permutation(n_items)
    return inter


def interactions_of(config: dict, seed: int) -> dict:
    d = config["dataset"]
    return amazon_shaped_interactions(derive(seed, "interactions"), d["n_users"], d["n_items"],
                                      d["n_interactions"])


def unit_rows(seed: int, n: int, d: int, device) -> torch.Tensor:
    """[n, d] f32 rows of unit L2 norm, drawn on `device` from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
