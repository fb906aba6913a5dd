"""The one generator of request traffic: an open-loop arrival schedule
from a cell's parameters and the run seed.

  rate_per_s   offered load (requests a second)
  arrivals     "poisson": exponential gaps (the one kind so far)
  k            items asked for
The gaps of a window are one fixed multiset for every run seed (drawn from
a stream of their own), put in an order drawn from the run seed, so every
seed offers the same number of requests over the same span. Each
request's history is the train items of a user drawn uniformly, from the
run seed, among the users that have any."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

GAP_SEED = 0x5EED


def schedule(params: dict, seed: int, seconds: float, histories: List[np.ndarray]
             ) -> List[Tuple[float, List[int], int]]:
    """[(offset_s, history, k)] in order of offset."""
    rate = float(params["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    if params["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {params['arrivals']!r}")
    gaps = np.random.default_rng(GAP_SEED).exponential(1.0 / rate, n)
    rng = np.random.default_rng(seed)
    offsets = np.cumsum(gaps[rng.permutation(n)])
    users = rng.integers(0, len(histories), n)
    k = int(params["k"])
    return [(float(t), histories[u].tolist(), k) for t, u in zip(offsets, users)]
