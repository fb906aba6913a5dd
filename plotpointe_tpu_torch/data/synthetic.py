"""Synthetic Amazon-Electronics-shaped dataset generator, numpy only.

Counterpart of `plotpointe_tpu/data/synthetic.py` (`synthetic_interactions`,
`amazon_calibrated_interactions`, `synthetic_catalog`, `synthetic_features`).
Tables are dicts of numpy column arrays instead of DataFrames: for the same
arguments the rows, columns and values are the JAX package's bits, because
every `rng` draw is taken in its order and the DataFrame steps are replaced
by numpy steps of the same result (`drop_duplicates` keeping the first row
of each (user_id, asin, ts), `pd.unique` by `first_occurrence_unique`).

The shape of the data: power-law user/item degrees (reference: user mean
7.07 sigma 6.97, item mean 21.6 sigma 65.3), ratings in [1, 5], unix
timestamps, and a latent-factor structure so that recommenders have signal
to learn (random data would give NDCG ~= K/N).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from plotpointe_tpu_torch.data.splits import first_of_each_key, first_occurrence_unique


def synthetic_interactions(
    n_users: int = 2000,
    n_items: int = 1200,
    n_interactions: int = 50_000,
    n_factors: int = 8,
    seed: int = 0,
    concentration: float = 1.2,
    return_factors: bool = False,
    affinity_strength: float = 3.0,
    user_sigma: Optional[float] = None,
    item_sigma: Optional[float] = None,
    rating_marginal: str = "affinity",  # {affinity, amazon}
    ts_mode: str = "uniform",  # {uniform, recency}
    n_clusters: int = 0,
    item_cluster_sigma: float = 0.35,
    user_cluster_sigma: float = 0.6,
    candidate_pool: int = 16,
    cluster_pool_bias: float = 0.0,
):
    """Interactions table {user_id, asin, rating, ts, verified, helpful}
    (and `(u_fac, i_fac)` with `return_factors`).

    Users and items get latent factors; each interaction picks the argmax of
    affinity * `affinity_strength` plus Gumbel noise over a pool of
    `candidate_pool` items drawn by popularity. Degrees follow lognormal
    activity/popularity weights (`user_sigma` / `item_sigma`).
    `n_clusters > 0` puts the factors near heavy-tailed cluster centroids,
    and `cluster_pool_bias` draws that share of each pool from the user's
    own cluster. `rating_marginal="amazon"` draws 5-star-skewed ratings,
    `ts_mode="recency"` end-of-span-biased timestamps."""
    rng = np.random.default_rng(seed)

    if n_clusters > 0:
        centroids = rng.normal(size=(n_clusters, n_factors)).astype(np.float32)
        centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
        cluster_p = rng.lognormal(mean=0.0, sigma=1.0, size=n_clusters)
        cluster_p /= cluster_p.sum()
        item_cluster = rng.choice(n_clusters, size=n_items, p=cluster_p)
        user_cluster = rng.choice(n_clusters, size=n_users, p=cluster_p)
        i_fac = centroids[item_cluster] + item_cluster_sigma * rng.normal(
            size=(n_items, n_factors)).astype(np.float32)
        u_fac = centroids[user_cluster] + user_cluster_sigma * rng.normal(
            size=(n_users, n_factors)).astype(np.float32)
    else:
        u_fac = rng.normal(size=(n_users, n_factors)).astype(np.float32)
        i_fac = rng.normal(size=(n_items, n_factors)).astype(np.float32)
    u_fac /= np.linalg.norm(u_fac, axis=1, keepdims=True)
    i_fac /= np.linalg.norm(i_fac, axis=1, keepdims=True)

    activity = rng.lognormal(mean=0.0, sigma=user_sigma or 0.9 * concentration / 1.2, size=n_users)
    activity = activity / activity.sum()
    users = rng.choice(n_users, size=n_interactions, p=activity)

    popularity = rng.lognormal(mean=0.0, sigma=item_sigma or 1.35 * concentration / 1.2, size=n_items)
    popularity = popularity / popularity.sum()

    C = candidate_pool
    cand = rng.choice(n_items, size=(n_interactions, C), p=popularity)
    if n_clusters > 0 and cluster_pool_bias > 0.0:
        uc = user_cluster[users]
        in_cluster = rng.random((n_interactions, C)) < cluster_pool_bias
        for k in range(n_clusters):
            items_k = np.flatnonzero(item_cluster == k)
            if items_k.size == 0:
                continue
            rows = np.flatnonzero(uc == k)
            if rows.size == 0:
                continue
            p_k = popularity[items_k] / popularity[items_k].sum()
            mask_k = in_cluster[rows]
            draws = rng.choice(items_k, size=int(mask_k.sum()), p=p_k)
            block = cand[rows]
            block[mask_k] = draws
            cand[rows] = block
    aff = np.einsum("nf,ncf->nc", u_fac[users], i_fac[cand]).astype(np.float32)
    gumbel = rng.gumbel(size=(n_interactions, C)).astype(np.float32)
    pick = np.argmax(aff * affinity_strength + gumbel, axis=1)
    items = cand[np.arange(n_interactions), pick]

    a = np.einsum("nf,nf->n", u_fac[users], i_fac[items])
    if rating_marginal == "amazon":
        base = rng.choice([5.0, 4.0, 3.0, 2.0, 1.0], size=n_interactions,
                          p=[0.59, 0.18, 0.09, 0.05, 0.09])
        rating = np.clip(np.round(base + 1.2 * a + rng.normal(scale=0.4, size=n_interactions)), 1, 5)
    else:
        rating = np.clip(np.round(3.0 + 2.0 * a + rng.normal(scale=0.7, size=n_interactions)), 1, 5)

    if ts_mode == "recency":
        span = 1_500_000_000 - 1_060_000_000  # ~2003-2017
        back = rng.exponential(scale=span / 4.0, size=n_interactions)
        ts = (1_500_000_000 - np.minimum(back, span)).astype(np.int64)
    else:
        ts = rng.integers(1_100_000_000, 1_500_000_000, size=n_interactions)
    ts = ts.astype(np.int64)
    # drawn after ts, in this order, as the JAX package's DataFrame columns are
    verified = rng.random(n_interactions) < 0.8
    helpful = rng.integers(0, 10, size=n_interactions).astype(np.int64)

    # (user, asin, ts) is unique: keep each key's first row, in row order.
    # The id strings are injective in the integer ids, so the integers decide.
    keep = first_of_each_key(users, items, ts)
    users, items = users[keep], items[keep]
    table = {
        "user_id": np.array([f"U{u:07d}" for u in users]),
        "asin": np.array([f"B{i:09d}" for i in items]),
        "rating": rating[keep].astype(np.float64),
        "ts": ts[keep],
        "verified": verified[keep],
        "helpful": helpful[keep],
    }
    if return_factors:
        return table, (u_fac, i_fac)
    return table


def amazon_calibrated_interactions(
    n_users: int = 192_403,
    n_items: int = 63_001,
    n_interactions: int = 1_689_116,
    n_factors: int = 16,
    seed: int = 0,
    affinity_strength: float = 3.0,
    return_factors: bool = False,
    n_clusters: int = 0,
    candidate_pool: int = 16,
    item_cluster_sigma: float = 0.35,
    user_cluster_sigma: float = 0.6,
    cluster_pool_bias: float = 0.0,
):
    """The full Amazon-Electronics shape (192,403 users x 63,001 items x
    1,689,116 interactions) with lognormal degree sigmas 0.83 / 1.52 (user
    deg 7.07 +- 6.97, item deg 21.60 +- 65.34 over deduplicated pairs), the
    Amazon rating skew and recency-biased timestamps.
    `affinity_strength` 0 gives a pure-popularity dataset."""
    return synthetic_interactions(
        n_users=n_users,
        n_items=n_items,
        n_interactions=n_interactions,
        n_factors=n_factors,
        seed=seed,
        return_factors=return_factors,
        affinity_strength=affinity_strength,
        user_sigma=0.83,
        item_sigma=1.52,
        rating_marginal="amazon",
        ts_mode="recency",
        n_clusters=n_clusters,
        candidate_pool=candidate_pool,
        item_cluster_sigma=item_cluster_sigma,
        user_cluster_sigma=user_cluster_sigma,
        cluster_pool_bias=cluster_pool_bias,
    )


def synthetic_catalog(interactions, n_extra_items: int = 0, seed: int = 0,
                      item_factors: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Items table {asin, title, brand, price, categories, image_url} over
    the interacted asins (first-occurrence order) plus `n_extra_items` cold
    items. With `item_factors`, titles, brands and categories name each
    item's two dominant factors (asin B{idx:09d} is factor row idx).
    `categories` and `image_url` are object arrays (lists; str or None)."""
    rng = np.random.default_rng(seed + 1)
    asins = first_occurrence_unique(np.asarray(interactions["asin"])).tolist()
    asins += [f"B9{i:08d}" for i in range(n_extra_items)]
    n = len(asins)
    has_img = rng.random(n) < 0.3

    titles, brands, cats = [], [], []
    for a in asins:
        fac_row = None
        if item_factors is not None and a.startswith("B") and not a.startswith("B9"):
            idx = int(a[1:])
            if idx < len(item_factors):
                fac_row = item_factors[idx]
        if fac_row is not None:
            order = np.argsort(-np.abs(fac_row))
            c1, c2 = int(order[0]), int(order[1])
            s1 = "pos" if fac_row[c1] > 0 else "neg"
            s2 = "pos" if fac_row[c2] > 0 else "neg"
            titles.append(f"{s1}axis{c1} {s2}axis{c2} device model {a[-4:]}")
            brands.append(f"Brand{c1}{s1}")
            cats.append(["Electronics", f"Cat{c1}{s1}", f"Sub{c2}{s2}"])
        else:
            titles.append(f"Synthetic item {a}")
            brands.append(f"Brand{rng.integers(0, 50)}")
            cats.append(["Electronics", f"Sub{rng.integers(0, 20)}"])

    categories = np.empty(n, dtype=object)
    categories[:] = cats
    return {
        "asin": np.array(asins, dtype=object),
        "title": np.array(titles, dtype=object),
        "brand": np.array(brands, dtype=object),
        "price": np.round(rng.gamma(2.0, 30.0, size=n), 2),
        "categories": categories,
        "image_url": np.array([f"http://img.example/{a}.jpg" if h else None
                               for a, h in zip(asins, has_img)], dtype=object),
    }


def synthetic_features(n_items: int, dim: int, seed: int = 0, factors: Optional[np.ndarray] = None,
                       noise: float = 0.3) -> np.ndarray:
    """L2-normalised item features [n_items, dim] f32. With `factors`, the
    features carry the latent structure (factors @ a random projection plus
    `noise` times a random matrix)."""
    rng = np.random.default_rng(seed + 2)
    feats = rng.normal(size=(n_items, dim)).astype(np.float32)
    if factors is not None:
        k = factors.shape[1]
        proj = rng.normal(size=(k, dim)).astype(np.float32)
        feats = feats * noise + factors[:n_items] @ proj
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-8
    return feats.astype(np.float32)
