"""Chronological leave-last-2 splits and node index maps, numpy only.

Counterpart of `plotpointe_tpu/data/splits.py` (`build_node_maps`,
`node_maps_json`, `build_splits`, `padded_positives`). The interactions may
be a pandas DataFrame or a plain dict of numpy arrays with `user_id`, `asin`,
`ts` and optional `rating` columns; nothing here needs pandas.

Split semantics, per user sorted by ts: >=3 interactions -> train=[:-2],
val=[-2], test=[-1]; ==2 -> train=[:-1], test=[-1]; <2 -> dropped.
Node maps use first-occurrence order of the ids over the table.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class Splits:
    n_users: int
    n_items: int
    train_u: np.ndarray  # int32 [T]
    train_i: np.ndarray  # int32 [T]
    train_w: np.ndarray  # float32 [T] edge weight (rating-1)/4
    val_u: np.ndarray  # int32 [Nv]
    val_i: np.ndarray  # int32 [Nv]
    test_u: np.ndarray  # int32 [Nt]
    test_i: np.ndarray  # int32 [Nt]

    @property
    def n_train(self) -> int:
        return int(self.train_u.shape[0])


def _column(interactions, name: str) -> np.ndarray:
    return np.asarray(interactions[name])


def _has_column(interactions, name: str) -> bool:
    cols = getattr(interactions, "columns", None)
    return name in (cols if cols is not None else interactions)


def first_occurrence_unique(values: np.ndarray) -> np.ndarray:
    """Unique values in order of first appearance (what `pd.unique` returns)."""
    uniq, first = np.unique(values, return_index=True)
    return uniq[np.argsort(first, kind="stable")]


def build_node_maps(interactions) -> Tuple[Dict, Dict]:
    """First-occurrence-order id maps {id: index} for users and items."""
    users = first_occurrence_unique(_column(interactions, "user_id")).tolist()
    items = first_occurrence_unique(_column(interactions, "asin")).tolist()
    return {u: i for i, u in enumerate(users)}, {a: i for i, a in enumerate(items)}


def node_maps_json(user_to_idx: Dict, item_to_idx: Dict) -> Dict:
    """The node_maps.json contract: both maps, their inverses and sizes."""
    return {
        "user_to_idx": user_to_idx,
        "item_to_idx": item_to_idx,
        "idx_to_user": {idx: uid for uid, idx in user_to_idx.items()},
        "idx_to_item": {idx: iid for iid, idx in item_to_idx.items()},
        "n_users": len(user_to_idx),
        "n_items": len(item_to_idx),
    }


def lookup_ids(values: np.ndarray, mapping: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised `mapping.get(v)` for every v: (index, found) arrays; the
    index is meaningless where `found` is False."""
    values = np.asarray(values)
    keys = np.asarray(list(mapping.keys()))
    idx = np.asarray(list(mapping.values()), dtype=np.int64)
    if len(keys) == 0:
        return np.zeros(len(values), np.int64), np.zeros(len(values), bool)
    order = np.argsort(keys, kind="stable")
    keys, idx = keys[order], idx[order]
    pos = np.clip(np.searchsorted(keys, values), 0, len(keys) - 1)
    return idx[pos], keys[pos] == values


def _map_ids(values: np.ndarray, mapping: Dict) -> np.ndarray:
    """Vectorised `mapping[v]` for every v; raises KeyError on an unknown id."""
    idx, hit = lookup_ids(values, mapping)
    if not np.all(hit):
        raise KeyError(f"id not in node map: {np.asarray(values)[~hit][0]!r}")
    return idx


def build_splits(interactions, user_to_idx: Dict, item_to_idx: Dict) -> Splits:
    """Vectorised leave-last-2 chronological split in index space."""
    u = _map_ids(_column(interactions, "user_id"), user_to_idx)
    i = _map_ids(_column(interactions, "asin"), item_to_idx)
    ts = _column(interactions, "ts")
    if _has_column(interactions, "rating"):
        w = (_column(interactions, "rating").astype(np.float32) - 1.0) / 4.0
    else:
        w = np.ones(len(u), dtype=np.float32)

    # stable sort by (user, ts): ties keep input order
    order = np.lexsort((ts, u))
    u, i, w = u[order], i[order], w[order]

    boundary = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
    counts = np.diff(np.r_[boundary, len(u)])
    pos = np.arange(len(u)) - np.repeat(boundary, counts)
    cnt = np.repeat(counts, counts)

    keep = cnt >= 2
    is_test = keep & (pos == cnt - 1)
    is_val = (cnt >= 3) & (pos == cnt - 2)
    is_train = keep & ~is_test & ~is_val

    return Splits(
        n_users=len(user_to_idx),
        n_items=len(item_to_idx),
        train_u=u[is_train].astype(np.int32),
        train_i=i[is_train].astype(np.int32),
        train_w=w[is_train].astype(np.float32),
        val_u=u[is_val].astype(np.int32),
        val_i=i[is_val].astype(np.int32),
        test_u=u[is_test].astype(np.int32),
        test_i=i[is_test].astype(np.int32),
    )


def padded_positives(splits: Splits, max_degree: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-user sorted, deduplicated train positives [n_users, P], padded with
    n_items, and each user's count of unique positives (capped at P).

    The exact negative samplers (`train/sampling.py`) map a uniform rank over
    the complement of a row to an item id. If `max_degree` truncates a row,
    only that user's truncated tail loses exactness."""
    n_users, n_items = splits.n_users, splits.n_items
    if len(splits.train_u) == 0:
        p = int(max_degree or 1)
        return np.full((n_users, p), n_items, dtype=np.int32), np.zeros(n_users, np.int32)

    pairs = np.unique(np.stack([splits.train_u, splits.train_i], axis=1), axis=0)  # sorted (u, i)
    su, si = pairs[:, 0], pairs[:, 1]
    deg = np.bincount(su, minlength=n_users).astype(np.int32)
    p = int(max_degree or deg.max() or 1)

    boundary = np.flatnonzero(np.r_[True, su[1:] != su[:-1]])
    counts = np.diff(np.r_[boundary, len(su)])
    pos_in_user = np.arange(len(su)) - np.repeat(boundary, counts)

    table = np.full((n_users, p), n_items, dtype=np.int32)
    keep = pos_in_user < p
    table[su[keep], pos_in_user[keep]] = si[keep]
    return table, np.minimum(deg, p).astype(np.int32)
