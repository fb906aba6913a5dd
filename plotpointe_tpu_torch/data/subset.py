"""The interacted subset: slice full-catalog features to interacted items.

Counterpart of `plotpointe_tpu/data/subset.py`, numpy only. Given the full
catalog matrix (rows aligned to the items table) and the interactions, emit
`{name}_interacted.npy`, whose rows follow the node-map (first-occurrence)
item order that training uses, and `interacted_items.json` (the ordered asin
list). The items and interactions may be pandas DataFrames or dicts of
column arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from plotpointe_tpu_torch.data.splits import _column, build_node_maps, lookup_ids
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore


def build_interacted_subset(
    full_matrix: np.ndarray,
    items,  # the items table; its row order defines full_matrix's rows
    interactions,
    out_prefix: Optional[str] = None,
    feature_name: str = "txt",
    store=None,
) -> Tuple[np.ndarray, list]:
    """Returns (subset matrix [n_interacted, d], ordered asin list)."""
    catalog = _column(items, "asin")
    if len(catalog) != full_matrix.shape[0]:
        raise ValueError(
            f"full matrix rows ({full_matrix.shape[0]}) must align to items.parquet ({len(catalog)})"
        )
    _, item_to_idx = build_node_maps(interactions)
    asin_order = list(item_to_idx)  # insertion order is index order
    # the last catalog row of an asin wins, as a dict built over the rows does
    catalog_row = {a: r for r, a in enumerate(catalog.tolist())}
    rows, found = lookup_ids(np.asarray(asin_order), catalog_row)
    if not found.all():
        missing = [a for a, f in zip(asin_order, found) if not f]
        raise KeyError(f"{len(missing)} interacted asins missing from catalog (first: {missing[:3]})")
    subset = np.ascontiguousarray(full_matrix[rows])

    if out_prefix is not None:
        store = store or ArtifactStore()
        store.save_npy(subset, f"{out_prefix}/{feature_name}_interacted.npy")
        store.save_json(asin_order, f"{out_prefix}/interacted_items.json")
    return subset, asin_order
