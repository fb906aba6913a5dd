"""Data staging: SNAP "loose JSON" dumps (.json or .json.gz) ->
interactions / items / rejects parquet.

Counterpart of `plotpointe_tpu/data/stage.py` (`parse_loose_json_gz`,
`to_interactions_df`, `to_items_df`, `apply_contract`, `stage`): the same
frames, contract filters and artifacts. Frames and parquet need pandas and
pyarrow, as in the JAX package, so staging runs on a host that has them.

Contract filters, in this order (a row is rejected for the first it fails):
  - non-null user_id / asin / ts                     -> "null_key"
  - rating in [1, 5]                                 -> "rating_bounds"
  - ts within [TS_LO, TS_HI]                         -> "ts_bounds"
  - asin present in the items table (foreign key)    -> "fk_asin"
Rejected rows go to the rejects parquet with a `reject_reason` column.
"""
from __future__ import annotations

import ast
import gzip
import itertools
import json
from pathlib import Path
from typing import Iterator, Optional, Tuple

from plotpointe_tpu_torch.utils.artifacts import ArtifactStore, require_pandas

TS_LO = 800_000_000  # ~1995
TS_HI = 2_000_000_000  # ~2033


def parse_loose_json_gz(path: str | Path) -> Iterator[dict]:
    """Records of a SNAP-style dump, one per line: JSON, or a python dict
    literal; lines that are neither are skipped. Gzip when the name ends
    in .gz."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                try:
                    yield ast.literal_eval(line)
                except (ValueError, SyntaxError):
                    continue


def to_interactions_df(records):
    """Review records -> DataFrame {user_id, asin, rating, ts, verified, helpful}."""
    pd = require_pandas()
    rows = []
    for r in records:
        helpful = r.get("helpful", [0, 0])
        rows.append(
            {
                "user_id": r.get("reviewerID"),
                "asin": r.get("asin"),
                "rating": r.get("overall"),
                "ts": r.get("unixReviewTime"),
                "verified": bool(r.get("verified", False)),
                "helpful": int(helpful[0]) if isinstance(helpful, (list, tuple)) else int(helpful or 0),
            }
        )
    return pd.DataFrame(rows)


def to_items_df(records):
    """Metadata records -> DataFrame {asin, title, brand, price, categories,
    image_url}; nested category lists keep their first list."""
    pd = require_pandas()
    rows = []
    for r in records:
        imurl = r.get("imUrl") or r.get("image_url")
        cats = r.get("categories") or []
        if cats and isinstance(cats[0], list):
            cats = cats[0]
        rows.append(
            {
                "asin": r.get("asin"),
                "title": r.get("title"),
                "brand": r.get("brand"),
                "price": r.get("price"),
                "categories": cats,
                "image_url": imurl,
            }
        )
    return pd.DataFrame(rows)


def apply_contract(interactions, items) -> Tuple[object, object, object]:
    """(clean interactions, items with non-null unique asins, rejects)."""
    pd = require_pandas()
    df = interactions.copy()
    reason = pd.Series("", index=df.index)

    null_mask = df[["user_id", "asin", "ts"]].isna().any(axis=1)
    reason[null_mask] = "null_key"
    rating_mask = ~null_mask & (~df["rating"].between(1, 5) | df["rating"].isna())
    reason[rating_mask] = "rating_bounds"
    ts_mask = ~null_mask & ~rating_mask & ~df["ts"].between(TS_LO, TS_HI)
    reason[ts_mask] = "ts_bounds"
    fk_mask = (
        ~null_mask & ~rating_mask & ~ts_mask & ~df["asin"].isin(set(items["asin"].dropna()))
    )
    reason[fk_mask] = "fk_asin"

    bad = reason != ""
    rejects = df[bad].assign(reject_reason=reason[bad])
    clean = df[~bad].reset_index(drop=True)

    items_clean = items[items["asin"].notna()].drop_duplicates("asin").reset_index(drop=True)
    return clean, items_clean, rejects


def stage(reviews_path: str | Path, meta_path: str | Path, out_prefix: str, store=None,
          max_records: Optional[int] = None):
    """Parse both dumps (the first `max_records` of each), apply the
    contract and write `{out_prefix}/interactions.parquet`, `items.parquet`
    and `rejects.parquet`. Returns (uris, counts)."""
    store = store or ArtifactStore()
    rev = parse_loose_json_gz(reviews_path)
    met = parse_loose_json_gz(meta_path)
    if max_records:
        rev = itertools.islice(rev, max_records)
        met = itertools.islice(met, max_records)
    interactions, items, rejects = apply_contract(to_interactions_df(rev), to_items_df(met))

    uris = {
        "interactions": f"{out_prefix}/interactions.parquet",
        "items": f"{out_prefix}/items.parquet",
        "rejects": f"{out_prefix}/rejects.parquet",
    }
    store.save_parquet(interactions, uris["interactions"])
    store.save_parquet(items, uris["items"])
    store.save_parquet(rejects, uris["rejects"])
    return uris, {"n_interactions": len(interactions), "n_items": len(items), "n_rejects": len(rejects)}
