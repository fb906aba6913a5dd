"""Dataset contract checks with a machine-readable report.

Counterpart of `plotpointe_tpu/data/validate.py` (`validate_interactions`,
`validate_items`, `validate`; the same checks, names, details and order).
Tables are pandas DataFrames or dicts of numpy column arrays; the checks
are numpy. Interactions: non-null keys, rating in [1, 5], ts within
[TS_LO, TS_HI], (user, asin, ts) unique, every asin in the items table;
items: non-null asin, unique asin, price >= 0 where present.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from plotpointe_tpu_torch.data.splits import first_of_each_key
from plotpointe_tpu_torch.data.stage import TS_HI, TS_LO


@dataclass
class CheckResult:
    name: str
    passed: bool
    detail: str = ""


@dataclass
class ValidationReport:
    checks: List[CheckResult] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks)

    def add(self, name: str, passed: bool, detail: str = "") -> None:
        self.checks.append(CheckResult(name, bool(passed), detail))

    def to_dict(self) -> Dict:
        return {
            "passed": self.passed,
            "checks": [{"name": c.name, "passed": c.passed, "detail": c.detail} for c in self.checks],
        }


def _column(table, name: str) -> np.ndarray:
    return np.asarray(table[name])


def _has_column(table, name: str) -> bool:
    cols = getattr(table, "columns", None)
    return name in (cols if cols is not None else table)


def _isnull(col: np.ndarray) -> np.ndarray:
    """pandas' `isna`: NaN in float columns, None or NaN in object columns."""
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.fromiter((v is None or (isinstance(v, float) and v != v) for v in col.tolist()),
                           bool, len(col))
    return np.zeros(len(col), bool)


def _between(col: np.ndarray, lo, hi) -> np.ndarray:
    """pandas' `between` (inclusive; null is outside)."""
    x = np.asarray(col, dtype=np.float64) if col.dtype.kind == "O" else col
    with np.errstate(invalid="ignore"):
        return ~_isnull(col) & (x >= lo) & (x <= hi)


def _codes(col: np.ndarray) -> np.ndarray:
    """One int64 code per value, every null one code: keys that sort."""
    if col.dtype.kind != "O":  # NaN is one value to np.unique
        return np.unique(col, return_inverse=True)[1].reshape(-1)
    null, seen = _isnull(col), {}
    return np.fromiter((seen.setdefault(None if n else v, len(seen))
                        for v, n in zip(col.tolist(), null.tolist())), np.int64, len(col))


def _n_duplicated(*cols: np.ndarray) -> int:
    """pandas' `duplicated(...).sum()`: rows whose key appears on an earlier row."""
    return int(len(cols[0]) - first_of_each_key(*(_codes(c) for c in cols)).sum())


def validate_interactions(df, items=None) -> ValidationReport:
    rep = ValidationReport()
    u, a, ts = (_column(df, k) for k in ("user_id", "asin", "ts"))
    nn = ~(_isnull(u) | _isnull(a) | _isnull(ts))
    rep.add("non_null_keys", nn.all(), f"{(~nn).sum()} rows with null keys")
    rb = _between(_column(df, "rating"), 1, 5)
    rep.add("rating_bounds", rb.all(), f"{(~rb).sum()} ratings outside [1,5]")
    tb = _between(ts, TS_LO, TS_HI)
    rep.add("ts_bounds", tb.all(), f"{(~tb).sum()} timestamps out of bounds")
    dup = _n_duplicated(u, a, ts)
    rep.add("uniqueness_user_asin_ts", dup == 0, f"{dup} duplicate (user, asin, ts) rows")
    if items is not None:
        ia = _column(items, "asin")
        known = set(ia[~_isnull(ia)].tolist())
        fk = np.fromiter((v in known for v in a.tolist()), bool, len(a))
        rep.add("fk_asin_in_items", fk.all(), f"{(~fk).sum()} interactions with unknown asin")
    return rep


def validate_items(df) -> ValidationReport:
    rep = ValidationReport()
    a = _column(df, "asin")
    nn = ~_isnull(a)
    rep.add("non_null_asin", nn.all(), f"{(~nn).sum()} null asins")
    dup = _n_duplicated(a)
    rep.add("unique_asin", dup == 0, f"{dup} duplicate asins")
    if _has_column(df, "price"):
        price = _column(df, "price")
        pr = np.asarray(price[~_isnull(price)], dtype=np.float64)
        ok = (pr >= 0).all() if len(pr) else True
        rep.add("price_non_negative", ok, f"{(pr < 0).sum() if len(pr) else 0} negative prices")
    return rep


def validate(interactions, items) -> ValidationReport:
    rep = ValidationReport()
    rep.checks.extend(validate_interactions(interactions, items).checks)
    rep.checks.extend(validate_items(items).checks)
    return rep
