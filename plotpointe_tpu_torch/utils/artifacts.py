"""Artifact store: the file contracts between pipeline stages, local paths only.

Counterpart of `plotpointe_tpu/utils/artifacts.py` (its local-path half):
npy, json, npz and parquet files addressed by plain paths or `file://` URIs.
Parquet needs pandas and pyarrow, as in the JAX package; the rest is numpy.
The gs:// half is not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np


def require_pandas():
    """The pandas module, or an ImportError naming the package's `data`
    extra: parquet tables need pandas and pyarrow."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError("parquet tables need pandas and pyarrow: install the package's "
                          "`data` extra (or keep tables as .npz column arrays)") from e
    return pd


def _local(uri: str) -> Path:
    uri = str(uri)
    if uri.startswith("gs://"):
        raise NotImplementedError("gs:// artifacts are not ported yet; use a local path")
    return Path(uri.removeprefix("file://"))


class ArtifactStore:
    """Resolve artifact URIs to local paths and read/write the contract formats."""

    def fetch(self, uri: str) -> Path:
        p = _local(uri)
        if not p.exists():
            raise FileNotFoundError(f"artifact not found: {uri}")
        return p

    def exists(self, uri: str) -> bool:
        return _local(uri).exists()

    def target(self, uri: str) -> Path:
        """The local path to write `uri` to, its directory created."""
        p = _local(uri)
        p.parent.mkdir(parents=True, exist_ok=True)
        return p

    def load_npy(self, uri: str, mmap: bool = False) -> np.ndarray:
        return np.load(self.fetch(uri), mmap_mode="r" if mmap else None)

    def save_npy(self, arr: np.ndarray, uri: str) -> str:
        np.save(self.target(uri), arr)
        return uri

    def load_json(self, uri: str) -> Any:
        with open(self.fetch(uri)) as f:
            return json.load(f)

    def save_json(self, obj: Any, uri: str) -> str:
        with open(self.target(uri), "w") as f:
            json.dump(obj, f, indent=2, sort_keys=False)
        return uri

    def load_npz(self, uri: str) -> Dict[str, np.ndarray]:
        with np.load(self.fetch(uri), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def save_npz(self, arrays: Dict[str, np.ndarray], uri: str) -> str:
        np.savez_compressed(self.target(uri), **arrays)
        return uri

    def load_parquet(self, uri: str):
        return require_pandas().read_parquet(self.fetch(uri))

    def save_parquet(self, df, uri: str) -> str:
        """Write a DataFrame (pandas and pyarrow, as in the JAX package)."""
        df.to_parquet(self.target(uri), index=False)
        return uri

    def load_interactions(self, prefix: str):
        """`{prefix}/interactions.npz` (a dict of column arrays, no pandas
        needed) when it exists, else `{prefix}/interactions.parquet`."""
        return self._load_table(prefix, "interactions")

    def load_items(self, prefix: str):
        """`{prefix}/items.npz` (column arrays) when it exists, else
        `{prefix}/items.parquet`."""
        return self._load_table(prefix, "items")

    def _load_table(self, prefix: str, name: str):
        npz = f"{prefix}/{name}.npz"
        if self.exists(npz):
            return self.load_npz(npz)
        return self.load_parquet(f"{prefix}/{name}.parquet")
