"""Artifact store: the file contracts between pipeline stages.

Counterpart of `plotpointe_tpu/utils/artifacts.py`: npy, json, npz and
parquet files addressed by plain paths, `file://` URIs or `gs://` URIs.
Local URIs are used directly. gs:// URIs are staged through `cache_dir`
(`<cache_dir>/<bucket>/<path>`) with google-cloud-storage, imported only
when a gs:// URI is first touched. Parquet needs pandas and pyarrow, as in
the JAX package; the rest is numpy.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

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


def _is_gcs(uri: str) -> bool:
    return str(uri).startswith("gs://")


def _local(uri: str) -> Path:
    return Path(str(uri).removeprefix("file://"))


class ArtifactStore:
    """Resolve artifact URIs to local paths, downloading or uploading gs://
    ones through `cache_dir`, and read/write the contract formats."""

    def __init__(self, cache_dir: str = "tmp/artifacts", project_id: Optional[str] = None):
        self.cache_dir = Path(cache_dir)
        self.project_id = project_id
        self._gcs_client = None

    def fetch(self, uri: str) -> Path:
        """A local path holding the artifact's bytes; a gs:// artifact is
        downloaded to its cache path on each call."""
        if not _is_gcs(uri):
            p = _local(uri)
            if not p.exists():
                raise FileNotFoundError(f"artifact not found: {uri}")
            return p
        local = self.target(uri)
        bucket, blob = self._split(uri)
        self._client().bucket(bucket).blob(blob).download_to_filename(str(local))
        return local

    def publish(self, local_path: str | Path, uri: str) -> str:
        """Copy (local) or upload (gs://) `local_path` to `uri`; returns the uri."""
        local_path = Path(local_path)
        if not _is_gcs(uri):
            dst = self.target(uri)
            if local_path.resolve() != dst.resolve():
                shutil.copy2(local_path, dst)
            return uri
        bucket, blob = self._split(uri)
        self._client().bucket(bucket).blob(blob).upload_from_filename(str(local_path))
        return uri

    def exists(self, uri: str) -> bool:
        if not _is_gcs(uri):
            return _local(uri).exists()
        bucket, blob = self._split(uri)
        return self._client().bucket(bucket).blob(blob).exists()

    def target(self, uri: str) -> Path:
        """The local path to write `uri` to (a gs:// URI's cache path, to
        `publish` after), its directory created."""
        p = self.cache_dir / str(uri).removeprefix("gs://") if _is_gcs(uri) else _local(uri)
        p.parent.mkdir(parents=True, exist_ok=True)
        return p

    @staticmethod
    def _split(uri: str):
        parts = str(uri).removeprefix("gs://").split("/", 1)
        return parts[0], parts[1] if len(parts) > 1 else ""

    def _client(self):
        if self._gcs_client is None:
            try:
                from google.cloud import storage  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "gs:// URIs require google-cloud-storage; use local paths instead") from e
            self._gcs_client = storage.Client(project=self.project_id)
        return self._gcs_client

    def load_npy(self, uri: str, mmap: bool = False) -> np.ndarray:
        return np.load(self.fetch(uri), mmap_mode="r" if mmap else None)

    def save_npy(self, arr: np.ndarray, uri: str) -> str:
        p = self.target(uri)
        np.save(p, arr)
        return self.publish(p, uri)

    def load_json(self, uri: str) -> Any:
        with open(self.fetch(uri)) as f:
            return json.load(f)

    def save_json(self, obj: Any, uri: str) -> str:
        p = self.target(uri)
        with open(p, "w") as f:
            json.dump(obj, f, indent=2, sort_keys=False)
        return self.publish(p, uri)

    def load_npz(self, uri: str) -> Dict[str, np.ndarray]:
        with np.load(self.fetch(uri), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def save_npz(self, arrays: Dict[str, np.ndarray], uri: str) -> str:
        p = self.target(uri)
        np.savez_compressed(p, **arrays)
        return self.publish(p, uri)

    def load_parquet(self, uri: str):
        return require_pandas().read_parquet(self.fetch(uri))

    def save_parquet(self, df, uri: str) -> str:
        """Write a DataFrame (pandas and pyarrow, as in the JAX package)."""
        p = self.target(uri)
        df.to_parquet(p, index=False)
        return self.publish(p, uri)

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


# The canonical artifact names: the file contracts between stages.
CONTRACTS = {
    "interactions": "interactions.parquet",
    "items": "items.parquet",
    "txt": "txt.npy",
    "txt_meta": "txt_meta.json",
    "img": "img.npy",
    "img_items": "img_items.parquet",
    "fused": "fused.npy",
    "fusion_config": "fusion_config.json",
    "txt_interacted": "txt_interacted.npy",
    "fused_interacted": "fused_interacted.npy",
    "interacted_items": "interacted_items.json",
    "ui_edges": "ui_edges.npz",
    "node_maps": "node_maps.json",
    "ui_stats": "ui_stats.json",
    "item_embeddings": "exports/item_embeddings.npy",
}
