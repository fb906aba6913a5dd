"""Manifest validator: check that every manifest's artifact prefixes exist.

Counterpart of `plotpointe_tpu/tools/manifest_validate.py`. A prefix
exists when a local path (plain or `file://`) exists, or when a gs://
prefix holds at least one object (one listed blob, as the JAX tool asks;
an object named exactly the prefix is not needed). Prints one report per
manifest and exits 0 when every prefix exists, 2 otherwise (`cli
validate-manifests`).

    python -m plotpointe_tpu_torch.tools.manifest_validate [--registry R] [--manifest-id ID]
"""
from __future__ import annotations

import argparse
import json

from plotpointe_tpu_torch.config import FeatureManifest, load_manifest, load_registry
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore


def prefix_exists(store: ArtifactStore, prefix: str) -> bool:
    """True when a gs:// prefix lists at least one blob, or a local path exists."""
    if str(prefix).startswith("gs://"):
        bucket, blob = store._split(prefix)
        return any(True for _ in store._client().list_blobs(bucket, prefix=blob, max_results=1))
    return store.exists(prefix)


def validate_manifest(manifest: FeatureManifest, store: ArtifactStore | None = None) -> dict:
    """{"id", "paths": {key: {"prefix", "exists"}}, "ok"} over REQUIRED_PATHS."""
    store = store or ArtifactStore()
    results = {}
    for key in FeatureManifest.REQUIRED_PATHS:
        prefix = manifest.paths[key]
        results[key] = {"prefix": prefix, "exists": prefix_exists(store, prefix)}
    return {"id": manifest.id, "paths": results, "ok": all(r["exists"] for r in results.values())}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Validate feature-manifest artifact prefixes")
    ap.add_argument("--registry", default="manifests/registry.json")
    ap.add_argument("--manifest-id", default=None, help="validate one manifest; default: all")
    args = ap.parse_args(argv)

    store = ArtifactStore()
    ids = [args.manifest_id] if args.manifest_id else list(load_registry(args.registry))
    reports = [validate_manifest(load_manifest(i, args.registry), store) for i in ids]
    print(json.dumps(reports, indent=2))
    raise SystemExit(0 if all(r["ok"] for r in reports) else 2)


if __name__ == "__main__":
    main()
