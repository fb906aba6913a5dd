"""Manifest validator: check that every manifest's artifact prefixes exist.

Counterpart of `plotpointe_tpu/tools/manifest_validate.py` for local
prefixes (plain paths or `file://`; the port's ArtifactStore has no gs://
half). Prints one report per manifest and exits 0 when every prefix exists,
2 otherwise (`cli validate-manifests`).

    python -m plotpointe_tpu_torch.tools.manifest_validate [--registry R] [--manifest-id ID]
"""
from __future__ import annotations

import argparse
import json

from plotpointe_tpu_torch.config import FeatureManifest, load_manifest, load_registry
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore


def validate_manifest(manifest: FeatureManifest, store: ArtifactStore | None = None) -> dict:
    """{"id", "paths": {key: {"prefix", "exists"}}, "ok"} over REQUIRED_PATHS."""
    store = store or ArtifactStore()
    results = {}
    for key in FeatureManifest.REQUIRED_PATHS:
        prefix = manifest.paths[key]
        results[key] = {"prefix": prefix, "exists": store.exists(prefix)}
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
