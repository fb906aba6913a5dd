"""Training and kNN configs (dataclasses with environment-variable
overrides) and the feature-manifest registry.

Counterpart of `plotpointe_tpu/config.py`: `TrainConfig` (same fields, same
defaults, same `from_env` / `to_dict` / `from_dict`), so a checkpoint's
embedded `train_config` reads in both packages; `KnnConfig`; and
`FeatureManifest`, `load_registry`, `load_manifest` (the same manifest JSON
schema and the same errors).

`attn_impl` (GAT) and `spmm_impl` (LightGCN) keep the JAX values and pick
the type the kernels round gathered rows to (`ops/gat_kernel.resolve_hs_dtype`):
`pallas`, and `auto` on CUDA, mean bf16 rows (what the JAX trainer runs on
its accelerator); `xla`, and `auto` on the CPU, mean f32 rows. On the card
both run the same CUDA kernels.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional


def _env_override(cfg, prefix: str = ""):
    """Apply FIELD_NAME (upper-cased) environment overrides."""
    for f in dataclasses.fields(cfg):
        raw = os.environ.get((prefix + f.name).upper())
        if raw is None:
            continue
        cur = getattr(cfg, f.name)
        if isinstance(cur, bool):
            val: Any = raw.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        else:
            val = raw
        setattr(cfg, f.name, val)
    return cfg


@dataclass
class TrainConfig:
    # model
    model_family: str = "gat"  # {gat, lightgcn}
    hidden_dim: int = 128
    layers: int = 2
    heads: int = 1
    attn_dropout: float = 0.1
    # optimization
    lr: float = 1e-3
    l2: float = 1e-4
    epochs: int = 20
    samples_per_epoch: int = 200_000
    steps_per_epoch: int = 1  # the reference protocol: one optimizer step per epoch
    optimizer: str = "adam"  # {adam (coupled L2, reference parity), adamw}
    warmup_steps: int = 0
    loss: str = "bpr"  # {bpr, bce}
    seed: int = 42
    # eval protocol (1 positive + eval_neg_k sampled negatives per user)
    eval_neg_k: int = 1000
    eval_chunk: int = 2048
    # features
    item_features: str = "fused"  # {fused, txt}
    # lightgcn-specific
    embed_dim: int = 64
    n_prop_layers: int = 3
    batch_size: int = 8192
    neg_per_pos: int = 5
    # execution
    attn_impl: str = "auto"  # {auto, xla, pallas}: the attention row type, see above
    spmm_impl: str = "auto"  # {auto, xla, pallas}: LightGCN's propagation row type, see above
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    mesh_shape: Optional[str] = None  # sharded training is not ported yet
    # io
    artifacts_prefix: str = "tmp/artifacts"
    models_prefix: str = "tmp/models"
    run_id: Optional[str] = None
    structured_logs: bool = False

    @classmethod
    def from_env(cls, **kwargs) -> "TrainConfig":
        return _env_override(cls(**kwargs))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class KnnConfig:
    """Item-item cosine-kNN config (the JAX package's `KnnConfig`)."""

    k: int = 20
    min_similarity: float = 0.3
    block_rows: int = 1024

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class FeatureManifest:
    """One dataset's artifact prefixes and default feature choice."""

    id: str
    dataset: str
    paths: Dict[str, str]
    defaults: Dict[str, str] = field(default_factory=dict)

    REQUIRED_PATHS = ("staging_prefix", "embeddings_prefix", "graphs_prefix")

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FeatureManifest":
        """Raises ValueError naming the first missing key."""
        for k in ("id", "dataset", "paths", "defaults"):
            if k not in d:
                raise ValueError(f"Manifest missing required key: {k}")
        for p in FeatureManifest.REQUIRED_PATHS:
            if p not in d["paths"]:
                raise ValueError(f"Manifest.paths missing required key: {p}")
        return FeatureManifest(id=d["id"], dataset=d["dataset"], paths=d["paths"],
                               defaults=d.get("defaults", {}))

    def resolve_paths(self) -> Dict[str, str]:
        """The manifest's entries under the trainer's flag names."""
        return {
            "staging_prefix": self.paths["staging_prefix"],
            "embeddings_prefix": self.paths["embeddings_prefix"],
            "graphs_prefix": self.paths["graphs_prefix"],
            "item_features": self.defaults.get("item_features", "fused"),
        }


def load_registry(registry_path: str | Path = "manifests/registry.json") -> Dict[str, str]:
    """{manifest id: manifest path}; ValueError without a `manifests` key."""
    with open(registry_path) as f:
        reg = json.load(f)
    if "manifests" not in reg:
        raise ValueError("Registry missing 'manifests'")
    return reg["manifests"]


def load_manifest(manifest_id: str,
                  registry_path: str | Path = "manifests/registry.json") -> FeatureManifest:
    """The registry's manifest `manifest_id` (KeyError if unlisted). A
    relative manifest path that does not exist from the working directory
    is taken from the registry's grandparent directory (the repo root for
    `manifests/registry.json`)."""
    manifests = load_registry(registry_path)
    if manifest_id not in manifests:
        raise KeyError(f"Manifest id not found in registry: {manifest_id}")
    p = Path(manifests[manifest_id])
    if not p.is_absolute() and not p.exists():
        p = Path(registry_path).parent.parent / p
    with open(p) as f:
        return FeatureManifest.from_dict(json.load(f))
