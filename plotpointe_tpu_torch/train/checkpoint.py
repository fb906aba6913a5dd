"""Self-describing checkpoints: flat parameters plus an embedded config in one npz.

Counterpart of `plotpointe_tpu/train/checkpoint.py`, same file format: one
array per parameter keyed by its JAX key-path string (what
`jax.tree_util.keystr` writes, e.g. `['layers'][0]['a_src']`) and a
`__config__` JSON string. No pickle. Checkpoints load across both packages;
`params_from_jax` turns those keys into a PyTorch `state_dict` and
`params_to_jax` turns a `state_dict` back into them.

The resume state (`save_resume_state` / `load_resume_state`: parameters,
optimizer and scheduler state, best parameters, epoch meta) is the port's
own format, a `torch.save` file read back with `weights_only=True`; the
JAX package's resume npz does not load here, nor the other way round.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_CONFIG_KEY = "__config__"
_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def save_checkpoint(path: str | Path, params: Mapping[str, np.ndarray], config: Dict[str, Any]) -> str:
    """params: {JAX key-path string: array}."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{_CONFIG_KEY: np.array(json.dumps(config))},
             **{k: np.asarray(v) for k, v in params.items()})
    return str(path)


def load_config(path: str | Path) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z[_CONFIG_KEY]))


def load_checkpoint(path: str | Path) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Returns ({JAX key-path string: array}, config)."""
    with np.load(path, allow_pickle=False) as z:
        config = json.loads(str(z[_CONFIG_KEY]))
        return {k: z[k] for k in z.files if k != _CONFIG_KEY}, config


def _dotted(keystr: str) -> str:
    parts = _KEY_PART.findall(keystr)
    if "".join(f"['{a}']" if a else f"[{b}]" for a, b in parts) != keystr:
        raise ValueError(f"not a JAX key-path string: {keystr!r}")
    return ".".join(a or b for a, b in parts)


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{`['layers'][0]['a_src']`: array} -> {`layers.0.a_src`: tensor}."""
    return {_dotted(k): torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _keystr(dotted: str) -> str:
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in dotted.split("."))


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{`layers.0.a_src`: tensor} -> {`['layers'][0]['a_src']`: float array},
    the keys the JAX package's `load_checkpoint` looks up."""
    return {_keystr(k): v.detach().cpu().numpy() for k, v in state_dict.items()}


def save_resume_state(path: str | Path, params: Mapping[str, torch.Tensor], opt_state: Dict[str, Any],
                      best_params: Mapping[str, torch.Tensor], meta: Dict[str, Any]) -> str:
    """Mid-training state for a preemption-safe resume."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"params": dict(params), "opt_state": opt_state, "best_params": dict(best_params),
                "meta": dict(meta)}, tmp)
    tmp.replace(path)  # a preempted write leaves the previous state whole
    return str(path)


def load_resume_state(path: str | Path, device=None) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                                                             Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns (params, opt_state, best_params, meta), tensors on `device`."""
    bundle = torch.load(path, map_location=device, weights_only=True)
    return bundle["params"], bundle["opt_state"], bundle["best_params"], bundle["meta"]
