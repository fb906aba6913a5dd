"""Convert Hugging Face MiniLM / CLIP-vision checkpoints to encoder npz files.

Counterpart of `plotpointe_tpu/tools/convert_weights.py`, the same numpy
mapping: the reference embeds items with sentence-transformers
all-MiniLM-L6-v2 and HF CLIP ViT-B/32; this maps those state_dicts onto the
towers of `models/encoders.py` and writes the flat key-path npz of
`train/checkpoint.save_checkpoint`, so an npz from either package loads in
both (`models/encoders.load_params_npz`).

Usage (offline: the HF model must already be on local disk):
    python -m plotpointe_tpu_torch.cli convert-weights --family minilm \
        --src /path/to/all-MiniLM-L6-v2 --out weights/minilm.npz
    python -m plotpointe_tpu_torch.cli convert-weights --family clip-vision \
        --src /path/to/clip-vit-base-patch32 --out weights/clip_vision.npz

Weight-mapping notes (held by output-parity tests against random-init HF
models, tests/test_torch_convert_weights.py):
  - torch Linear stores [out, in]; the towers keep [in, out] -> transpose.
  - q/k/v projections fuse into one [H, 3H] matmul (split order q,k,v).
  - BERT token_type embeddings: the text pipeline only ever uses segment 0,
    so token_type_embeddings[0] folds into the position table.
  - CLIP patch conv [O,C,P,P] -> linear over patches flattened as (row, col,
    channel), matching ViTImageEncoder.forward's reshape order.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from plotpointe_tpu_torch.train.checkpoint import save_checkpoint


def _t(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).T


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _fused_qkv(sd: Dict[str, Any], q: str, k: str, v: str) -> Dict[str, np.ndarray]:
    return {
        "w": np.concatenate([_t(sd[q + ".weight"]), _t(sd[k + ".weight"]), _t(sd[v + ".weight"])], axis=1),
        "b": np.concatenate([_a(sd[q + ".bias"]), _a(sd[k + ".bias"]), _a(sd[v + ".bias"])]),
    }


def _linear(sd, prefix, bias_shape=None):
    w = _t(sd[prefix + ".weight"])
    b = _a(sd[prefix + ".bias"]) if prefix + ".bias" in sd else np.zeros(
        bias_shape if bias_shape is not None else w.shape[1], np.float32
    )
    return {"w": w, "b": b}


def _ln(sd, prefix):
    return {"g": _a(sd[prefix + ".weight"]), "b": _a(sd[prefix + ".bias"])}


def convert_minilm_state_dict(sd: Dict[str, Any], max_len: int = 256) -> Dict[str, Any]:
    """BertModel state_dict -> TransformerTextEncoder params pytree."""
    pfx = "embeddings."
    if any(k.startswith("bert.") for k in sd):
        sd = {k.removeprefix("bert."): v for k, v in sd.items()}
    tok = _a(sd[pfx + "word_embeddings.weight"])
    pos = _a(sd[pfx + "position_embeddings.weight"])[:max_len]
    # segment-0 token-type row is added to every position in our pipeline
    pos = pos + _a(sd[pfx + "token_type_embeddings.weight"])[0]
    n_layers = 1 + max(
        int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer.")
    )
    blocks = []
    for i in range(n_layers):
        lp = f"encoder.layer.{i}."
        blocks.append({
            "qkv": _fused_qkv(sd, lp + "attention.self.query", lp + "attention.self.key",
                              lp + "attention.self.value"),
            "proj": _linear(sd, lp + "attention.output.dense"),
            "ln1": _ln(sd, lp + "attention.output.LayerNorm"),
            "ffn1": _linear(sd, lp + "intermediate.dense"),
            "ffn2": _linear(sd, lp + "output.dense"),
            "ln2": _ln(sd, lp + "output.LayerNorm"),
        })
    return {
        "tok_emb": tok,
        "pos_emb": pos,
        "ln_emb": _ln(sd, pfx + "LayerNorm"),
        "blocks": blocks,
    }


def convert_clip_vision_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """CLIPVisionModelWithProjection state_dict -> ViTImageEncoder params."""
    v = "vision_model."
    conv = _a(sd[v + "embeddings.patch_embedding.weight"])  # [O, C, P, P]
    o, c, p, _ = conv.shape
    # our patches flatten as (row, col, channel): [O,C,P,P] -> [P,P,C,O] -> [P*P*C, O]
    patch_w = conv.transpose(2, 3, 1, 0).reshape(p * p * c, o)
    n_layers = 1 + max(
        int(k.split(".")[3]) for k in sd if k.startswith(v + "encoder.layers.")
    )
    blocks = []
    for i in range(n_layers):
        lp = f"{v}encoder.layers.{i}."
        blocks.append({
            "qkv": _fused_qkv(sd, lp + "self_attn.q_proj", lp + "self_attn.k_proj",
                              lp + "self_attn.v_proj"),
            "proj": _linear(sd, lp + "self_attn.out_proj"),
            "ln1": _ln(sd, lp + "layer_norm1"),
            "ffn1": _linear(sd, lp + "mlp.fc1"),
            "ffn2": _linear(sd, lp + "mlp.fc2"),
            "ln2": _ln(sd, lp + "layer_norm2"),
        })
    return {
        "patch_proj": {"w": patch_w, "b": np.zeros(o, np.float32)},
        "cls": _a(sd[v + "embeddings.class_embedding"]),
        "pos_emb": _a(sd[v + "embeddings.position_embedding.weight"]),
        "ln_pre": _ln(sd, v + "pre_layrnorm"),  # (sic) HF attribute name
        "ln_post": _ln(sd, v + "post_layernorm"),
        "proj": _linear(sd, "visual_projection"),
        "blocks": blocks,
    }


def _hf_state_dict(src: str) -> Dict[str, np.ndarray]:
    """Load a state_dict from a local HF model directory (offline):
    `model.safetensors` where `safetensors` imports, else
    `pytorch_model.bin` through `torch.load(weights_only=True)`."""
    src_p = Path(src)
    st = src_p / "model.safetensors"
    if st.exists():
        try:
            from safetensors.numpy import load_file
        except ImportError:
            load_file = None
        if load_file is not None:
            return load_file(str(st))
    bin_p = src_p / "pytorch_model.bin"
    if bin_p.exists():
        sd = torch.load(bin_p, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no loadable model.safetensors or pytorch_model.bin under {src}")


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> {JAX key-path string: array}."""
    if isinstance(tree, dict):
        items = ((f"['{k}']", v) for k, v in tree.items())
    elif isinstance(tree, list):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    return {k: v for part, sub in items for k, v in _flatten(sub, prefix + part).items()}


def convert(family: str, src: str, out: str, max_len: int = 256) -> Dict[str, Any]:
    """Convert a local HF checkpoint dir -> encoder npz. Returns the config dict."""
    sd = _hf_state_dict(src)
    if family == "minilm":
        params = convert_minilm_state_dict(sd, max_len=max_len)
        cfg = {"family": "minilm", "hidden": int(params["tok_emb"].shape[1]),
               "n_layers": len(params["blocks"]), "max_len": max_len,
               "vocab_size": int(params["tok_emb"].shape[0])}
    elif family == "clip-vision":
        params = convert_clip_vision_state_dict(sd)
        cfg = {"family": "clip-vision", "hidden": int(params["cls"].shape[0]),
               "n_layers": len(params["blocks"]),
               "out_dim": int(params["proj"]["w"].shape[1])}
    else:
        raise ValueError(f"unknown family {family!r} (minilm | clip-vision)")
    save_checkpoint(out, _flatten(params), cfg)
    return cfg
