"""Fetch the real encoder checkpoints and write them as test fixtures.

Counterpart of `plotpointe_tpu/tools/fetch_fixtures.py`, the same files with
the same keys: the reference embeds with sentence-transformers
all-MiniLM-L6-v2 and openai/clip-vit-base-patch32. This tool downloads those
checkpoints once through `transformers` (a machine with network access is
required), converts them with `tools/convert_weights.py`, runs the Hugging
Face model on fixed probe inputs and writes into `--out`:

  minilm_real.npz   `param:<path>` converted tower params + `probe_ids`,
                    `probe_mask` and `ref_pooled` (HF mean-pooled output)
  clip_real.npz     `param:<path>` converted tower params + `probe_pixels`
                    (NHWC) and `ref_embeds` (HF image_embeds)

The probes and the conversion are the JAX tool's, so one file serves both
packages' real-checkpoint tests (`tests/test_convert_weights.py`,
`tests/test_torch_convert_weights.py`), which skip while the files are
absent. The reference forward runs on `--device` in f32 with TF32 off.

Usage (needs network + transformers):
    python -m plotpointe_tpu_torch.tools.fetch_fixtures [--out tests/fixtures] \
        [--family minilm|clip|all] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from plotpointe_tpu_torch import full_f32_matmul, resolve_device
from plotpointe_tpu_torch.tools.convert_weights import (
    convert_clip_vision_state_dict, convert_minilm_state_dict)

PROBE_SEED = 1234
TXT_BATCH, TXT_LEN = 4, 32
IMG_BATCH = 2
MINILM = "sentence-transformers/all-MiniLM-L6-v2"
CLIP = "openai/clip-vit-base-patch32"
PROBE_TEXTS = [
    "a wireless bluetooth speaker with deep bass",
    "usb-c fast charging cable for phones",
    "noise cancelling over-ear headphones",
    "4k streaming media player remote included",
]


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError("fetch_fixtures needs the `transformers` package to download and run the "
                          "Hugging Face checkpoints") from e
    return transformers


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> {"blocks/0/qkv/w": array}: the fixtures'
    key paths, the JAX tool's."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _state_dict(hf) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in hf.state_dict().items()}


def fetch_minilm(out_dir: Path, device=None) -> Path:
    """all-MiniLM-L6-v2 -> out_dir/minilm_real.npz: the converted params, the
    four probe texts padded to TXT_LEN tokens, and HF's mean-pooled output
    (sentence-transformers' pooling, not normalised)."""
    transformers = _transformers()
    dev = resolve_device(device)
    tok = transformers.AutoTokenizer.from_pretrained(MINILM)
    hf = transformers.AutoModel.from_pretrained(MINILM).eval()
    sd = _state_dict(hf)
    enc = tok(PROBE_TEXTS, padding="max_length", truncation=True, max_length=TXT_LEN, return_tensors="pt")
    with torch.no_grad(), full_f32_matmul():
        ref = hf.to(dev)(**{k: v.to(dev) for k, v in enc.items()}).last_hidden_state  # [B, L, H]
        mask = enc["attention_mask"].to(dev).unsqueeze(-1).float()
        pooled = (ref * mask).sum(1) / mask.sum(1)

    blob = {f"param:{k}": v for k, v in _flatten(convert_minilm_state_dict(sd, max_len=TXT_LEN)).items()}
    blob["probe_ids"] = enc["input_ids"].numpy().astype(np.int32)
    blob["probe_mask"] = enc["attention_mask"].numpy().astype(np.float32)
    blob["ref_pooled"] = pooled.cpu().numpy().astype(np.float32)
    path = out_dir / "minilm_real.npz"
    np.savez_compressed(path, **blob)
    print(f"wrote {path} ({len(blob)} arrays)")
    return path


def fetch_clip(out_dir: Path, device=None) -> Path:
    """clip-vit-base-patch32's vision tower -> out_dir/clip_real.npz: the
    converted params, IMG_BATCH seeded 224 x 224 probe images (NHWC) and
    HF's image_embeds."""
    transformers = _transformers()
    dev = resolve_device(device)
    hf = transformers.CLIPVisionModelWithProjection.from_pretrained(CLIP).eval()
    sd = _state_dict(hf)
    pixels = np.random.default_rng(PROBE_SEED).normal(size=(IMG_BATCH, 3, 224, 224)).astype(np.float32)
    with torch.no_grad(), full_f32_matmul():
        ref = hf.to(dev)(pixel_values=torch.from_numpy(pixels).to(dev)).image_embeds  # [B, 512]

    blob = {f"param:{k}": v for k, v in _flatten(convert_clip_vision_state_dict(sd)).items()}
    blob["probe_pixels"] = np.transpose(pixels, (0, 2, 3, 1))  # NHWC, the towers' layout
    blob["ref_embeds"] = ref.cpu().numpy().astype(np.float32)
    path = out_dir / "clip_real.npz"
    np.savez_compressed(path, **blob)
    print(f"wrote {path} ({len(blob)} arrays)")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="download the real encoder checkpoints as test fixtures")
    ap.add_argument("--out", default="tests/fixtures")
    ap.add_argument("--family", choices=["minilm", "clip", "all"], default="all")
    ap.add_argument("--device", default=None, help="where the reference forward runs (default: cuda)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.family in ("minilm", "all"):
        fetch_minilm(out, args.device)
    if args.family in ("clip", "all"):
        fetch_clip(out, args.device)


if __name__ == "__main__":
    main()
