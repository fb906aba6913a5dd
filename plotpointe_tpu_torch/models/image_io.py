"""Image decode + CLIP preprocessing + batched encoding on the card.

Counterpart of `plotpointe_tpu/models/image_io.py`: the pixel path the
reference runs per item over the network (download, CLIP encode, failure
counting). Zero-egress by default: images are local files staged ahead of
time; missing and corrupt files are counted and reported as the reference
counts failed downloads. `allow_remote=True` also fetches http(s) URLs
(stdlib urllib with timeout and retry). Decoding needs PIL (the `image`
extra); the tower runs in PyTorch on `device` (default: the card).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch import resolve_device
from plotpointe_tpu_torch.models.encoders import ViTImageEncoder, load_params_npz

# CLIP preprocessing constants (openai/clip-vit-base-patch32 processor config)
CLIP_SIZE = 224
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def local_path(uri: str) -> Optional[Path]:
    """file:// URI or plain path -> Path; None for remote (http...) refs."""
    if uri.startswith("file://"):
        return Path(uri[7:])
    if "://" in uri:
        return None
    return Path(uri)


def preprocess_clip(img) -> np.ndarray:
    """PIL image -> [224, 224, 3] float32, CLIP-normalized.

    Matches CLIPImageProcessor: bicubic resize of the short side to 224,
    center crop, scale to [0,1], channel-wise mean/std normalization."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    scale = CLIP_SIZE / min(w, h)
    img = img.resize((max(CLIP_SIZE, round(w * scale)), max(CLIP_SIZE, round(h * scale))),
                     Image.BICUBIC)
    w, h = img.size
    left, top = (w - CLIP_SIZE) // 2, (h - CLIP_SIZE) // 2
    img = img.crop((left, top, left + CLIP_SIZE, top + CLIP_SIZE))
    x = np.asarray(img, np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def fetch_image(url: str, timeout: float = 5.0, retries: int = 2):
    """Download an image over HTTP with timeout + retry; None on failure.

    The reference downloads each image per item (`embed_image.py:23-31`:
    requests.get(timeout=5) -> PIL decode, failures counted); this is the
    flag-gated equivalent on stdlib urllib (zero extra dependency), with
    bounded exponential backoff between attempts."""
    import io
    import time as _time
    import urllib.request

    from PIL import Image

    for attempt in range(retries + 1):
        try:
            req = urllib.request.Request(url, headers={"User-Agent": "plotpointe-tpu/1.0"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                data = resp.read()
            img = Image.open(io.BytesIO(data))
            img.load()
            return img
        except Exception:  # noqa: BLE001 — any failure counts like the reference's
            if attempt < retries:
                _time.sleep(min(0.25 * (2 ** attempt), 2.0))
    return None


def load_image_batch(paths: List[str], allow_remote: bool = False,
                     timeout: float = 5.0, retries: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + preprocess a list of image refs (local files; http(s) URLs
    too when allow_remote — flag-gated so the zero-egress pipeline does no
    network IO by surprise).
    Returns (pixels [N_ok, 224, 224, 3], ok_mask [N] bool)."""
    from PIL import Image

    out, ok = [], np.zeros(len(paths), bool)
    for r, p in enumerate(paths):
        lp = local_path(str(p))
        if lp is None:
            if not allow_remote:
                continue
            img = fetch_image(str(p), timeout=timeout, retries=retries)
            if img is None:
                continue
            try:
                out.append(preprocess_clip(img))
                ok[r] = True
            except Exception:  # noqa: BLE001
                continue
            continue
        if not lp.exists():
            continue
        try:
            with Image.open(lp) as img:
                out.append(preprocess_clip(img))
            ok[r] = True
        except Exception:  # noqa: BLE001 — corrupt file == reference download failure
            continue
    pixels = np.stack(out) if out else np.zeros((0, CLIP_SIZE, CLIP_SIZE, 3), np.float32)
    return pixels, ok


def encode_image_files(
    uris: List[str],
    weights: Optional[str] = None,
    batch_size: int = 64,
    compute_dtype: str = "bfloat16",
    allow_remote: bool = False,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Local image files -> CLIP-vision embeddings.

    Returns (emb [N_ok, out_dim] f32 L2-normalized, ok_mask [N] bool,
    n_failures). With `weights` (converted via tools/convert_weights.py) the
    embeddings match the reference's real CLIP features; without, the tower
    is random-init from `torch.Generator` seeded 0 (pipeline plumbing still
    fully exercised). The parameters and the pixels are cast to
    `compute_dtype` (bf16 by default, layer norm and softmax included, as the
    JAX package runs it), and the last batch is padded to `batch_size`."""
    dev = resolve_device(device)
    enc = ViTImageEncoder()
    if weights:
        load_params_npz(weights, enc)
    else:
        enc.init_params(torch.Generator().manual_seed(0))
    dt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    enc = enc.to(dev, dt).eval()

    pixels, ok = load_image_batch(uris, allow_remote=allow_remote)
    n_fail = int((~ok).sum())
    if not len(pixels):
        return np.zeros((0, enc.out_dim), np.float32), ok, n_fail

    outs = []
    with torch.no_grad():
        for s in range(0, len(pixels), batch_size):
            chunk = pixels[s : s + batch_size]
            pad = batch_size - len(chunk)  # one batch shape, as the JAX package's compiled program
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
            emb = enc(torch.as_tensor(chunk).to(dev, dt)).float().cpu().numpy()
            outs.append(emb[: batch_size - pad] if pad else emb)
    emb = np.concatenate(outs, axis=0)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
    return emb, ok, n_fail
