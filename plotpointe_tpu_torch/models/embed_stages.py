"""Embedding pipeline stages: text, image, fusion, artifact in/out.

Counterpart of `plotpointe_tpu/models/embed_stages.py`, with the same
artifact names and JSON keys: txt.npy + txt_meta.json; img{_chunkN}.npy +
img_items{_chunkN}.parquet + img_meta{_chunkN}.json; fused.npy +
fusion_config.json. The same text composition, alignment and chunk-sharding
semantics. Item tables are the port's numpy column dicts
(`data/synthetic.py`) or DataFrames read from parquet. The deterministic
hash encoder (host, numpy) needs no weights; the MiniLM tower
(`weights` + `vocab`) and the CLIP tower (pixel path) run on `device`
(default: the card). img_items parquet needs pandas (the `data` extra).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch import full_f32_matmul, resolve_device
from plotpointe_tpu_torch.config import FusionConfig
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore, require_pandas


def _column(items, name: str):
    """A column of a dict of arrays or a DataFrame as a numpy array, or None."""
    if isinstance(items, dict):
        return np.asarray(items[name]) if name in items else None
    return items[name].to_numpy() if name in items.columns else None


def compose_item_text(items) -> list:
    """title + 'Brand: {brand}' + joined categories (+ description if
    present), joined by '. '; 'unknown item' when a row has none. Per row the
    JAX package's truthiness tests, over columns instead of `iterrows`."""
    asin = _column(items, "asin")
    cols = [_column(items, c) for c in ("title", "brand", "categories", "description")]
    title, brand, cats, desc = (c if c is not None else [None] * len(asin) for c in cols)
    texts = []
    for t, b, c, d in zip(title, brand, cats, desc):
        parts = []
        if t:
            parts.append(str(t))
        if b:
            parts.append(f"Brand: {b}")
        if c is not None and len(c):
            parts.append(" ".join(str(x) for x in c))
        if d:
            parts.append(str(d))
        texts.append(". ".join(parts) if parts else "unknown item")
    return texts


def make_minilm_encoder(weights: str, vocab: str, batch_size: int = 128, device=None) -> Callable:
    """Converted-MiniLM text encoder: WordPiece tokenize -> the tower on
    `device` in f32 (TF32 off: the JAX package's f32). Batches are padded to
    `batch_size`; a padded row keeps its first token valid."""
    from plotpointe_tpu_torch.models.encoders import TransformerTextEncoder, load_params_npz
    from plotpointe_tpu_torch.models.tokenizer import WordPieceTokenizer

    dev = resolve_device(device)
    enc = load_params_npz(weights, TransformerTextEncoder()).to(dev).eval()
    tok = WordPieceTokenizer(vocab)

    def encode(texts: list) -> np.ndarray:
        ids, mask = tok.encode(texts, max_len=enc.max_len)
        pad = batch_size - len(texts) if len(texts) < batch_size else 0
        if pad:
            ids = np.concatenate([ids, np.zeros((pad, enc.max_len), np.int32)])
            mask = np.concatenate([mask, np.zeros((pad, enc.max_len), np.float32)])
            mask[len(texts):, 0] = 1.0  # no all-masked padded row
        with torch.no_grad(), full_f32_matmul():
            out = enc(torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev))
        return out.cpu().numpy()[: len(texts)]

    return encode


def embed_text_stage(
    items,
    out_prefix: str,
    encoder: Optional[Callable[[list], np.ndarray]] = None,
    store: Optional[ArtifactStore] = None,
    batch_size: int = 128,
    weights: Optional[str] = None,
    vocab: Optional[str] = None,
    device=None,
) -> Tuple[np.ndarray, Dict]:
    """items -> txt.npy (rows in items order, L2-normalized) + txt_meta.json.

    With `weights` (converted MiniLM npz) + `vocab` (WordPiece vocab.txt) the
    MiniLM tower runs on `device`; otherwise the deterministic hash encoder
    runs on the host."""
    store = store or ArtifactStore()
    t0 = time.time()
    texts = compose_item_text(items)
    if encoder is None and weights and vocab:
        encoder = make_minilm_encoder(weights, vocab, device=device)
    if encoder is None:
        from plotpointe_tpu_torch.models.encoders import hash_text_encoder

        encoder = hash_text_encoder(dim=384)
    outs = [encoder(texts[s : s + batch_size]) for s in range(0, len(texts), batch_size)]
    emb = np.concatenate(outs, axis=0).astype(np.float32) if outs else np.zeros((0, 384), np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
    dt = time.time() - t0
    meta = {
        "n_items": int(emb.shape[0]),
        "dims": int(emb.shape[1]) if emb.size else 0,
        "throughput_items_per_sec": float(emb.shape[0] / dt) if dt > 0 else 0.0,
        "build_time_sec": dt,
    }
    store.save_npy(emb, f"{out_prefix}/txt.npy")
    store.save_json(meta, f"{out_prefix}/txt_meta.json")
    return emb, meta


def image_rows(items, chunk_start: Optional[int] = None, chunk_end: Optional[int] = None,
               max_items: Optional[int] = None, seed: int = 42) -> np.ndarray:
    """Table positions of the rows an image stage embeds: rows with an
    image_url, then the index range [chunk_start, chunk_end), else a sample
    of `max_items` of them in the order pandas'
    `sample(n, random_state=seed)` takes (RandomState(seed).choice without
    replacement)."""
    urls = np.asarray(_column(items, "image_url"), dtype=object)
    rows = np.flatnonzero(~require_pandas().isna(urls))
    if chunk_start is not None or chunk_end is not None:
        return rows[chunk_start or 0 : chunk_end]
    if max_items is not None and len(rows) > max_items:
        return rows[np.random.RandomState(seed).choice(len(rows), size=max_items, replace=False)]
    return rows


def embed_image_stage(
    items,
    out_prefix: str,
    encoder: Optional[Callable[[list], np.ndarray]] = None,
    store: Optional[ArtifactStore] = None,
    chunk_start: Optional[int] = None,
    chunk_end: Optional[int] = None,
    chunk_id: Optional[int] = None,
    max_items: Optional[int] = None,
    seed: int = 42,
    pixels: Optional[bool] = None,
    weights: Optional[str] = None,
    allow_remote: bool = False,
    device=None,
) -> Tuple[np.ndarray, Dict]:
    """items with image_url -> img{_chunk}.npy + img_items{_chunk}.parquet
    + img_meta{_chunk}.json.

    Index-range chunks for multi-worker sharding, or a seeded sample cap
    (`image_rows`). Two encode paths:
      - pixel path (pixels=True, or auto when image_url points at existing
        local files): decode + CLIP preprocess + the ViT on `device`
        (`models/image_io.encode_image_files`), failures counted and their
        rows dropped from both the matrix and img_items. `weights` is a
        converted CLIP-vision npz.
      - url-hash path (zero-egress fallback): the hash encoder over the URL
        strings, on the host.
    allow_remote=True also downloads http(s) image_urls; off by default, so
    the default pipeline performs no network IO."""
    store = store or ArtifactStore()
    pd = require_pandas()  # img_items is parquet
    t0 = time.time()
    rows = image_rows(items, chunk_start, chunk_end, max_items, seed)
    asins = _column(items, "asin")[rows]
    urls = [str(u) for u in _column(items, "image_url")[rows]]
    n_failures = 0
    if pixels is None and encoder is None and urls:
        from plotpointe_tpu_torch.models.image_io import local_path

        lp = local_path(urls[0])
        pixels = (lp is not None and lp.exists()) or (allow_remote and lp is None)

    if pixels:
        from plotpointe_tpu_torch.models.image_io import encode_image_files

        emb, ok, n_failures = encode_image_files(urls, weights=weights, allow_remote=allow_remote,
                                                 device=device)
        asins = asins[ok]
    else:
        if encoder is None:
            from plotpointe_tpu_torch.models.encoders import hash_text_encoder

            encoder = hash_text_encoder(dim=512)
        emb = encoder(urls).astype(np.float32) if urls else np.zeros((0, 512), np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12

    sfx = f"_chunk{chunk_id}" if chunk_id is not None else ""
    dt = time.time() - t0
    meta = {
        "n_images": int(emb.shape[0]),
        "dims": int(emb.shape[1]) if emb.size else 0,
        "failures": int(n_failures),
        "chunk_id": chunk_id,
        "build_time_sec": dt,
    }
    store.save_npy(emb, f"{out_prefix}/img{sfx}.npy")
    store.save_parquet(pd.DataFrame({"asin": asins}), f"{out_prefix}/img_items{sfx}.parquet")
    store.save_json(meta, f"{out_prefix}/img_meta{sfx}.json")
    return emb, meta


def merge_image_chunks(out_prefix: str, n_chunks: int, store: Optional[ArtifactStore] = None):
    """img_chunk{i}.npy + img_items_chunk{i}.parquet -> img.npy + img_items.parquet."""
    pd = require_pandas()
    store = store or ArtifactStore()
    embs, frames = [], []
    for c in range(n_chunks):
        embs.append(np.asarray(store.load_npy(f"{out_prefix}/img_chunk{c}.npy")))
        frames.append(store.load_parquet(f"{out_prefix}/img_items_chunk{c}.parquet"))
    emb = np.concatenate(embs, axis=0)
    items = pd.concat(frames, ignore_index=True)
    store.save_npy(emb, f"{out_prefix}/img.npy")
    store.save_parquet(items, f"{out_prefix}/img_items.parquet")
    return emb, items


def fuse_stage(
    embeddings_prefix: str,
    out_prefix: Optional[str] = None,
    cfg: Optional[FusionConfig] = None,
    store: Optional[ArtifactStore] = None,
    items=None,
    device=None,
) -> Tuple[np.ndarray, Dict]:
    """txt.npy + img.npy + img_items.parquet (+ items) -> fused.npy +
    fusion_config.json, trained and applied on `device`.

    Image rows map to catalog rows by asin; items without images get the
    mean image embedding at inference."""
    from plotpointe_tpu_torch.models.fusion import fuse_all_items, train_fusion

    store = store or ArtifactStore()
    out_prefix = out_prefix or embeddings_prefix
    txt = np.asarray(store.load_npy(f"{embeddings_prefix}/txt.npy"))
    img = np.asarray(store.load_npy(f"{embeddings_prefix}/img.npy"))
    img_items = store.load_parquet(f"{embeddings_prefix}/img_items.parquet")
    if items is None:
        items = store.load_parquet(f"{embeddings_prefix}/items.parquet")

    asin = _column(items, "asin")
    catalog_row = {a: r for r, a in enumerate(asin)}
    img_row_for_item = np.full(len(asin), -1, dtype=np.int64)
    for img_row, a in enumerate(img_items["asin"]):
        r = catalog_row.get(a)
        if r is not None:
            img_row_for_item[r] = img_row

    cfg = cfg or FusionConfig(text_dim=txt.shape[1], img_dim=img.shape[1])
    t0 = time.time()
    model, history = train_fusion(txt, img, img_row_for_item, cfg, device=device)
    fused = fuse_all_items(model, txt, img, img_row_for_item)
    dt = time.time() - t0

    config_out = cfg.to_dict() | {
        "n_items": int(len(asin)),
        "n_with_images": int((img_row_for_item >= 0).sum()),
        "train_history": history,
        "build_time_sec": dt,
    }
    store.save_npy(fused, f"{out_prefix}/fused.npy")
    store.save_json(config_out, f"{out_prefix}/fusion_config.json")
    return fused, config_out
