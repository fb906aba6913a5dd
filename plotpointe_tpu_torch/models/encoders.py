"""Text encoders for the embedding stages: so far only `hash_text_encoder`.

A copy of `plotpointe_tpu/models/encoders.py::hash_text_encoder` (numpy
only; the port imports nothing of the JAX package). The transformer and
vision towers wait for the embedding-stage slice.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np


def hash_text_encoder(dim: int = 384, n_grams: int = 3, seed: int = 0, max_len: int = 256) -> Callable[[List[str]], np.ndarray]:
    """Feature-hashing encoder: character n-grams -> signed buckets -> L2 norm.

    Deterministic across processes/hosts, so artifacts are reproducible
    without any model weights. Similar texts share n-grams and therefore land
    near each other — enough signal for the kNN/fusion plumbing to be
    meaningful in tests and offline runs.

    Fully vectorized (numpy rolling polynomial hashes over a fixed-width byte
    matrix): encodes the 498k-item reference catalog in seconds; the naive
    per-ngram md5 formulation took hours at that scale.
    """
    P1, P2 = np.uint64(1099511628211), np.uint64(14695981039346656037)  # FNV-ish
    MIX = np.uint64(0x9E3779B97F4A7C15)

    def encode(texts: List[str]) -> np.ndarray:
        n_rows = len(texts)
        # fixed-width byte matrix (lowercased, truncated/padded with 0)
        mat = np.zeros((n_rows, max_len), dtype=np.uint64)
        lens = np.zeros(n_rows, dtype=np.int64)
        for i, t in enumerate(texts):
            b = (t or "").lower().encode("utf-8", "ignore")[:max_len]
            lens[i] = len(b)
            if b:
                mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        mat = mat + np.uint64(seed + 1)

        out = np.zeros((n_rows, dim), dtype=np.float32)
        pos = np.arange(max_len)
        with np.errstate(over="ignore"):
            for n in range(1, n_grams + 1):
                # rolling hash of every n-gram window: h = sum b[j+k] * P1^k, mixed
                h = np.zeros((n_rows, max_len - n + 1), dtype=np.uint64)
                for k in range(n):
                    h = h * P1 + mat[:, k : max_len - n + 1 + k]
                h = (h ^ (h >> np.uint64(33))) * MIX ^ P2
                h ^= h >> np.uint64(29)
                valid = pos[None, : max_len - n + 1] < (lens[:, None] - n + 1)
                bucket = (h % np.uint64(dim)).astype(np.int64)
                sign = np.where((h >> np.uint64(13)) & np.uint64(1), 1.0, -1.0).astype(np.float32)
                contrib = np.where(valid, sign, 0.0)
                np.add.at(out, (np.repeat(np.arange(n_rows), bucket.shape[1]), bucket.ravel()), contrib.ravel())
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.where(norms > 0, norms, 1.0)

    return encode
