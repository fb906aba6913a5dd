"""Encoder towers for the embedding stages.

Counterpart of `plotpointe_tpu/models/encoders.py`:

  - `hash_text_encoder`: deterministic featureless encoder (feature-hashing
    n-grams -> L2-normalized dense vector), a copy (numpy only). Needs no
    weights: the default in zero-egress environments.
  - `TransformerTextEncoder`: the all-MiniLM-L6-v2 shape (post-LN blocks,
    erf-GELU, mean pooling over valid tokens, L2).
  - `ViTImageEncoder`: the CLIP ViT-B/32 vision shape (pre-LN blocks,
    QuickGELU, CLS token, projection to 512, L2).

The towers are `nn.Module`s in plain PyTorch ops: the JAX towers are plain
XLA ops (einsum attention, softmax, layer norm, GELU), with no Pallas
kernel. Weights keep the JAX `[in, out]` layout and names, so `state_dict()`
keys are the JAX key-paths with dots (`['blocks'][0]['qkv']['w']` <->
`blocks.0.qkv.w`) and an encoder npz from either package's
`save_checkpoint` loads by key path (`load_params_npz`).

Random init (`init_params`) takes an explicit `torch.Generator`; the
stages seed it with 0 where JAX uses `jax.random.key(0)`, so the draws are
not JAX's. Tests carry JAX's parameters across (`encoder_params_from_jax`).
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from plotpointe_tpu_torch.train.checkpoint import load_checkpoint, params_from_jax


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


# ---------------------------------------------------------------------------
# Shared transformer blocks
# ---------------------------------------------------------------------------

# Converted real weights only reproduce the published embeddings with the
# activation the checkpoint was trained with: BERT/MiniLM erf-GELU, CLIP
# QuickGELU (x * sigmoid(1.702 x)).
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


def _uniform_(p: torch.Tensor, bound: float, g: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))


def _normal_(p: torch.Tensor, std: float, g: torch.Generator) -> None:
    p.copy_(std * torch.randn(p.shape, generator=g))


class Linear(nn.Module):
    """`x @ w + b` with `w` [in, out], the JAX layout."""

    def __init__(self, fan_in: int, fan_out: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out, device=device))
        self.b = nn.Parameter(torch.zeros(fan_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        """U(+-1/sqrt(fan_in)) for w and b, as JAX's `_linear_init`."""
        bound = 1.0 / math.sqrt(self.w.shape[0])
        _uniform_(self.w, bound, g)
        _uniform_(self.b, bound, g)


class LayerNorm(nn.Module):
    """Biased variance under rsqrt(var + eps), gain `g` and bias `b`."""

    def __init__(self, hidden: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(hidden, device=device))
        self.b = nn.Parameter(torch.zeros(hidden, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.g.shape, self.g, self.b, self.eps)


class Block(nn.Module):
    """One transformer block: pre-LN (ViT/CLIP) or post-LN (BERT)."""

    def __init__(self, hidden: int, ffn: int, heads: int, pre_ln: bool, act: str, ln_eps: float,
                 device=None):
        super().__init__()
        self.heads, self.pre_ln, self.act = heads, pre_ln, ACTIVATIONS[act]
        self.qkv = Linear(hidden, 3 * hidden, device)
        self.proj = Linear(hidden, hidden, device)
        self.ffn1 = Linear(hidden, ffn, device)
        self.ffn2 = Linear(ffn, hidden, device)
        self.ln1 = LayerNorm(hidden, ln_eps, device)
        self.ln2 = LayerNorm(hidden, ln_eps, device)

    def attn(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, h = x.shape
        d = h // self.heads
        q, k, v = (t.reshape(b, s, self.heads, d).transpose(1, 2)
                   for t in self.qkv(x).split(h, dim=-1))
        logits = q @ k.transpose(-1, -2) / math.sqrt(d)
        if keep is not None:
            # JAX's jnp.where(mask, logits, -1e9): a row with no valid key
            # attends uniformly (no NaN, as a boolean SDPA mask would give)
            logits = logits.masked_fill(~keep[:, None, None, :], -1e9)
        out = (logits.softmax(-1) @ v).transpose(1, 2).reshape(b, s, h)
        return self.proj(out)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn2(self.act(self.ffn1(x)))

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pre_ln:
            x = x + self.attn(self.ln1(x), keep)
            return x + self.ffn(self.ln2(x))
        x = self.ln1(x + self.attn(x, keep))
        return self.ln2(x + self.ffn(x))

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        for lin in (self.qkv, self.proj, self.ffn1, self.ffn2):
            lin.init_params(g)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / (x.norm(dim=-1, keepdim=True) + 1e-12)


# ---------------------------------------------------------------------------
# MiniLM-shaped text tower
# ---------------------------------------------------------------------------


class TransformerTextEncoder(nn.Module):
    """all-MiniLM-L6-v2 shape: vocab 30522, hidden 384, 6 layers, 12 heads,
    max_len 256, mean pooling over valid tokens, L2 normalize."""

    def __init__(self, vocab_size: int = 30522, hidden: int = 384, n_layers: int = 6,
                 heads: int = 12, ffn: int = 1536, max_len: int = 256, act: str = "gelu_exact",
                 ln_eps: float = 1e-12, device=None):
        super().__init__()
        self.vocab_size, self.hidden, self.n_layers, self.heads = vocab_size, hidden, n_layers, heads
        self.ffn, self.max_len, self.act, self.ln_eps = ffn, max_len, act, ln_eps
        self.tok_emb = nn.Parameter(torch.zeros(vocab_size, hidden, device=device))
        self.pos_emb = nn.Parameter(torch.zeros(max_len, hidden, device=device))
        self.ln_emb = LayerNorm(hidden, ln_eps, device)
        self.blocks = nn.ModuleList(Block(hidden, ffn, heads, False, act, ln_eps, device)
                                    for _ in range(n_layers))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerTextEncoder":
        """JAX's init distributions (embeddings N(0, 0.02), linears
        U(+-1/sqrt(fan_in)), unit LN gains), drawn from `generator` (a CPU
        generator gives the same values on every device)."""
        _normal_(self.tok_emb, 0.02, generator)
        _normal_(self.pos_emb, 0.02, generator)
        for blk in self.blocks:
            blk.init_params(generator)
        return self

    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """token_ids, mask: [B, S] -> [B, hidden] mean-pooled, L2-normalized."""
        s = token_ids.shape[1]
        x = self.ln_emb(self.tok_emb[token_ids.long()] + self.pos_emb[:s])
        keep = mask != 0
        for blk in self.blocks:
            x = blk(x, keep)
        m = mask[..., None].to(x.dtype)
        return _l2((x * m).sum(1) / m.sum(1).clamp_min(1.0))

    def tokenize(self, texts: List[str]) -> tuple:
        """Hash tokenizer (no vocab file needed): whitespace words -> hashed ids.
        With real MiniLM weights, plug a WordPiece tokenizer instead."""
        ids = np.zeros((len(texts), self.max_len), np.int32)
        mask = np.zeros((len(texts), self.max_len), np.float32)
        for i, t in enumerate(texts):
            words = (t or "").lower().split()[: self.max_len]
            for j, w in enumerate(words):
                h = hashlib.md5(w.encode()).digest()
                ids[i, j] = int.from_bytes(h[:4], "little") % self.vocab_size
            mask[i, : len(words)] = 1.0
        return ids, mask


# ---------------------------------------------------------------------------
# CLIP-ViT-B/32-shaped vision tower
# ---------------------------------------------------------------------------


class ViTImageEncoder(nn.Module):
    """CLIP ViT-B/32 vision shape: 224px, 32px patches (49 + CLS tokens),
    hidden 768, 12 layers, 12 heads, pre-LN, projection to 512."""

    def __init__(self, image_size: int = 224, patch: int = 32, hidden: int = 768,
                 n_layers: int = 12, heads: int = 12, ffn: int = 3072, out_dim: int = 512,
                 act: str = "quick_gelu", ln_eps: float = 1e-5, device=None):
        super().__init__()
        self.image_size, self.patch, self.hidden, self.n_layers = image_size, patch, hidden, n_layers
        self.heads, self.ffn, self.out_dim, self.act, self.ln_eps = heads, ffn, out_dim, act, ln_eps
        self.patch_proj = Linear(3 * patch * patch, hidden, device)
        self.cls = nn.Parameter(torch.zeros(hidden, device=device))
        self.pos_emb = nn.Parameter(torch.zeros(self.n_patches + 1, hidden, device=device))
        self.ln_pre = LayerNorm(hidden, ln_eps, device)
        self.ln_post = LayerNorm(hidden, ln_eps, device)
        self.proj = Linear(hidden, out_dim, device)
        self.blocks = nn.ModuleList(Block(hidden, ffn, heads, True, act, ln_eps, device)
                                    for _ in range(n_layers))

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ViTImageEncoder":
        """JAX's init distributions, drawn from `generator`."""
        self.patch_proj.init_params(generator)
        _normal_(self.cls, 0.02, generator)
        _normal_(self.pos_emb, 0.02, generator)
        self.proj.init_params(generator)
        for blk in self.blocks:
            blk.init_params(generator)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] (CLIP-normalized pixels) -> [B, out_dim] L2-normalized."""
        b, p = images.shape[0], self.patch
        g = self.image_size // p
        # patches flattened as (row, col, channel), the converter's order
        x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
        x = self.patch_proj(x)
        x = torch.cat([self.cls.expand(b, 1, self.hidden), x], dim=1) + self.pos_emb
        x = self.ln_pre(x)
        for blk in self.blocks:
            x = blk(x)
        return _l2(self.proj(self.ln_post(x[:, 0])))


def encoder_params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{JAX key-path string: array} (`['blocks'][0]['qkv']['w']`) -> a
    tower's f32 `state_dict` (`blocks.0.qkv.w`): the same weights in both
    packages."""
    return {k: v.float() for k, v in params_from_jax(flat).items()}


def load_params_npz(path: str, encoder: nn.Module) -> nn.Module:
    """Load a flat key-path npz (either package's `save_checkpoint`, e.g.
    `tools/convert_weights.py` output) into `encoder`; every key must match."""
    flat, _ = load_checkpoint(path)
    encoder.load_state_dict(encoder_params_from_jax(flat))
    return encoder
