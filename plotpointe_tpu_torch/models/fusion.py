"""Multimodal fusion MLP trained with InfoNCE contrastive loss.

Counterpart of `plotpointe_tpu/models/fusion.py` (plain PyTorch ops, as the
JAX module is plain XLA ops):
  FusionModel: concat(txt 384 + img 512) -> Linear 256 -> ReLU -> Dropout 0.1
               -> Linear 128; plus per-modality projection heads txt_proj /
               img_proj into the fused space. Weights keep the JAX [in, out]
               layout and names (`mlp1.w` <-> `['mlp1']['w']`).
  Loss: symmetric InfoNCE between the fused vector and the projected
  modalities, in-batch negatives, averaged over the two modalities.
  Inference over all items uses the mean image embedding for items without
  images.

Random draws come from explicit `torch.Generator`s seeded from `cfg.seed`:
the init from a CPU generator (the same parameters on every device), the
epoch permutations and dropout masks from a generator on the training
device. They are not `jax.random`'s.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from plotpointe_tpu_torch import resolve_device
from plotpointe_tpu_torch.config import FusionConfig
from plotpointe_tpu_torch.models.encoders import Linear, encoder_params_from_jax
from plotpointe_tpu_torch.utils.prng import stream_seed


class FusionModel(nn.Module):
    def __init__(self, cfg: FusionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mlp1 = Linear(cfg.text_dim + cfg.img_dim, cfg.hidden_dim, device)
        self.mlp2 = Linear(cfg.hidden_dim, cfg.output_dim, device)
        self.txt_proj = Linear(cfg.text_dim, cfg.output_dim, device)
        self.img_proj = Linear(cfg.img_dim, cfg.output_dim, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "FusionModel":
        """U(+-1/sqrt(fan_in)) for every weight and bias, as JAX's init."""
        for lin in (self.mlp1, self.mlp2, self.txt_proj, self.img_proj):
            lin.init_params(generator)
        return self

    def forward(self, txt: torch.Tensor, img: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fused vectors [B, output_dim]; `keep` is the dropout mask of the
        hidden layer (training), None at inference."""
        h = torch.relu(self.mlp1(torch.cat([txt, img], dim=-1)))
        if keep is not None:
            h = torch.where(keep, h / (1.0 - self.cfg.dropout), 0.0)
        return self.mlp2(h)


def fusion_params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{JAX key-path string: array} (`['mlp1']['w']`) -> `FusionModel`'s f32
    `state_dict` (`mlp1.w`): the same weights in both packages."""
    return encoder_params_from_jax(flat)


def infonce_fusion_loss(fused: torch.Tensor, txt: torch.Tensor, img: torch.Tensor,
                        temperature: float = 0.07) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric InfoNCE, diagonal labels. Returns (loss, loss_txt, loss_img)."""

    def _norm(x):
        return x / (x.norm(dim=-1, keepdim=True) + 1e-12)

    fz, tz, iz = _norm(fused), _norm(txt), _norm(img)
    labels = torch.arange(fused.shape[0], device=fused.device)
    lt = F.cross_entropy(fz @ tz.T / temperature, labels)
    li = F.cross_entropy(fz @ iz.T / temperature, labels)
    return (lt + li) / 2.0, lt, li


def fusion_loss(model: FusionModel, txt: torch.Tensor, img: torch.Tensor,
                keep: Optional[torch.Tensor] = None):
    """One batch's (loss, loss_txt, loss_img): InfoNCE between the fused
    vectors and the projected modalities."""
    fused = model(txt, img, keep)
    return infonce_fusion_loss(fused, model.txt_proj(txt), model.img_proj(img), model.cfg.temperature)


def dropout_keep(shape, p: float, generator: torch.Generator) -> Optional[torch.Tensor]:
    """A Bernoulli(1 - p) keep mask drawn on `generator`'s device, or None
    when `p` is 0."""
    if p <= 0:
        return None
    return torch.rand(shape, generator=generator, device=generator.device) < 1.0 - p


def train_fusion(
    txt: np.ndarray,
    img_aligned: np.ndarray,
    img_row_for_item: np.ndarray,
    cfg: Optional[FusionConfig] = None,
    init_params: Optional[Mapping[str, torch.Tensor]] = None,
    device=None,
) -> Tuple[FusionModel, Dict[str, float]]:
    """Train the fusion MLP on items that have both modalities.

    txt: [n_items, text_dim] catalog-ordered text embeddings.
    img_aligned: [n_img, img_dim] image embeddings.
    img_row_for_item: [n_items] int, row into img_aligned or -1 if no image.
    init_params: a starting `state_dict` (default: init from `cfg.seed`).

    Adam (optax's update: bias-corrected, eps outside the square root) over
    `n // batch_size` batches an epoch, the remainder dropped; history
    `epoch_{e}_loss` is the mean step loss of epoch e (from 1)."""
    dev = resolve_device(device)
    cfg = cfg or FusionConfig(text_dim=txt.shape[1], img_dim=img_aligned.shape[1])
    model = FusionModel(cfg, dev)
    if init_params is None:
        model.init_params(torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(init_params)
    g = torch.Generator(device=dev).manual_seed(stream_seed(cfg.seed, 1, 0))

    has_img = np.flatnonzero(img_row_for_item >= 0)
    txt_all = torch.as_tensor(np.asarray(txt[has_img], np.float32), device=dev)
    img_all = torch.as_tensor(np.asarray(img_aligned[img_row_for_item[has_img]], np.float32),
                              device=dev)
    n = len(has_img)
    bs = min(cfg.batch_size, n)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)

    history = {}
    steps_per_epoch = max(1, n // bs)
    for epoch in range(cfg.epochs):
        perm = torch.randperm(n, generator=g, device=dev)
        tot = torch.zeros((), device=dev)
        for s in range(steps_per_epoch):
            idx = perm[s * bs : (s + 1) * bs]
            keep = dropout_keep((bs, cfg.hidden_dim), cfg.dropout, g)
            loss, _, _ = fusion_loss(model, txt_all[idx], img_all[idx], keep)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot += loss.detach()
        history[f"epoch_{epoch + 1}_loss"] = float(tot) / steps_per_epoch
    return model, history


@torch.no_grad()
def fuse_all_items(
    model: FusionModel,
    txt: np.ndarray,
    img_aligned: np.ndarray,
    img_row_for_item: np.ndarray,
    batch_size: int = 8192,
) -> np.ndarray:
    """Inference over ALL items on the model's device: each item's image row,
    or the mean image embedding for items without one; rows L2-normalized
    with +1e-8 (the JAX package's)."""
    cfg = model.cfg
    dev = model.mlp1.w.device
    img = torch.as_tensor(np.asarray(img_aligned, np.float32), device=dev)
    mean_img = img.mean(0) if len(img) else torch.zeros(cfg.img_dim, device=dev)
    rows = torch.as_tensor(np.asarray(img_row_for_item), device=dev)
    outs = []
    for s in range(0, len(txt), batch_size):
        r = rows[s : s + batch_size]
        ib = mean_img.expand(len(r), -1)
        if len(img):
            ib = torch.where((r >= 0)[:, None], img[r.clamp_min(0)], ib)
        fused = model(torch.as_tensor(np.asarray(txt[s : s + batch_size], np.float32), device=dev), ib)
        outs.append(fused / (fused.norm(dim=-1, keepdim=True) + 1e-8))
    return torch.cat(outs).cpu().numpy() if outs else np.zeros((0, cfg.output_dim), np.float32)
