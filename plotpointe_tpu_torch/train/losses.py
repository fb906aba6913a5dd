"""Ranking losses, the JAX package's formulas (`plotpointe_tpu/train/losses.py`).

BPR: -log(sigmoid(pos - neg) + 1e-8), mean.
BCE: binary cross-entropy with logits over [pos; neg] with labels [1; 0], in
     the stable form max(x, 0) - x * y + log(1 + exp(-|x|)).
"""
from __future__ import annotations

import torch


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.sigmoid(pos_scores - neg_scores) + 1e-8).mean()


def bce_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    logits = torch.cat([pos_scores, neg_scores], dim=0)
    labels = torch.cat([torch.ones_like(pos_scores), torch.zeros_like(neg_scores)], dim=0)
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


LOSSES = {"bpr": bpr_loss, "bce": bce_loss}
