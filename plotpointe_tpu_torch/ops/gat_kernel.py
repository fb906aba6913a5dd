"""Attention dispatch: the counterpart of the JAX package's
`segment_softmax_attention_pallas` (`gat_kernel.py:264-285`).

  heads == 1    the fused op `attention_v3` (kernel 1, B1, B2); D is
                zero-padded to a multiple of 32;
  2 to 8 heads  the head-packed op `attention_v3_mh` (kernels 8, 9 and B2
                per head); D is zero-padded to a power of two >= 32;
  more heads    one `attention_v3` pass per head, each with its own seed.
Zero columns add nothing to the logits and are sliced off afterwards, as the
JAX dispatch pads D to the TPU's 128 lanes.

Dropout seeds: one uint32 `seed` for up to 8 heads; above 8 heads one seed
per head (a sequence), which the JAX package derives as
`bits(fold_in(rng, head))` and the port's trainer draws from its generator.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops.gat_fused import MAX_PACKED_HEADS, attention_v3, attention_v3_mh


def resolve_hs_dtype(impl: str, device) -> torch.dtype:
    """The row type an `attn_impl` (or LightGCN `spmm_impl`) value means on
    `device`: `pallas`, and `auto` on CUDA, round gathered rows to bf16 (the
    JAX trainer's kernel path); `xla`, and `auto` on the CPU, keep them f32
    (the JAX golden's function). There is no separate golden path on the
    card."""
    if impl == "pallas" or (impl == "auto" and torch.device(device).type == "cuda"):
        return torch.bfloat16
    if impl in ("auto", "xla"):
        return torch.float32
    raise ValueError(f"unknown impl {impl!r} (expected auto|xla|pallas)")


def _pad_width(h, a_src, a_dst, width):
    pad = width - h.shape[-1]
    if not pad:
        return h, a_src, a_dst
    return F.pad(h, (0, pad)), F.pad(a_src, (0, pad)), F.pad(a_dst, (0, pad))


def segment_softmax_attention_kernel(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                                     graph: Graph, dropout_rate: float = 0.0,
                                     seed: Optional[Union[int, Sequence[int]]] = None,
                                     hs_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """h [N, H, D], a_src/a_dst [H, D] -> [N, H, D]. hs_dtype: the type the
    kernels round source rows to. dropout_rate and a uint32 seed (one per
    head above 8 heads) draw the hash masks over canonical edge ids."""
    heads, d = h.shape[1], h.shape[2]
    if heads > MAX_PACKED_HEADS:
        seeds = [None] * heads
        if dropout_rate > 0.0 and seed is not None:
            if isinstance(seed, int) or len(seed) != heads:
                raise ValueError(f"{heads} heads (> {MAX_PACKED_HEADS}) take one dropout seed per head")
            seeds = list(seed)
        return torch.cat([segment_softmax_attention_kernel(
            h[:, k:k + 1], a_src[k:k + 1], a_dst[k:k + 1], graph, dropout_rate, seeds[k], hs_dtype)
            for k in range(heads)], dim=1)
    if heads == 1:
        width, op = -(-d // 32) * 32, attention_v3
    else:
        width, op = max(32, 1 << (d - 1).bit_length()), attention_v3_mh
    hp, sp, dp = _pad_width(h, a_src, a_dst, width)
    out = op(hp, sp, dp, graph, dropout_rate=dropout_rate, seed=seed, hs_dtype=hs_dtype)
    return out[..., :d] if width != d else out
