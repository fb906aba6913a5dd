"""Attention dispatch: the counterpart of the JAX package's
`segment_softmax_attention_pallas`.

heads == 1 runs the fused attention op (`ops/gat_fused.attention_v3`: the
forward kernel, and B1/B2 in the backward) for D up to 512; a D that is not
a multiple of 32 is zero-padded to one (zero columns add nothing to the
logits) and sliced back, as the JAX dispatch pads D to the TPU's 128 lanes.
heads > 1 has no CUDA kernels yet (the head-packed kernels 8 and 9): on a
CUDA tensor it raises; on a CPU tensor it runs the plain golden without
dropout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops.gat_fused import attention_v3
from plotpointe_tpu_torch.ops.segment import segment_softmax_attention


def resolve_hs_dtype(attn_impl: str, device) -> torch.dtype:
    """The row type an `attn_impl` value means on `device`: `pallas`, and
    `auto` on CUDA, round source rows to bf16 (the JAX trainer's kernel
    path); `xla`, and `auto` on the CPU, keep them f32 (the JAX golden's
    function). There is no separate golden path on the card."""
    if attn_impl == "pallas" or (attn_impl == "auto" and torch.device(device).type == "cuda"):
        return torch.bfloat16
    if attn_impl in ("auto", "xla"):
        return torch.float32
    raise ValueError(f"unknown attn_impl {attn_impl!r} (expected auto|xla|pallas)")


def segment_softmax_attention_kernel(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                                     graph: Graph, dropout_rate: float = 0.0,
                                     seed: Optional[int] = None,
                                     hs_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """h [N, H, D], a_src/a_dst [H, D] -> [N, H, D]. hs_dtype: the type source
    rows are rounded to in the fused kernels (heads == 1). dropout_rate and
    a uint32 seed draw the hash mask over canonical edge ids."""
    heads, d = h.shape[1], h.shape[2]
    if heads == 1:
        pad = -d % 32
        if pad:
            h = F.pad(h, (0, pad))
            a_src, a_dst = F.pad(a_src, (0, pad)), F.pad(a_dst, (0, pad))
        out = attention_v3(h, a_src, a_dst, graph, dropout_rate=dropout_rate, seed=seed,
                           hs_dtype=hs_dtype)
        return out[..., :d] if pad else out
    if h.device.type == "cuda":
        raise NotImplementedError(
            "multi-head attention on CUDA needs the head-packed kernels 8 and 9 "
            "(_fwd_kernel_mh / _bwd_kernel_mh), which are a later slice of the port")
    if dropout_rate > 0.0 and seed is not None:
        raise NotImplementedError(
            "multi-head attention dropout (per-head hash masks) is a later slice of the port")
    return segment_softmax_attention(h, a_src, a_dst, graph)
