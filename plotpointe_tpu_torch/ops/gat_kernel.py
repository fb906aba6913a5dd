"""Attention dispatch: the counterpart of the JAX package's
`segment_softmax_attention_pallas`.

heads == 1 runs the fused attention kernel (`ops/gat_fused.attention_fwd`)
for any D that is a multiple of 32 up to 512. heads > 1 has no CUDA kernel
yet: on a CUDA tensor it raises, on a CPU tensor it runs the plain golden.
"""
from __future__ import annotations

import torch

from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops.gat_fused import attention_fwd
from plotpointe_tpu_torch.ops.segment import segment_softmax_attention


def segment_softmax_attention_kernel(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                                     graph: Graph,
                                     hs_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """h [N, H, D], a_src/a_dst [H, D] -> [N, H, D]. hs_dtype: the type source
    rows are rounded to in the fused kernel (heads == 1)."""
    heads = h.shape[1]
    if heads == 1:
        return attention_fwd(h, a_src, a_dst, graph, hs_dtype=hs_dtype)[0]
    if h.device.type == "cuda":
        raise NotImplementedError(
            "multi-head attention on CUDA needs the head-packed kernels "
            "(_fwd_kernel_mh / _bwd_kernel_mh), which are a later slice of the port")
    return segment_softmax_attention(h, a_src, a_dst, graph)
