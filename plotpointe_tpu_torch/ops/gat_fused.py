"""Fused single-head GAT attention forward: CUDA kernel + plain version.

Counterpart of `plotpointe_tpu/ops/gat_fused.py::attention_v3`'s forward
(`_fwd_kernel`). The kernel is `csrc/gat_fwd.cu`; `attention_fwd_plain` is
the same function in plain PyTorch, used for CPU tensors and as the
reference the kernel is held to on the card.

Rounding matches the TPU kernel: source rows are rounded to `hs_dtype`
before use (for the source logit term and the aggregation), the destination
logit term uses the f32 rows, and every sum is f32. The dropout mask
multiplies the numerator of the output only; the denominator sums the
unmasked numerators.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops import cuda_build as cb
from plotpointe_tpu_torch.ops.segment import EPS, edge_numerators

LAUNCHES = cb.COUNTERS["gat_fwd"]
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_mask(seed: int, ids: torch.Tensor, rate: float) -> torch.Tensor:
    """Stateless per-edge dropout mask, bit-exact to the JAX package's
    `_hash_mask`: a splitmix32-style hash of the canonical edge id xor a
    uint32 seed decides keep (1 / (1 - rate)) or drop (0). uint32 arithmetic
    is emulated in int64 with `& 0xFFFFFFFF`."""
    x = (ids.to(torch.int64) & _M32) ^ (int(seed) & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    thresh = min(int((1.0 - rate) * 4294967296.0), 4294967295)
    return (x < thresh).to(torch.float32) * (1.0 / (1.0 - rate))


def attention_fwd_plain(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                        mask: Optional[torch.Tensor] = None,
                        hs_dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, 1, D] f32, a_src/a_dst [1, D] -> (out [N, 1, D], den [N])."""
    h2 = h[:, 0, :].float()
    hs = h2.to(hs_dtype).float()
    num = edge_numerators(hs @ a_src[0], h2 @ a_dst[0], graph)  # [E]
    dst = graph.dst.long()
    den = torch.zeros(graph.n_nodes, dtype=torch.float32, device=h.device).index_add_(0, dst, num)
    w = num if mask is None else num * mask
    acc = torch.zeros_like(h2).index_add_(0, dst, w[:, None] * hs[graph.src.long()])
    return (acc / (den[:, None] + EPS))[:, None, :], den


def _check(h, a_src, a_dst, graph, mask, hs_dtype):
    n, heads, d = h.shape
    if heads != 1:
        raise ValueError(f"attention_fwd is single-head; got heads={heads}")
    if d % 32 != 0 or d > 512:
        raise ValueError(f"the attention kernel takes D a multiple of 32 up to 512; got D={d}")
    if n != graph.n_nodes:
        raise ValueError(f"h has {n} rows but the graph has {graph.n_nodes} nodes")
    if hs_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hs_dtype must be float32 or bfloat16; got {hs_dtype}")
    for name, t, dt in (("h", h, torch.float32), ("a_src", a_src, torch.float32),
                        ("a_dst", a_dst, torch.float32), ("src", graph.src, torch.int32),
                        ("row_ptr", graph.row_ptr, torch.int32)):
        if t.device != h.device or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} on {h.device}; got {t.dtype} on {t.device}")
    if a_src.shape != (1, d) or a_dst.shape != (1, d):
        raise ValueError(f"a_src/a_dst must be [1, {d}]")
    if mask is not None and (mask.shape != (graph.n_edges,) or mask.dtype != torch.float32
                             or mask.device != h.device):
        raise ValueError(f"mask must be float32 [{graph.n_edges}] on {h.device}")


def attention_fwd(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                  mask: Optional[torch.Tensor] = None,
                  hs_dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention forward. h [N, 1, D] f32 (D a multiple of 32, <= 512),
    a_src/a_dst [1, D] f32, mask [E] f32 over canonical edge ids or None.
    Returns (out [N, 1, D] f32, den [N] f32). Launches the CUDA kernel for
    CUDA tensors; runs `attention_fwd_plain` for CPU tensors."""
    _check(h, a_src, a_dst, graph, mask, hs_dtype)
    if h.device.type == "cpu":
        return attention_fwd_plain(h, a_src, a_dst, graph, mask, hs_dtype)
    n, _, d = h.shape
    h2 = h.reshape(n, d).contiguous()
    a_s, a_d = a_src.reshape(d).contiguous(), a_dst.reshape(d).contiguous()
    src, row_ptr = graph.src.contiguous(), graph.row_ptr.contiguous()
    m = None if mask is None else mask.contiguous()
    hs = torch.empty((n, d), dtype=torch.bfloat16, device=h.device) if hs_dtype == torch.bfloat16 else None
    gs = torch.empty(n, dtype=torch.float32, device=h.device)
    gd = torch.empty_like(gs)
    out = torch.empty((n, d), dtype=torch.float32, device=h.device)
    den = torch.empty_like(gs)
    fn = cb.entry("gat_fwd")
    with torch.cuda.device(h.device):
        rc = fn(cb.ptr(h2), cb.ptr(a_s), cb.ptr(a_d), cb.ptr(row_ptr), cb.ptr(src), cb.ptr(m),
                cb.ptr(hs), cb.ptr(gs), cb.ptr(gd), cb.ptr(out), cb.ptr(den), n, d,
                cb.stream_of(h))
    cb.check(rc, "gat_fwd")
    LAUNCHES.bump()
    return out[:, None, :], den
