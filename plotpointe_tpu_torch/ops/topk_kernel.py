"""Exact two-level top-K inner-product search over an item catalog.

Counterpart of `plotpointe_tpu/ops/topk_kernel.py::topk_mips_pallas`:

  phase 1 (`chunk_max`, kernel `csrc/topk_chunkmax.cu`, on `wgmma`): stream
      the catalog once and keep only the max score of each 128-item chunk
      per query;
  selection: exact `torch.topk` over the chunk maxima, r = min(k + 8,
      n_chunks) chunks ("exact") or k + 2 ("fast");
  phase 2 (`rescore`, kernel `csrc/topk_rescore.cu`): exact f32 scores of
      the selected chunks' items;
  a final `torch.topk` orders the survivors. Slots with no real candidate
      get index -1 and score -1e30.

Exactness: every chunk holding a true top-k item has a max >= the k-th
score, and at most k chunks can rank above it, so the top-(k + margin)
chunks contain the true top-k. Phase 1 scores on the tensor cores (bf16
tables in one pass, f32 tables in three TF32 passes over the hi/lo split of
`knn_kernel.split_tf32`, f32-faithful), phase 2 with f32 FMAs, so a chunk's
max may differ from the phase-2 score of its item by f32 rounding, as the
JAX kernel's MXU phase 1 differs from its phase 2: the margins (8 exact, 2
fast) absorb such ~1-ulp differences, as CHUNK_MARGIN does in JAX. The
selection uses f32 maxima (the JAX package's truncated packed keys are a
TPU device); ties at the k-th score may resolve to either index.

Each kernel wrapper runs its plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from plotpointe_tpu_torch.ops import cuda_build as cb

CHUNK = 128
CHUNK_MARGIN = 8
FAST_MARGIN = 2
NEG_INF = -1e30

CHUNKMAX_LAUNCHES = cb.COUNTERS["topk_chunkmax"]
RESCORE_LAUNCHES = cb.COUNTERS["topk_rescore"]


def n_chunks_of(n: int) -> int:
    return (n + CHUNK - 1) // CHUNK


def chunk_max_plain(item_vecs: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """[B, n_chunks] f32: max of Q[b] . X[i] over each 128-item chunk."""
    n = item_vecs.shape[0]
    scores = queries.float() @ item_vecs.float().T  # [B, N]
    pad = n_chunks_of(n) * CHUNK - n
    scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    return scores.view(scores.shape[0], -1, CHUNK).amax(dim=2)


def rescore_plain(item_vecs: torch.Tensor, queries: torch.Tensor,
                  chunk_id: torch.Tensor) -> torch.Tensor:
    """[B, R, 128] f32 scores of the items of chunks chunk_id [B, R]; NEG_INF past N."""
    n = item_vecs.shape[0]
    item = chunk_id.long()[:, :, None] * CHUNK + torch.arange(CHUNK, device=chunk_id.device)
    rows = item_vecs[item.clamp(max=n - 1)].float()  # [B, R, 128, D]
    s = torch.einsum("brcd,bd->brc", rows, queries.float())
    return torch.where(item < n, s, torch.full_like(s, NEG_INF))


def _check_table(item_vecs: torch.Tensor, queries: torch.Tensor) -> None:
    if item_vecs.dim() != 2 or queries.dim() != 2 or item_vecs.shape[1] != queries.shape[1]:
        raise ValueError(f"need item_vecs [N, D] and queries [B, D]; got "
                         f"{tuple(item_vecs.shape)} and {tuple(queries.shape)}")
    if item_vecs.shape[0] == 0 or queries.shape[0] == 0:
        raise ValueError("empty catalog or query batch")
    if item_vecs.dtype not in (torch.float32, torch.bfloat16) or queries.dtype != item_vecs.dtype:
        raise ValueError(f"item_vecs and queries must share float32 or bfloat16; got "
                         f"{item_vecs.dtype} and {queries.dtype}")
    if queries.device != item_vecs.device:
        raise ValueError("item_vecs and queries must be on one device")
    vec = 16 // item_vecs.element_size()  # the kernels read rows in 16-byte loads
    if item_vecs.shape[1] % vec:
        raise ValueError(f"D must be a multiple of {vec} for {item_vecs.dtype}; got {item_vecs.shape[1]}")


def chunk_max(item_vecs: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Phase 1. item_vecs [N, D], queries [B, D], both float32 or both
    bfloat16 -> [B, ceil(N / 128)] f32 chunk maxima."""
    _check_table(item_vecs, queries)
    if item_vecs.is_cpu:
        return chunk_max_plain(item_vecs, queries)
    (n, d), b = item_vecs.shape, queries.shape[0]
    x, q = cb.aligned(item_vecs), queries.contiguous()
    cb.require_smem("topk_chunkmax", d)
    out = torch.empty((b, n_chunks_of(n)), dtype=torch.float32, device=x.device)
    cb.launch("topk_chunkmax", x.device, cb.ptr(x), cb.ptr(q), cb.ptr(out), n, b, d,
              int(x.dtype == torch.bfloat16))
    CHUNKMAX_LAUNCHES.bump()
    return out


def rescore(item_vecs: torch.Tensor, queries: torch.Tensor, chunk_id: torch.Tensor) -> torch.Tensor:
    """Phase 2. chunk_id [B, R] int32 in [0, ceil(N / 128)) -> [B, R, 128]
    exact f32 scores, NEG_INF for items past N."""
    _check_table(item_vecs, queries)
    (n, d), b = item_vecs.shape, queries.shape[0]
    if chunk_id.dim() != 2 or chunk_id.shape[0] != b or chunk_id.dtype != torch.int32 \
            or chunk_id.device != item_vecs.device:
        raise ValueError(f"chunk_id must be int32 [{b}, R] on {item_vecs.device}")
    if item_vecs.is_cpu:
        return rescore_plain(item_vecs, queries, chunk_id)
    r = chunk_id.shape[1]
    x, q, cid = cb.aligned(item_vecs), queries.contiguous(), chunk_id.contiguous()
    cb.require_smem("topk_rescore", d)
    out = torch.empty((b, r, CHUNK), dtype=torch.float32, device=x.device)
    cb.launch("topk_rescore", x.device, cb.ptr(x), cb.ptr(q), cb.ptr(cid), cb.ptr(out), n, b, r, d,
              int(x.dtype == torch.bfloat16))
    RESCORE_LAUNCHES.bump()
    return out


def topk_mips(item_vecs: torch.Tensor, queries: torch.Tensor, k: int, mode: str = "exact",
              stage: Optional[Callable[[str], None]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product search. item_vecs [N, D] and queries [B, D] in one
    dtype (float32, or bfloat16 for half the catalog stream). Returns
    (indices [B, k] int32, scores [B, k] f32), scores descending and exact
    f32 re-scores of the selected items. `stage`, if given, is called with
    each stage's name as the stage's work is queued: "chunk_max",
    "first_topk" (with the chunk ids' clamp and cast), "rescore" and
    "final_select" (the last `torch.topk`, the item ids, the -1 fill); a
    timing hook (a caller may record a CUDA event in it)."""
    if mode not in ("exact", "fast"):
        raise ValueError(f"mode must be 'exact' or 'fast'; got {mode!r}")
    n = item_vecs.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}]; got {k}")
    cm = chunk_max(item_vecs, queries)
    if stage is not None:
        stage("chunk_max")
    margin = CHUNK_MARGIN if mode == "exact" else FAST_MARGIN
    r = min(k + margin, cm.shape[1])
    _, sel = torch.topk(cm, r, dim=1)
    chunk_id = torch.clamp(sel, max=(n - 1) // CHUNK).to(torch.int32)
    if stage is not None:
        stage("first_topk")
    scores = rescore(item_vecs, queries, chunk_id).flatten(1)  # [B, R * 128], NEG_INF past N
    if stage is not None:
        stage("rescore")
    v, pos = torch.topk(scores, k, dim=1)
    item = chunk_id.long()[:, :, None] * CHUNK + torch.arange(CHUNK, device=cm.device)
    i = torch.gather(item.flatten(1), 1, pos)
    i = torch.where(v > NEG_INF / 2, i, torch.full_like(i, -1)).to(torch.int32)
    if stage is not None:
        stage("final_select")
    return i, v


def topk_mips_ref(item_vecs: torch.Tensor, queries: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain reference: the full f32 score matrix and one `torch.topk`."""
    scores = queries.float() @ item_vecs.float().T
    v, i = torch.topk(scores, k, dim=1)
    return i.to(torch.int32), v


def untied(v: torch.Tensor, rtol: float, atol: float) -> torch.Tensor:
    """[B, k] mask of the places of descending scores v [B, k + 1] (a
    reference's, one beyond k) that no tie straddles: neighbours within
    atol + rtol * |v| count as tied. Where a mask is true, any correct
    top-k holds the reference's index; elsewhere it may hold a tied one."""
    gap = (v[:, :-1] - v[:, 1:]).abs() <= atol + rtol * v[:, :-1].abs()
    tied = torch.zeros_like(v, dtype=torch.bool)
    tied[:, :-1] |= gap
    tied[:, 1:] |= gap
    return ~tied[:, :-1]
