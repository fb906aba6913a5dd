"""Exact two-level top-K inner-product search over an item catalog.

Counterpart of `plotpointe_tpu/ops/topk_kernel.py::topk_mips_pallas`:

  phase 1 (`chunk_max`, kernel `csrc/topk_chunkmax.cu`, on `wgmma`): stream
      the catalog once and keep only the max score of each 128-item chunk
      per query;
  first selection (`select_chunks`, kernel `csrc/topk_select.cu`): the
      r = min(k + 8, n_chunks) chunks ("exact") or k + 2 ("fast") of
      largest max, written in ascending chunk order;
  phase 2 (`rescore`, kernel `csrc/topk_rescore.cu`): exact f32 scores of
      the selected chunks' items;
  final selection (`select_items`, the same select kernel): the top k of
      the survivors, descending, as item ids. Slots with no real candidate
      get index -1 and score -1e30.

Exactness: every chunk holding a true top-k item has a max >= the k-th
score, and at most k chunks can rank above it, so the top-(k + margin)
chunks contain the true top-k. Phase 1 scores on the tensor cores (bf16
tables in one pass, f32 tables in three TF32 passes over the hi/lo split of
`knn_kernel.split_tf32`, f32-faithful), phase 2 with f32 FMAs, so a chunk's
max may differ from the phase-2 score of its item by f32 rounding, as the
JAX kernel's MXU phase 1 differs from its phase 2: the margins (8 exact, 2
fast) absorb such ~1-ulp differences, as CHUNK_MARGIN does in JAX. The
selections use f32 values (the JAX package's truncated packed keys are a
TPU device).

Ties: both selections rank by (value descending, position ascending), the
order of `lax.top_k` and of a stable descending sort. Since the first
selection lists the chunks in ascending order, a position in the final
selection's [B, r * 128] rows follows the item index, so equal scores go
to the smaller item index, as `lax.top_k` over the full score matrix
orders them: where the scores are exact (copied rows score alike), the
result is that of `lax.top_k(q @ X.T, k)`. With ties at the k-th score, a
tied item of smaller index lies in a selected chunk: the chunks of max
equal to the k-th score are taken in ascending order, each holds one tied
item at least, and the margin leaves room for every one needed.

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
SELECT_LAUNCHES = cb.COUNTERS["topk_select"]
SELECT_SORT_CAP = 2048  # csrc/topk_select.cu's SORT_CAP: a final selection of more sorts through scratch
_FIRST, _FINAL = 0, 1  # the select kernel's modes


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


def select_topk_plain(x: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top r of each row of x [B, W] f32: (values [B, r] descending,
    positions [B, r] int64), ties at equal value to the smaller position (a
    stable descending sort, the order of `lax.top_k`; -0 ranks as +0, NaN
    below every number)."""
    pos = torch.sort(-x, dim=1, stable=True).indices[:, :r]
    return torch.gather(x, 1, pos), pos


def select_chunks_plain(cm: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """The first selection: the r chunks of largest max in cm [B, n_chunks]
    (ties to the smaller chunk), as int32 chunk ids [B, r] in ascending
    order, clamped to the last chunk of an n-item catalog."""
    pos = select_topk_plain(cm, r)[1]
    return torch.sort(pos, dim=1).values.clamp(max=(n - 1) // CHUNK).to(torch.int32)


def select_items_plain(scores: torch.Tensor, chunk_id: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final selection: the top k of scores [B, R * 128] (the rescore's
    output for chunk_id [B, R]) as (item ids [B, k] int32, values [B, k]),
    values descending, ties to the smaller position; id -1 where the value
    is <= NEG_INF / 2."""
    v, pos = select_topk_plain(scores, k)
    item = torch.gather(chunk_id.long(), 1, pos // CHUNK) * CHUNK + pos % CHUNK
    return torch.where(v > NEG_INF / 2, item, torch.full_like(item, -1)).to(torch.int32), v


def _check_rows(x: torch.Tensor, r: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] == 0:
        raise ValueError(f"need a float32 [B, W] matrix; got {x.dtype} {tuple(x.shape)}")
    if not 0 < r <= x.shape[1]:
        raise ValueError(f"r must be in [1, {x.shape[1]}]; got {r}")


def select_chunks(cm: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """First selection. cm [B, n_chunks] f32 chunk maxima of an n-item
    catalog -> int32 chunk ids [B, r] of the r largest, ascending."""
    _check_rows(cm, r)
    if cm.is_cpu:
        return select_chunks_plain(cm, r, n)
    b, w = cm.shape
    cm = cm.contiguous()
    out = torch.empty((b, r), dtype=torch.int32, device=cm.device)
    cb.launch("topk_select", cm.device, cm.data_ptr(), b, w, r, _FIRST, (n - 1) // CHUNK, None,
              out.data_ptr(), None, None)
    SELECT_LAUNCHES.bump()
    return out


def select_items(scores: torch.Tensor, chunk_id: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final selection. scores [B, R * 128] f32 of the items of chunk_id
    [B, R] int32 -> (item ids [B, k] int32, -1 past the candidates; values
    [B, k] f32, descending)."""
    _check_rows(scores, k)
    b, w = scores.shape
    if chunk_id.dim() != 2 or chunk_id.dtype != torch.int32 or tuple(chunk_id.shape) != (b, w // CHUNK) \
            or w % CHUNK or chunk_id.device != scores.device:
        raise ValueError(f"chunk_id must be int32 [{b}, {w // CHUNK}] on {scores.device} for scores "
                         f"[{b}, {w}] (W a multiple of {CHUNK})")
    if scores.is_cpu:
        return select_items_plain(scores, chunk_id, k)
    scores, chunk_id = scores.contiguous(), chunk_id.contiguous()
    ids = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    v = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    scratch = (torch.empty((b, k), dtype=torch.int64, device=scores.device)
               if k > SELECT_SORT_CAP else None)
    cb.launch("topk_select", scores.device, scores.data_ptr(), b, w, k, _FINAL, 0, chunk_id.data_ptr(),
              ids.data_ptr(), v.data_ptr(), cb.ptr(scratch))
    SELECT_LAUNCHES.bump()
    return ids, v


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
    f32 re-scores of the selected items, ties to the smaller index. On the
    card it is four launches (chunk-max, select, rescore, select) with only
    allocations between them. `stage`, if given, is called with each
    stage's name as the stage's work is queued: "chunk_max", "first_topk"
    (the first selection), "rescore" and "final_select"; a timing hook (a
    caller may record a CUDA event in it)."""
    if mode not in ("exact", "fast"):
        raise ValueError(f"mode must be 'exact' or 'fast'; got {mode!r}")
    n = item_vecs.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}]; got {k}")
    cm = chunk_max(item_vecs, queries)
    if stage is not None:
        stage("chunk_max")
    margin = CHUNK_MARGIN if mode == "exact" else FAST_MARGIN
    chunk_id = select_chunks(cm, min(k + margin, cm.shape[1]), n)
    if stage is not None:
        stage("first_topk")
    scores = rescore(item_vecs, queries, chunk_id).flatten(1)  # [B, R * 128], NEG_INF past N
    if stage is not None:
        stage("rescore")
    i, v = select_items(scores, chunk_id, k)
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
