"""Cosine kNN over L2-normalised rows: candidate kernels, their plain
versions, and the exact re-score.

Counterpart of `plotpointe_tpu/ops/knn_kernel.py::knn_topk_pallas` and its
kernels:
  exact  `_knn_kernel`       -> `csrc/knn_topk.cu`       (`knn_candidates`)
  fast   `_knn_kernel_fast`  -> `csrc/knn_topk_fast.cu`  (`knn_candidates_fast`)

A candidate kernel takes xn [N, d] f32 and R = min(k + SEL_MARGIN, K_PAD)
(one more in fast mode, as JAX selects) and returns per row the R best
columns by score, self and padding excluded, as (cand_idx [N, R] int32,
cand_score [N, R] f32) in descending order; equal scores order the smaller
column first, and slots no column reached hold -1 / -1e30. The exact kernel
scores f32-faithfully in three TF32 tensor-core passes over the split
`split_tf32` makes (as the TPU kernel's Precision.HIGHEST takes several bf16
passes), the fast one multiplies bf16-rounded rows and sums in f32.
`rescore_topk` then re-scores every candidate exactly in f32 (an elementwise
product summed over d, so no TF32 setting reaches it) and keeps the top k
with the same tie rule.

Where JAX selects on packed scores with truncated mantissas
(`ops/topk_kernel.py::pack_keys`), the port selects on the exact f32 scores
with a total order, so a kernel and its plain version choose the same set
from the same scores, duplicate rows included. Fast mode has no slot
pre-reduction (a TPU vector-unit economy): its selection is exact on its
bf16-product scores.

Each `*_plain` function is its kernel's function in plain PyTorch (blocked
f32 `torch.mm` with TF32 off, self masked, a top-R on keys that carry the
tie rule), used for CPU tensors and as the reference the kernel is held to
on the card. A wrapper launches its kernel for CUDA tensors (or raises) and
counts the launch. Inside the package's `reference_versions()`, `knn_topk`
takes the plain versions on any device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from plotpointe_tpu_torch import full_f32_matmul, reference_active
from plotpointe_tpu_torch.ops import cuda_build as cb

K_PAD = 128  # the most candidates a row keeps (the TPU kernel's lane width)
SEL_MARGIN = 8  # candidates beyond k that the exact re-score chooses from
NEG_INF = -1e30
PLAIN_BLOCK_ROWS = 1024  # rows of [rows, N] f32 scores the plain versions hold at once
RESCORE_ELEMS = 1 << 25  # f32 elements of the [rows, R, d] re-score gather at once

EXACT_LAUNCHES = cb.COUNTERS["knn_topk"]
FAST_LAUNCHES = cb.COUNTERS["knn_topk_fast"]


def n_candidates(k: int, mode: str = "exact") -> int:
    """R: candidates a row keeps for the re-score (fast mode one more)."""
    return min(k + SEL_MARGIN + (mode == "fast"), K_PAD)


def order_keys(score: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order ranks higher scores first and equal
    scores by smaller column: the f32 bits made monotone (after -0 -> +0),
    above 2**31 - 1 - col."""
    bits = (score.float() + 0.0).contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return (bits << 32) + (0x7FFFFFFF - col.to(torch.int64))


def _candidates_plain(x: torch.Tensor, r: int, block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[0]
    cand_i = torch.full((n, r), -1, dtype=torch.int32, device=x.device)
    cand_s = torch.full((n, r), NEG_INF, dtype=torch.float32, device=x.device)
    m = min(r, n)
    cols = torch.arange(n, device=x.device)
    with full_f32_matmul():
        for r0 in range(0, n, block_rows):
            r1 = min(n, r0 + block_rows)
            s = x[r0:r1] @ x.T  # [rows, N]
            own = torch.arange(r1 - r0, device=x.device)
            s[own, own + r0] = float("-inf")  # self
            top = torch.topk(order_keys(s, cols.expand_as(s)), m, dim=1).indices
            v = torch.gather(s, 1, top)
            real = v > NEG_INF / 2
            cand_i[r0:r1, :m] = torch.where(real, top, -1).to(torch.int32)
            cand_s[r0:r1, :m] = torch.where(real, v, NEG_INF)
    return cand_i, cand_s


def knn_candidates_plain(xn: torch.Tensor, r: int,
                         block_rows: int = PLAIN_BLOCK_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10's function: the top-R columns of f32 scores per row."""
    return _candidates_plain(xn.float(), r, block_rows)


def knn_candidates_fast_plain(xn: torch.Tensor, r: int,
                              block_rows: int = PLAIN_BLOCK_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 11's function: the same on bf16-rounded rows (f32 sums)."""
    return _candidates_plain(xn.to(torch.bfloat16).float(), r, block_rows)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 x: hi is x rounded to the nearest TF32 value (ties
    away from zero, as `cvt.rna.tf32.f32`; its 13 low mantissa bits zero) and
    lo = x - hi, exact in f32 with |lo| <= 2**-11 |x|. Kernel 10 sums
    lo.hi^T + hi.lo^T + hi.hi^T from them."""
    bits = x.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


def _check(xn: torch.Tensor, r: int) -> None:
    if xn.dim() != 2 or xn.shape[0] == 0 or xn.shape[1] == 0 or xn.dtype != torch.float32:
        raise ValueError(f"need xn [N, d] float32 with N, d > 0; got {tuple(xn.shape)} {xn.dtype}")
    if not 1 <= r <= K_PAD:
        raise ValueError(f"R must be in [1, {K_PAD}]; got {r}")


def _padded(x: torch.Tensor, mult: int) -> torch.Tensor:
    """x with zero features up to a multiple of `mult` (a zero adds nothing
    to a score), contiguous and 16-byte aligned."""
    if x.shape[1] % mult:
        x = torch.nn.functional.pad(x, (0, mult - x.shape[1] % mult))
    return cb.aligned(x)


def _launch(name: str, r: int, *xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = xs[0].shape
    cb.require_smem(name, r, "R")
    cand_i = torch.empty((n, r), dtype=torch.int32, device=xs[0].device)
    cand_s = torch.empty((n, r), dtype=torch.float32, device=xs[0].device)
    cb.launch(name, xs[0].device, *map(cb.ptr, xs), cb.ptr(cand_i), cb.ptr(cand_s), n, d, r)
    return cand_i, cand_s


def knn_candidates(xn: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10: xn [N, d] f32 -> (cand_idx [N, R] int32, cand_score [N, R] f32),
    scored in 3xTF32 on the card (`split_tf32`)."""
    _check(xn, r)
    if xn.is_cpu:
        return knn_candidates_plain(xn, r)
    hi, lo = split_tf32(_padded(xn, 4))
    out = _launch("knn_topk", r, hi, lo)
    EXACT_LAUNCHES.bump()
    return out


def knn_candidates_fast(xn: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 11: as `knn_candidates`, scored on bf16-rounded rows."""
    _check(xn, r)
    if xn.is_cpu:
        return knn_candidates_fast_plain(xn, r)
    out = _launch("knn_topk_fast", r, _padded(xn.to(torch.bfloat16), 8))
    FAST_LAUNCHES.bump()
    return out


def rescore_topk(xn: torch.Tensor, cand_idx: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-score of the candidates and the top k of them, higher
    score first, equal scores by smaller index: (idx [N, k] int32, sim [N, k]
    f32), -1 / -1e30 where a row has fewer than k candidates. Works in row
    chunks, so the [rows, R, d] gather stays near RESCORE_ELEMS."""
    x = xn.float()
    n, d = x.shape
    r = cand_idx.shape[1]
    idx = torch.empty((n, k), dtype=torch.int32, device=x.device)
    sim = torch.empty((n, k), dtype=torch.float32, device=x.device)
    chunk = max(1, RESCORE_ELEMS // (r * d))
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        ci = cand_idx[r0:r1].long()
        exact = (x[ci.clamp(min=0)] * x[r0:r1, None, :]).sum(-1)  # [rows, R]
        exact = torch.where(ci >= 0, exact, NEG_INF)
        pos = torch.topk(order_keys(exact, ci), k, dim=1).indices
        v, i = torch.gather(exact, 1, pos), torch.gather(ci, 1, pos)
        real = v > NEG_INF / 2
        idx[r0:r1] = torch.where(real, i, -1).to(torch.int32)
        sim[r0:r1] = torch.where(real, v, NEG_INF)
    return idx, sim


def knn_topk(xn: torch.Tensor, k: int, mode: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine neighbours of every row of xn [N, d] (L2-normalised f32):
    (idx [N, k] int32, sim [N, k] f32), self excluded, rows descending, sims
    exact f32 re-scores; -1 / -1e30 in the tail of a row with fewer than k
    neighbours. mode "exact" selects on f32 scores (kernel 10), "fast" on
    bf16-product scores (kernel 11; its recall against exact is measured, not
    guaranteed). The kernels' tiles are fixed, so JAX's block sizes have no
    counterpart here."""
    if mode not in ("exact", "fast"):
        raise ValueError(f"mode must be 'exact' or 'fast'; got {mode!r}")
    if not 1 <= k <= K_PAD:
        raise ValueError(f"k must be in [1, {K_PAD}]; got {k}")
    r = n_candidates(k, mode)
    if reference_active():
        plain = knn_candidates_plain if mode == "exact" else knn_candidates_fast_plain
        cand_idx, _ = plain(xn, r)
    else:
        kernel = knn_candidates if mode == "exact" else knn_candidates_fast
        cand_idx, _ = kernel(xn, r)
    return rescore_topk(xn, cand_idx, k)
