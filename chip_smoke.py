#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (plotpointe_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--epochs 3] [--layers 2]

Drives the port's paths end to end at full width and holds every CUDA
kernel against its plain PyTorch version. The models: GAT (hidden 128, 1
head, 384-d item features, `--layers` deep), the 2-head GAT of the
reference's heads ablation (hidden 128, `--layers` deep) and LightGCN
(64-d, 3 propagation rounds). Phases, one JSON line each:

  device   the card (and `nvidia-smi` name + power limit on a line of its own)
  build    nvcc builds of the kernels, all sources at once
  data     seeded interactions at the Amazon-Electronics cardinalities
           (192,403 users x 63,001 items x 1,689,116 interactions, lognormal
           degree skew sigma 0.83 / 1.52) and 384-d item features
  check    each kernel vs its plain version on the card, at a small shape and
           at the main paths' shapes (tolerances below); kernels 1, 2, 3 and
           14 at widths above one column strip (D 1,024 on 40 nodes, D 544
           on the main graph); top-K's kernels 4 and 5 on the 498,196-row
           catalog at B 1, 8 and 64 (kernel 5 also equal bits on a second
           launch), the select kernel's two selections bit-equal to their
           plain versions on the same rows and on rows with exact ties, and
           on a long row of the per-request kind (k 2,000 and 5,000 over
           2,008 chunks' scores), and `topk_mips`'s indices against
           `topk_mips_ref`'s wherever untied; the attention ops' and the SpMM
           operator's gradients vs autograd of the plain goldens
  train    path 1, every launch counter set to 0 first: `train_from_artifacts`
           (interactions.npz + features npy -> `--epochs` optimizer steps of
           200,000 BPR triples with dropout 0.1 and bf16 rows, a 1,000-negative
           val eval per epoch, best checkpoint in the JAX npz format); losses
           must be finite and the attention kernels must have launched; then
           the first step with the kernels vs the same step with their plain
           versions (loss and every parameter gradient)
  main     path 2, counters set to 0 first: `export_item_embeddings` of the
           trained checkpoint on the card, then two stdlib HTTP servers (8
           single /recommend requests; 64 concurrent ones micro-batched);
           every reply must be 200 and its scores must match the plain CPU
           answer; the export must match the CPU export; every kernel of the
           path must have launched
  train_lightgcn
           path 3, counters set to 0 before its training and again before
           its serving: one full epoch of LightGCN's mini-batch protocol
           (batch 8,192, 5 negatives per positive, bf16 rows) through
           `train_from_artifacts`, a 1,000-negative val eval and the best
           checkpoint; the first step with kernel 7 vs the same step with
           its plain version; the export on the card vs the CPU export; 8
           /recommend requests on the 64-wide table vs the plain answer
  train_mh path 4, the same for the 2-head GAT: `--epochs` steps of 200,000
           triples with dropout 0.1 at bf16 rows (kernels 8, 9 and B2 per
           head), the first-step check, and the export on the card (kernel
           8, f32 rows) vs the CPU export
  graph_build
           path 5, counters set to 0 first: the graph-build stage at the
           reference's shapes through the CLI's functions in-process:
           `build-ui` on the interactions above, `build-subset` of a seeded
           498,196-row catalog (clustered rows, ~500 duplicated interacted
           rows) at 128 d (fused) and 384 d (text), `build-knn` on
           fused_interacted.npy (63,001 x 128, k 20, min similarity 0.3) and
           `cosine_knn_graph` on txt_interacted.npy (x 384): kernel 10 must
           have launched; the artifacts must hold no self edge, no index
           >= N, rows in descending order and the JAX stats keys. Then,
           counters at 0 again, `cosine_knn(impl="pallas", mode="fast")` on
           the text rows: kernel 11 must have launched. Then kernel 10 vs its
           plain version at both shapes, the edges of both graphs vs the
           plain path's, kernel 11 vs its plain version and vs kernel 10
  tooling  path 6, counters set to 0 first: `run_smoke()` in-process (its
           five checks; kernel 12), `python -m plotpointe_tpu_torch.cli smoke`
           in a subprocess (exit 0), then `measure_device_peaks()` (a bf16
           4096 x 8192 x 4096 matmul loop and kernel 6 over 256 MB), printed
           as {"measured_peaks": ...} and held to 0.5-1.05x the spec memory
           rate and <= 1.05x the spec bf16 rate; kernels 6 and 12 must have
           launched. Then kernels 6 and 12 vs their plain versions (exact) at
           the smoke's shape, a small one and 256 MB
  legacy   path 7, the legacy attention contracts on the main graph marked
           `.with_tiling()`: `GATModel.forward(train=True)` (dropout 0.1,
           384-d features, `--layers` deep) and the backward of a fixed
           linear loss at hidden 128 / 1 head (v2, kernel 14), hidden 64 /
           1 head (v1, kernel 13) and hidden 128 / 2 heads (v1, kernel 15),
           counters at 0 before each; each against the same call under
           `reference_versions()` (gradients within GRAD_TOL; the output
           within ATTN_TOL where rows stay f32). v2 runs at the main model
           and at V2_MODEL_SEEDS more, its output held to `v2_out_tol`:
           the last layer rounds rows to bf16, and rows that differ in the
           last f32 bit may round a bf16 step apart; beside each, a flip
           control (the plain path again with the last layer's weights one
           f32 ulp up) shows how far such flips alone move the output; each
           kernel must have launched
  anchor   path 8, the quality anchor: the anchor's data alone first (the
           generator's host seconds, peak host memory), then, counters at
           0, `cli anchor --scale full` in-process with the gate's defaults
           and the port's baseline file (`tools/anchor_baseline.json`):
           the chance, popularity, inverse-popularity and factor-oracle
           baselines, the untrained GAT, the reference protocol (20 epochs
           of one 200,000-sample Adam step, bf16 rows) and the 32-step
           beyond-parity leg (adam; the gate skips the adamw leg). The gate
           must print PASS; the dataset block and generator config must
           equal `docs/results/anchor_full_r05.json`'s and the baselines'
           NDCG@20 lie within 0.005 of its; kernels 1, 2 and 3 must have
           launched. Each leg's metrics and wall beside the archive's
  ablate   path 9, the anchor's data as interactions.npz with its 128-d
           (fused) and 384-d (txt) features, then, counters at 0, `cli
           ablate` in-process over the seven variants at 1 epoch of 200,000
           samples: no variant may report an error; kernels 1, 2, 3, 7, 8
           and 9 must have launched
  timing   CUDA-event times of each kernel, its plain version and, where one
           PyTorch call computes the same function, that call; the bound with
           its reckoning; `host_us_per_launch`, the host's time to issue one
           call of the kernel 12, 4 and 7 wrappers beside
           `torch.addcmul`, and one whole `topk_mips` call at B 1 and 8;
           kernel 1 with the export's f32 rows and the
           training step's bf16 rows and mask, split into its CUDA kernels and
           timed on a graph of the same size without degree skew; kernels 4,
           5 and the select kernel (both selections, beside `torch.topk` of
           the same rows) at B 1, 8 and 64 in f32 and bf16, and one
           `topk_mips` call split by CUDA events into chunk-max, the first
           selection, rescore and the final selection; the training step
           split into sampling, forward, backward and optimizer, and its
           device time by kernel with the idle share (torch.profiler); one
           eval pass; kernel 7 in both directions with `torch.sparse.mm` as
           its yardstick; kernels 8 and 9 per layer; the LightGCN and 2-head
           steps by phase, profiled; kernels 10 and 11 at the graph-build
           shapes beside a blocked `torch.mm` of the same product
  kernels  one {"kernels": [...]} line, each kernel with its bound at the spec
           peaks (`utils/profiling.GPU_SPECS`) and `sol_fraction_dev`, its
           bound at the measured peaks over its time
  last     {"ok": true, "device": {...}}

Exits non-zero, printing no result, without CUDA or without the package.
Nothing here imports JAX or the JAX package.

    python3 chip_smoke.py --compare-with DIR

times only kernels 7, 12, 13 and 15 and `host_us_per_launch` (`time_rule2`),
kernels 8, 3, 2 and 9 at the 2-head and GAT training shapes and kernels 8,
2 and 9 with f32 rows (`time_gather_trees`), kernels 4 and 5, the select
kernel (where the tree has it) and `topk_mips` at B 1, 8 and 64 in f32 and
bf16 and kernels 1 and 14 at the training and export shapes
(`time_topk_and_fwd_trees`), and kernels 10 and 11 on the graph-build
subsets at 63,001 x 128 and x 384 with the ptxas report of kernels 1-5,
8-11 and the select kernel, where the tree has them (`time_knn_trees`),
for the port in the checkout DIR (an earlier commit, say) and for this
one, each tree in a process of its own that builds its own kernels, in
turns (DIR, this, this, DIR) on one
card; both trees read the same graph and rows, saved once; every line
carries its "tree". Kernel 5's scores of the same chunks must be the same
bits in both trees.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)  # same rows, f32 sums, another order
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)  # tests/test_gat_fused.py:53-55: sums with cancellation
FENCE_TOL = dict(rtol=1e-5, atol=1e-5)  # at most 8 x 128 f32 terms, another order
EXACT = dict(rtol=0.0, atol=0.0)  # max (kernel 6) and x * 2 + 1 (kernel 12) round alike
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)  # f32 dot products of width 128, another order
# one training step, kernels vs plain versions, bf16 rows: the first layers
# differ in the last f32 bit, so a few second-layer rows round to another
# bf16 value; gradients summed over every item show it at ~2e-4 of their
# largest entry (the same band as the CPU test against JAX)
STEP_RTOL, STEP_ATOL_OF_MAX, LOSS_RTOL = 5e-4, 1e-3, 1e-5
V2_MODEL_SEEDS = (0, 5, 9, 11)  # legacy v2 model seeds drawn besides the main one
SERVE_RTOL = 1e-4  # served scores vs the plain CPU answer
CATALOG = 498_196  # the reference's serving catalog
CHUNK_ROWS = 128  # items per top-K chunk
SELECT_KERNELS = ("select_rows", "sort_tiles", "rank_tiles")  # csrc/topk_select.cu's kernels
SOURCES = {
    "gat_fwd": ("plotpointe_tpu_torch/csrc/gat_fwd.cu", "plotpointe_tpu/ops/gat_fused.py:91"),
    "gat_bwd_dst": ("plotpointe_tpu_torch/csrc/gat_bwd_dst.cu", "plotpointe_tpu/ops/gat_fused.py:185"),
    "gat_bwd_src": ("plotpointe_tpu_torch/csrc/gat_bwd_src.cu", "plotpointe_tpu/ops/gat_fused.py:344"),
    "gather_fence": ("plotpointe_tpu_torch/csrc/gather_fence.cu", "plotpointe_tpu/ops/gat_fused.py:43"),
    "topk_chunkmax": ("plotpointe_tpu_torch/csrc/topk_chunkmax.cu", "plotpointe_tpu/ops/topk_kernel.py:140"),
    "topk_rescore": ("plotpointe_tpu_torch/csrc/topk_rescore.cu", "plotpointe_tpu/ops/topk_kernel.py:175"),
    # the selections between the top-K kernels: XLA ops in the JAX package, not a Pallas kernel
    "topk_select": ("plotpointe_tpu_torch/csrc/topk_select.cu", "plotpointe_tpu/ops/topk_kernel.py:296"),
    "spmm_csr": ("plotpointe_tpu_torch/csrc/spmm_csr.cu", "plotpointe_tpu/ops/spmm_kernel.py:34"),
    "gat_fwd_mh": ("plotpointe_tpu_torch/csrc/gat_fwd.cu", "plotpointe_tpu/ops/gat_fused.py:460"),
    "gat_bwd_dst_mh": ("plotpointe_tpu_torch/csrc/gat_bwd_dst.cu", "plotpointe_tpu/ops/gat_fused.py:557"),
    "knn_topk": ("plotpointe_tpu_torch/csrc/knn_topk.cu", "plotpointe_tpu/ops/knn_kernel.py:44"),
    "knn_topk_fast": ("plotpointe_tpu_torch/csrc/knn_topk_fast.cu",
                      "plotpointe_tpu/ops/knn_kernel.py:80"),
    "stream_probe": ("plotpointe_tpu_torch/csrc/stream_probe.cu", "plotpointe_tpu/utils/profiling.py:79"),
    "smoke_affine": ("plotpointe_tpu_torch/csrc/smoke_affine.cu", "plotpointe_tpu/tools/smoke_tpu.py:60"),
    "fused_segment_reduce": ("plotpointe_tpu_torch/csrc/spmm_csr.cu",
                             "plotpointe_tpu/ops/gat_kernel.py:47"),
    "fused_layer": ("plotpointe_tpu_torch/csrc/gat_fwd.cu", "plotpointe_tpu/ops/gat_kernel.py:129"),
    "onehot_reduce": ("plotpointe_tpu_torch/csrc/spmm_csr.cu", "plotpointe_tpu/ops/gat_fused.py:291"),
}
# the kernels each path must launch; gather_fence is on none (the port's
# backward kernels gather rows themselves, so there are no two XLA gathers
# to order) and is only checked and timed
PATH_KERNELS = {"train": ("gat_fwd", "gat_bwd_dst", "gat_bwd_src"),
                "serve": ("gat_fwd", "topk_chunkmax", "topk_rescore", "topk_select"),
                "lightgcn_train": ("spmm_csr",),
                "lightgcn_serve": ("spmm_csr", "topk_chunkmax", "topk_rescore", "topk_select"),
                "mh_train": ("gat_fwd_mh", "gat_bwd_dst_mh", "gat_bwd_src"),
                "mh_export": ("gat_fwd_mh",),
                "graph_build": ("knn_topk",),
                "graph_build_fast": ("knn_topk_fast",),
                "tooling": ("smoke_affine", "stream_probe"),
                "legacy_v2": ("fused_layer",),
                "legacy_v1": ("fused_segment_reduce",),
                "legacy_v1_mh": ("onehot_reduce",),
                "anchor": ("gat_fwd", "gat_bwd_dst", "gat_bwd_src"),
                "ablate": ("gat_fwd", "gat_bwd_dst", "gat_bwd_src", "spmm_csr", "gat_fwd_mh",
                           "gat_bwd_dst_mh")}
# the legacy phase's configurations: (path, hidden, heads); v2 takes 1 head
# with D % 128 == 0, v1 the rest (64 is the reference's hidden-dim ablation)
LEGACY = (("legacy_v2", 128, 1), ("legacy_v1", 64, 1), ("legacy_v1_mh", 128, 2))
LIGHTGCN = dict(embed_dim=64, n_prop_layers=3, batch_size=8192, neg_per_pos=5)
# the quality anchor's archived JAX run at full shape, and how near the
# port's reference-free baselines must land (their negatives are other draws)
ARCHIVED_ANCHOR = "docs/results/anchor_full_r05.json"
ANCHOR_BASELINES = ("chance", "popularity", "inverse_popularity", "factor_oracle")
ANCHOR_BASELINE_TOL = 0.005
MH_HEADS = 2
# the libraries whose ptxas lines (registers, spills, shared memory) the build line carries
PTXAS_REPORTED = ("knn_topk", "knn_topk_fast", "gat_fwd", "gat_bwd_dst", "gat_bwd_src", "topk_chunkmax",
                  "topk_rescore", "topk_select")
KNN = dict(k=20, min_similarity=0.3)  # the pipeline's build-knn defaults
KNN_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 scores of the same rows, summed in another order
TIE_TOL = 1e-5  # candidates whose scores lie this close may swap places
FAST_RECALL_PLAIN, FAST_RECALL_EXACT = 0.999, 0.998
KNN_CLUSTERS, KNN_NOISE, KNN_DUPLICATES = 2000, 0.65, 500
KNN_STATS_KEYS = ["n_items", "n_edges", "k", "min_similarity", "avg_similarity",
                  "min_similarity_observed", "max_similarity", "avg_neighbors_per_item",
                  "items_with_full_k", "build_time_sec"]
UI_STATS_KEYS = ["n_users", "n_items", "n_edges", "sparsity", "user_degree_mean", "user_degree_std",
                 "user_degree_min", "user_degree_max", "item_degree_mean", "item_degree_std",
                 "item_degree_min", "item_degree_max", "build_time_sec"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def spec() -> dict:
    """The card's published peaks: the port's one table."""
    from plotpointe_tpu_torch.utils.profiling import GPU_SPECS, detect_generation

    return GPU_SPECS[detect_generation()]


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """Least time in ms for `nbytes` of memory traffic and `ops` operations
    of `dtype` at the spec peaks (f32 off the tensor cores; bf16 and TF32 on
    them)."""
    s = spec()
    peak = {"float32": s["f32_tflops"], "bfloat16": s["bf16_tflops"],
            "tfloat32": s["tf32_tflops"]}[dtype] * 1e12
    t_bytes, t_ops = nbytes / (s["hbm_gbps"] * 1e9), ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sol_fraction_dev(row: dict, peaks: dict) -> float:
    """The row's bound at the measured peaks over its time: a bytes bound
    scales with the measured memory rate, a bf16 operations bound with the
    measured matmul rate; an f32 or a TF32 operations bound keeps the spec
    rate (no probe measures f32 off the tensor cores, or TF32)."""
    s = spec()
    b = row["bound_ms"]
    if row["bound_by"] == "bytes":
        b *= s["hbm_gbps"] / peaks["hbm_gbps"]
    elif row.get("ops_dtype") == "bfloat16":
        b *= s["bf16_tflops"] / peaks["tflops"]
    return b / row["ms"]


def gather_ms(nbytes: dict, n_gathers: int, row_bytes: int) -> float:
    """The gather ceiling in ms: the compulsory bytes plus one gathered row
    per entry, all from device memory at the spec rate, as if no gathered
    row hit in the L2 (a kernel whose rows do hit can land below it)."""
    return (sum(nbytes.values()) + n_gathers * row_bytes) / (spec()["hbm_gbps"] * 1e9) * 1e3


def topk_bound(b: int, n: int, d: int, dname: str) -> dict:
    """Kernel 4's bound for b queries over n x d rows of `dname`: the catalog
    and the queries read once, the [b, ceil(n / 128)] maxima written; the
    2 b n d operations in the route the kernel takes (three TF32 passes for
    f32 tables, one bf16 pass). `bound_cuda_cores_ms` is the same work on
    the f32 CUDA cores, the yardstick of the kernel's earlier CUDA-core
    design."""
    sz = 4 if dname == "float32" else 2
    nbytes = {"x": n * d * sz, "q": b * d * sz, "out": b * (-(-n // 128)) * 4}
    ops = 2 * b * n * d
    route, passes, odt = ("3xTF32", 3, "tfloat32") if sz == 4 else ("bf16", 1, "bfloat16")
    b_ms, b_by = bound(sum(nbytes.values()), passes * ops, odt)
    return {"bound_ms": b_ms, "bound_by": b_by, "ops_dtype": odt, "ops_route": route,
            "bound_bytes": nbytes, "bound_ops": passes * ops,
            "bound_cuda_cores_ms": bound(sum(nbytes.values()), ops, "float32")[0]}


def rescore_bound(b: int, r: int, d: int, sz: int, cid) -> tuple[float, str]:
    """Kernel 5's bound for b queries of r chunks each (ids `cid`) over rows
    of `sz` bytes a value: each distinct chunk read once, the queries and
    ids read, the [b, r, 128] f32 scores written; the f32 FMAs of every
    score."""
    import torch

    uniq = int(torch.unique(cid).numel())
    return bound(uniq * CHUNK_ROWS * d * sz + b * d * sz + b * r * 4 + b * r * CHUNK_ROWS * 4,
                 2 * b * r * CHUNK_ROWS * d, "float32")


def topk_phase_split(x, q, k: int, iters: int = 20, warmup: int = 3) -> dict:
    """One exact-mode `topk_mips(x, q, k)` split into its four stages
    (chunk-max, the first selection, rescore, the final selection) by a
    CUDA event that its `stage` hook records as each stage ends. Each
    stretch runs from one event to the next on the stream, so it holds the
    idle time the host leaves between launches; each call starts after a
    synchronise, as a served batch does. `host_ms` is the host clock per
    synchronised call."""
    import torch

    from plotpointe_tpu_torch.ops.topk_kernel import topk_mips

    names = ("chunk_max", "first_topk", "rescore", "final_select")
    ev = {name: torch.cuda.Event(enable_timing=True) for name in ("start",) + names}

    def once():
        ev["start"].record()
        topk_mips(x, q, k, stage=lambda name: ev[name].record())

    for _ in range(warmup):
        once()
    torch.cuda.synchronize()
    sums = dict.fromkeys(names, 0.0)
    t0 = time.perf_counter()
    for _ in range(iters):
        once()
        torch.cuda.synchronize()
        for before, name in zip(("start",) + names, names):
            sums[name] += ev[before].elapsed_time(ev[name])
    host = (time.perf_counter() - t0) / iters * 1e3
    split = {name: v / iters for name, v in sums.items()}
    return {"split_ms": split, "device_ms": sum(split.values()), "host_ms": host, "iters": iters}


def fwd_mh_bytes(n: int, e: int, hh: int, d: int, masked: bool) -> dict:
    """The attention forward's compulsory bytes at hh heads (kernels 1 and
    14 at one, 8 at more): each input read once, each output written once
    (the rounded rows and the per-edge row gathers are not)."""
    return {"h": n * hh * d * 4, "a": 2 * hh * d * 4, "row_ptr": (n + 1) * 4, "src": e * 4,
            "mask": hh * e * 4 if masked else 0, "out": n * hh * d * 4, "den": n * hh * 4}


def bwd_dst_bytes(n: int, e: int, hh: int, d: int, isz: int, masked: bool) -> dict:
    """B1's compulsory bytes at hh heads (kernel 2 at one, 9 at more): each
    input read once, each output written once; the per-edge row gathers and
    the per-block partial rows of d a_src (a scratch buffer of this design)
    are not compulsory traffic."""
    return {"rows": n * hh * d * isz, "g": n * hh * d * 4, "out": n * hh * d * 4, "src": e * 4,
            "mask": hh * e * 4 if masked else 0, "row_ptr": (n + 1) * 4, "gs_gd_den": 3 * n * hh * 4,
            "de_sum_godot": 2 * n * hh * 4, "da_src": hh * d * 4}


def bwd_src_bytes(n: int, e: int, d: int, isz: int) -> dict:
    """B2's compulsory bytes with the mask: each input read once, dh
    written once (the per-edge cotangent gathers are not)."""
    return {"rows": n * d * isz, "g_rounded": n * d * isz, "a_src": d * 4,
            "gs_gd_den_godot": 4 * n * 4, "t_ptr": (n + 1) * 4, "t_dst": e * 4,
            "t_eid": e * 4, "mask": e * 4, "dh": n * d * 4}


def amazon_shaped_interactions(seed: int, n_users=192_403, n_items=63_001, n=1_689_116):
    """Interactions as column arrays: lognormal user/item degree weights, and
    every user and item in at least one row (the reference's counts are of
    users and items that interacted)."""
    rng = np.random.default_rng(seed)
    wu = rng.lognormal(0.0, 0.83, n_users)
    wi = rng.lognormal(0.0, 1.52, n_items)
    inter = {
        "user_id": rng.choice(n_users, n, p=wu / wu.sum()).astype(np.int64),
        "asin": rng.choice(n_items, n, p=wi / wi.sum()).astype(np.int64),
        "ts": rng.integers(1_100_000_000, 1_500_000_000, n),
        "rating": rng.integers(1, 6, n).astype(np.float64),
    }
    inter["user_id"][:n_users] = rng.permutation(n_users)
    inter["asin"][:n_items] = rng.permutation(n_items)
    return inter


def random_gat_params(rng, n_users: int, feat_dim: int, hidden: int, layers: int, heads: int = 1):
    """JAX-keyed parameters with the JAX package's init distributions."""
    def xavier(shape, fan_in, fan_out):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-a, a, shape).astype(np.float32)

    lim = 1.0 / math.sqrt(feat_dim)
    p = {"['user_emb']": (0.1 * rng.normal(size=(n_users, hidden))).astype(np.float32),
         "['item_proj']['w']": rng.uniform(-lim, lim, (feat_dim, hidden)).astype(np.float32),
         "['item_proj']['b']": np.zeros(hidden, np.float32)}
    for li in range(layers):
        p[f"['layers'][{li}]['w']"] = xavier((hidden, heads, hidden), hidden, hidden)
        p[f"['layers'][{li}]['a_src']"] = xavier((heads, hidden), 1, hidden)
        p[f"['layers'][{li}]['a_dst']"] = xavier((heads, hidden), 1, hidden)
    return p


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, keys=("",), iters: int = 20, warmup: int = 3, tries: int = 3):
    """Mean device time per call of `fn`, summed over its CUDA kernels whose
    names hold one of `keys` (every kernel by default), from torch.profiler:
    the kernels' own run time. CUDA events around back-to-back calls take
    in the host's time to issue each call where that is the longer, as it
    is for the few-microsecond top-K kernels. A profile that recorded no
    such kernel (it happens) is taken again; None after `tries` of them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages() if any(k in e.key for k in keys))
        if total > 0:
            return total / iters / 1e3
    return None


def host_us_per_launch(fn, calls: int = 200, warmup: int = 20) -> float:
    """Host microseconds per call of `fn` over `calls` calls with no
    synchronise inside the loop, after `warmup` calls and a synchronise:
    what the calling thread spends to issue one launch (the card runs
    behind it; 200 calls stay within the launch queue where the card takes
    longer)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def counts() -> dict:
    from plotpointe_tpu_torch.ops import cuda_build

    return {k: c.count for k, c in cuda_build.COUNTERS.items()}


class Errors:
    """max |kernel - plain| per kernel over every comparison of this run.
    Each check line also gives max |kernel - plain| / (atol + |plain|): the
    relative error, with atol keeping it finite where the plain value is 0."""

    def __init__(self):
        self.max = {}

    def check(self, name: str, what: str, got, want, tol) -> None:
        import torch

        diff = (got - want).abs()
        err = float(diff.max()) if got.numel() else 0.0
        rel = float((diff / (tol["atol"] + want.abs())).max()) if got.numel() else 0.0
        ok = bool(torch.allclose(got, want, **tol))
        self.max[name] = max(self.max.get(name, 0.0), err)
        emit({"phase": "check", "kernel": name, "case": what, "max_abs_err": err,
              "max_rel_err": rel, "tol": tol, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} ({what}) disagrees with its plain version: max abs err {err}")

    def equal(self, name: str, what: str, got, want) -> None:
        """A kernel that only compares and moves values must give its plain
        version's bits: every tensor of `got` equal to its counterpart."""
        import torch

        err = max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        ok = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
        self.max[name] = max(self.max.get(name, 0.0), err)
        emit({"phase": "check", "kernel": name, "case": what + ": equal bits", "max_abs_err": err,
              "ok": ok})
        if not ok:
            raise AssertionError(f"{name} ({what}) differs from its plain version: max abs err {err}")

    def same_bits(self, name: str, what: str, got, again) -> None:
        """Two launches of a kernel on the same inputs must give equal bits."""
        import torch

        ok = all(torch.equal(a, b) for a, b in zip(got, again))
        emit({"phase": "check", "kernel": name, "case": what + " launched twice: equal bits", "ok": ok})
        if not ok:
            raise AssertionError(f"{name} ({what}) gave other bits on a second launch")


def post(url: str, payload) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=3, help="optimizer steps of the train phase")
    ap.add_argument("--layers", type=int, default=2, help="GAT depth of the trained model")
    ap.add_argument("--compare-with", metavar="DIR", default=None,
                    help="only time kernels 1-5, 7-15, the select kernel and host_us_per_launch, for "
                         "the port in DIR (another checkout) and this one, in turns on this card")
    ap.add_argument("--rows-of", metavar="DIR", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--graph", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--knn-rows", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tree", default="change", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rows_of:  # time the package of that checkout, not this one
        sys.path.insert(0, str(Path(args.rows_of).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.rows_of:
        return rows_of(args)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.compare_with:
            return run_compare(args, Path(tmp))
        return run(args, Path(tmp))


GRAPH_ARRAYS = ("row_ptr", "src", "t_ptr", "t_dst", "t_eid")


def rows_of(args) -> int:
    """`time_rule2`, `time_gather_trees` and `time_topk_and_fwd_trees` with
    the package of the checkout `--rows-of` on the graph saved at `--graph`,
    then `time_knn_trees` on the rows saved at `--knn-rows`; each line
    labelled `--tree`."""
    from types import SimpleNamespace

    import torch

    import plotpointe_tpu_torch

    root = Path(plotpointe_tpu_torch.__file__).resolve().parents[1]
    if root != Path(args.rows_of).resolve():
        raise AssertionError(f"imported the package of {root}, not of {args.rows_of}")
    torch.backends.cuda.matmul.allow_tf32 = False
    z = torch.load(args.graph)
    graph = SimpleNamespace(n_nodes=int(z["n_nodes"]), n_edges=int(z["n_edges"]),
                            **{k: z[k].to("cuda") for k in GRAPH_ARRAYS})
    time_rule2({}, graph, "cuda", tree=args.tree)
    time_gather_trees(graph, "cuda", args.tree)
    time_topk_and_fwd_trees(graph, "cuda", args.tree, Path(args.graph).parent)
    del graph, z
    torch.cuda.empty_cache()
    from plotpointe_tpu_torch.graphs.knn import l2_normalize

    feats = {k: l2_normalize(v.to("cuda")) for k, v in torch.load(args.knn_rows).items()}
    time_knn_trees(feats, args.tree)
    return 0


def run_compare(args, work: Path) -> int:
    """Kernels 7, 12, 13 and 15, the launch path's host time, kernels 8, 3,
    2, 9, 4, 5, the select kernel, 1 and 14 on the main graph and catalog of
    `run` (kernel 5's scores held equal between the trees), then kernels 10
    and 11 on its graph-build subsets
    (`build-subset` of the seeded catalog at 128 and 384 d), for the
    checkout `--compare-with` and this one, each in a process of its own
    that builds that checkout's kernels, in turns (the other, this, this,
    the other)."""
    import torch

    from plotpointe_tpu_torch import cli
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph

    name = phase_device()
    inter = amazon_shaped_interactions(args.seed)
    s = build_splits(inter, *build_node_maps(inter))
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    torch.save({"n_nodes": graph.n_nodes, "n_edges": graph.n_edges,
                **{k: getattr(graph, k) for k in GRAPH_ARRAYS}}, work / "graph.pt")
    staging, emb = write_graph_inputs(work, inter, args.seed)
    with contextlib.redirect_stdout(io.StringIO()):
        for feat in ("fused", "txt"):
            cli.main(["build-subset", "--staging-prefix", str(staging), "--features", str(emb / f"{feat}.npy"),
                      "--output-prefix", str(emb), "--feature-name", feat])
    torch.save({feat: torch.as_tensor(np.load(emb / f"{feat}_interacted.npy")) for feat in ("fused", "txt")},
               work / "knn_rows.pt")
    here = Path(__file__).resolve().parent
    other = Path(args.compare_with).resolve()
    for tree, root in (("parent", other), ("change", here), ("change", here), ("parent", other)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(here / "chip_smoke.py"), "--rows-of", str(root),
                               "--tree", tree, "--graph", str(work / "graph.pt"),
                               "--knn-rows", str(work / "knn_rows.pt")],
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        emit({"phase": "compare", "tree": tree, "root": str(root), "rc": proc.returncode,
              "seconds": time.perf_counter() - t0})
        if proc.returncode != 0:
            raise AssertionError(f"timing the {tree} tree failed: {proc.stderr[-3000:]}")
    # kernel 5 of this tree against the other's, on the same chunks: the same
    # FMAs in the same order give the same bits
    for mine in sorted(work.glob("rescore_change_*.pt")):
        got, want = torch.load(mine), torch.load(work / mine.name.replace("_change_", "_parent_"))
        same = torch.equal(got, want)
        emit({"phase": "compare", "kernel": "topk_rescore", "case": mine.stem[len("rescore_change_"):],
              "equal_bits_to_the_other_tree": same, "max_abs_diff": float((got - want).abs().max())})
        if not same:
            raise AssertionError(f"kernel 5 ({mine.stem}) gives other bits than the other tree's")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


# -- phases ---------------------------------------------------------------------


def phase_device() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    return name


def phase_build() -> None:
    from plotpointe_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    took = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": took,
          "ptxas": ptxas_report(PTXAS_REPORTED)})


def phase_data(args, rng, dev):
    import torch

    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.train.checkpoint import params_from_jax

    t0 = time.perf_counter()
    inter = amazon_shaped_interactions(args.seed)
    s = build_splits(inter, *build_node_maps(inter))
    feats = rng.normal(size=(s.n_items, 384)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w).to(dev)
    # the check and timing phases' attention inputs: layer 0 of a random GAT
    config = {"model_family": "gat", "n_users": s.n_users, "n_items": s.n_items, "feat_dim": 384,
              "hidden_dim": 128, "n_layers": 1, "heads": 1, "attn_dropout": 0.1, "use_bias": False}
    model = GATModel.from_config(config)
    model.load_state_dict(params_from_jax(random_gat_params(rng, s.n_users, 384, 128, 1)))
    model.to(dev)
    with torch.no_grad():
        x0 = model.node_features(torch.as_tensor(feats, device=dev))
        h0 = torch.einsum("nf,fhd->nhd", x0, model.layers[0].w).contiguous()
    a_s, a_d = model.layers[0].a_src.detach(), model.layers[0].a_dst.detach()
    emit({"phase": "data", "seconds": time.perf_counter() - t0, "n_users": s.n_users,
          "n_items": s.n_items, "n_interactions": len(inter["user_id"]), "n_train": s.n_train,
          "graph_nodes": graph.n_nodes, "graph_edges": graph.n_edges,
          "max_in_degree": int((graph.row_ptr[1:] - graph.row_ptr[:-1]).max()),
          "layers": args.layers, "hidden": 128, "feat_dim": 384, "catalog": [CATALOG, 128]})
    return inter, s, feats, graph, (h0, a_s, a_d)


def check_attention(errs, rng, label, g, h, a_s, a_d, dev):
    """Forward, B1, B2 and the attention op's gradients vs their plain versions."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst, attention_bwd_dst_plain, attention_bwd_src, attention_bwd_src_plain,
        attention_fwd, attention_fwd_plain, attention_v3, hash_mask, node_terms_plain)
    from plotpointe_tpu_torch.ops.segment import segment_softmax_attention

    n, d = g.n_nodes, h.shape[-1]
    ct = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev)
    mask = hash_mask(7, torch.arange(g.n_edges, device=dev), 0.1)
    with torch.no_grad():
        for rows_dt in (torch.float32, torch.bfloat16):
            for masked in (False, True):
                mk = mask if masked else None
                what = f"{label} N={n} E={g.n_edges} rows={str(rows_dt)[6:]} mask={masked}"
                got = attention_fwd(h, a_s, a_d, g, mask=mk, hs_dtype=rows_dt)
                want = attention_fwd_plain(h, a_s, a_d, g, mask=mk, hs_dtype=rows_dt)
                errs.check("gat_fwd", what + " out", got[0], want[0], ATTN_TOL)
                errs.check("gat_fwd", what + " den", got[1], want[1], ATTN_TOL)
                rows, gs, gd = node_terms_plain(h[:, 0], a_s, a_d, rows_dt)
                args = (rows, gs, gd, ct, want[0][:, 0], want[1], g, mk)
                got1, want1 = attention_bwd_dst(*args), attention_bwd_dst_plain(*args)
                for part, x, y in zip(("de_sum", "godot", "da_src"), got1, want1):
                    errs.check("gat_bwd_dst", f"{what} {part}", x, y, GRAD_TOL)
                errs.same_bits("gat_bwd_dst", what, got1, attention_bwd_dst(*args))
                args2 = (rows, ct.to(rows_dt), a_s, gs, gd, want[1], want1[1], g, mk)
                errs.check("gat_bwd_src", what + " dh", attention_bwd_src(*args2),
                           attention_bwd_src_plain(*args2), GRAD_TOL)
                del got, want, got1, want1, rows, args, args2
    # the attention op (forward kernel, B1, B2, glue) vs autograd of the golden
    got = [t.detach().clone().requires_grad_() for t in (h, a_s, a_d)]
    (attention_v3(*got, g, hs_dtype=torch.float32)[:, 0] * ct).sum().backward()
    want = [t.detach().clone().requires_grad_() for t in (h, a_s, a_d)]
    (segment_softmax_attention(*want, g)[:, 0] * ct).sum().backward()
    for part, x, y in zip(("dh", "da_src", "da_dst"), got, want):
        errs.check("attention_v3", f"{label} N={n} rows=float32 mask=False grad {part} vs golden "
                   "autograd", x.grad, y.grad, GRAD_TOL)
    sync()


def check_wide_attention(errs, rng, label, g, d, dev, configs) -> None:
    """Kernels 1, 2, 3 and 14 at a width above one column strip (512)
    against their plain versions, on seeded rows: the forward, B1 and B2
    for each (row type, masked) of `configs` (the strips share the logits
    taken from the full rows), and kernel 14 with the Bernoulli mask."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst, attention_bwd_dst_plain, attention_bwd_src, attention_bwd_src_plain,
        attention_fwd, attention_fwd_plain, hash_mask, node_terms_plain)
    from plotpointe_tpu_torch.ops.gat_kernel import fused_layer, fused_layer_plain, legacy_mask

    n = g.n_nodes

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)

    h, a_s, a_d, ct = t(n, 1, d), t(1, d, scale=0.05), t(1, d, scale=0.05), t(n, d)
    mask = hash_mask(7, torch.arange(g.n_edges, device=dev), 0.1)
    with torch.no_grad():
        for rows_dt, masked in configs:
            mk = mask if masked else None
            what = f"{label} N={n} E={g.n_edges} D={d} rows={str(rows_dt)[6:]} mask={masked}"
            got = attention_fwd(h, a_s, a_d, g, mask=mk, hs_dtype=rows_dt)
            want = attention_fwd_plain(h, a_s, a_d, g, mask=mk, hs_dtype=rows_dt)
            errs.check("gat_fwd", what + " out", got[0], want[0], ATTN_TOL)
            errs.check("gat_fwd", what + " den", got[1], want[1], ATTN_TOL)
            del got
            rows, gs, gd = node_terms_plain(h[:, 0], a_s, a_d, rows_dt)
            args = (rows, gs, gd, ct, want[0][:, 0], want[1], g, mk)
            got1, want1 = attention_bwd_dst(*args), attention_bwd_dst_plain(*args)
            for part, x, y in zip(("de_sum", "godot", "da_src"), got1, want1):
                errs.check("gat_bwd_dst", f"{what} {part}", x, y, GRAD_TOL)
            args2 = (rows, ct.to(rows_dt), a_s, gs, gd, want[1], want1[1], g, mk)
            errs.check("gat_bwd_src", what + " dh", attention_bwd_src(*args2),
                       attention_bwd_src_plain(*args2), GRAD_TOL)
            del want, got1, want1, rows, args, args2
            torch.cuda.empty_cache()
        m1 = legacy_mask(g, 1, 0.1, 7, dev)[:, 0].contiguous()
        errs.check("fused_layer", f"{label} N={n} E={g.n_edges} D={d} rows=bfloat16 mask=True",
                   fused_layer(h, a_s, a_d, g, m1), fused_layer_plain(h, a_s, a_d, g, m1), ATTN_TOL)
    del h, ct
    torch.cuda.empty_cache()
    sync()


def check_spmm(errs, rng, label, g, dev):
    """Kernel 7 in both directions (the LightGCN operator's forward and
    backward CSRs, its symmetric normalized values) vs its plain version,
    and the operator's gradient vs autograd of the plain golden."""
    import torch

    from plotpointe_tpu_torch.graphs.csr import symmetric_normalized_weights
    from plotpointe_tpu_torch.ops.segment import spmm as golden_spmm
    from plotpointe_tpu_torch.ops.spmm_kernel import make_spmm, spmm_csr, spmm_csr_plain

    vals = symmetric_normalized_weights(g)
    v = torch.as_tensor(vals, device=dev)
    dirs = (("dst", g.row_ptr, g.src, v), ("transpose", g.t_ptr, g.t_dst, v[g.t_eid.long()]))
    with torch.no_grad():
        for d in (64, 128):
            x = torch.as_tensor(rng.normal(size=(g.n_nodes, d)).astype(np.float32), device=dev)
            for rows_dt in (torch.float32, torch.bfloat16):
                for name, ptr, idx, vv in dirs:
                    what = f"{label} N={g.n_nodes} E={g.n_edges} D={d} rows={str(rows_dt)[6:]} {name}"
                    errs.check("spmm_csr", what, spmm_csr(x, vv, ptr, idx, rows_dt),
                               spmm_csr_plain(x, vv, ptr, idx, rows_dt), ATTN_TOL)
    x = torch.as_tensor(rng.normal(size=(g.n_nodes, 64)).astype(np.float32), device=dev)
    ct = torch.as_tensor(rng.normal(size=(g.n_nodes, 64)).astype(np.float32), device=dev)
    got, want = x.clone().requires_grad_(), x.clone().requires_grad_()
    (make_spmm(g, vals, torch.float32)(got) * ct).sum().backward()
    (golden_spmm(g, v, want) * ct).sum().backward()
    errs.check("make_spmm", f"{label} N={g.n_nodes} D=64 rows=float32 grad vs golden autograd",
               got.grad, want.grad, GRAD_TOL)
    sync()


def check_multihead(errs, rng, label, g, dev, layer=None):
    """Kernels 8 and 9 and B2 on one head's strided rows vs their plain
    versions (heads 2 and 4, D = 128), and the op's gradients vs autograd of
    the golden. `layer` = (h [N, 1, D], a_src, a_dst) of a model's layer:
    head k then takes those rows and vectors rotated by 17 k features, so
    the main graph's check sees the path's magnitudes (d a_src sums 2.7M
    edges with cancellation; at N(0, 1) rows its f32 order noise reaches
    1e-3 relative), as the single-head check does."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst_mh, attention_bwd_dst_mh_plain, attention_bwd_src,
        attention_bwd_src_plain, attention_fwd_mh, attention_fwd_mh_plain, attention_v3_mh,
        dropout_mask_mh, node_terms_mh_plain)
    from plotpointe_tpu_torch.ops.segment import segment_softmax_attention

    n, d = g.n_nodes, 128

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)

    def inputs(heads):
        if layer is None:
            return t(n, heads, d), t(heads, d, scale=0.1), t(heads, d, scale=0.1), t(n, heads, d)
        h1, s1, d1 = layer
        rot = [17 * k for k in range(heads)]
        return (torch.stack([torch.roll(h1[:, 0], r, -1) for r in rot], 1).contiguous(),
                torch.cat([torch.roll(s1, r, -1) for r in rot]),
                torch.cat([torch.roll(d1, r, -1) for r in rot]), t(n, heads, d))

    for heads in (2, 4):
        h, a_s, a_d, ct = inputs(heads)
        mask = dropout_mask_mh(g, 0.1, 7, heads, dev)
        with torch.no_grad():
            for rows_dt in (torch.float32, torch.bfloat16):
                for masked in (False, True):
                    mk = mask if masked else None
                    what = f"{label} N={n} E={g.n_edges} H={heads} D={d} rows={str(rows_dt)[6:]} mask={masked}"
                    got = attention_fwd_mh(h, a_s, a_d, g, mask=mk, hs_dtype=rows_dt)
                    want = attention_fwd_mh_plain(h, a_s, a_d, g, mask=mk, hs_dtype=rows_dt)
                    errs.check("gat_fwd_mh", what + " out", got[0], want[0], ATTN_TOL)
                    errs.check("gat_fwd_mh", what + " den", got[1], want[1], ATTN_TOL)
                    rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, rows_dt)
                    args = (rows, gs, gd, ct, want[0], want[1], g, mk)
                    got1, want1 = attention_bwd_dst_mh(*args), attention_bwd_dst_mh_plain(*args)
                    for part, x, y in zip(("de_sum", "godot", "da_src"), got1, want1):
                        errs.check("gat_bwd_dst_mh", f"{what} {part}", x, y, GRAD_TOL)
                    errs.same_bits("gat_bwd_dst_mh", what, got1, attention_bwd_dst_mh(*args))
                    k = heads - 1  # B2 on the last head's rows, read with a row stride
                    args2 = (rows[:, k], ct.to(rows_dt)[:, k], a_s[k:k + 1], gs[:, k].contiguous(),
                             gd[:, k].contiguous(), want[1][:, k].contiguous(),
                             want1[1][:, k].contiguous(), g, None if mk is None else mk[k])
                    errs.check("gat_bwd_src", f"{what} head {k} strided dh",
                               attention_bwd_src(*args2), attention_bwd_src_plain(*args2), GRAD_TOL)
                    del got, want, got1, want1, rows, args, args2
        del h, ct, mask
    h, a_s, a_d, ct = inputs(2)
    got = [x.clone().requires_grad_() for x in (h, a_s, a_d)]
    (attention_v3_mh(*got, g, hs_dtype=torch.float32) * ct).sum().backward()
    want = [x.clone().requires_grad_() for x in (h, a_s, a_d)]
    (segment_softmax_attention(*want, g) * ct).sum().backward()
    for part, x, y in zip(("dh", "da_src", "da_dst"), got, want):
        errs.check("attention_v3_mh", f"{label} N={n} H=2 rows=float32 mask=False grad {part} vs "
                   "golden autograd", x.grad, y.grad, GRAD_TOL)
    sync()


def check_legacy_kernels(errs, rng, label, g, h, a_s, a_d, dev) -> None:
    """Kernels 13, 14 and 15 vs their plain versions on the legacy paths'
    inputs: kernel 14 with and without the Bernoulli mask; kernel 13 on
    alpha and rows gathered at 64 and 128 features; kernel 15 on the 2-head
    rows pre-scaled by alpha (256 wide; on the small graph also 1,100 wide,
    three column strips)."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import segment_sum_rows, segment_sum_rows_plain
    from plotpointe_tpu_torch.ops.gat_kernel import (
        fused_layer, fused_layer_plain, fused_segment_reduce, fused_segment_reduce_plain, legacy_mask)
    from plotpointe_tpu_torch.ops.segment import attention_weights

    what = f"{label} N={g.n_nodes} E={g.n_edges}"
    mask = legacy_mask(g, 1, 0.1, 7, dev)
    with torch.no_grad():
        for mk in (None, mask[:, 0].contiguous()):
            errs.check("fused_layer", f"{what} D=128 rows=bfloat16 mask={mk is not None}",
                       fused_layer(h, a_s, a_d, g, mk), fused_layer_plain(h, a_s, a_d, g, mk), ATTN_TOL)
        src = g.src.long()
        for d in (64, 128):
            alpha = attention_weights(h[..., :d], a_s[:, :d], a_d[:, :d], g, mask)[:, 0].contiguous()
            hs = h[:, 0, :d][src]
            errs.check("fused_segment_reduce", f"{what} D={d} mask=0.1",
                       fused_segment_reduce(alpha, hs, g), fused_segment_reduce_plain(alpha, hs, g),
                       ATTN_TOL)
        widths = (256, 1100) if label == "small" else (256,)
        for w in widths:
            x = torch.cat([torch.roll(hs, 17 * k, -1) for k in range(-(-w // 128))], 1)[:, :w]
            x *= alpha[:, None]
            errs.check("onehot_reduce", f"{what} W={w} rows pre-scaled by alpha",
                       segment_sum_rows(x, g), segment_sum_rows_plain(x, g), ATTN_TOL)
            del x
        del hs
    sync()


def phase_check(errs, rng, graph, h0, a_s, a_d, catalog, dev) -> None:
    import torch

    from plotpointe_tpu_torch.graphs.csr import build_graph
    from plotpointe_tpu_torch.ops.gat_fused import gather_fence, gather_fence_plain
    from plotpointe_tpu_torch.ops.topk_kernel import (
        CHUNK, CHUNK_MARGIN, chunk_max, chunk_max_plain, n_chunks_of, rescore, rescore_plain,
        select_chunks, select_chunks_plain, select_items, select_items_plain)

    small_n, small_e = 3000, 30_000
    src = rng.integers(0, small_n, small_e)
    dst = np.where(rng.random(small_e) < 0.2, 5, rng.integers(0, small_n - 100, small_e))
    gsmall = build_graph(src, dst, small_n).to(dev)
    hsmall = torch.as_tensor(rng.normal(size=(small_n, 1, 128)).astype(np.float32), device=dev)
    check_attention(errs, rng, "small", gsmall, hsmall, a_s, a_d, dev)
    check_attention(errs, rng, "main", graph, h0, a_s, a_d, dev)
    # rows wider than one column strip: every row type and mask on 40 nodes
    # at D 1,024; the training configuration on the main graph at D 544
    g40 = build_graph(rng.integers(0, 30, 200), np.where(rng.random(200) < 0.3, 3,
                                                         rng.integers(0, 30, 200)), 40).to(dev)
    every = [(dt, m) for dt in (torch.float32, torch.bfloat16) for m in (False, True)]
    check_wide_attention(errs, rng, "tiny", g40, 1024, dev, every)
    check_wide_attention(errs, rng, "main", graph, 544, dev, [(torch.bfloat16, True)])
    check_legacy_kernels(errs, rng, "small", gsmall, hsmall, a_s, a_d, dev)
    check_legacy_kernels(errs, rng, "main", graph, h0, a_s, a_d, dev)
    for label, g, layer in (("small", gsmall, None), ("main", graph, (h0, a_s, a_d))):
        check_spmm(errs, rng, label, g, dev)
        check_multihead(errs, rng, label, g, dev, layer)
    with torch.no_grad():
        for label, x in (("small", hsmall[:40, 0, :64]), ("main", h0[:, 0])):
            for dt in (torch.float32, torch.bfloat16):
                xt = x.to(dt)
                errs.check("gather_fence", f"{label} {list(xt.shape)} {str(dt)[6:]}", gather_fence(xt),
                           gather_fence_plain(xt), FENCE_TOL)
        # B 1: a single request; 8 and 64: the batcher's batches. The main B 1
        # and B 8 queries come from a generator of their own (`own`), so the
        # numpy stream the later phases draw their data from is unchanged.
        for label, n, b, own in (("small", 5000, 8, None), ("main", CATALOG, 1, 101),
                                 ("main", CATALOG, 8, 108), ("main", CATALOG, 64, None)):
            for dt in (torch.float32, torch.bfloat16):
                x = catalog[:n].to(dt)
                q = (torch.as_tensor(rng.normal(size=(b, 128)).astype(np.float32), device=dev)
                     if own is None else
                     torch.randn((b, 128), generator=torch.Generator(device=dev).manual_seed(own),
                                 device=dev)).to(dt)
                what = f"{label} N={n} B={b} {str(dt)[6:]}"
                cm = chunk_max(x, q)
                errs.check("topk_chunkmax", what, cm, chunk_max_plain(x, q), SCORE_TOL)
                r = min(32 + CHUNK_MARGIN, cm.shape[1])
                cid = select_chunks(cm, r, n)
                errs.equal("topk_select", what + f" first r={r}", [cid], [select_chunks_plain(cm, r, n)])
                cid[:, -1] = n_chunks_of(n) - 1  # the tail chunk, partly past N
                sc = rescore(x, q, cid)
                errs.check("topk_rescore", what + f" R={r}", sc, rescore_plain(x, q, cid), SCORE_TOL)
                errs.same_bits("topk_rescore", what + f" R={r}", [sc], [rescore(x, q, cid)])
                scores = sc.flatten(1)
                errs.equal("topk_select", what + f" final W={scores.shape[1]} k=32",
                           select_items(scores, cid, 32), select_items_plain(scores, cid, 32))
                # exact ties: the maxima and the scores on a grid of 1/4
                tied_cm, tied_sc = torch.round(cm * 4) / 4, torch.round(scores * 4) / 4
                errs.equal("topk_select", what + " first, tied maxima", [select_chunks(tied_cm, r, n)],
                           [select_chunks_plain(tied_cm, r, n)])
                errs.equal("topk_select", what + " final, tied scores", select_items(tied_sc, cid, 32),
                           select_items_plain(tied_sc, cid, 32))
                check_topk_indices(what, x, q, 32)
        # the per-request path's long rows: B 1, a k of 2,000 over its 2,008 chunks' scores (read
        # from global memory on each pass); 5,000 sorts its survivors through scratch
        own = np.random.default_rng(2008)  # leaves the main numpy stream as it was
        long = torch.as_tensor(np.round(own.normal(size=(1, 2008 * CHUNK)) * 64) / 64,
                               dtype=torch.float32, device=dev)
        cid = torch.arange(2008, device=dev, dtype=torch.int32)[None] * 2
        for k in (2000, 5000):
            errs.equal("topk_select", f"long row W={long.shape[1]} final k={k}", select_items(long, cid, k),
                       select_items_plain(long, cid, k))
    sync()
    check_knn(errs, "small", small_knn_rows(rng, dev))


def check_topk_indices(what: str, x, q, k: int) -> None:
    """`topk_mips` against `topk_mips_ref` (the full f32 score matrix and
    one `torch.topk`): scores within SCORE_TOL, indices equal wherever no
    tie within twice that band straddles a place (the (k + 1)-th reference
    score shows a tie at the last place)."""
    import torch

    from plotpointe_tpu_torch.ops.topk_kernel import topk_mips, topk_mips_ref, untied

    gi, gv = topk_mips(x, q, k)
    wi, wv = topk_mips_ref(x, q, k + 1)
    keep = untied(wv, **{key: 2 * v for key, v in SCORE_TOL.items()})
    off = int((gi[keep] != wi[:, :k][keep]).sum())
    ok = off == 0 and bool(torch.allclose(gv, wv[:, :k], **SCORE_TOL))
    emit({"phase": "check", "kernel": "topk_mips", "case": what + f" k={k} indices where untied",
          "untied": int(keep.sum()), "of": keep.numel(), "differ": off,
          "max_abs_err": float((gv - wv[:, :k]).abs().max()), "ok": ok})
    if not ok:
        raise AssertionError(f"topk_mips ({what}): {off} untied indices differ from topk_mips_ref")


def write_artifacts(work: Path, inter, feats):
    """interactions.npz and the item features, as `train_from_artifacts` reads them."""
    staging, emb = work / "staging", work / "embeddings"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz", **inter)
    np.save(emb / "fused_interacted.npy", feats)
    return staging, emb


def phase_train(label: str, cfg, work: Path, dev, path_kernels, check_config):
    """One training path: `train_from_artifacts` with every counter set to 0
    first. Returns the trainer, the checkpoint path, the results and the
    launches."""
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.pipeline import train_from_artifacts
    from plotpointe_tpu_torch.train.checkpoint import load_checkpoint, params_to_jax

    cuda_build.reset_counters()
    t0 = time.perf_counter()
    res = train_from_artifacts(cfg, str(work / "staging"), str(work / "embeddings"),
                               str(work / f"models_{label}"), device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    trainer = res["trainer"]
    for h in res["history"]:
        emit({"phase": label, "epoch": h["epoch"], "loss": h["loss"], "step_s": h["step_time_s"],
              "eval_s": h["eval_time_s"], "val_ndcg@20": h.get("val_ndcg@20"),
              "val_recall@20": h.get("val_recall@20")})
    losses = [h["loss"] for h in res["history"]]
    ckpt = Path(res["checkpoint_uri"])
    flat, config = load_checkpoint(ckpt)
    best = params_to_jax(trainer.model.state_dict())  # the best parameters after fit
    jax_format = (sorted(flat) == sorted(best) and "train_config" in config
                  and all(np.array_equal(flat[k], best[k]) for k in best)
                  and all(config[k] == v for k, v in check_config.items()))
    missing = [k for k in path_kernels if launches[k] == 0]
    rows = getattr(trainer.model, "hs_dtype", getattr(trainer.model, "xs_dtype", None))
    emit({"phase": label, "wall_s": wall, "epochs": cfg.epochs, "losses": losses,
          "rows": str(rows)[6:], "best_val_ndcg@20": res["best_val_ndcg@20"],
          "test": res["test"], "checkpoint_keys": sorted(flat), "checkpoint_jax_format": jax_format,
          "launches": launches, "ok": not missing and jax_format and bool(np.isfinite(losses).all())})
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite training loss: {losses}")
    if missing:
        raise AssertionError(f"{label}: kernels not launched on the training path: {missing}")
    if not jax_format:
        raise AssertionError(f"{label}: best checkpoint {ckpt} is not the best parameters in the JAX format")
    return trainer, ckpt, res, launches


def step_parity(label: str, model, loss_fn) -> None:
    """One training step's loss and gradients with the kernels vs with their
    plain versions (`reference_versions()`), on the same card tensors (these
    launches are not the path's)."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import reference_versions

    out = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        with reference_versions() if plain else contextlib.nullcontext():
            loss = loss_fn()
            loss.backward()
        out[plain] = (float(loss.detach()), {n: p.grad.detach().clone()
                                             for n, p in model.named_parameters()})
    (lk, gk), (lp, gp) = out[False], out[True]
    worst, bad = {}, []
    for name, want in gp.items():
        scale = float(want.abs().max())
        worst[name] = float((gk[name] - want).abs().max()) / max(scale, 1e-30)
        if not torch.allclose(gk[name], want, rtol=STEP_RTOL, atol=STEP_ATOL_OF_MAX * scale):
            bad.append(name)
    loss_ok = abs(lk - lp) <= LOSS_RTOL * abs(lp)
    emit({"phase": label, "check": "first step, kernels vs plain versions", "loss_kernels": lk,
          "loss_plain": lp, "grad_max_abs_err_over_max": worst,
          "tol": {"rtol": STEP_RTOL, "atol_of_max": STEP_ATOL_OF_MAX, "loss_rtol": LOSS_RTOL},
          "ok": loss_ok and not bad})
    if not loss_ok or bad:
        raise AssertionError(f"{label} step: loss {lk} vs {lp}, gradients off: {bad}")
    model.zero_grad(set_to_none=True)


def phase_step_parity(label: str, tr) -> None:
    """The first step of a trainer's path (GAT or LightGCN) from its initial
    parameters, kernels vs plain versions."""
    from plotpointe_tpu_torch.train.trainer import STREAM_INIT, STREAM_TRAIN

    tr.model.init_params(tr._reseed(STREAM_INIT, 0))
    tr._reseed(STREAM_TRAIN, 1)
    if tr._spmm_op is not None:
        perm, _ = tr._lightgcn_perm()
        batch = tr._lightgcn_sample(perm, 0)
        step_parity(label, tr.model, lambda: tr._lightgcn_loss(*batch))
    else:
        u, i, j, seeds = tr._sample()
        step_parity(label, tr.model, lambda: tr._loss(u, i, j, seeds))


def export_and_check(label: str, work: Path, ckpt, inter, feats, n_items: int, width: int, dev):
    """`export_item_embeddings` of a checkpoint on the card and on the CPU;
    they must agree within ATTN_TOL. Returns (npy path, export stats)."""
    from plotpointe_tpu_torch.tools.export import export_item_embeddings

    out_npy = str(work / f"{label}_items.npy")
    t0 = time.perf_counter()
    emb = export_item_embeddings(ckpt, inter, feats, out_npy, device=dev)
    sync()
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb_cpu = export_item_embeddings(ckpt, inter, feats, str(work / f"{label}_cpu_items.npy"),
                                     device="cpu")
    t_export_cpu = time.perf_counter() - t0
    export_err = float(np.max(np.abs(emb - emb_cpu)))
    if emb.shape != (n_items, width) or not np.isfinite(emb).all() \
            or not np.allclose(emb, emb_cpu, **ATTN_TOL):
        raise AssertionError(f"{label} export on the card: shape {emb.shape}, max err vs CPU {export_err}")
    return out_npy, {"export_s": t_export, "export_cpu_s": t_export_cpu,
                     "export_shape": list(emb.shape), "export_max_abs_err_vs_cpu": export_err}


def serve_and_check(npy: str, histories, n_single: int, n_concurrent: int) -> dict:
    """`n_single` sequential /recommend requests to one stdlib HTTP server,
    then `n_concurrent` concurrent ones to a micro-batching server; every
    reply must be 200 and its scores must match the plain CPU answer."""
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig

    replies = [None] * (n_single + n_concurrent)
    single_srv, _ = serve("127.0.0.1", 0, block=False)
    servers = [single_srv]
    if n_concurrent:
        servers.append(serve("127.0.0.1", 0, block=False, micro_batch=True, micro_batch_max=64,
                             micro_batch_wait_ms=5.0)[0])
    stats = {}
    try:
        urls = [f"http://127.0.0.1:{srv.server_address[1]}" for srv in servers]
        for u in urls:
            code, body = post(f"{u}/startup", {"item_embeddings_uri": npy, "use_device": True})
            if code != 200:
                raise AssertionError(f"/startup answered {code}: {body}")
        t1 = time.perf_counter()
        for i in range(n_single):
            replies[i] = post(f"{urls[0]}/recommend", {"item_ids": histories[i], "k": 20})
        stats["single_requests"], stats["single_wall_s"] = n_single, time.perf_counter() - t1
        if n_concurrent:
            barrier = threading.Barrier(n_concurrent)

            def client(i):
                barrier.wait()
                replies[i] = post(f"{urls[1]}/recommend", {"item_ids": histories[i], "k": 20})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_single, n_single + n_concurrent)]
            t1 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            stats["concurrent_requests"] = n_concurrent
            stats["concurrent_wall_s"] = time.perf_counter() - t1
            b = servers[1].state.batcher.stats
            stats["batcher_requests_batches_max"] = (b.n_requests, b.n_batches, b.max_batch)
        sync()
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
            srv.state.close()

    codes = [r[0] if r else None for r in replies]
    if any(c != 200 for c in codes):
        raise AssertionError(f"/recommend replies not all 200: {codes}")
    plain_rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=npy, device="cpu",
                                                use_kernel_topk=False))
    plain_rt.startup()
    worst = 0.0
    for h, (_, body) in zip(histories, replies):
        _, want = plain_rt.top_k_for_user_items(h, k=20)
        got = np.sort(np.asarray(body["scores"], np.float64))
        want = np.sort(want.astype(np.float64))
        if len(got) != 20 or set(body["indices"]) & set(h):
            raise AssertionError(f"bad reply for history {h}: {body}")
        worst = max(worst, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12))))
    if worst > SERVE_RTOL:
        raise AssertionError(f"served scores differ from the plain answer by {worst} relative")
    return stats | {"status_codes": sorted(set(codes)), "served_max_rel_err_vs_plain": worst}


def histories_of(n_items: int, n: int):
    hist_rng = np.random.default_rng(1)
    return [hist_rng.choice(n_items, size=int(hist_rng.integers(1, 21)), replace=False).tolist()
            for _ in range(n)]


def phase_serve(label: str, work: Path, ckpt, inter, feats, n_items: int, width: int,
                n_single: int, n_concurrent: int, dev, path_kernels) -> dict:
    """A serving path, counters set to 0 first: export the trained checkpoint
    on the card (held to the CPU export) and serve it over HTTP."""
    from plotpointe_tpu_torch.ops import cuda_build

    cuda_build.reset_counters()
    npy, stats = export_and_check(label, work, ckpt, inter, feats, n_items, width, dev)
    if n_single or n_concurrent:
        stats |= serve_and_check(npy, histories_of(n_items, n_single + n_concurrent), n_single,
                                 n_concurrent)
    launches = counts()
    missing = [k for k in path_kernels if launches[k] == 0]
    emit({"phase": label, "checkpoint": "trained", **stats, "launches": launches, "ok": not missing})
    if missing:
        raise AssertionError(f"{label}: kernels not launched on the path: {missing}")
    return launches


def check_knn(errs, label: str, xn) -> None:
    """Kernels 10 and 11 vs their plain versions on the same card rows: the
    candidate scores within KNN_TOL; kernel 10's columns equal wherever no
    tie within TIE_TOL straddles a place (the plain version lists one more,
    to show the tie past the last); kernel 11's column sets with recall >=
    FAST_RECALL_PLAIN, as bf16 products summed in another order may swap
    near-tied candidates."""
    import torch

    from plotpointe_tpu_torch.ops.knn_kernel import (
        knn_candidates, knn_candidates_fast, knn_candidates_fast_plain, knn_candidates_plain,
        n_candidates)

    n, d = xn.shape
    r = n_candidates(KNN["k"], "exact")
    what = f"{label} N={n} d={d} R={r}"
    got_i, got_s = knn_candidates(xn, r)
    want_i, want_s = knn_candidates_plain(xn, r + 1)
    errs.check("knn_topk", what + " scores", got_s, want_s[:, :r], KNN_TOL)
    gap = (want_s[:, :-1] - want_s[:, 1:]).abs() <= TIE_TOL  # [N, r]: place j ties place j + 1
    tied = gap.clone()
    tied[:, 1:] |= gap[:, :-1]
    off = int(((got_i != want_i[:, :r]) & ~tied).sum())
    emit({"phase": "check", "kernel": "knn_topk", "case": what + " columns where untied",
          "mismatches": off, "tied_places": int(tied.sum()), "ok": off == 0})
    if off:
        raise AssertionError(f"knn_topk ({what}): {off} untied candidate columns differ from plain")
    rf = n_candidates(KNN["k"], "fast")
    what = f"{label} N={n} d={d} R={rf}"
    got_i, got_s = knn_candidates_fast(xn, rf)
    want_i, want_s = knn_candidates_fast_plain(xn, rf)
    errs.check("knn_topk_fast", what + " scores", got_s, want_s, KNN_TOL)
    rec = edge_recall(got_i, want_i)
    emit({"phase": "check", "kernel": "knn_topk_fast", "case": what + " recall vs plain",
          "recall": rec, "min": FAST_RECALL_PLAIN, "ok": rec >= FAST_RECALL_PLAIN})
    if rec < FAST_RECALL_PLAIN:
        raise AssertionError(f"knn_topk_fast ({what}): recall {rec} against its plain version")
    sync()
    del got_i, got_s, want_i, want_s
    torch.cuda.empty_cache()


def edge_recall(got_idx, want_idx) -> float:
    """Share of want's real (row, column) pairs that got also lists."""
    import torch

    n = want_idx.shape[0]
    rows = torch.arange(n, device=want_idx.device, dtype=torch.int64)[:, None]

    def keys(idx):
        idx = idx.to(torch.int64)
        return (rows * n + idx)[idx >= 0]

    want = keys(want_idx)
    return float(torch.isin(want, keys(got_idx)).sum()) / max(1, want.numel())


def small_knn_rows(rng, dev, n=3000, d=64):
    """N not a multiple of the 128-row tile, duplicated rows, a zero row."""
    import torch

    from plotpointe_tpu_torch.graphs.knn import l2_normalize

    x = rng.normal(size=(n, d)).astype(np.float32)
    src, dst = rng.choice(n, size=(2, 60), replace=False)
    x[dst] = x[src]
    x[7] = 0.0
    return l2_normalize(torch.as_tensor(x, device=dev))


def write_graph_inputs(work: Path, inter, seed: int):
    """The graph-build stage's inputs in directories of their own: the
    interactions and the catalog's asins (items.npz: the 498,196 asins in a
    seeded permutation, so the interacted ones are scattered through it) and
    the full-catalog features fused.npy (128 d) and txt.npy (384 d). Rows sit
    around KNN_CLUSTERS unit-normal centres plus KNN_NOISE N(0, I) noise (a
    within-cluster cosine near 0.7, so min similarity 0.3 keeps most edges);
    KNN_DUPLICATES interacted rows are copies of others (exact ties)."""
    rng = np.random.default_rng(seed + 4)
    staging, emb = work / "graph_staging", work / "graph_embeddings"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz", **inter)
    asin = rng.permutation(CATALOG).astype(np.int64)
    np.savez(staging / "items.npz", asin=asin)
    row_of = np.argsort(asin)  # catalog row of each asin
    src, dst = rng.choice(row_of[np.unique(inter["asin"])], size=(2, KNN_DUPLICATES), replace=False)
    cluster = rng.integers(0, KNN_CLUSTERS, CATALOG)
    for name, d in (("fused", 128), ("txt", 384)):
        x = rng.standard_normal((KNN_CLUSTERS, d), dtype=np.float32)[cluster]
        x += np.float32(KNN_NOISE) * rng.standard_normal((CATALOG, d), dtype=np.float32)
        x[dst] = x[src]
        np.save(emb / f"{name}.npy", x)
        del x
    return staging, emb


def check_knn_artifacts(graphs: Path, name: str, n: int) -> dict:
    """ii_edges_{name}.npz: no self edge, no index >= N, similarities >= the
    threshold and descending within a row; the stats JSON has the JAX keys."""
    z = np.load(graphs / f"ii_edges_{name}.npz")
    row, col, data = z["row"], z["col"], z["data"]
    stats = json.loads((graphs / f"ii_{name}_stats.json").read_text())
    same = row[1:] == row[:-1]
    problems = {
        "dtypes": not (row.dtype == col.dtype == np.int32 and data.dtype == np.float32),
        "self_edges": bool((row == col).any()),
        "index_out_of_range": bool(((col < 0) | (col >= n) | (row < 0) | (row >= n)).any()),
        "below_threshold_or_not_finite": bool(not np.isfinite(data).all()
                                              or (data < KNN["min_similarity"]).any()),
        "rows_not_descending": bool((data[1:][same] > data[:-1][same]).any()),
        "rows_not_grouped": bool((row[1:] < row[:-1]).any()),
        "header": list(z["shape"]) != [n, n] or z["format"].item() != b"coo",
        "stats_keys": list(stats) != KNN_STATS_KEYS or stats["n_edges"] != len(data),
    }
    bad = [k for k, v in problems.items() if v]
    if bad:
        raise AssertionError(f"ii_edges_{name}: {bad}")
    return {"edges": int(len(data)), "avg_similarity": stats["avg_similarity"],
            "items_with_full_k": stats["items_with_full_k"]}


def check_ui_and_subsets(graphs: Path, staging: Path, emb: Path, s) -> dict:
    """ui_edges.npz, node_maps.json and ui_stats.json of the interactions;
    each subset's rows are the catalog rows of the node map's asins."""
    z = np.load(graphs / "ui_edges.npz")
    maps = json.loads((graphs / "node_maps.json").read_text())
    ui = json.loads((graphs / "ui_stats.json").read_text())
    asins = json.loads((emb / "interacted_items.json").read_text())
    row_of = np.argsort(np.load(staging / "items.npz")["asin"])
    bad = []
    if list(z["shape"]) != [s.n_users, s.n_items] or len(z["row"]) != ui["n_edges"]:
        bad.append("ui_edges")
    if maps["n_users"] != s.n_users or maps["n_items"] != s.n_items or list(ui) != UI_STATS_KEYS:
        bad.append("node_maps / ui_stats")
    if len(asins) != s.n_items or [int(a) for a in maps["idx_to_item"].values()] != asins:
        bad.append("interacted_items")
    shapes = {}
    for name, d in (("fused", 128), ("txt", 384)):
        sub = np.load(emb / f"{name}_interacted.npy")
        full = np.load(emb / f"{name}.npy", mmap_mode="r")
        shapes[name] = list(sub.shape)
        if sub.shape != (s.n_items, d) or not np.array_equal(sub, full[row_of[asins]]):
            bad.append(f"{name}_interacted")
    if bad:
        raise AssertionError(f"graph-build artifacts wrong: {bad}")
    return {"ui_edges": int(ui["n_edges"]), "subset_shapes": shapes}


def compare_edges(label: str, got, want) -> dict:
    """Two COO edge sets (row, col, data) of one graph: shared edges' data
    within TIE_TOL; an edge in only one set must lie within TIE_TOL of the
    threshold or of its row's last kept similarity (a near-tie at the k-th
    place); counts equal apart from edges within TIE_TOL of the threshold."""
    n_max = int(max(got[0].max(initial=0), want[0].max(initial=0))) + 1
    kg = got[0].astype(np.int64) * n_max + got[1]
    kw = want[0].astype(np.int64) * n_max + want[1]
    _, ig, iw = np.intersect1d(kg, kw, assume_unique=True, return_indices=True)
    data_err = float(np.abs(got[2][ig] - want[2][iw]).max(initial=0.0))

    def unexplained(edges, keep):
        row, data = edges[0][keep], edges[2][keep]
        last = np.full(n_max, np.inf, np.float32)
        np.minimum.at(last, edges[0], edges[2])  # each row's last kept similarity
        near = (np.abs(data - KNN["min_similarity"]) <= TIE_TOL) | (np.abs(data - last[row]) <= TIE_TOL)
        return int((~near).sum()), int(keep.sum())

    only_g = np.ones(len(kg), bool)
    only_g[ig] = False
    only_w = np.ones(len(kw), bool)
    only_w[iw] = False
    bad_g, n_g = unexplained(got, only_g)
    bad_w, n_w = unexplained(want, only_w)
    thr_g = int((np.abs(got[2] - KNN["min_similarity"]) <= TIE_TOL).sum())
    thr_w = int((np.abs(want[2] - KNN["min_similarity"]) <= TIE_TOL).sum())
    counts_ok = abs(len(kg) - len(kw)) <= max(thr_g, thr_w)
    ok = data_err <= TIE_TOL and bad_g == 0 and bad_w == 0 and counts_ok
    line = {"phase": "check", "case": label, "edges": [len(kg), len(kw)], "shared": int(len(ig)),
            "only_kernel_path": n_g, "only_plain_path": n_w, "unexplained": bad_g + bad_w,
            "shared_data_max_abs_err": data_err, "tol": TIE_TOL, "ok": bool(ok)}
    emit(line)
    if not ok:
        raise AssertionError(f"{label}: edge sets disagree: {line}")
    return line


def phase_graph_build(errs, work: Path, inter, s, seed: int, dev):
    """Path 5: build-ui, build-subset (fused, txt), build-knn (fused) and
    cosine_knn_graph (txt) with every counter at 0 first; then the fast
    call with the counters at 0 again; then the checks. Returns the two
    runs' launches and the normalized subsets for the timing phase."""
    import torch

    from plotpointe_tpu_torch import cli
    from plotpointe_tpu_torch.graphs.knn import cosine_knn, cosine_knn_graph, l2_normalize
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.ops.gat_fused import reference_versions

    t0 = time.perf_counter()
    staging, emb = write_graph_inputs(work, inter, seed)
    graphs = work / "graphs"
    secs = {"inputs_s": time.perf_counter() - t0}
    cuda_build.reset_counters()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):  # the commands print indented JSON
        for step, argv in (
                ("build_ui_s", ["build-ui", "--staging-prefix", str(staging), "--output-prefix", str(graphs)]),
                ("build_subset_fused_s", ["build-subset", "--staging-prefix", str(staging), "--features",
                                          str(emb / "fused.npy"), "--output-prefix", str(emb),
                                          "--feature-name", "fused"]),
                ("build_subset_txt_s", ["build-subset", "--staging-prefix", str(staging), "--features",
                                        str(emb / "txt.npy"), "--output-prefix", str(emb),
                                        "--feature-name", "txt"]),
                ("build_knn_s", ["build-knn", "--features", str(emb / "fused_interacted.npy"),
                                 "--output-prefix", str(graphs)])):
            t0 = time.perf_counter()
            cli.main(argv)
            sync()
            secs[step] = time.perf_counter() - t0
    txt = np.load(emb / "txt_interacted.npy")
    t0 = time.perf_counter()
    cosine_knn_graph(txt, out_prefix=str(graphs), feature_name="txt", **KNN)
    secs["knn_graph_txt_s"] = time.perf_counter() - t0
    launches = counts()
    missing = [k for k in PATH_KERNELS["graph_build"] if launches[k] == 0]
    emit({"phase": "graph_build", **secs, "launches": launches, "ok": not missing})
    if missing:
        raise AssertionError(f"graph_build: kernels not launched on the path: {missing}")

    cuda_build.reset_counters()
    t0 = time.perf_counter()
    fast = cosine_knn(txt, impl="pallas", mode="fast", **KNN)
    fast_s = time.perf_counter() - t0
    fast_launches = counts()
    missing = [k for k in PATH_KERNELS["graph_build_fast"] if fast_launches[k] == 0]
    emit({"phase": "graph_build_fast", "cosine_knn_fast_s": fast_s, "launches": fast_launches,
          "ok": not missing})
    if missing:
        raise AssertionError(f"graph_build_fast: kernels not launched: {missing}")

    n = s.n_items
    emit({"phase": "graph_build", "check": "artifacts", **check_ui_and_subsets(graphs, staging, emb, s),
          "fused": check_knn_artifacts(graphs, "fused", n), "txt": check_knn_artifacts(graphs, "txt", n),
          "ok": True})
    feats = {}
    for name in ("fused", "txt"):
        x = np.load(emb / f"{name}_interacted.npy")
        feats[name] = l2_normalize(torch.as_tensor(x, device=dev))
        check_knn(errs, f"graph_build {name}", feats[name])
        z = np.load(graphs / f"ii_edges_{name}.npz")
        with reference_versions():
            plain, _ = cosine_knn_graph(x, feature_name=name, device=dev, **KNN)
        compare_edges(f"graph_build {name} ii_edges, kernel path vs plain path",
                      (z["row"], z["col"], z["data"]), plain)
    # kernel 11's graph against kernel 10's, both after the exact re-score
    z = np.load(graphs / "ii_edges_txt.npz")
    fi, fsim, fvalid = fast
    fr = np.repeat(np.arange(n), fi.shape[1])[fvalid.ravel()]
    fast_edges = (fr, fi.ravel()[fvalid.ravel()].astype(np.int64), fsim.ravel()[fvalid.ravel()])
    kw = z["row"].astype(np.int64) * n + z["col"]
    kf = fast_edges[0].astype(np.int64) * n + fast_edges[1]
    _, iw, jf = np.intersect1d(kw, kf, assume_unique=True, return_indices=True)
    rec = len(iw) / max(1, len(kw))
    err = float(np.abs(z["data"][iw] - fast_edges[2][jf]).max(initial=0.0))
    ok = rec >= FAST_RECALL_EXACT and err <= TIE_TOL
    emit({"phase": "check", "kernel": "knn_topk_fast",
          "case": f"graph_build txt N={n} d=384: fast-mode edges vs exact-mode edges",
          "recall": rec, "min": FAST_RECALL_EXACT, "shared_sim_max_abs_err": err, "tol": TIE_TOL,
          "ok": ok})
    if not ok:
        raise AssertionError(f"fast mode vs exact: recall {rec}, shared similarity err {err}")
    return launches, fast_launches, feats, secs["build_knn_s"]


def blocked_mm(x, rows: int = 1024, ld_mult: int = 8):
    """x @ x.T in strips of `rows` rows into one reused buffer: the product
    kernel 10 or 11 computes, with no selection (a context figure). x gets
    zero rows up to a multiple of `ld_mult`, so the output's row stride is
    16-byte aligned for cuBLAS's tensor-core paths; ld_mult=1 keeps N's own
    stride (63,001: unaligned)."""
    import torch

    n = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, 0, (-n) % ld_mult))
    out = torch.empty((rows, xp.shape[0]), dtype=x.dtype, device=x.device)

    def run():
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            torch.mm(xp[r0:r1], xp.T, out=out[:r1 - r0])
    return run


def knn_bound(kname: str, n: int, d: int, r: int) -> dict:
    """The bound of kernel 10 or 11 at [n, d] with R = r. It counts each
    unordered pair's dot product once, N (N - 1) d operations (the scores are
    symmetric), against the bytes of x once plus the candidate lists. Kernel
    11: the bf16 tensor-core peak. Kernel 10 (f32-faithful): the lower of
    three TF32 passes, 3 N (N - 1) d at the TF32 peak, and one f32 pass on
    the f32 pipe (printed beside it as `bound_f32_pipe_ms`, the bound of the
    earlier design on the CUDA cores); `ops_dtype` names which.
    `design_bound_ms` is the full matrix (2 N^2 d a pass) that the row-owned
    kernels compute."""
    isz = 4 if kname == "knn_topk" else 2
    nbytes = {"x": n * d * isz, "cand_idx": n * r * 4, "cand_score": n * r * 4}
    total, pairs = sum(nbytes.values()), n * (n - 1) * d
    if kname == "knn_topk":
        f32 = bound(total, pairs, "float32")
        tf32 = bound(total, 3 * pairs, "tfloat32")
        passes, dname = (3, "tfloat32") if tf32[0] <= f32[0] else (1, "float32")
        extra = {"bound_f32_pipe_ms": f32[0], "bound_tf32_ms": tf32[0]}
    else:
        passes, dname, extra = 1, "bfloat16", {}
    b_ms, b_by = bound(total, passes * pairs, dname)
    return {"bound_ms": b_ms, "bound_by": b_by, "ops_dtype": dname, **extra,
            "design_bound_ms": bound(total, passes * 2 * n * n * d, dname)[0],
            "bound_bytes": nbytes, "bound_ops": passes * pairs}


def knn_kernels():
    from plotpointe_tpu_torch.ops.knn_kernel import (
        knn_candidates, knn_candidates_fast, knn_candidates_fast_plain, knn_candidates_plain)

    return (("knn_topk", "exact", knn_candidates, knn_candidates_plain),
            ("knn_topk_fast", "fast", knn_candidates_fast, knn_candidates_fast_plain))


def time_knn(rows_out, feats, build_knn_s: float) -> None:
    """Kernels 10 and 11 at both shapes: 1 warm-up and 3 timed calls
    (the plain versions 1 and 1), each with its bound (`knn_bound`). Beside
    them a blocked torch.mm of the same full product, with its output's row
    stride aligned and at N's own."""
    import torch

    from plotpointe_tpu_torch.ops.knn_kernel import n_candidates

    for name, x in feats.items():
        n, d = x.shape
        for kname, mode, fn, plain in knn_kernels():
            r = n_candidates(KNN["k"], mode)
            dt = torch.float32 if mode == "exact" else torch.bfloat16
            dname = str(dt)[6:]
            xd = x.to(dt)
            line = {"phase": "timing", "kernel": kname, "shape": f"N={n} d={d} R={r} {name}",
                    "ms": time_ms(lambda: fn(x, r), 3, 1),
                    "plain_ms": time_ms(lambda: plain(x, r), 1, 1), "library_ms": None,
                    **knn_bound(kname, n, d, r),
                    "gemm_ms": time_ms(blocked_mm(xd), 3, 1),
                    "gemm_ld_unaligned_ms": time_ms(blocked_mm(xd, ld_mult=1), 3, 1),
                    "gemm_what": f"context only: blocked {dname} torch.mm of the full product "
                                 "(1,024-row strips, output row stride padded to a multiple of 8; "
                                 "and at N's own stride), no selection"}
            if kname == "knn_topk" and name == "fused":
                line["build_knn_wall_s"] = build_knn_s
            emit(line)
            if d == 384:
                rows_out[kname] = line
            torch.cuda.empty_cache()


def time_knn_trees(feats, tree: str) -> None:
    """`--compare-with`'s kNN rows: kernels 10 and 11 alone at both
    graph-build shapes (1 warm-up, 3 timed calls) with their bounds, then
    the ptxas report of both libraries of this tree."""
    from plotpointe_tpu_torch.ops.knn_kernel import n_candidates

    for name, x in feats.items():
        n, d = x.shape
        for kname, mode, fn, _ in knn_kernels():
            r = n_candidates(KNN["k"], mode)
            emit({"phase": "timing", "kernel": kname, "shape": f"N={n} d={d} R={r} {name}", "tree": tree,
                  "ms": time_ms(lambda: fn(x, r), 3, 1), **knn_bound(kname, n, d, r)})
    emit({"phase": "build", "tree": tree, "ptxas": ptxas_report(PTXAS_REPORTED)})


def ptxas_report(names) -> dict:
    """Each library's `nvcc -Xptxas -v` lines (registers, spills, entry
    functions) from the `<lib>.log` its build wrote; a library whose source
    the tree lacks is left out."""
    from plotpointe_tpu_torch.ops import cuda_build

    out = {}
    for name in names:
        if not (cuda_build.CSRC / f"{name}.cu").exists():  # an older tree, without this source
            continue
        lines = cuda_build.lib_path(name).with_suffix(".log").read_text().splitlines()
        out[name] = [ln.strip() for ln in lines if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    return out


def time_backward(rows_out, graph, h0, a_s, a_d, dev, rng):
    """B1 and B2 at the main graph with the dropout mask of the training path."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst, attention_bwd_dst_plain, attention_bwd_src, attention_bwd_src_plain,
        attention_fwd, hash_mask, node_terms_plain)

    n, e, d = graph.n_nodes, graph.n_edges, h0.shape[-1]
    ct = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev)
    mask = hash_mask(7, torch.arange(e, device=dev), 0.1)
    with torch.no_grad():
        for rows_dt in (torch.float32, torch.bfloat16):
            isz, dname = (4 if rows_dt == torch.float32 else 2), str(rows_dt)[6:]
            rows, gs, gd = node_terms_plain(h0[:, 0], a_s, a_d, rows_dt)
            out, den = attention_fwd(h0, a_s, a_d, graph, mask=mask, hs_dtype=rows_dt)
            out = out[:, 0].contiguous()
            a1 = (rows, gs, gd, ct, out, den, graph, mask)
            godot = attention_bwd_dst(*a1)[1]
            a2 = (rows, ct.to(rows_dt), a_s, gs, gd, den, godot, graph, mask)
            shape = f"N={n} E={e} D={d} rows={dname} mask=0.1"
            b1_bytes = bwd_dst_bytes(n, e, 1, d, isz, True)
            b2_bytes = bwd_src_bytes(n, e, d, isz)
            ops = 4 * e * d  # per edge: one row dot product and one row axpy
            for kname, fn, plain, nbytes in (
                    ("gat_bwd_dst", lambda: attention_bwd_dst(*a1), lambda: attention_bwd_dst_plain(*a1), b1_bytes),
                    ("gat_bwd_src", lambda: attention_bwd_src(*a2), lambda: attention_bwd_src_plain(*a2), b2_bytes)):
                b_ms, b_by = bound(sum(nbytes.values()), ops, "float32")
                line = {"phase": "timing", "kernel": kname, "shape": shape, "ms": time_ms(fn),
                        "plain_ms": time_ms(plain, 5), "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "bound_bytes": nbytes, "bound_ops": ops,
                        "gather_ms": gather_ms(nbytes, e, d * isz)}
                emit(line)
                if rows_dt == torch.bfloat16:
                    rows_out[kname] = line  # the training path's row type
            del rows, out, a1, a2, godot


def step_fns(tr):
    """(sample, loss of a sample) of one training step of the trainer's path:
    the GAT's sampled triples, or LightGCN's next mini-batch."""
    if tr._spmm_op is None:
        return tr._sample, lambda batch: tr._loss(*batch)
    perm, n_steps = tr._lightgcn_perm()
    steps = iter(range(1 << 30))
    return (lambda: tr._lightgcn_sample(perm, next(steps) % n_steps),
            lambda batch: tr._lightgcn_loss(*batch))


def time_train_step(label: str, tr, s, **extra) -> None:
    """The training step split into phases (host clock around synchronised
    work), one eval pass over the val split, and a profiled step."""
    sample, loss_of = step_fns(tr)
    phases = {"sample": [], "forward": [], "backward": [], "optimizer": []}
    for it in range(4):  # the first is a warm-up
        sync()
        t0 = time.perf_counter()
        batch = sample()
        sync()
        t1 = time.perf_counter()
        loss = loss_of(batch)
        sync()
        t2 = time.perf_counter()
        tr.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sync()
        t3 = time.perf_counter()
        tr._opt_step()
        sync()
        t4 = time.perf_counter()
        if it:
            for k, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                phases[k].append(dt)
    t0 = time.perf_counter()
    val = tr.evaluate(s.val_u, s.val_i, 1)
    eval_s = time.perf_counter() - t0
    step = {k: float(np.mean(v)) for k, v in phases.items()}
    emit({"phase": "timing", "what": f"{label} training step", **extra,
          "seconds_by_phase": step, "step_s": sum(step.values()), "repeats": 3,
          "eval_pass_s": eval_s, "eval_users": len(s.val_u), "eval_neg_k": tr.cfg.eval_neg_k,
          "val_ndcg@20": val["ndcg@20"]})
    profile_train_step(label, tr, sum(step.values()))


def profile_train_step(label: str, tr, step_s: float) -> None:
    """Device time of one training step by kernel (torch.profiler), and the
    device's idle share against the unprofiled step's wall time."""
    import torch

    sample, loss_of = step_fns(tr)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        loss = loss_of(sample())
        tr.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        tr._opt_step()
        sync()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.is_user_annotation:  # a named range (Adam.step) spans kernels counted below
            continue
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if on_device or (ev.cpu_time_total == 0 and ev.device_time_total > 0):
            by_kernel[ev.key[:80]] = by_kernel.get(ev.key[:80], 0.0) + ev.device_time_total / 1e3
    busy = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15])
    ours = {k: sum(v for n, v in by_kernel.items() if any(p in n for p in pats))
            # kernels 1 and 8 share one walk: its row is whichever the step ran
            for k, pats in (("gat_fwd or gat_fwd_mh walk", ("attention_walk<", "attention_walk_combine(")),
                            ("gat_fwd or gat_fwd_mh node_terms", ("node_terms<",)),
                            # kernels 2 and 9 likewise
                            ("gat_bwd_dst or gat_bwd_dst_mh", ("bwd_dst_walk<", "bwd_dst_combine(")),
                            ("gat_bwd_src", ("bwd_src_units<", "bwd_src_combine(")),
                            ("spmm_csr", ("spmm_units<", "spmm_combine(")))}
    emit({"phase": "timing", "what": f"{label} training step profile", "device_busy_ms": busy,
          "step_wall_ms_unprofiled": step_s * 1e3, "idle_share": 1.0 - busy / (step_s * 1e3),
          "profiled_wall_ms": wall * 1e3, "port_kernels_ms": {k: v for k, v in ours.items() if v},
          "kernels_seen": len(by_kernel), "top_kernels_ms": top})


def timing_row(kname, shape, fn, plain, nbytes, ops, dtype, library=None, plain_iters=5, **extra):
    """One timing line: the kernel's and its plain version's CUDA-event
    times, the bound of its compulsory bytes and operations at the spec
    peaks, and the one PyTorch call of the same function where there is one."""
    b_ms, b_by = bound(sum(nbytes.values()), ops, dtype)
    line = {"phase": "timing", "kernel": kname, "shape": shape, "ms": time_ms(fn),
            "plain_ms": time_ms(plain, plain_iters), "bound_ms": b_ms, "bound_by": b_by,
            "ops_dtype": dtype, "library_ms": None if library is None else time_ms(library),
            "bound_bytes": nbytes, "bound_ops": ops, **extra}
    emit(line)
    return line


def time_rule2(rows_out, graph, dev, tree: str = "change") -> None:
    """The rows of the kernels this port redesigned for the H100 after
    bring-up, at the main graph, each beside its library call: kernel 7
    (`csrc/spmm_csr.cu`) at D = 64 (LightGCN's width) in both directions and
    both row types, against `torch.sparse.mm` on a CSR tensor built once
    (f32); kernel 13 (pre-gathered f32 rows, D 64 and 128) against
    `torch.sparse.mm` of the [N, E] CSR of its weights; kernel 15 (W 256, the
    2-head rows) against `torch.segment_reduce`; kernel 12 at the smoke's
    [256, 128] and at 256 MB against `torch.addcmul`. Then `host_us_per_launch`:
    the host's microseconds per call of the kernel 12, 4 and 7 wrappers
    and of `torch.addcmul`, over 200 calls with no synchronise in the loop,
    and of the kernel 12 wrapper's parts (its output's allocation, the C
    entry through ctypes without a launch and with one).
    The inputs are seeded on the card, so `--compare-with` feeds the same
    ones to each tree; `graph` needs only its CSR arrays and sizes. `tree`
    labels each line."""
    import torch

    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.ops.elementwise import affine, affine_plain
    from plotpointe_tpu_torch.ops.gat_fused import segment_sum_rows, segment_sum_rows_plain
    from plotpointe_tpu_torch.ops.gat_kernel import fused_segment_reduce, fused_segment_reduce_plain
    from plotpointe_tpu_torch.ops.spmm_kernel import spmm_csr, spmm_csr_plain
    from plotpointe_tpu_torch.ops.topk_kernel import chunk_max, topk_mips

    n, e, d = graph.n_nodes, graph.n_edges, LIGHTGCN["embed_dim"]
    gen = torch.Generator(device=dev).manual_seed(11)
    deg = (graph.row_ptr[1:] - graph.row_ptr[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(n, device=dev), deg, output_size=e)
    # normalized per-destination weights, as alpha and LightGCN's values are
    u = torch.rand(e, generator=gen, device=dev)
    v = u / torch.zeros(n, device=dev).index_add_(0, dst, u)[dst]
    vt = v[graph.t_eid.long()].contiguous()
    x = torch.randn((n, d), generator=gen, device=dev)
    dirs = (("dst", graph.row_ptr, graph.src, v), ("transpose", graph.t_ptr, graph.t_dst, vt))
    with torch.no_grad():
        mats = {name: torch.sparse_csr_tensor(ptr, idx, vv, size=(n, n)) for name, ptr, idx, vv in dirs}
        for rows_dt in (torch.bfloat16, torch.float32):
            isz, dname = (4 if rows_dt == torch.float32 else 2), str(rows_dt)[6:]
            xs = x.to(rows_dt)
            for name, ptr, idx, vv in dirs:
                # compulsory bytes: x, idx, values, ptr read once, y written once
                line = timing_row(
                    "spmm_csr", f"N={n} E={e} D={d} rows={dname} {name}",
                    lambda: spmm_csr(xs, vv, ptr, idx, rows_dt),
                    lambda: spmm_csr_plain(xs, vv, ptr, idx, rows_dt),
                    {"x": n * d * isz, "idx": e * 4, "values": e * 4, "ptr": (n + 1) * 4, "y": n * d * 4},
                    2 * e * d, "float32", library=lambda: torch.sparse.mm(mats[name], x), tree=tree,
                    library_what="torch.sparse.mm(CSR [N, N] f32, x f32)")
                if rows_dt == torch.bfloat16 and name == "dst":
                    rows_out["spmm_csr"] = line  # the training path's rows and direction
        del mats
        cols = torch.arange(e, device=dev, dtype=torch.int32)
        mat = torch.sparse_csr_tensor(graph.row_ptr, cols, v, size=(n, e))
        for dd in (64, 128):  # 64: the legacy path's (hidden 64); 128: the flagship width
            hs = torch.randn((e, dd), generator=gen, device=dev)
            line = timing_row(
                "fused_segment_reduce", f"N={n} E={e} D={dd} f32 pre-gathered rows",
                lambda: fused_segment_reduce(v, hs, graph), lambda: fused_segment_reduce_plain(v, hs, graph),
                {"hs": e * dd * 4, "w": e * 4, "ptr": (n + 1) * 4, "out": n * dd * 4}, 2 * e * dd, "float32",
                library=lambda: torch.sparse.mm(mat, hs), tree=tree,
                library_what="torch.sparse.mm(CSR [N, E] of w, hs)")
            if dd == 64:
                rows_out["fused_segment_reduce"] = line
            del hs
        del mat
        w = 2 * 128  # the 2-head path's [E, 256]
        xw = torch.randn((e, w), generator=gen, device=dev)
        rows_out["onehot_reduce"] = timing_row(
            "onehot_reduce", f"N={n} E={e} W={w} f32 pre-gathered rows",
            lambda: segment_sum_rows(xw, graph), lambda: segment_sum_rows_plain(xw, graph),
            {"x": e * w * 4, "ptr": (n + 1) * 4, "out": n * w * 4}, e * w, "float32",
            library=lambda: torch.segment_reduce(xw, "sum", lengths=deg), tree=tree,
            library_what="torch.segment_reduce(x, 'sum', lengths=in-degrees)")
        del xw
        one = torch.ones((), device=dev)
        two = torch.full((), 2.0, device=dev)
        for label, shape in (("smoke", (256, 128)), ("256 MB", (8192, 8192))):
            xa = torch.randn(shape, generator=gen, device=dev)
            k = xa.numel()
            line = timing_row("smoke_affine", f"{label} {list(shape)} float32", lambda: affine(xa),
                              lambda: affine_plain(xa), {"x": k * 4, "out": k * 4}, 2 * k, "float32",
                              library=lambda: torch.addcmul(one, xa, two), tree=tree,
                              library_what="torch.addcmul(1, x, 2)")
            if label == "smoke":
                rows_out["smoke_affine"] = line
                small = xa
        xb = x.to(torch.bfloat16)
        # where the kernel 12 wrapper's time goes: its output's allocation, the
        # C entry through ctypes without a launch (n = 0) and with one
        fn, out = cuda_build.entry("smoke_affine"), torch.empty_like(small)
        st = torch.cuda.current_stream().cuda_stream
        parts = {"torch.empty_like": host_us_per_launch(lambda: torch.empty_like(small)),
                 "C entry, n = 0": host_us_per_launch(lambda: fn(0, 0, 0, st)),
                 "C entry, launching": host_us_per_launch(
                     lambda: fn(small.data_ptr(), out.data_ptr(), small.numel(), st))}
        xt = torch.randn((4096, 128), generator=gen, device=dev)
        qt = torch.randn((8, 128), generator=gen, device=dev)
        emit({"phase": "timing", "what": "host_us_per_launch", "tree": tree, "calls": 200,
              "smoke_affine [256, 128] f32": host_us_per_launch(lambda: affine(small)),
              "topk_chunkmax N=4096 D=128 B=8 f32": host_us_per_launch(lambda: chunk_max(xt, qt)),
              # one whole call (all its launches and the ops between them)
              "topk_mips N=4096 D=128 B=1 f32 k=32": host_us_per_launch(lambda: topk_mips(xt, qt[:1], 32),
                                                                       calls=50),
              "topk_mips N=4096 D=128 B=8 f32 k=32": host_us_per_launch(lambda: topk_mips(xt, qt, 32),
                                                                       calls=50),
              f"spmm_csr N={n} E={e} D={d} rows=bfloat16 dst": host_us_per_launch(
                  lambda: spmm_csr(xb, v, graph.row_ptr, graph.src, torch.bfloat16)),
              "torch.addcmul [256, 128] f32": host_us_per_launch(lambda: torch.addcmul(one, small, two)),
              "smoke_affine parts": parts})


def time_multihead(rows_out, graph, dev, rng) -> None:
    """Kernels 8 and 9 per layer at heads 2, D = 128: f32 rows without a mask
    (the export) and bf16 rows with the 0.1 dropout mask (training)."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst_mh, attention_bwd_dst_mh_plain, attention_fwd_mh, attention_fwd_mh_plain,
        dropout_mask_mh, node_terms_mh_plain)

    n, e, hh, d = graph.n_nodes, graph.n_edges, MH_HEADS, 128

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)

    h, a_s, a_d, ct = t(n, hh, d), t(hh, d, scale=0.1), t(hh, d, scale=0.1), t(n, hh, d)
    mask = dropout_mask_mh(graph, 0.1, 7, hh, dev)
    with torch.no_grad():
        for rows_dt, mk in ((torch.float32, None), (torch.bfloat16, mask)):
            isz, dname = (4 if rows_dt == torch.float32 else 2), str(rows_dt)[6:]
            shape = f"N={n} E={e} H={hh} D={d} rows={dname} mask={0.1 if mk is not None else 0}"
            fwd_bytes = fwd_mh_bytes(n, e, hh, d, mk is not None)
            fwd_ops = 2 * e * hh * d + 4 * n * hh * d
            rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, rows_dt)
            out, den = attention_fwd_mh(h, a_s, a_d, graph, mask=mk, hs_dtype=rows_dt)
            a1 = (rows, gs, gd, ct, out, den, graph, mk)
            b1_bytes = bwd_dst_bytes(n, e, hh, d, isz, mk is not None)
            b1_ops = 4 * e * hh * d
            for kname, fn, plain, nbytes, ops in (
                    ("gat_fwd_mh", lambda: attention_fwd_mh(h, a_s, a_d, graph, mask=mk, hs_dtype=rows_dt),
                     lambda: attention_fwd_mh_plain(h, a_s, a_d, graph, mask=mk, hs_dtype=rows_dt),
                     fwd_bytes, fwd_ops),
                    ("gat_bwd_dst_mh", lambda: attention_bwd_dst_mh(*a1),
                     lambda: attention_bwd_dst_mh_plain(*a1), b1_bytes, b1_ops)):
                b_ms, b_by = bound(sum(nbytes.values()), ops, "float32")
                line = {"phase": "timing", "kernel": kname, "shape": shape, "ms": time_ms(fn),
                        "plain_ms": time_ms(plain, 5), "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "bound_bytes": nbytes, "bound_ops": ops,
                        "gather_ms": gather_ms(nbytes, e, hh * d * isz)}
                emit(line)
                if rows_dt == torch.bfloat16:
                    rows_out[kname] = line  # the training path's rows and mask
            del rows, out, den, a1


def time_gather_trees(graph, dev, tree: str) -> None:
    """`--compare-with`'s attention rows, kernels alone, on inputs seeded on
    the card (so each tree gets the same): kernel 8 at heads 2, D 128 with
    bf16 rows and the 0.1 mask (the 2-head training step) and with f32 rows
    and no mask (the export), as `time_multihead` times it; B2 at D 128 with
    bf16 rows and the mask, on contiguous rows (the GAT step, as
    `time_backward` times it) and on the last head's row-strided rows of
    [N, 2, 128] tensors (the 2-head step); kernels 2 (B1) at D 128 and 9 at
    heads 2, D 128, each with bf16 rows and the 0.1 mask (the training
    steps) and with f32 rows (kernel 2 masked, as `time_backward` times it;
    kernel 9 without, as `time_multihead`). Each line carries its bound, its
    gather ceiling and `tree`."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst, attention_bwd_dst_mh, attention_bwd_src, attention_fwd_mh, dropout_mask_mh,
        hash_mask)

    n, e, hh, d = graph.n_nodes, graph.n_edges, MH_HEADS, 128
    gen = torch.Generator(device=dev).manual_seed(13)

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    h, a_s, a_d, ct = t(n, hh, d), t(hh, d, scale=0.1), t(hh, d, scale=0.1), t(n, hh, d)
    mask = dropout_mask_mh(graph, 0.1, 7, hh, dev)
    with torch.no_grad():
        for rows_dt, mk in ((torch.bfloat16, mask), (torch.float32, None)):
            isz, dname = (4 if rows_dt == torch.float32 else 2), str(rows_dt)[6:]
            nbytes = fwd_mh_bytes(n, e, hh, d, mk is not None)
            b_ms, b_by = bound(sum(nbytes.values()), 2 * e * hh * d + 4 * n * hh * d, "float32")
            emit({"phase": "timing", "kernel": "gat_fwd_mh", "tree": tree,
                  "shape": f"N={n} E={e} H={hh} D={d} rows={dname} mask={0.1 if mk is not None else 0}",
                  "ms": time_ms(lambda: attention_fwd_mh(h, a_s, a_d, graph, mask=mk, hs_dtype=rows_dt)),
                  "bound_ms": b_ms, "bound_by": b_by, "gather_ms": gather_ms(nbytes, e, hh * d * isz)})
        m1 = hash_mask(7, torch.arange(e, device=dev), 0.1)
        gs, gd, godot = t(n), t(n), t(n, scale=0.1)
        den = torch.rand(n, generator=gen, device=dev) * 4 + 1
        hb, cb16 = h.to(torch.bfloat16), ct.to(torch.bfloat16)
        nbytes = bwd_src_bytes(n, e, d, 2)
        b_ms, b_by = bound(sum(nbytes.values()), 4 * e * d, "float32")
        for label, rows, gh in (("contiguous", hb[:, 0].contiguous(), cb16[:, 0].contiguous()),
                                ("head 1 of [N, 2, D], strided", hb[:, 1], cb16[:, 1])):
            emit({"phase": "timing", "kernel": "gat_bwd_src", "tree": tree,
                  "shape": f"N={n} E={e} D={d} rows=bfloat16 mask=0.1 {label}",
                  "ms": time_ms(lambda: attention_bwd_src(rows, gh, a_s[1:], gs, gd, den, godot, graph, m1)),
                  "bound_ms": b_ms, "bound_by": b_by, "gather_ms": gather_ms(nbytes, e, d * 2)})
        # kernels 2 (B1, head 0's contiguous rows, the mask: as `time_backward`)
        # and 9 (both heads; the mask with bf16 rows: as `time_multihead`)
        gs2, gd2, out2 = t(n, hh, scale=0.5), t(n, hh, scale=0.5), t(n, hh, d, scale=0.1)
        den2 = torch.rand((n, hh), generator=gen, device=dev) * 4 + 1
        for rows_dt in (torch.bfloat16, torch.float32):
            isz, dname = (4 if rows_dt == torch.float32 else 2), str(rows_dt)[6:]
            rows = h.to(rows_dt)
            mk = mask if rows_dt == torch.bfloat16 else None
            a1 = [x[:, 0].contiguous() for x in (rows, gs2, gd2, ct, out2, den2)]
            for kname, fn, hk, masked in (
                    ("gat_bwd_dst", lambda: attention_bwd_dst(*a1, graph, m1), 1, True),
                    ("gat_bwd_dst_mh", lambda: attention_bwd_dst_mh(rows, gs2, gd2, ct, out2, den2, graph, mk),
                     hh, mk is not None)):
                nbytes = bwd_dst_bytes(n, e, hk, d, isz, masked)
                b_ms, b_by = bound(sum(nbytes.values()), 4 * e * hk * d, "float32")
                emit({"phase": "timing", "kernel": kname, "tree": tree,
                      "shape": f"N={n} E={e} H={hk} D={d} rows={dname} mask={0.1 if masked else 0}",
                      "ms": time_ms(fn), "bound_ms": b_ms, "bound_by": b_by,
                      "gather_ms": gather_ms(nbytes, e, hk * d * isz)})


def time_topk_and_fwd_trees(graph, dev, tree: str, bits_dir: Path) -> None:
    """`--compare-with`'s rows of kernels 4, 5, the select kernel, 1 and 14,
    on inputs seeded on the card (so each tree gets the same): kernel 4
    (chunk-max) over a 498,196 x 128 catalog at B 1, 8 and 64 in f32 and
    bf16, with its bound, and the whole `topk_mips` (k 32) beside it, with
    its split where the tree's `topk_mips` has the `stage` hook; kernel 5 on
    the 40 chunks of largest plain maxima a query, listed by value (the
    order of earlier trees' paths) and ascending (this tree's), with its
    scores of the ascending list saved to `bits_dir` for the parent-bits
    comparison; the select kernel where the tree has it; kernel 1 on the main graph
    at D 128 with bf16 rows and the 0.1 mask (the GAT step) and with f32
    rows and no mask (the export); kernel 14 (`fused_layer`, bf16 rows, the
    Bernoulli mask of the v2 contract). Each line carries `tree`."""
    import inspect

    import torch

    from plotpointe_tpu_torch.ops.gat_fused import attention_fwd, hash_mask
    from plotpointe_tpu_torch.ops.gat_kernel import fused_layer, legacy_mask
    from plotpointe_tpu_torch.ops import topk_kernel
    from plotpointe_tpu_torch.ops.topk_kernel import chunk_max, chunk_max_plain, rescore, topk_mips

    hooked = "stage" in inspect.signature(topk_mips).parameters  # older trees have no hook
    r = 32 + 8  # k 32 and the exact margin
    n, e, d = graph.n_nodes, graph.n_edges, 128
    gen = torch.Generator(device=dev).manual_seed(17)
    with torch.no_grad():
        catalog = torch.randn((CATALOG, d), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x, dname = catalog.to(dt), str(dt)[6:]
            for b in (1, 8, 64):
                q = torch.randn((b, d), generator=gen, device=dev).to(dt)
                shape = f"N={CATALOG} D={d} B={b} {dname}"
                emit({"phase": "timing", "kernel": "topk_chunkmax", "tree": tree, "shape": shape,
                      "ms": time_ms(lambda: chunk_max(x, q)), **topk_bound(b, CATALOG, d, dname)})
                emit({"phase": "timing", "kernel": "topk_mips", "tree": tree, "shape": shape, "k": 32,
                      "ms": time_ms(lambda: topk_mips(x, q, 32)),
                      **(topk_phase_split(x, q, 32) if hooked else {})})
                cm = chunk_max_plain(x, q)  # cuBLAS maxima: the same chunks in both trees
                by_value = torch.topk(cm, r, dim=1)[1].to(torch.int32)
                for order, cid in (("value", by_value), ("ascending", torch.sort(by_value, dim=1)[0])):
                    b_ms, b_by = rescore_bound(b, r, d, 2 if dt == torch.bfloat16 else 4, cid)
                    emit({"phase": "timing", "kernel": "topk_rescore", "tree": tree, "shape": shape, "R": r,
                          "chunk_order": order, "ms": time_ms(lambda: rescore(x, q, cid)),
                          "device_ms": device_ms(lambda: rescore(x, q, cid), ("rescore",)), "bound_ms": b_ms,
                          "bound_by": b_by})
                torch.save(rescore(x, q, cid).cpu(), bits_dir / f"rescore_{tree}_{dname}_B{b}.pt")
                if hasattr(topk_kernel, "select_items"):
                    time_select(shape, cm, cid, rescore(x, q, cid).flatten(1), r, 32, tree=tree)
            del x
        del catalog
        h = torch.randn((n, 1, d), generator=gen, device=dev)
        a_s, a_d = (torch.randn((1, d), generator=gen, device=dev) * 0.1 for _ in range(2))
        mask = hash_mask(7, torch.arange(e, device=dev), 0.1)
        for rows_dt, mk in ((torch.bfloat16, mask), (torch.float32, None)):
            nbytes = fwd_mh_bytes(n, e, 1, d, mk is not None)
            b_ms, b_by = bound(sum(nbytes.values()), 2 * e * d + 4 * n * d, "float32")
            emit({"phase": "timing", "kernel": "gat_fwd", "tree": tree,
                  "shape": f"N={n} E={e} D={d} rows={str(rows_dt)[6:]} mask={0.1 if mk is not None else 0}",
                  "ms": time_ms(lambda: attention_fwd(h, a_s, a_d, graph, mask=mk, hs_dtype=rows_dt)),
                  "bound_ms": b_ms, "bound_by": b_by,
                  "gather_ms": gather_ms(nbytes, e, d * (4 if rows_dt == torch.float32 else 2))})
        m1 = legacy_mask(graph, 1, 0.1, 7, dev)[:, 0].contiguous()
        nbytes = fwd_mh_bytes(n, e, 1, d, True)
        b_ms, b_by = bound(sum(nbytes.values()), 2 * e * d + 4 * n * d, "float32")
        emit({"phase": "timing", "kernel": "fused_layer", "tree": tree,
              "shape": f"N={n} E={e} D={d} rows=bfloat16 mask=0.1",
              "ms": time_ms(lambda: fused_layer(h, a_s, a_d, graph, m1)), "bound_ms": b_ms,
              "bound_by": b_by, "gather_ms": gather_ms(nbytes, e, d * 2)})


def phase_tooling(errs, dev):
    """Path 6, every counter at 0 first: the smoke check in-process and
    through the CLI in a subprocess, then the measured peaks. Then kernels 6
    and 12 vs their plain versions. Returns (launches, measured peaks)."""
    import torch

    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.ops.elementwise import affine, affine_plain
    from plotpointe_tpu_torch.tools.smoke_gpu import run_smoke
    from plotpointe_tpu_torch.utils.profiling import measure_device_peaks, stream_probe, stream_probe_plain

    cuda_build.reset_counters()
    t0 = time.perf_counter()
    report = run_smoke()
    smoke_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "plotpointe_tpu_torch.cli", "smoke"],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    cli_report = json.loads(proc.stdout) if proc.returncode == 0 else {"ok": False, "checks": {}}
    t0 = time.perf_counter()
    peaks = measure_device_peaks(dev)
    peaks_s = time.perf_counter() - t0
    launches = counts()
    s = spec()
    band_ok = (0.5 * s["hbm_gbps"] <= peaks["hbm_gbps"] <= 1.05 * s["hbm_gbps"]
               and peaks["tflops"] <= 1.05 * s["bf16_tflops"])
    missing = [k for k in PATH_KERNELS["tooling"] if launches[k] == 0]
    emit({"phase": "tooling", "smoke_s": smoke_s, "smoke": {k: {kk: v for kk, v in c.items() if kk != "kind"}
                                                            for k, c in report["checks"].items()},
          "cli_smoke": {"rc": proc.returncode, "s": cli_s, "ok": cli_report["ok"],
                        "checks": {k: c["ok"] for k, c in cli_report["checks"].items()}},
          "peaks_s": peaks_s, "launches": launches,
          "ok": report["ok"] and proc.returncode == 0 and band_ok and not missing})
    emit({"measured_peaks": peaks, "spec": {"tflops": s["bf16_tflops"], "hbm_gbps": s["hbm_gbps"]},
          "band": "0.5-1.05x spec hbm_gbps, <= 1.05x spec tflops", "ok": band_ok})
    if not report["ok"]:
        raise AssertionError(f"run_smoke failed: {report}")
    if proc.returncode != 0:
        raise AssertionError(f"cli smoke exited {proc.returncode}: {proc.stderr[-2000:]}")
    if not band_ok:
        raise AssertionError(f"measured peaks {peaks} outside the band around {s}")
    if missing:
        raise AssertionError(f"tooling: kernels not launched on the path: {missing}")
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        for label, (m, d, bm) in (("small", (512, 256, 64)), ("main", (32768, 4096, 512))):
            x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
            errs.check("stream_probe", f"{label} [{m}, {d}] bfloat16 BM={bm} c=0.375",
                       stream_probe(x, bm, 0.375), stream_probe_plain(x, bm, 0.375), EXACT)
        for label, shape in (("smoke", (256, 128)), ("odd", (1000, 1001)), ("256 MB", (65536, 1024))):
            x = torch.randn(shape, generator=gen, device=dev) * 1e3
            errs.check("smoke_affine", f"{label} {list(shape)} float32", affine(x), affine_plain(x), EXACT)
        del x
    sync()
    return launches, peaks


def in_process_cli(argv) -> tuple[str, int]:
    """`python -m plotpointe_tpu_torch.cli ARGV` in this process: (its
    standard output, its exit code)."""
    from plotpointe_tpu_torch import cli

    out, code = io.StringIO(), 0
    with contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
            if not isinstance(e.code, int):
                print(e.code)
    return out.getvalue(), code


def peak_host_gb() -> float:
    """This process's peak resident memory so far, GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def phase_anchor(work: Path, dev) -> tuple[dict, tuple]:
    """Path 8: the quality anchor. First the anchor's data alone, as the
    gate's config generates it (the generator's host seconds and peak host
    memory), kept for the ablate path. Then, counters at 0, `cli anchor
    --scale full` in-process with the gate's defaults, the port's baseline
    file as `--gate-baseline` and the beyond-parity leg (adam; the gate
    skips the adamw leg): it must print PASS, launch kernels 1, 2 and 3, and
    match the archived JAX run (`ARCHIVED_ANCHOR`): the dataset block and
    generator config field for field, the baselines' NDCG@20 within
    ANCHOR_BASELINE_TOL. Returns (launches, (interactions, item factors,
    generator config))."""
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.tools import anchor

    cfg = json.loads(anchor.BASELINE.read_text())["generator_config"]
    rss_before = peak_host_gb()
    t0 = time.perf_counter()
    inter, (_, i_fac) = anchor.anchor_data(cfg)
    gen_s = time.perf_counter() - t0
    gen_peak = peak_host_gb()

    # the wall of each scored leg: the anchor's own evals, in its order
    # (the trainer's val and test evals call their own import of sampled_eval)
    from plotpointe_tpu_torch.train import evaluate

    eval_walls, plain_eval = [], evaluate.sampled_eval

    def timed_eval(*a, **kw):
        t = time.perf_counter()
        r = plain_eval(*a, **kw)
        sync()
        eval_walls.append(time.perf_counter() - t)
        return r

    cuda_build.reset_counters()
    t0 = time.perf_counter()
    evaluate.sampled_eval = timed_eval
    try:
        out, code = in_process_cli(["anchor", "--scale", "full", "--out", str(work / "anchor"),
                                    "--gate-baseline", str(anchor.BASELINE), "--device", str(dev)])
    finally:
        evaluate.sampled_eval = plain_eval
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    res = json.loads((work / "anchor" / "anchor.json").read_text())
    gates = [json.loads(x) for x in out.splitlines() if x.startswith('{"anchor_gate"')]
    gate = gates[-1] if gates else None
    archived = json.loads((Path(__file__).resolve().parent / ARCHIVED_ANCHOR).read_text())
    legs = {k: v for k, v in res.items()
            if k != "reference_band" and isinstance(v, dict) and ("ndcg@20" in v or "error" in v)}
    for k, w in zip((*ANCHOR_BASELINES, "gat_init"), eval_walls):
        legs[k] = {**legs[k], "eval_wall_s": w}
    baseline_err = {k: abs(res[k]["ndcg@20"] - archived[k]["ndcg@20"]) for k in ANCHOR_BASELINES}
    same_data = res["dataset"] == archived["dataset"]
    same_cfg = res["generator_config"] == archived["generator_config"]
    missing = [k for k in PATH_KERNELS["anchor"] if launches[k] == 0]
    passed = code == 0 and gate is not None and gate["anchor_gate"] == "PASS"
    ok = (passed and same_data and same_cfg and max(baseline_err.values()) <= ANCHOR_BASELINE_TOL
          and not missing)
    emit({"phase": "anchor", "wall_s": wall, "generator_host_s": gen_s,
          "peak_host_gb_before_generator": rss_before, "peak_host_gb_after_generator": gen_peak,
          "peak_host_gb": peak_host_gb(), "exit_code": code, "gate": gate,
          "generator_hash": res["generator_hash"], "dataset": res["dataset"],
          "dataset_equals_archive": same_data, "generator_config_equals_archive": same_cfg,
          "legs": {k: {**v, **({"archive": {m: archived[k].get(m) for m in ("ndcg@20", "recall@20")}}
                              if k in archived else {})} for k, v in legs.items()},
          "baseline_ndcg20_abs_err_vs_archive": baseline_err, "launches": launches, "ok": ok})
    if not passed:
        raise AssertionError(f"anchor: exit {code}, gate {gate}: {out[-2000:]}")
    if not (same_data and same_cfg):
        raise AssertionError(f"anchor: dataset {res['dataset']} / config {res['generator_config']} "
                             f"differ from {ARCHIVED_ANCHOR}")
    if max(baseline_err.values()) > ANCHOR_BASELINE_TOL:
        raise AssertionError(f"anchor: baselines off the archive by {baseline_err}")
    if missing:
        raise AssertionError(f"anchor: kernels not launched on the path: {missing}")
    return launches, (inter, i_fac, cfg)


def phase_ablate(work: Path, data, dev) -> dict:
    """Path 9: the anchor's data as interactions.npz with its features
    (`synthetic_features` of the generator's item factors at 128 d as
    fused_interacted.npy, at 384 d as txt_interacted.npy), then, counters at
    0, `cli ablate` in-process over its seven variants at 1 epoch of
    200,000 samples: no variant may report an error, kernels 1, 2, 3, 7, 8
    and 9 must have launched."""
    from plotpointe_tpu_torch.cli import ABLATIONS
    from plotpointe_tpu_torch.data.splits import first_occurrence_unique
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.tools import anchor

    inter, i_fac, cfg = data
    staging, emb = work / "ablate_staging", work / "ablate_embeddings"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz", **inter)
    n_items = len(first_occurrence_unique(inter["asin"]))
    for name, dim in (("fused", 128), ("txt", 384)):
        _, feats = anchor.anchor_features(inter, i_fac, n_items, dim, cfg["seed"], cfg["feature_noise"])
        np.save(emb / f"{name}_interacted.npy", feats)

    cuda_build.reset_counters()
    t0 = time.perf_counter()
    out, code = in_process_cli(["ablate", "--staging-prefix", str(staging), "--embeddings-prefix",
                                str(emb), "--models-prefix", str(work / "ablate_models"),
                                "--epochs", "1", "--samples-per-epoch", "200000",
                                "--device", str(dev)])
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    report = json.loads((work / "ablate_models" / "ablations_report.json").read_text())
    failed = sorted(set(ABLATIONS) - {k for k, v in report.items() if "test" in v})
    missing = [k for k in PATH_KERNELS["ablate"] if launches[k] == 0]
    emit({"phase": "ablate", "wall_s": wall, "variants": report, "exit_code": code,
          "launches": launches, "ok": code == 0 and not failed and not missing})
    if code != 0 or failed:
        raise AssertionError(f"ablate: exit {code}, variants without test metrics {failed}: {out[-2000:]}")
    if missing:
        raise AssertionError(f"ablate: kernels not launched on the path: {missing}")
    return launches


def v2_out_tol(model, x_feats, graph, seeds, out_p) -> dict:
    """The legacy v2 output's band against its plain path. The last layer
    rounds its rows h to bf16, and a value whose f32 bits differ between
    the paths (earlier layers sum in another order) may round one bf16 step
    apart: that moves an output by at most the step times the edges'
    summed weight, mask * num / den <= 1 / (1 - dropout). So the band is
    the training step's band (STEP_RTOL, STEP_ATOL_OF_MAX) plus one bf16
    step of the largest |h| (read here by the model without its last layer,
    plain versions) over 1 - dropout."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import reference_versions

    layers = model.layers
    with torch.no_grad(), reference_versions():
        model.layers = layers[:-1]
        try:
            x = model(x_feats, graph, train=True, seeds=seeds[:-1])
        finally:
            model.layers = layers
        rows_max = float(torch.einsum("nf,fhd->nhd", x, layers[-1].w).abs().max())
    step = 2.0 ** (math.floor(math.log2(rows_max)) - 7)  # bf16 keeps 8 significant bits
    scale = float(out_p.abs().max())
    return dict(rtol=STEP_RTOL, atol=STEP_ATOL_OF_MAX * scale + step / (1.0 - model.attn_dropout))


def phase_legacy(errs, rng, s, feats, graph, layers: int, dev) -> dict:
    """Path 7: the GAT forward (train=True, dropout 0.1) and the backward of
    a fixed linear loss on the main graph marked `.with_tiling()`, per
    LEGACY configuration, with the kernels (counters at 0 first) and under
    `reference_versions()`; v2 at its model from `rng` and at each of
    V2_MODEL_SEEDS, each beside a flip control held to the same band (the
    band's premise). Returns each
    configuration's launches (those of its model from `rng`)."""
    import torch

    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.ops.gat_fused import reference_versions
    from plotpointe_tpu_torch.train.checkpoint import params_from_jax

    tiled = graph.with_tiling()
    x_feats = torch.as_tensor(feats, device=dev)
    by_path = {}
    for label, hidden, heads in LEGACY:
        v2 = label == "legacy_v2"
        for model_seed in (None,) + (V2_MODEL_SEEDS if v2 else ()):
            r = rng if model_seed is None else np.random.default_rng(model_seed)
            model = GATModel(s.n_users, s.n_items, 384, hidden, n_layers=layers, heads=heads,
                             attn_dropout=0.1)
            model.load_state_dict(params_from_jax(random_gat_params(r, s.n_users, 384, hidden,
                                                                    layers, heads)))
            model.to(dev)
            ct = torch.as_tensor(r.normal(size=(graph.n_nodes, hidden)).astype(np.float32),
                                 device=dev)
            seeds = [int(x) for x in r.integers(0, 2**32, layers)]
            runs = {}
            for plain in (False, True):
                model.zero_grad(set_to_none=True)
                cuda_build.reset_counters()
                sync()
                t0 = time.perf_counter()
                with reference_versions() if plain else contextlib.nullcontext():
                    out = model(x_feats, tiled, train=True, seeds=seeds)
                    (out * ct).sum().backward()
                sync()
                runs[plain] = (out.detach(),
                               {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                               counts(), time.perf_counter() - t0)
                del out
            (out_k, grads_k, launches, wall_k), (out_p, grads_p, plain_launches, wall_p) = \
                runs[False], runs[True]
            scale = float(out_p.abs().max())
            out_tol = v2_out_tol(model, x_feats, tiled, seeds, out_p) if v2 else ATTN_TOL
            out_err = float((out_k - out_p).abs().max())
            out_ok = bool(torch.allclose(out_k, out_p, **out_tol)) and bool(torch.isfinite(out_k).all())
            grad_err = {n: float((grads_k[n] - g).abs().max()) for n, g in grads_p.items()}
            bad = [n for n, g in grads_p.items() if not torch.allclose(grads_k[n], g, **GRAD_TOL)]
            missing = [k for k in PATH_KERNELS[label] if launches[k] == 0]
            in_plain = [k for k in PATH_KERNELS[label] if plain_launches[k]]
            line = {"phase": "legacy", "path": label, "model_seed": model_seed, "hidden": hidden,
                    "heads": heads, "layers": layers, "contract": "v2" if v2 else "v1",
                    "dropout": 0.1, "fwd_bwd_s": wall_k, "fwd_bwd_plain_s": wall_p,
                    "out_shape": list(out_k.shape), "out_max_abs": scale,
                    "out_max_abs_err_vs_plain": out_err, "out_tol": out_tol}
            control_ok = True
            if v2:  # the flip control: the plain path alone, the last layer's rows nudged
                w = model.layers[-1].w
                with torch.no_grad(), reference_versions():
                    keep = w.detach().clone()
                    w.copy_(torch.nextafter(keep, torch.full_like(keep, float("inf"))))
                    out_c = model(x_feats, tiled, train=True, seeds=seeds)
                    w.copy_(keep)
                line["flip_control_max_abs_err"] = float((out_c - out_p).abs().max())
                control_ok = bool(torch.allclose(out_c, out_p, **out_tol))
                del out_c
            ok = out_ok and control_ok and not bad and not missing and not in_plain
            emit({**line, "grad_max_abs_err_vs_plain": grad_err, "grad_tol": GRAD_TOL,
                  "launches": {k: v for k, v in launches.items() if v}, "ok": ok})
            if not ok:
                raise AssertionError(
                    f"{label} (model seed {model_seed}): output ok {out_ok}, flip control within "
                    f"the band {control_ok}, gradients off {bad}, kernels not launched {missing}, "
                    f"launched under the plain versions {in_plain}")
            if model_seed is None:
                by_path[label] = launches
            del model, runs, out_k, out_p, grads_k, grads_p, ct
            torch.cuda.empty_cache()
    return by_path


def time_tooling_and_legacy(rows_out, graph, h0, a_s, a_d, dev) -> None:
    """Kernels 6 (the tooling path's shape) and 14 (the legacy path's, at
    the main graph), with the library call that computes the same function
    where there is one; kernels 12, 13 and 15 are timed by `time_rule2`."""
    import torch

    from plotpointe_tpu_torch.ops.gat_kernel import fused_layer, fused_layer_plain, legacy_mask
    from plotpointe_tpu_torch.utils.profiling import stream_probe, stream_probe_plain

    n, e = graph.n_nodes, graph.n_edges
    with torch.no_grad():
        mask = legacy_mask(graph, 1, 0.1, 7, dev)
        m1 = mask[:, 0].contiguous()
        d = h0.shape[-1]
        nbytes = fwd_mh_bytes(n, e, 1, d, True)
        rows_out["fused_layer"] = timing_row(
            "fused_layer", f"N={n} E={e} D={d} rows=bfloat16 mask=0.1",
            lambda: fused_layer(h0, a_s, a_d, graph, m1), lambda: fused_layer_plain(h0, a_s, a_d, graph, m1),
            nbytes, 2 * e * d + 4 * n * d, "float32", gather_ms=gather_ms(nbytes, e, d * 2))
        m, d, bm = 32768, 4096, 512
        xp = torch.randn((m, d), device=dev).to(torch.bfloat16)
        view = xp.view(m // bm * 8, bm // 8, d // 128, 128)
        rows_out["stream_probe"] = timing_row(
            "stream_probe", f"[{m}, {d}] bfloat16 BM={bm}", lambda: stream_probe(xp, bm),
            lambda: stream_probe_plain(xp, bm), {"x": m * d * 2, "out": m // bm * 8 * 128 * 4}, m * d,
            "float32", library=lambda: torch.amax(view, dim=(1, 2)),
            library_what="torch.amax over the (slab, column-group) dims")
        del xp, view


def phase_timing(rng, graph, h0, a_s, a_d, catalog, trainer, s, dev):
    import torch

    from plotpointe_tpu_torch.graphs.csr import build_graph
    from plotpointe_tpu_torch.ops.gat_fused import attention_fwd, attention_fwd_plain, hash_mask
    from plotpointe_tpu_torch.ops.gat_fused import gather_fence, gather_fence_plain
    from plotpointe_tpu_torch.ops.topk_kernel import (
        CHUNK_MARGIN, chunk_max, chunk_max_plain, rescore, rescore_plain, select_chunks, topk_mips,
        topk_mips_ref)

    n, e, d = graph.n_nodes, graph.n_edges, 128
    rows = {}
    with torch.no_grad():
        mask = hash_mask(7, torch.arange(e, device=dev), 0.1)
        # the export's f32 rows, then the training step's bf16 rows and 0.1 mask
        for rows_dt, mk in ((torch.float32, None), (torch.bfloat16, mask)):
            nbytes = fwd_mh_bytes(n, e, 1, d, mk is not None)
            line = timing_row(
                "gat_fwd", f"N={n} E={e} D={d} rows={str(rows_dt)[6:]} mask={0.1 if mk is not None else 0}",
                lambda: attention_fwd(h0, a_s, a_d, graph, mask=mk, hs_dtype=rows_dt),
                lambda: attention_fwd_plain(h0, a_s, a_d, graph, mask=mk, hs_dtype=rows_dt),
                nbytes, 2 * e * d + 4 * n * d, "float32",
                gather_ms=gather_ms(nbytes, e, d * (4 if rows_dt == torch.float32 else 2)))
            rows["gat_fwd"] = line  # the training step's mode: 14 of the paths' 16 launches
        # where kernel 1's time goes: its CUDA kernels, and the same N and E
        # with uniform in-degrees (no hot rows)
        uni = build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n).to(dev)
        split = {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for rows_dt in (torch.float32, torch.bfloat16):
                for _ in range(5):
                    attention_fwd(h0, a_s, a_d, graph, hs_dtype=rows_dt)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            for name in ("attention_walk_combine", "attention_walk", "node_terms"):
                if name + "<" in ev.key or name + "(" in ev.key:
                    row = "<bfloat16>" if "bfloat16" in ev.key else ("<float>" if "<float" in ev.key else "")
                    split[name + row] = ev.device_time_total / ev.count / 1e3
                    break
        emit({"phase": "timing", "kernel": "gat_fwd", "profile_ms_per_call": split,
              "uniform_graph_ms": {str(r)[6:]: time_ms(lambda: attention_fwd(h0, a_s, a_d, uni, hs_dtype=r))
                                   for r in (torch.float32, torch.bfloat16)}})
        del uni, mask
    time_backward(rows, graph, h0, a_s, a_d, dev, rng)
    with torch.no_grad():
        # JAX fences its gathered bf16 cotangent stream; the port has none, so
        # the fence is timed on the [N, D] bf16 cotangent (it reads one block)
        x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev).to(torch.bfloat16)
        fb = 8 * 128 * 2 + 8 * 128 * 4
        b_ms, b_by = bound(fb, 8 * 128, "float32")
        line = {"phase": "timing", "kernel": "gather_fence", "shape": f"[{n}, {d}] bfloat16",
                "ms": time_ms(lambda: gather_fence(x)), "plain_ms": time_ms(lambda: gather_fence_plain(x), 5),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "bound_bytes": fb}
        emit(line)
        rows["gather_fence"] = line
        for dt in (torch.float32, torch.bfloat16):
            sz, dname = (4 if dt == torch.float32 else 2), str(dt)[6:]
            x = catalog.to(dt)
            for b in (1, 8, 64):
                q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev).to(dt)
                k = 32  # the served kk: k=20 plus history, rounded up to 32
                r = k + CHUNK_MARGIN
                cm = chunk_max(x, q)
                cid = select_chunks(cm, r, CATALOG)
                scores = rescore(x, q, cid).flatten(1)
                shape = f"N={CATALOG} D={d} B={b} {dname}"
                cm_b = topk_bound(b, CATALOG, d, dname)
                rs_b = rescore_bound(b, r, d, sz, cid)
                line = {"phase": "timing", "kernel": "topk_chunkmax", "shape": shape,
                        "ms": time_ms(lambda: chunk_max(x, q)),
                        "plain_ms": time_ms(lambda: chunk_max_plain(x, q), 5), **cm_b,
                        "library_ms": None}
                emit(line)
                if dt == torch.float32 and b == 64:
                    rows["topk_chunkmax"] = line  # the served dtype at the batcher's cap
                lines = {
                    "topk_rescore": (time_ms(lambda: rescore(x, q, cid)),
                                     time_ms(lambda: rescore_plain(x, q, cid), 5), rs_b, None),
                    "topk_mips": (time_ms(lambda: topk_mips(x, q, k)),
                                  time_ms(lambda: topk_mips_ref(x, q, k), 5),
                                  (cm_b["bound_ms"] + rs_b[0], cm_b["bound_by"]),
                                  time_ms(lambda: torch.topk(q @ x.T, k, dim=1))),
                }
                for kname, (k_ms, p_ms, (b_ms, b_by), lib) in lines.items():
                    line = {"phase": "timing", "kernel": kname, "shape": shape, "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "ops_dtype": "float32" if kname == "topk_rescore" else dname, "library_ms": lib}
                    if kname == "topk_rescore":
                        line["device_ms"] = device_ms(lambda: rescore(x, q, cid), ("rescore",))
                    emit(line)
                    if dt == torch.float32 and b == 64:
                        rows[kname] = line
                emit({"phase": "timing", "what": "topk_mips split", "shape": shape, "k": k,
                      **topk_phase_split(x, q, k)})
                for line in time_select(shape, cm, cid, scores, r, k):
                    if dt == torch.float32 and b == 64 and "final" in line["shape"]:
                        rows["topk_select"] = line
    time_rule2(rows, graph, dev)
    time_multihead(rows, graph, dev, rng)
    return rows


def time_select(shape: str, cm, cid, scores, r: int, k: int, **extra) -> list:
    """The select kernel in both modes on one batch's rows, beside
    `torch.topk` of the same rows: the first selection (r of the
    [B, n_chunks] maxima) and the final one (k of the [B, r * 128]
    scores). Bound: each input read once, each output written once; one
    comparison a value."""
    import torch

    from plotpointe_tpu_torch.ops.topk_kernel import (
        select_chunks, select_chunks_plain, select_items, select_items_plain)

    b = cm.shape[0]
    cases = (("first", cm, r, lambda: select_chunks(cm, r, CATALOG),
              lambda: select_chunks_plain(cm, r, CATALOG), {"x": cm.numel() * 4, "ids": b * r * 4}),
             ("final", scores, k, lambda: select_items(scores, cid, k),
              lambda: select_items_plain(scores, cid, k),
              {"x": scores.numel() * 4, "chunk_id": cid.numel() * 4, "ids": b * k * 4, "values": b * k * 4}))
    lines = []
    for what, rows_in, rr, fn, plain, nbytes in cases:
        lib = lambda: torch.topk(rows_in, rr, dim=1)  # noqa: E731
        lines.append(timing_row(
            "topk_select", f"{shape} {what} [{b}, {rows_in.shape[1]}] r={rr}", fn, plain, nbytes,
            rows_in.numel(), "float32", library=lib, library_what=f"torch.topk(x, {rr}, dim=1)",
            device_ms=device_ms(fn, SELECT_KERNELS), library_device_ms=device_ms(lib), **extra))
    return lines


def run(args, work: Path, dev="cuda") -> int:
    import torch

    import plotpointe_tpu_torch  # noqa: F401  (without the package: fail before any output)
    from plotpointe_tpu_torch.config import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    rng = np.random.default_rng(args.seed)
    inter, s, feats, graph, (h0, a_s, a_d) = phase_data(args, rng, dev)
    catalog = torch.as_tensor(rng.normal(size=(CATALOG, 128)).astype(np.float32), device=dev)

    errs = Errors()
    phase_check(errs, rng, graph, h0, a_s, a_d, catalog, dev)
    write_artifacts(work, inter, feats)
    by_path = {}
    gat = dict(hidden_dim=128, layers=args.layers, attn_dropout=0.1, epochs=args.epochs,
               samples_per_epoch=200_000, eval_neg_k=1000, attn_impl="auto", seed=args.seed)
    # path 1 and 2: the single-head GAT, trained, then exported and served
    trainer, ckpt, _, by_path["train"] = phase_train(
        "train", TrainConfig(heads=1, **gat), work, dev, PATH_KERNELS["train"],
        {"n_layers": args.layers, "hidden_dim": 128, "heads": 1})
    phase_step_parity("train", trainer)
    by_path["serve"] = phase_serve("main", work, ckpt, inter, feats, s.n_items, 128, 8, 64, dev,
                                   PATH_KERNELS["serve"])
    # path 3: LightGCN, one full epoch, then exported and served
    lg_cfg = TrainConfig(model_family="lightgcn", epochs=1, eval_neg_k=1000, spmm_impl="auto",
                         seed=args.seed, **LIGHTGCN)
    lg_trainer, lg_ckpt, lg_res, by_path["lightgcn_train"] = phase_train(
        "train_lightgcn", lg_cfg, work, dev, PATH_KERNELS["lightgcn_train"],
        {"model_family": "lightgcn", **{k: LIGHTGCN[k] for k in ("embed_dim", "n_prop_layers")}})
    lg_steps = s.n_train // LIGHTGCN["batch_size"]
    emit({"phase": "train_lightgcn", "steps_per_epoch": lg_steps, "train_interactions": s.n_train,
          "epoch_s": lg_res["history"][0]["step_time_s"]})
    phase_step_parity("train_lightgcn", lg_trainer)
    by_path["lightgcn_serve"] = phase_serve(
        "serve_lightgcn", work, lg_ckpt, inter, None, s.n_items, LIGHTGCN["embed_dim"], 8, 0, dev,
        PATH_KERNELS["lightgcn_serve"])
    # path 4: the 2-head GAT, trained, then exported
    mh_trainer, mh_ckpt, _, by_path["mh_train"] = phase_train(
        "train_mh", TrainConfig(heads=MH_HEADS, **gat), work, dev, PATH_KERNELS["mh_train"],
        {"n_layers": args.layers, "hidden_dim": 128, "heads": MH_HEADS})
    phase_step_parity("train_mh", mh_trainer)
    by_path["mh_export"] = phase_serve("export_mh", work, mh_ckpt, inter, feats, s.n_items, 128,
                                       0, 0, dev, PATH_KERNELS["mh_export"])
    # path 5: the graph-build stage, then kNN's fast mode
    by_path["graph_build"], by_path["graph_build_fast"], knn_feats, build_knn_s = phase_graph_build(
        errs, work, inter, s, args.seed, dev)
    # path 6: the smoke check and the measured peaks
    by_path["tooling"], peaks = phase_tooling(errs, dev)
    # path 7: the legacy attention contracts on a tiled graph
    by_path.update(phase_legacy(errs, rng, s, feats, graph, args.layers, dev))
    # paths 8 and 9: the quality anchor at full shape, then the ablation sweep on its data
    by_path["anchor"], anchor_data = phase_anchor(work, dev)
    by_path["ablate"] = phase_ablate(work, anchor_data, dev)
    del anchor_data

    rows = phase_timing(rng, graph, h0, a_s, a_d, catalog, trainer, s, dev)
    time_train_step("gat", trainer, s, samples=trainer.cfg.samples_per_epoch)
    time_train_step("lightgcn", lg_trainer, s, batch=LIGHTGCN["batch_size"],
                    negatives_per_positive=LIGHTGCN["neg_per_pos"], steps_per_epoch=lg_steps,
                    epoch_s=lg_res["history"][0]["step_time_s"])
    time_train_step("gat_2_heads", mh_trainer, s, samples=mh_trainer.cfg.samples_per_epoch)
    time_knn(rows, knn_feats, build_knn_s)
    time_tooling_and_legacy(rows, graph, h0, a_s, a_d, dev)

    kernels = []
    for kname, (src_path, replaces) in SOURCES.items():
        t = rows[kname]
        paths = {p: by_path[p][kname] for p, ks in PATH_KERNELS.items() if kname in ks}
        kernels.append({"name": kname, "route": "cuda", "source": src_path, "replaces": replaces,
                        "launches": sum(paths.values()), "launches_by_path": paths,
                        "max_abs_err": errs.max[kname], "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "sol_fraction": t["bound_ms"] / t["ms"],
                        "sol_fraction_dev": sol_fraction_dev(t, peaks), "shape": t["shape"],
                        **({"ops_route": t["ops_route"]} if "ops_route" in t else {})})
    if "jax" in sys.modules or any(m.startswith("plotpointe_tpu.") or m == "plotpointe_tpu"
                                   for m in sys.modules):
        raise AssertionError("the port pulled in JAX or the JAX package")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
