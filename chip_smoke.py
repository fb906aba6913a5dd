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
           degree skew sigma 0.83 / 1.52) and 384-d item features; the main
           graph built on the native host library (`native.backend()` must
           be "native") and again through its lexsort path, the same bits,
           with both host times
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
           operator's gradients vs autograd of the plain goldens; the eval's
           rank kernel at one eval chunk (2,048 users x 1,001 candidates of
           63,001 rows, D 64 and 128) equal to the dense product's ranks and
           ties on rows whose scores are exact, and on a second launch; the
           HGT kernels at 8 heads x 32 on the typed graph, and the 3xTF32
           dense products (`ops/dense.linear`: forward, dx, dw) at the HGT
           layer's four product shapes against an f64 product, each within
           2x cuBLAS f32's error (TF32 off), the same bits twice
  train    path 1, every launch counter set to 0 first: `train_from_artifacts`
           (interactions.npz + features npy -> `--epochs` optimizer steps of
           200,000 BPR triples with dropout 0.1 and bf16 rows, a 1,000-negative
           val eval per epoch, best checkpoint in the JAX npz format); losses
           must be finite and the attention kernels and the eval's rank
           kernel must have launched; then
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
  anchor   path 8, the quality anchor: counters at 0, `cli anchor --scale
           full` in-process with the gate's defaults and the port's
           baseline file (`tools/anchor_baseline.json`), its own call of the
           generator timed (host seconds, peak host memory) and its data
           kept for path 9 (no second run of the generator):
           the chance, popularity, inverse-popularity and factor-oracle
           baselines, the untrained GAT, the reference protocol (20 epochs
           of one 200,000-sample Adam step, bf16 rows) and the 32-step
           beyond-parity leg (adam; the gate skips the adamw leg). The gate
           must print PASS; the dataset block and generator config must
           equal `docs/results/anchor_full_r05.json`'s and the baselines'
           NDCG@20 lie within 0.005 of its; kernels 1, 2 and 3 and the
           eval's rank kernel must have launched. Each leg's metrics and wall beside the archive's
  ablate   path 9, the anchor's data as interactions.npz with its 128-d
           (fused) and 384-d (txt) features, then, counters at 0, `cli
           ablate` in-process over the seven variants at 1 epoch of 200,000
           samples: no variant may report an error; kernels 1, 2, 3, 7, 8
           and 9 and the eval's rank kernel must have launched
  serve_telemetry
           path 10, counters at 0 first, on path 2's export (63,001 x 128
           f32): a micro-batching stdlib server loaded by
           `ServingState.startup_from_env()` with durable telemetry (fsync a
           record): 32 concurrent /recommend requests with user keys, one
           /feedback per reply, an out-of-range request (400, one reject
           line) and a bad feedback (400); every good reply 200 with a
           request_id and the plain answer's scores; the queues reopened from
           disk hold exactly those 32 requests and 32 feedbacks and drain to
           a backlog of 0 with no dead letters; `cli drift` counts 32;
           kernels 4, 5 and the select kernel must have launched. Then
           `python -m plotpointe_tpu_torch.serving` in a subprocess
           (environment-configured, SERVING_USE_DEVICE unset: the card; 8
           requests held to the plain answer, its JSONL log 8 lines; killed
           by its PID) and the wall of 8 sequential requests with telemetry
           off, JSONL and durable
  serve_bench
           path 11, counters at 0 first: `tools/serve_bench.main` in-process
           at JAX's defaults (498,196 x 128 seeded catalog, bf16 table, 64
           clients, the kernel top-K), `--seconds 3` (JAX: 10): served QPS,
           p50/p95 latency, mean batch and dispatch ms of the single,
           micro-batched and loopback modes; every mode must serve requests
           and kernels 4, 5 and the select kernel must have launched
  embed    path 12, counters at 0 first, the embedding stages at full
           width on a seeded 498,196-row catalog of the data phase's items:
           the MiniLM tower (random-init weights saved through
           `save_checkpoint`, a vocab.txt of the catalog's words) through
           `embed_text_stage(weights=, vocab=)` over the first 16,384 rows
           at batch 128, S 256, f32 with TF32 off, held to the same tower in
           f32 on the CPU on 256 rows (1e-4), with the tower's time a batch
           beside its FLOP bound; the CLIP ViT-B/32 tower in bf16 at batch
           64 through `encode_image_files` over 1,024 seeded PNGs plus a
           corrupt and a missing file (2 failures; without PIL, printed as
           "decode": "absent", the tower on seeded pixel arrays), held to
           the CPU f32 tower (bf16 within 1e-2, the card's f32 within 1e-4);
           then the zero-egress default at the full catalog: the hash text
           stage, the URL-hash image stage unchunked, and in 4 chunks +
           `merge_image_chunks` over its first 20,000 rows (equal bits; cut
           from all 149,669), `fuse_stage` at
           FusionConfig's defaults (losses finite and falling; one step's
           loss and gradients on the card = the CPU's within GRAD_TOL;
           `fuse_all_items` on the card = the CPU's within 1e-5); the walls
           of compose, hash encode, fuse training and inference
  pipeline path 13, counters at 0 first: `cli pipeline --in-process` at a
           tenth of the Amazon shape (19,240 x 6,300 x 168,912, 43,520 extra
           items; cut from 192,403 x 63,001 x 1,689,116 and 435,195, whose
           stages paths 1-5, 8 and 12 run; hidden 128, 200,000 samples,
           1,000 negatives, 2 epochs): it must
           end "complete", leave every sentinel artifact and launch kernels
           10, 1, 2 and 3; the same command with `--continue` must skip
           every sentinel stage; then the subprocess mode `--parallel
           --image-chunks 4` at JAX's defaults in a fresh workdir (every
           lane on the card): exit 0, its img.npy equal to an unchunked
           image stage's; each stage's wall
  sharded  path 14, sharded training: (a) the main graph cut into 2 and 4
           destination ranges (`parallel/spmd.shard_graph_by_edges`); on
           each local graph kernels 1, 2, 3 (bf16 rows, the dropout mask
           over canonical ids from e_lo), 8 and 9 at 2 heads and 7 at D 64
           (both directions) vs their plain versions, then the shards'
           owned rows combined vs the unsharded kernels' output; (b) this
           process as a world of one NCCL rank, counters at 0 before each
           sharded run: `train_from_artifacts` with --mesh data:1 and
           without on the same seed for the GAT (2 epochs of one
           200,000-triple step, dropout 0.1), the 2-head GAT (1 epoch) and
           LightGCN (1 epoch): losses, test metrics and exported item rows
           held to the unsharded run's (loss rtol 5e-4, LightGCN 5e-3;
           metrics atol 2e-3; rows rtol 5e-3 / atol 5e-5); kernels 1, 2,
           3, 7, 8 and 9 must have launched; the sharded GAT step by phase
           and profiled beside the unsharded one's; one step's collectives
           from the recorder, held to `tools/scaling_audit`'s at n = 1;
           (c) `tools/multihost_smoke` as 2 processes on this card over
           gloo (one step, then --fit) and as 1: equal losses in both
           processes, within 5e-4 of the one process's, staging through
           host tensors, and the 2-rank step's recorded collectives held to
           the audit's at n = 2 (the tool's shape); (d)
           `dryrun_multichip(1)`; (e) the audit at 1, 2, 4 and 8 shards of
           the main graph and the efficiency predicted at 8 H100s from
           (b)'s step and NVLink's 450 GB/s spec, labelled a prediction
  deploy   path 15, the deployment tools: (a) `cli provision` on
           deploy_torch/infra.yaml into a fresh root (the first apply as
           `python -m plotpointe_tpu_torch.cli` in a subprocess, the rest
           through `cli.main`): apply creates every resource (4 materialised,
           the gpu_vm and the service account recorded with their gcloud
           lines), a second apply is all noops, each provisioned queue takes
           one record in the port's DurableQueue and gives it back, render
           prints the gpu_vm's `gcloud compute instances create` line, and
           destroy leaves an empty state and no materialised directory; (b)
           `cli jobs list` shows the 8 H100 specs, then `tools.jobs.run_job`
           runs the graph-build spec and the GAT training spec (EPOCHS 2) on
           path 13's `--parallel` artifacts (2,000 x 1,200 x 50,000): each
           returns 0 and leaves its artifacts (ui_edges, the kNN npz held as
           path 5 holds it, one checkpoint, resume.pt, metrics with finite
           losses), counters at 0 first; the jobs' child processes append
           their launch counts to a log (PLOTPOINTE_LAUNCH_LOG), which must
           show kernel 10, then kernels 1, 2 and 3; then the training spec
           with CUDA_VISIBLE_DEVICES empty and no restarts must exit non-zero
           with "CUDA is not available"; each wall
  walls    the host seconds of each group of phases above and the total
  timing   CUDA-event times of each kernel, its plain version and, where one
           PyTorch call computes the same function, that call (for the
           gather fence, `torch.sum` of the same [8, 128] corner); the bound with
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
           its yardstick; kernels 8 and 9 per layer; the GATv2 kernels
           (forward, B1, B2) at 2 heads x 128; the HGT kernels, then the
           3xTF32 products (forward, dx, dw at each HGT product shape)
           beside cuBLAS f32 with the device launches of a call, and the
           layer's typed products written into q and kv (`linear_into`)
           against per-type products, `split` and `cat`; the LightGCN and 2-head
           steps by phase, profiled; kernels 10 and 11 at the graph-build
           shapes beside a blocked `torch.mm` of the same product; the eval's
           rank kernel at one eval chunk (D 128 and 64) beside the dense
           product and gathers, its bound at the measured L2 and
           device-memory read rates
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
import os
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
# a leaf whose plain gradient's largest entry is under this share of the median
# leaf's is zero but for round-off (the HGT's last item output bias: every item
# score difference cancels it) and is held to that floor on both sides
ZERO_GRAD_SHARE = 1e-4
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
    # the eval's ranks: an XLA product and gathers in the JAX package, not a Pallas kernel
    "eval_rank": ("plotpointe_tpu_torch/csrc/eval_rank.cu", "plotpointe_tpu/train/evaluate.py:47"),
    # GATv2 is port-only: the JAX package has no counterpart, the plain reference is benchmark/reference/gatv2.py
    "gatv2_fwd": ("plotpointe_tpu_torch/csrc/gatv2_fwd.cu", None),
    "gatv2_bwd_dst": ("plotpointe_tpu_torch/csrc/gatv2_bwd_dst.cu", None),
    "gatv2_bwd_src": ("plotpointe_tpu_torch/csrc/gatv2_bwd_src.cu", None),
    # HGT is port-only too: the plain reference is benchmark/reference/hgt.py
    "hgt_fwd": ("plotpointe_tpu_torch/csrc/hgt_fwd.cu", None),
    "hgt_bwd_dst": ("plotpointe_tpu_torch/csrc/hgt_bwd_dst.cu", None),
    "hgt_bwd_src": ("plotpointe_tpu_torch/csrc/hgt_bwd_src.cu", None),
    # the HGT layer's f32 products (cuBLAS's before): the plain version is `ops/dense.mm_3xtf32_plain`
    "dense_3xtf32": ("plotpointe_tpu_torch/csrc/dense_3xtf32.cu", None),
}
# the kernels each path must launch; gather_fence is on none (the port's
# backward kernels gather rows themselves, so there are no two XLA gathers
# to order) and is only checked and timed
PATH_KERNELS = {"train": ("gat_fwd", "gat_bwd_dst", "gat_bwd_src", "eval_rank"),
                "serve": ("gat_fwd", "topk_chunkmax", "topk_rescore", "topk_select"),
                "lightgcn_train": ("spmm_csr", "eval_rank"),
                "lightgcn_serve": ("spmm_csr", "topk_chunkmax", "topk_rescore", "topk_select"),
                "mh_train": ("gat_fwd_mh", "gat_bwd_dst_mh", "gat_bwd_src", "eval_rank"),
                "mh_export": ("gat_fwd_mh",),
                "gatv2_train": ("gatv2_fwd", "gatv2_bwd_dst", "gatv2_bwd_src", "eval_rank"),
                "gatv2_export": ("gatv2_fwd",),
                "hgt_train": ("hgt_fwd", "hgt_bwd_dst", "hgt_bwd_src", "eval_rank", "dense_3xtf32"),
                "graph_build": ("knn_topk",),
                "graph_build_fast": ("knn_topk_fast",),
                "tooling": ("smoke_affine", "stream_probe"),
                "legacy_v2": ("fused_layer",),
                "legacy_v1": ("fused_segment_reduce",),
                "legacy_v1_mh": ("onehot_reduce",),
                "anchor": ("gat_fwd", "gat_bwd_dst", "gat_bwd_src", "eval_rank"),
                "ablate": ("gat_fwd", "gat_bwd_dst", "gat_bwd_src", "spmm_csr", "gat_fwd_mh",
                           "gat_bwd_dst_mh", "eval_rank"),
                "serve_telemetry": ("topk_chunkmax", "topk_rescore", "topk_select"),
                "serve_bench": ("topk_chunkmax", "topk_rescore", "topk_select"),
                "embed": (),  # plain PyTorch ops, as the JAX towers and fusion are plain XLA
                "pipeline": ("knn_topk", "gat_fwd", "gat_bwd_dst", "gat_bwd_src"),
                "sharded": ("gat_fwd", "gat_bwd_dst", "gat_bwd_src", "gat_fwd_mh", "gat_bwd_dst_mh",
                            "spmm_csr"),
                # launched by the job specs' child processes, read from their launch logs
                "deploy": ("knn_topk", "gat_fwd", "gat_bwd_dst", "gat_bwd_src")}
# the legacy phase's configurations: (path, hidden, heads); v2 takes 1 head
# with D % 128 == 0, v1 the rest (64 is the reference's hidden-dim ablation)
LEGACY = (("legacy_v2", 128, 1), ("legacy_v1", 64, 1), ("legacy_v1_mh", 128, 2))
LIGHTGCN = dict(embed_dim=64, n_prop_layers=3, batch_size=8192, neg_per_pos=5)
EVAL_CHUNK, EVAL_NEG_K = 2048, 1000  # an eval chunk (TrainConfig.eval_chunk) and its negatives
# the quality anchor's archived JAX run at full shape, and how near the
# port's reference-free baselines must land (their negatives are other draws)
ARCHIVED_ANCHOR = "docs/results/anchor_full_r05.json"
ANCHOR_BASELINES = ("chance", "popularity", "inverse_popularity", "factor_oracle")
ANCHOR_BASELINE_TOL = 0.005
MH_HEADS = 2
# the libraries whose ptxas lines (registers, spills, shared memory) the build line carries
PTXAS_REPORTED = ("knn_topk", "knn_topk_fast", "gat_fwd", "gat_bwd_dst", "gat_bwd_src", "topk_chunkmax",
                  "topk_rescore", "topk_select", "dense_3xtf32")
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

    def within(self, name: str, what: str, got, want, band) -> None:
        """|got - want| within `band`, a tolerance of each entry's own (a sum
        over a node's edges widened by the bound of its f32 summation)."""
        diff = (got - want).abs()
        err = float(diff.max()) if got.numel() else 0.0
        excess = float((diff - band).max()) if got.numel() else 0.0
        self.max[name] = max(self.max.get(name, 0.0), err)
        emit({"phase": "check", "kernel": name, "case": what, "max_abs_err": err,
              "max_excess_over_band": excess, "ok": excess <= 0})
        if excess > 0:
            raise AssertionError(f"{name} ({what}) disagrees with its plain version: {excess} past its band")

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
    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.train.checkpoint import params_from_jax

    t0 = time.perf_counter()
    inter = amazon_shaped_interactions(args.seed)
    s = build_splits(inter, *build_node_maps(inter))
    feats = rng.normal(size=(s.n_items, 384)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    graph, native_line = native_graph(s)
    graph = graph.to(dev)
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
          "layers": args.layers, "hidden": 128, "feat_dim": 384, "catalog": [CATALOG, 128], **native_line})
    return inter, s, feats, graph, (h0, a_s, a_d)


def native_graph(s):
    """The main graph from the native host library (`native.backend()` must
    be "native": g++ built it) and again through the lexsort path that the
    library's absence takes (`native.build_csr_numpy`); both must be the
    same bits. Returns the graph and its line's fields with both host times."""
    from unittest import mock

    from plotpointe_tpu_torch import native
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph

    t0 = time.perf_counter()
    backend = native.backend()  # builds the library on first use
    build_s = time.perf_counter() - t0
    if backend != "native":
        raise AssertionError(f"native.backend() is {backend!r}: the host library did not build or load")
    t0 = time.perf_counter()
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    native_s = time.perf_counter() - t0
    with mock.patch.object(native, "build_csr", native.build_csr_numpy):
        t0 = time.perf_counter()
        plain = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
        lexsort_s = time.perf_counter() - t0
    equal = {k: bool(np.array_equal(getattr(graph, k).numpy(), getattr(plain, k).numpy()))
             for k in ("src", "dst", "weight", "row_ptr", "t_ptr", "t_dst", "t_eid")}
    if not all(equal.values()):
        raise AssertionError(f"build_graph with the native library differs from the lexsort path: {equal}")
    return graph, {"native_backend": backend, "native_build_s": build_s,
                   "build_graph_native_s": native_s, "build_graph_lexsort_s": lexsort_s,
                   "build_graph_bit_equal": True}


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


def check_gatv2(errs, label, g, dev) -> None:
    """The GATv2 kernels (`csrc/gatv2_*.cu`) vs their plain versions at the
    `gatv2-amazon` cell's 2 heads x 128: bf16 rows with dropout 0.1
    (training), f32 rows without (the export). Tolerances as in
    tests/test_torch_gatv2.py: the forward within ATTN_TOL; B1's per-edge
    (al, ds) within GRAD_TOL; a node's sum over its edges (dxr, dxl) within
    GRAD_TOL widened by twice the bound of an f32 sum in any order (entries
    x 2^-24 x sum |terms|); da, a sum over every edge, within GRAD_TOL's
    rtol and its atol x sqrt(E); the signs of z equal wherever |z| > 1e-6;
    the same bits on a second launch. Inputs from a generator of their own,
    so the numpy stream of the later phases is unchanged."""
    import torch

    from plotpointe_tpu_torch.ops import gatv2 as op

    own = np.random.default_rng(23)
    n, e, heads, d = g.n_nodes, g.n_edges, 2, 128
    src, dst = g.src.long(), g.dst.long()

    def t(*shape, scale=0.3):
        return torch.as_tensor((own.normal(size=shape) * scale).astype(np.float32), device=dev)

    def sums(name, what, got, want, rows, terms_abs):
        depth = torch.bincount(rows, minlength=n).float()[:, None, None]
        mag = torch.zeros_like(got).index_add_(0, rows, terms_abs)
        band = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * want.abs() + 2 * 2.0 ** -24 * depth * mag
        errs.within(name, what, got, want, band)

    xl, xr, a, ct = t(n, heads, d), t(n, heads, d), t(heads, d), t(n, heads, d, scale=1.0)
    da_tol = dict(rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"] * e ** 0.5)
    with torch.no_grad():
        for rows_dt, rate in ((torch.bfloat16, 0.1), (torch.float32, 0.0)):
            what = f"{label} N={n} E={e} H={heads} D={d} rows={str(rows_dt)[6:]} dropout={rate}"
            rl = xl.to(rows_dt).contiguous()
            fa = (rl, xr, a, g, rate, 7)
            got = op.gatv2_fwd(*fa)
            out, den = op.gatv2_fwd_plain(*fa)
            errs.check("gatv2_fwd", what + " out", got[0], out, ATTN_TOL)
            errs.check("gatv2_fwd", what + " den", got[1], den, ATTN_TOL)
            errs.same_bits("gatv2_fwd", what, got, op.gatv2_fwd(*fa))
            b1 = (rl, xr, a, ct, out, den, g, rate, 7)
            got = op.gatv2_bwd_dst(*b1)
            dxr, da, edge, signs = op.gatv2_bwd_dst_plain(*b1)
            errs.check("gatv2_bwd_dst", what + " edge (al, ds)", got[2], edge, GRAD_TOL)
            sums("gatv2_bwd_dst", what + " dxr", got[0], dxr, dst, edge[:, :, 1:2].abs() * a.abs())
            errs.check("gatv2_bwd_dst", what + " da", got[1], da, da_tol)
            clear = ((rl.float()[src] + xr[dst]).abs() > 1e-6).reshape(e, -1, op.vec_of(rows_dt)).all(-1)
            errs.equal("gatv2_bwd_dst", what + " signs of z where |z| > 1e-6", [got[3][clear]],
                       [signs[clear]])
            errs.same_bits("gatv2_bwd_dst", what, got, op.gatv2_bwd_dst(*b1))
            b2 = (ct, a, edge, signs, g)
            got = op.gatv2_bwd_src(*b2)
            terms = edge[:, :, :1].abs() * ct[dst].abs() + edge[:, :, 1:2].abs() * a.abs()
            sums("gatv2_bwd_src", what + " dxl", got, op.gatv2_bwd_src_plain(*b2), src, terms)
            errs.same_bits("gatv2_bwd_src", what, [got], [op.gatv2_bwd_src(*b2)])
            del got, out, den, dxr, da, edge, signs, clear, terms, rl, fa, b1, b2
    del xl, xr, a, ct
    sync()


def hgt_graph(s, feats, work: Path, dev):
    """The typed graph of the `hgt-amazon` configuration over the main
    graph's train split: the item kNN of the main features (k 20,
    min_similarity 0.0, `benchmark/reference/hgt.knn_edges`), also written as
    the `ii_edges_hgt.npz` artifact the HGT path trains from."""
    import torch

    from benchmark.reference.hgt import knn_edges
    from plotpointe_tpu_torch.graphs.hetero import build_hetero_graph

    rows, cols = knn_edges(torch.as_tensor(feats, device=dev), 20, 0.0)
    (work / "graphs").mkdir(parents=True, exist_ok=True)
    np.savez(work / "graphs" / "ii_edges_hgt.npz", row=rows.astype(np.int32), col=cols.astype(np.int32),
             data=np.ones(len(rows), np.float32))
    g = build_hetero_graph(s.train_u, s.train_i, s.n_users, s.n_items, rows, cols)
    emit({"phase": "data", "what": "hgt typed graph", "targets": g.n_nodes, "stacked_rows": g.n_rows,
          "edges": g.n_edges, "edges_by_relation": list(g.rel_edges),
          "max_in_degree": int((g.row_ptr[1:] - g.row_ptr[:-1]).max())})
    return g.to(dev)


def check_hgt(errs, label, g, dev) -> None:
    """The HGT kernels (`csrc/hgt_*.cu`) vs their plain versions at the
    `hgt-amazon` cell's 8 heads x 32: bf16 rows (training) and f32 rows (the
    export). Tolerances as in tests/test_torch_hgt.py: the forward (out,
    lse) within ATTN_TOL; B1's per-edge (c | alpha) within GRAD_TOL; a row's
    sum over its edges (dq over in-edges, dkv over a stacked row's edges)
    within GRAD_TOL widened by twice the bound of an f32 sum in any order;
    dp, a sum over every edge, within GRAD_TOL's rtol and its atol x
    sqrt(E); the same bits on a second launch. Inputs from a generator of
    their own."""
    import torch

    from plotpointe_tpu_torch.ops import hgt as op

    own = np.random.default_rng(29)
    n, e, heads, d = g.n_nodes, g.n_edges, 8, 32
    src, dst = g.src.long(), g.dst.long()

    def t(*shape, scale=0.5):
        return torch.as_tensor((own.normal(size=shape) * scale).astype(np.float32), device=dev)

    def sums(name, what, got, want, rows, terms_abs):
        shape = (-1,) + (1,) * (got.dim() - 1)
        depth = torch.bincount(rows, minlength=got.shape[0]).float().view(shape)
        mag = torch.zeros_like(got).index_add_(0, rows, terms_abs)
        band = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * want.abs() + 2 * 2.0 ** -24 * depth * mag
        errs.within(name, what, got, want, band)

    q, kv, ct = t(n, heads, d), t(g.n_rows, 2, heads, d), t(n, heads, d, scale=1.0)
    p = torch.as_tensor(own.uniform(0.5, 1.5, (3, heads)).astype(np.float32), device=dev)
    scale = d ** -0.5
    dp_tol = dict(rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"] * e ** 0.5)
    with torch.no_grad():
        for rows_dt in (torch.bfloat16, torch.float32):
            what = f"{label} N={n} S={g.n_rows} E={e} H={heads} D={d} rows={str(rows_dt)[6:]}"
            rows = kv.to(rows_dt).contiguous()
            fa = (q, rows, p, g, scale)
            got = op.hgt_fwd(*fa)
            out, lse = op.hgt_fwd_plain(*fa)
            errs.check("hgt_fwd", what + " out", got[0], out, ATTN_TOL)
            errs.check("hgt_fwd", what + " lse", got[1], lse, ATTN_TOL)
            errs.same_bits("hgt_fwd", what, got, op.hgt_fwd(*fa))
            b1 = (q, rows, p, ct, out, lse, g, scale)
            got = op.hgt_bwd_dst(*b1)
            dq, dp, edge = op.hgt_bwd_dst_plain(*b1)
            errs.check("hgt_bwd_dst", what + " edge (c | alpha)", got[2], edge, GRAD_TOL)
            sums("hgt_bwd_dst", what + " dq", got[0], dq, dst, edge[:, :heads, None].abs() * rows[:, 0].float()[src].abs())
            errs.check("hgt_bwd_dst", what + " dp", got[1], dp, dp_tol)
            errs.same_bits("hgt_bwd_dst", what, got, op.hgt_bwd_dst(*b1))
            got = op.hgt_bwd_src(q, ct, edge, g)
            terms = torch.stack([edge[:, :heads, None].abs() * q[dst].abs(),
                                 edge[:, heads:, None].abs() * ct[dst].abs()], 1)
            sums("hgt_bwd_src", what + " dkv", got, op.hgt_bwd_src_plain(q, ct, edge, g), src, terms)
            errs.same_bits("hgt_bwd_src", what, [got], [op.hgt_bwd_src(q, ct, edge, g)])
            del got, out, lse, dq, dp, edge, terms, rows, fa, b1
    del q, kv, ct
    sync()
    check_dense(errs, label, g, dev)


def dense_shapes(g) -> list:
    """The HGT layer's products at the typed graph's sizes: (what, rows, N)
    of x [rows, 256] @ w [256, N] (hgt-amazon's 256 wide)."""
    f = 256
    return [("users typed", g.n_users, 3 * f), ("items typed", g.n_items, 5 * f),
            ("users output", g.n_users, f), ("items output", g.n_items, f)]


def dense_operands(rng, m: int, k: int, n: int, dev):
    """x [m, k] N(0, 1), w [k, n] U(+-1/sqrt(k)) (the layer's init), a bias
    [n] and an output gradient [m, n] N(0, 1)."""
    import torch

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    return (t(rng.normal(size=(m, k))), t(rng.uniform(-1, 1, size=(k, n)) / k ** 0.5), t(rng.normal(size=n)),
            t(rng.normal(size=(m, n))))


def check_dense(errs, label, g, dev) -> None:
    """The 3xTF32 products as the HGT layer runs them (`dense.linear` and
    its autograd backward) at each product shape of the typed graph: y = x w
    + b, dx and dw, each within 2x the max abs error of cuBLAS f32 (TF32
    off, `reference_versions()`) on the same inputs against an f64 product;
    the same bits on a second call. Inputs from a generator of their own."""
    import torch

    from plotpointe_tpu_torch import reference_versions
    from plotpointe_tpu_torch.ops import dense

    own = np.random.default_rng(31)
    for what, m, n in dense_shapes(g):
        x, w, b, gy = dense_operands(own, m, 256, n, dev)

        def run():
            leaves = [v.clone().requires_grad_(True) for v in (x, w, b)]
            y = dense.linear(*leaves)
            return (y.detach(), *torch.autograd.grad(y, leaves[:2], gy))

        got = run()
        with reference_versions():
            cublas = run()
        exact = (torch.addmm(b.double(), x.double(), w.double()), gy.double() @ w.double().T,
                 x.double().T @ gy.double())
        case = f"{label} {what} [{m}, 256] @ [256, {n}]"
        for name, a, c, e in zip(("forward", "dx", "dw"), got, cublas, exact):
            lib = float((c.double() - e).abs().max())
            errs.within("dense_3xtf32", f"{case} {name} against f64, cuBLAS f32 {lib:.4g}: within 2x", a, e,
                        2 * lib)
        errs.same_bits("dense_3xtf32", case, got, run())
        del x, w, b, gy, got, cublas, exact
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
        check_gatv2(errs, label, g, dev)
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
    check_eval_rank(errs, dev)
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
    worst, bad, roundoff = {}, [], []
    floor = ZERO_GRAD_SHARE * float(np.median([float(w.abs().max()) for w in gp.values()]))
    for name, want in gp.items():
        scale = float(want.abs().max())
        worst[name] = float((gk[name] - want).abs().max()) / max(scale, 1e-30)
        if scale < floor:  # a gradient that is zero but for round-off: both sides must stay under the floor
            roundoff.append(name)
            if float(gk[name].abs().max()) >= floor:
                bad.append(name)
        elif not torch.allclose(gk[name], want, rtol=STEP_RTOL, atol=STEP_ATOL_OF_MAX * scale):
            bad.append(name)
    loss_ok = abs(lk - lp) <= LOSS_RTOL * abs(lp)
    emit({"phase": label, "check": "first step, kernels vs plain versions", "loss_kernels": lk,
          "loss_plain": lp, "grad_max_abs_err_over_max": worst,
          "tol": {"rtol": STEP_RTOL, "atol_of_max": STEP_ATOL_OF_MAX, "loss_rtol": LOSS_RTOL},
          "roundoff_leaves": roundoff, "roundoff_floor": floor, "ok": loss_ok and not bad})
    if not loss_ok or bad:
        raise AssertionError(f"{label} step: loss {lk} vs {lp}, gradients off: {bad}")
    model.zero_grad(set_to_none=True)


def phase_step_parity(label: str, tr) -> None:
    """The first step of a trainer's path (GAT, HGT or LightGCN) from its initial
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

    return stats | check_replies(npy, histories, replies)


def check_replies(npy: str, histories, replies, k: int = 20) -> dict:
    """Every reply 200, k items, none of its history, and its scores within
    SERVE_RTOL of the plain CPU answer for the same history."""
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig

    codes = [r[0] if r else None for r in replies]
    if any(c != 200 for c in codes):
        raise AssertionError(f"/recommend replies not all 200: {codes}")
    plain_rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=npy, device="cpu",
                                                use_kernel_topk=False))
    plain_rt.startup()
    worst = 0.0
    for h, (_, body) in zip(histories, replies):
        _, want = plain_rt.top_k_for_user_items(h, k=k)
        got = np.sort(np.asarray(body["scores"], np.float64))
        want = np.sort(want.astype(np.float64))
        if len(got) != k or set(body["indices"]) & set(h):
            raise AssertionError(f"bad reply for history {h}: {body}")
        worst = max(worst, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12))))
    if worst > SERVE_RTOL:
        raise AssertionError(f"served scores differ from the plain answer by {worst} relative")
    return {"status_codes": sorted(set(codes)), "served_max_rel_err_vs_plain": worst}


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
    return sum(step.values())


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


def time_gatv2(rows_out, graph, dev, rng) -> None:
    """The GATv2 kernels (`csrc/gatv2_*.cu`) at the `gatv2-amazon` cell's 2
    heads x 128 on the main graph: the forward at f32 rows without dropout
    (the export) and at bf16 rows with dropout 0.1 (training), then B1 and
    B2 on that forward; each beside its plain version, with its bound
    (`benchmark/counts/gatv2.py`), its gather ceiling and its largest gap to
    the plain output."""
    import torch

    from benchmark.counts import gatv2 as counts
    from plotpointe_tpu_torch.ops import gatv2 as op

    n, e, hh, d = graph.n_nodes, graph.n_edges, 2, 128

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)

    def gap(got, want):
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))

    xl, xr, a, g = t(n, hh, d, scale=0.3), t(n, hh, d, scale=0.3), t(hh, d, scale=0.1), t(n, hh, d)
    with torch.no_grad():
        for rows_dt, rate in ((torch.float32, 0.0), (torch.bfloat16, 0.1)):
            isz, dname = (4 if rows_dt == torch.float32 else 2), str(rows_dt)[6:]
            shape = f"N={n} E={e} H={hh} D={d} rows={dname} dropout={rate}"
            fa = (xl.to(rows_dt).contiguous(), xr, a, graph, rate, 7)
            out, den = op.gatv2_fwd(*fa)
            nbytes = counts.fwd_bytes(n, e, hh, d, isz)
            line = timing_row("gatv2_fwd", shape, lambda: op.gatv2_fwd(*fa), lambda: op.gatv2_fwd_plain(*fa),
                              nbytes, counts.fwd_ops(e, hh, d), "float32", plain_iters=2,
                              max_abs_err=gap((out, den), op.gatv2_fwd_plain(*fa)),
                              gather_ms=gather_ms(nbytes, e, hh * d * isz))
            if rows_dt == torch.float32:
                continue
            rows_out["gatv2_fwd"] = line
            b1 = (fa[0], xr, a, g, out, den, graph, rate, 7)
            dxr, da, edge, signs = op.gatv2_bwd_dst(*b1)
            want = op.gatv2_bwd_dst_plain(*b1)
            nbytes = counts.bwd_dst_bytes(n, e, hh, d, isz)
            rows_out["gatv2_bwd_dst"] = timing_row(
                "gatv2_bwd_dst", shape, lambda: op.gatv2_bwd_dst(*b1), lambda: op.gatv2_bwd_dst_plain(*b1),
                nbytes, counts.bwd_dst_ops(e, hh, d), "float32", plain_iters=2,
                max_abs_err=gap((dxr, edge), want[:3:2]), da_max_abs_err=gap((da,), want[1:2]),
                signs_differ=int((signs != want[3]).sum()), gather_ms=gather_ms(nbytes, e, hh * d * isz))
            b2 = (g, a, edge, signs, graph)
            nbytes = counts.bwd_src_bytes(n, e, hh, d, isz)
            rows_out["gatv2_bwd_src"] = timing_row(
                "gatv2_bwd_src", shape, lambda: op.gatv2_bwd_src(*b2), lambda: op.gatv2_bwd_src_plain(*b2),
                nbytes, counts.bwd_src_ops(e, hh, d), "float32", plain_iters=2,
                max_abs_err=gap((op.gatv2_bwd_src(*b2),), (op.gatv2_bwd_src_plain(*b2),)),
                gather_ms=gather_ms(nbytes, e, hh * d * 4))
            del b1, b2, want, dxr, edge, signs
    del xl, xr, a, g


def time_hgt(rows_out, g, dev, rng) -> None:
    """The HGT kernels (`csrc/hgt_*.cu`) at the `hgt-amazon` cell's 8 heads x
    32 on the main typed graph: the forward at f32 rows (the export) and at
    bf16 rows (training), then B1 and B2 on that forward; each beside its
    plain version, with its bound (`benchmark/counts/hgt.py`), its gather
    ceiling and its largest gap to the plain output. Then the layer's
    products (`time_dense`)."""
    import torch

    from benchmark.counts import hgt as counts
    from plotpointe_tpu_torch.ops import hgt as op

    n, s_rows, e, hh, d = g.n_nodes, g.n_rows, g.n_edges, 8, 32

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)

    def gap(got, want):
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))

    q, kv, ct = t(n, hh, d, scale=0.5), t(s_rows, 2, hh, d, scale=0.5), t(n, hh, d)
    p = torch.as_tensor(rng.uniform(0.5, 1.5, (3, hh)).astype(np.float32), device=dev)
    scale = d ** -0.5
    with torch.no_grad():
        for rows_dt in (torch.float32, torch.bfloat16):
            isz, dname = (4 if rows_dt == torch.float32 else 2), str(rows_dt)[6:]
            shape = f"N={n} S={s_rows} E={e} H={hh} D={d} rows={dname}"
            fa = (q, kv.to(rows_dt).contiguous(), p, g, scale)
            out, lse = op.hgt_fwd(*fa)
            nbytes = counts.fwd_bytes(n, s_rows, e, hh, d, isz)
            line = timing_row("hgt_fwd", shape, lambda: op.hgt_fwd(*fa), lambda: op.hgt_fwd_plain(*fa),
                              nbytes, counts.fwd_ops(e, hh, d), "float32", plain_iters=2,
                              max_abs_err=gap((out, lse), op.hgt_fwd_plain(*fa)),
                              gather_ms=gather_ms(nbytes, e, 2 * hh * d * isz))
            if rows_dt == torch.float32:
                continue
            rows_out["hgt_fwd"] = line
            b1 = (*fa[:3], ct, out, lse, g, scale)
            dq, dp, edge = op.hgt_bwd_dst(*b1)
            want = op.hgt_bwd_dst_plain(*b1)
            nbytes = counts.bwd_dst_bytes(n, s_rows, e, hh, d, isz)
            rows_out["hgt_bwd_dst"] = timing_row(
                "hgt_bwd_dst", shape, lambda: op.hgt_bwd_dst(*b1), lambda: op.hgt_bwd_dst_plain(*b1),
                nbytes, counts.bwd_dst_ops(e, hh, d), "float32", plain_iters=2,
                max_abs_err=gap((dq, edge), want[::2]), dp_max_abs_err=gap((dp,), want[1:2]),
                gather_ms=gather_ms(nbytes, e, 2 * hh * d * isz))
            nbytes = counts.bwd_src_bytes(n, s_rows, e, hh, d)
            rows_out["hgt_bwd_src"] = timing_row(
                "hgt_bwd_src", shape, lambda: op.hgt_bwd_src(q, ct, edge, g),
                lambda: op.hgt_bwd_src_plain(q, ct, edge, g), nbytes, counts.bwd_src_ops(e, hh, d),
                "float32", plain_iters=2,
                max_abs_err=gap((op.hgt_bwd_src(q, ct, edge, g),), (op.hgt_bwd_src_plain(q, ct, edge, g),)),
                gather_ms=gather_ms(nbytes, e, 2 * hh * d * 4))
            del b1, want, dq, dp, edge
    del q, kv, ct
    time_dense(rows_out, g, dev, rng)


def kernels_per_call(fn, key: str, calls: int = 4, tries: int = 3) -> float | None:
    """Device kernels whose names hold `key` that one call of `fn` launches
    (torch.profiler, the mean of `calls` calls); None if no profile of
    `tries` recorded one."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if key in e.key)
        if n:
            return n / calls
    return None


def time_dense(rows_out, g, dev, rng) -> None:
    """The 3xTF32 kernel (`csrc/dense_3xtf32.cu`) at the HGT layer's product
    shapes on the typed graph: the forward (with the weight's split, as the
    op runs it), dx and dw, each beside its plain version
    (`dense.mm_3xtf32_plain`) and cuBLAS f32 (TF32 off), with the bound of
    its three TF32 passes and its compulsory bytes (each operand read once,
    C written once) and the device kernels one call launches (the product,
    the weight's split, the dw slabs' sum; the counter counts the product
    alone). Then the layer's typed products into q and kv: `linear_into`
    against each type's `linear`, `split` and `cat` (the layout before the
    tables were written in place), forward and forward + backward, with
    each one's peak of allocated device memory."""
    import torch

    from plotpointe_tpu_torch.models.hgt import typed_plan
    from plotpointe_tpu_torch.ops import dense

    k = 256
    for what, m, n in dense_shapes(g):
        x, w, b, gy = dense_operands(rng, m, k, n, dev)
        y, dx = torch.empty((m, n), device=dev), torch.empty((m, k), device=dev)
        cases = (("forward", (m, k, n), lambda: dense.mm(x, dense.split_weight(w, True), b, [y]),
                  lambda: dense.mm_3xtf32_plain(x, w) + b, lambda: torch.addmm(b, x, w)),
                 ("dx", (m, n, k), lambda: dense.mm_y([gy], dense.split_weight(w, False), dx),
                  lambda: dense.mm_3xtf32_plain(gy, w.T), lambda: gy @ w.T),
                 ("dw", (k, m, n), lambda: dense.mm_tn(x, [gy]), lambda: dense.mm_3xtf32_plain(x.T, gy),
                  lambda: x.T @ gy))
        for prod, (pm, pk, pn), fn, plain, lib in cases:
            flops = 2.0 * pm * pn * pk
            line = timing_row("dense_3xtf32", f"{what} {prod} [{pm}, {pk}] @ [{pk}, {pn}]", fn, plain,
                              {"a": 4 * pm * pk, "b": 4 * pk * pn, "c": 4 * pm * pn}, 3 * flops, "tfloat32",
                              library=lib, plain_iters=2, library_what="cuBLAS f32, TF32 off",
                              device_launches=kernels_per_call(fn, "tf32x3"), counted_launches=1)
            emit({"phase": "timing", "kernel": "dense_3xtf32", "shape": line["shape"],
                  "tflops": flops / line["ms"] / 1e9, "library_tflops": flops / line["library_ms"] / 1e9})
            if what == "users typed" and prod == "forward":
                rows_out["dense_3xtf32"] = line
        del x, w, b, gy, y, dx
    torch.cuda.empty_cache()

    u, f = g.n_users, 256
    plan = typed_plan(g, f)
    x = torch.as_tensor(rng.normal(size=(g.n_nodes, f)).astype(np.float32), device=dev)
    _, wu, bu, _ = dense_operands(rng, 1, f, 3 * f, dev)
    _, wi, bi, _ = dense_operands(rng, 1, f, 5 * f, dev)
    gq = torch.as_tensor(rng.normal(size=(g.n_nodes, f)).astype(np.float32), device=dev)
    gkv = torch.as_tensor(rng.normal(size=(g.n_rows, 2 * f)).astype(np.float32), device=dev)
    leaves = [v.requires_grad_(True) for v in (x, wu, bu, wi, bi)]

    def into(xx, *wbs):
        return dense.linear_into(xx, plan, *wbs)

    def split_cat(xx, wu_, bu_, wi_, bi_):
        yu = dense.linear(xx[:u], wu_, bu_).split([f, 2 * f], 1)
        yi = dense.linear(xx[u:], wi_, bi_).split([f, 2 * f, 2 * f], 1)
        return torch.cat([yu[0], yi[0]]), torch.cat([yu[1], yi[1], yi[2]])

    line = {"phase": "timing", "what": "hgt.project typed products: linear_into against linear, split, cat",
            "shape": f"x [{g.n_nodes}, {f}] -> q [{g.n_nodes}, {f}], kv [{g.n_rows}, {2 * f}]"}
    for name, fn in (("linear_into", into), ("split_cat", split_cat)):
        def fwd():
            with torch.no_grad():
                return fn(*leaves)

        def fwd_bwd():
            return torch.autograd.grad(fn(*leaves), leaves, (gq, gkv))

        line[name + "_fwd_ms"] = time_ms(fwd, iters=10)
        line[name + "_fwd_bwd_ms"] = time_ms(fwd_bwd, iters=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_bwd()
        torch.cuda.synchronize()
        line[name + "_fwd_bwd_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    emit(line)
    del x, gq, gkv, leaves


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
    """Path 8: the quality anchor. Counters at 0, `cli anchor --scale full`
    in-process with the gate's defaults, the port's baseline file as
    `--gate-baseline` and the beyond-parity leg (adam; the gate skips the
    adamw leg): it must print PASS, launch kernels 1, 2 and 3, and match the
    archived JAX run (`ARCHIVED_ANCHOR`): the dataset block and generator
    config field for field, the baselines' NDCG@20 within
    ANCHOR_BASELINE_TOL. The anchor's own call of the generator is timed
    (host seconds, peak host memory) and its data kept for the ablate
    path. Returns (launches, (interactions, item factors, generator
    config))."""
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.tools import anchor

    gen, plain_data = [], anchor.anchor_data

    def timed_data(cfg):
        rss = peak_host_gb()
        t = time.perf_counter()
        r = plain_data(cfg)
        gen.append((r[0], r[1][1], cfg, time.perf_counter() - t, rss, peak_host_gb()))
        return r

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
    evaluate.sampled_eval, anchor.anchor_data = timed_eval, timed_data
    try:
        out, code = in_process_cli(["anchor", "--scale", "full", "--out", str(work / "anchor"),
                                    "--gate-baseline", str(anchor.BASELINE), "--device", str(dev)])
    finally:
        evaluate.sampled_eval, anchor.anchor_data = plain_eval, plain_data
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
    if len(gen) != 1:
        raise AssertionError(f"anchor: the generator ran {len(gen)} times in `cli anchor` (exit {code}), "
                             f"want 1: {out[-2000:]}")
    inter, i_fac, cfg, gen_s, rss_before, gen_peak = gen[0]
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


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def telemetry_walls(npy: str, work: Path, n: int = 8) -> dict:
    """Host wall of `n` sequential /recommend requests (after one warm one)
    to a stdlib server on one card runtime, with telemetry off, JSONL and
    durable (an fsync a record): what an operator pays for each mode."""
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig
    from plotpointe_tpu_torch.serving.telemetry import ServingTelemetry

    rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=npy))
    rt.startup()
    hists = histories_of(rt.item_vecs.shape[0], n + 1)
    walls = {}
    for mode, durable in (("off", None), ("jsonl", False), ("durable_fsync", True)):
        tel = None if durable is None else ServingTelemetry(root=str(work / f"tel_{mode}"), durable=durable)
        srv, _ = serve("127.0.0.1", 0, runtime=rt, telemetry=tel, block=False)
        url = f"http://127.0.0.1:{srv.server_address[1]}/recommend"
        try:
            post(url, {"item_ids": hists[n], "k": 20})
            t0 = time.perf_counter()
            codes = [post(url, {"item_ids": h, "k": 20})[0] for h in hists[:n]]
            walls[mode] = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
            srv.state.close()
            if durable:
                tel.requests.queue.close()
                tel.feedback.queue.close()
        if codes != [200] * n:
            raise AssertionError(f"telemetry {mode}: replies {codes}")
    return {f"wall_{n}_sequential_s": walls}


def serve_env_subprocess(npy: str, work: Path, n: int = 8) -> dict:
    """`python -m plotpointe_tpu_torch.serving` configured by the environment
    (SERVING_USE_DEVICE unset: the card), `n` requests held to the plain
    answer, its JSONL request log `n` lines; stopped by its PID."""
    import os

    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "SERVING_USE_DEVICE"}
    env.update(ITEM_EMBEDDINGS_URI=npy, TOPK="20", TELEMETRY_DIR=str(work / "tel_env"),
               HOST="127.0.0.1", PORT=str(port))
    err_log = work / "env_server.err"
    t0 = time.perf_counter()
    with open(err_log, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "plotpointe_tpu_torch.serving"],
                                cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True)
    try:
        lines = []  # the startup line, printed once the table is on the card
        reader = threading.Thread(target=lambda: lines.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=300)
        line = lines[0].strip() if lines else ""
        start_s = time.perf_counter() - t0
        if line != f"serving on 127.0.0.1:{port} loaded=True telemetry=True":
            proc.kill()
            proc.wait(timeout=60)
            raise AssertionError(f"the env entry point printed {line!r}: {err_log.read_text()[-3000:]}")
        url = f"http://127.0.0.1:{port}/recommend"
        deadline = time.perf_counter() + 60
        while True:  # the line comes just before the socket is bound
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5).read()
                break
            except (urllib.error.URLError, ConnectionError):
                if time.perf_counter() > deadline:
                    raise
                time.sleep(0.05)
        hists = histories_of(np.load(npy, mmap_mode="r").shape[0], n)
        t1 = time.perf_counter()
        replies = [post(url, {"item_ids": h, "k": 20, "user_key": f"env{i}"}) for i, h in enumerate(hists)]
        wall = time.perf_counter() - t1
    finally:
        proc.kill()
        proc.wait(timeout=60)
        proc.stdout.close()
    stats = check_replies(npy, hists, replies)
    logged = (work / "tel_env" / "requests.jsonl").read_text().splitlines()
    ids = sorted(json.loads(x)["request_id"] for x in logged)
    if ids != sorted(b["request_id"] for _, b in replies):
        raise AssertionError(f"the env entry point logged {len(logged)} requests, not the {n} it served")
    return {"env_start_s": start_s, f"env_wall_{n}_sequential_s": wall, "env_logged_requests": len(logged),
            **{f"env_{k}": v for k, v in stats.items()}}


def phase_serve_telemetry(work: Path, dev) -> dict:
    """Path 10: the rest of serving on path 2's trained export (63,001 x
    128, f32). Counters at 0, then (a) in-process: a micro-batching stdlib
    server whose runtime comes from `ServingState.startup_from_env()`, with
    durable telemetry (an fsync a record): 32 concurrent /recommend requests
    with user keys, one /feedback per reply, one out-of-range request (400,
    one reject line) and one bad feedback (400); the replies held to the
    plain answer, the queues reopened from disk holding exactly those 32
    requests and 32 feedbacks, drained to a backlog of 0 with no dead
    letters, `cli drift` counting 32; kernels 4, 5 and the select kernel
    must have launched. (b) `python -m plotpointe_tpu_torch.serving` in a
    subprocess. Then the wall of 8 sequential requests per telemetry mode."""
    import os
    from unittest import mock

    import torch

    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.serving.eventqueue import DurableQueue
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.telemetry import ServingTelemetry

    npy, root, n = str(work / "main_items.npy"), work / "tel_durable", 32
    n_items = np.load(npy, mmap_mode="r").shape[0]
    hists = histories_of(n_items, n)
    cuda_build.reset_counters()
    t0 = time.perf_counter()
    tel = ServingTelemetry(root=str(root), durable=True)
    srv, _ = serve("127.0.0.1", 0, telemetry=tel, block=False, micro_batch=True, micro_batch_max=64,
                   micro_batch_wait_ms=5.0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    replies = [None] * n
    try:
        with mock.patch.dict(os.environ, {"ITEM_EMBEDDINGS_URI": npy}):  # restored after
            for k in ("ITEM_INDEX_MAP_URI", "TOPK", "PROJECT_ID", "GOOGLE_CLOUD_PROJECT"):
                os.environ.pop(k, None)
            if not srv.state.startup_from_env():
                raise AssertionError("startup_from_env did not load the export")
        if srv.state.runtime._table.device.type != torch.device(dev).type:
            raise AssertionError(f"the environment's runtime is not on {dev}")
        barrier = threading.Barrier(n)

        def client(i):
            barrier.wait()
            replies[i] = post(f"{base}/recommend", {"item_ids": hists[i], "k": 20, "user_key": f"user{i}"})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        sync()
        batches = srv.state.batcher.stats
        if any(r is None or r[0] != 200 for r in replies):
            raise AssertionError(f"/recommend replies: {[r and r[0] for r in replies]}")
        feedback = [post(f"{base}/feedback", {"request_id": b["request_id"], "item_id": b["indices"][0],
                                              "event_type": "click", "user_key": f"user{i}"})
                    for i, (_, b) in enumerate(replies)]
        bad_req = post(f"{base}/recommend", {"item_ids": [n_items + 5], "k": 20})
        rejects_after_bad_req = len(tel.rejects.read_all())
        bad_fb = post(f"{base}/feedback", {"item_id": 1})
    finally:
        srv.shutdown()
        srv.server_close()
        srv.state.close()
        tel.requests.queue.close()
        tel.feedback.queue.close()
    wall = time.perf_counter() - t0
    launches = counts()
    stats = check_replies(npy, hists, replies)
    if any(code != 200 or body != {"status": "ok"} for code, body in feedback):
        raise AssertionError(f"/feedback replies: {feedback}")
    if bad_req[0] != 400 or rejects_after_bad_req != 1 or bad_fb[0] != 400 or len(tel.rejects.read_all()) != 2:
        raise AssertionError(f"rejects: {bad_req}, {bad_fb}, {tel.rejects.read_all()}")
    want = {b["request_id"]: (i, b) for i, (_, b) in enumerate(replies)}
    queues = {}
    for name in ("requests", "feedback"):  # reopened from disk, drained as a subscriber would
        q = DurableQueue(root / name)
        recs = q.read_all()
        pulled = q.pull(10 * n)
        q.ack([o for o, _ in pulled])
        queues[name] = {"records": len(recs), "pulled": len(pulled), "backlog": q.backlog(),
                        "dead_letters": len(q.dead_letters())}
        q.close()
        if sorted(r["request_id"] for r in recs) != sorted(want) or len(pulled) != n \
                or queues[name]["backlog"] or queues[name]["dead_letters"]:
            raise AssertionError(f"durable {name} queue: {queues[name]}")
        for r in recs:
            i, body = want[r["request_id"]]
            logged = r["item_ids"] if name == "requests" else [r["item_id"]]
            if logged != (body["indices"] if name == "requests" else body["indices"][:1]) \
                    or r["user_key"] != f"user{i}" or (name == "requests" and r["scores"] != body["scores"]):
                raise AssertionError(f"durable {name} record {r} differs from its reply {body}")
    out, code = in_process_cli(["drift", "--telemetry-dir", str(root)])
    drift = json.loads(out)
    n_drift = sum(row["n_requests"] for row in drift)  # an hour may turn during the run
    missing = [k for k in PATH_KERNELS["serve_telemetry"] if launches[k] == 0]
    line = {"phase": "serve_telemetry", "requests": n, "wall_s": wall, **stats,
            "batcher_requests_batches_max": (batches.n_requests, batches.n_batches, batches.max_batch),
            "feedback_codes": sorted({c for c, _ in feedback}), "bad_request": bad_req[0],
            "bad_feedback": bad_fb[0], "rejects": len(tel.rejects.read_all()), "queues": queues,
            "drift": drift, "drift_exit_code": code, "launches": launches}
    if code != 0 or n_drift != n or missing:
        emit(line | {"ok": False})
        raise AssertionError(f"serve_telemetry: drift exit {code}, n_requests {n_drift}; not launched: {missing}")
    line |= serve_env_subprocess(npy, work)
    line |= telemetry_walls(npy, work)
    emit(line | {"ok": True})
    return launches


def phase_serve_bench(dev) -> dict:
    """Path 11: `tools/serve_bench.main` in-process at JAX's defaults
    (498,196 x 128 seeded catalog, bf16 table, 64 clients, in flight 4) with
    the kernel top-K asked for (`--pallas`); `--seconds 3` (JAX: 10) is the
    one cut. Counters at 0 first; every mode must serve requests and kernels
    4, 5 and the select kernel must have launched."""
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.tools import serve_bench

    cuda_build.reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = serve_bench.main(["--clients", "64", "--seconds", "3", "--pallas", "--json",
                                "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = counts()
    modes = {m: {k: res[m].get(k) for k in ("served_qps", "n_requests", "latency_p50_ms", "latency_p95_ms",
                                            "mean_batch", "dispatch_ms")}
             for m in ("single", "micro_batch", "loopback")}
    missing = [k for k in PATH_KERNELS["serve_bench"] if launches[k] == 0]
    idle = [m for m, r in modes.items() if not r["n_requests"]]
    emit({"phase": "serve_bench", "items": res["items"], "d": res["d"], "clients": res["clients"],
          "table_dtype": "bfloat16", "seconds": 3, "cut": "--seconds 3 (JAX default 10)",
          "modes": modes, "speedup": res.get("speedup"), "wall_s": wall, "launches": launches,
          "ok": not missing and not idle})
    if missing or idle:
        raise AssertionError(f"serve_bench: modes without requests {idle}; not launched: {missing}")
    return launches


# -- paths 12 and 13: the embedding stages and `cli pipeline` ----------------

EMBED_TEXT_ROWS = 16_384  # catalog rows through the MiniLM tower (cut from 498,196 for time)
EMBED_TEXT_CHECK_ROWS = 256  # rows held to the same tower in f32 on the CPU
EMBED_IMAGES = 1_024  # seeded PNGs through the CLIP tower (bf16, batch 64)
EMBED_IMAGE_CHECK_ROWS = 64  # rows held to the same tower in f32 on the CPU
SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
# unit rows: card f32 (TF32 off) against CPU f32, the same weights, sums in
# another order through 6 (text) or 12 (image) blocks
TOWER_F32_ATOL = 1e-4
# card bf16 (every op's output rounded, layer norm and softmax included, as
# JAX runs it) against CPU f32 at ViT-B/32 depth, largest entry difference of
# unit rows: ~2.5 bf16 steps (2^-8); the CPU's own bf16 lands 1.9e-3 off
TOWER_BF16_ATOL = 1e-2
FUSE_ALL_ATOL = 1e-5  # fuse_all_items card vs CPU, the same parameters (f32, TF32 off)
# URL-hash rows the 4-chunk image stage re-embeds against the unchunked one (cut from all
# 149,669 for time: path 13's `--parallel` run makes the same check on its own catalog)
IMAGE_CHUNK_CHECK_ROWS = 20_000
# `cli pipeline --in-process` at a tenth of the Amazon shape (JAX's `synth` generator; cut
# from 192,403 x 63,001 x 1,689,116 + 435,195 for time: paths 1-5, 8 and 12 run its stages'
# functions at the full shape)
PIPELINE = dict(users=19_240, items=6_300, interactions=168_912, extra_items=43_520,
                hidden_dim=128, samples_per_epoch=200_000, eval_neg_k=1000, epochs=2)


def minilm_flops_per_token(s: int, hidden=384, layers=6, ffn=1536) -> float:
    """Multiply-adds x 2 of one token through the MiniLM tower at sequence
    length s: the q/k/v, output and two FFN products and the two attention
    products (23.6 MFLOP at s 256)."""
    return layers * 2.0 * (hidden * 3 * hidden + hidden * hidden + 2 * hidden * ffn + 2 * s * hidden)


def vit_flops_per_image(image=224, patch=32, hidden=768, layers=12, ffn=3072, out=512) -> float:
    """FLOPs of one image through the CLIP ViT-B/32 tower (8.8 GFLOP)."""
    t = (image // patch) ** 2 + 1
    per_token = layers * 2.0 * (hidden * 3 * hidden + hidden * hidden + 2 * hidden * ffn + 2 * t * hidden)
    return t * per_token + (t - 1) * 2.0 * 3 * patch * patch * hidden + 2.0 * hidden * out


def embed_catalog(inter, seed: int) -> dict:
    """The seeded 498,196-row catalog of the data phase's interactions
    (asins `B{item:09d}`, titles from seeded item factors, 30% with an
    image URL) as the port's column dict."""
    from plotpointe_tpu_torch.data.synthetic import synthetic_catalog

    asin = np.array([f"B{a:09d}" for a in range(int(inter["asin"].max()) + 1)], dtype=object)
    named = {"asin": asin[inter["asin"]]}
    n_inter = len(np.unique(inter["asin"]))
    fac = np.random.default_rng(seed + 12).normal(size=(n_inter, 8)).astype(np.float32)
    return synthetic_catalog(named, n_extra_items=CATALOG - n_inter, seed=seed, item_factors=fac)


def write_vocab(path: Path, texts) -> int:
    """vocab.txt: the special tokens, every single character and its `##`
    piece, then the catalog's most frequent words, 30,522 lines at most (the
    tower's vocabulary); words outside it split into pieces. Returns its
    size."""
    from collections import Counter

    from plotpointe_tpu_torch.models.tokenizer import WordPieceTokenizer

    basic = WordPieceTokenizer(SPECIAL_TOKENS)
    words = Counter(w for t in texts for raw in basic._clean(t).split() for w in basic._split_word(raw))
    chars = sorted({c for w in words for c in w})
    vocab = SPECIAL_TOKENS + chars + [f"##{c}" for c in chars]
    vocab += [w for w, _ in words.most_common() if w not in set(vocab)][: 30_522 - len(vocab)]
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return len(vocab)


def write_pngs(d: Path, n: int, seed: int) -> list:
    """n seeded RGB PNGs of 48-320 px a side, one corrupt file and one
    missing path; returns the n + 2 paths."""
    from PIL import Image

    rng = np.random.default_rng(seed + 13)
    d.mkdir()
    paths = []
    for i in range(n):
        h, w = rng.integers(48, 321, 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"{i}.png")
        paths.append(str(d / f"{i}.png"))
    (d / "corrupt.png").write_bytes(b"not a png")
    return paths + [str(d / "corrupt.png"), str(d / "missing.png")]


def check_rows(label: str, emb: np.ndarray, n: int, d: int) -> None:
    norms = np.linalg.norm(emb, axis=1)
    if emb.shape != (n, d) or not np.isfinite(emb).all() or np.abs(norms - 1.0).max() > 1e-4:
        raise AssertionError(f"{label}: shape {emb.shape} (want {(n, d)}), finite "
                             f"{bool(np.isfinite(emb).all())}, norms {norms.min()}-{norms.max()}")


def embed_text_tower(work: Path, items: dict, seed: int, dev) -> dict:
    """The MiniLM tower at full width: random-init weights (torch.Generator
    seeded `seed`) saved through `save_checkpoint`, a vocab.txt of the
    catalog's words, `embed_text_stage(weights=, vocab=)` over the first
    EMBED_TEXT_ROWS rows at batch 128 and S 256 on the card, then
    EMBED_TEXT_CHECK_ROWS of them through the same tower in f32 on the CPU."""
    import torch

    from plotpointe_tpu_torch.models.embed_stages import (
        compose_item_text, embed_text_stage, make_minilm_encoder)
    from plotpointe_tpu_torch.models.encoders import TransformerTextEncoder
    from plotpointe_tpu_torch.models.tokenizer import WordPieceTokenizer
    from plotpointe_tpu_torch.train.checkpoint import params_to_jax, save_checkpoint

    head = {k: v[:EMBED_TEXT_ROWS] for k, v in items.items()}
    texts = compose_item_text(head)
    vocab_n = write_vocab(work / "vocab.txt", texts)
    tower = TransformerTextEncoder().init_params(torch.Generator().manual_seed(seed))
    weights = save_checkpoint(work / "minilm_random.npz", params_to_jax(tower.state_dict()),
                              {"family": "minilm", "init": f"torch.Generator({seed})"})
    t0 = time.perf_counter()
    emb, meta = embed_text_stage(head, str(work / "minilm"), weights=weights, vocab=str(work / "vocab.txt"),
                                 device=dev)
    sync()
    stage_s = time.perf_counter() - t0
    check_rows("embed minilm", emb, EMBED_TEXT_ROWS, 384)
    ids, mask = WordPieceTokenizer(work / "vocab.txt").encode(texts[:128], max_len=256)

    # the tower alone on one batch of 128 x 256 (CUDA events), against its FLOP bound
    card = tower.to(dev).eval()
    ids_d, mask_d = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
    with torch.no_grad():
        batch_ms = time_ms(lambda: card(ids_d, mask_d), iters=5, warmup=1)
    flop = 128 * 256 * minilm_flops_per_token(256)
    s = spec()
    pick = np.random.default_rng(seed + 14).choice(EMBED_TEXT_ROWS, EMBED_TEXT_CHECK_ROWS, replace=False)
    pick.sort()
    t0 = time.perf_counter()
    want = make_minilm_encoder(weights, str(work / "vocab.txt"), device="cpu")([texts[i] for i in pick])
    cpu_s = time.perf_counter() - t0
    want /= np.linalg.norm(want, axis=1, keepdims=True) + 1e-12
    err = float(np.abs(emb[pick] - want).max())
    tokens = float(mask.sum()) / len(mask)
    line = {"rows": EMBED_TEXT_ROWS, "batch": 128, "seq_len": 256, "precision": "float32 (TF32 off)",
            "vocab_size": vocab_n, "valid_tokens_per_row_mean": tokens, "stage_s": stage_s,
            "stage_items_per_s": EMBED_TEXT_ROWS / stage_s,
            "meta_items_per_s": meta["throughput_items_per_sec"],
            "tower_batch_ms": batch_ms, "tower_items_per_s": 128 / batch_ms * 1e3,
            "flop_per_batch": flop, "bound_ms_f32": flop / (s["f32_tflops"] * 1e12) * 1e3,
            "bound_ms_tf32": flop / (s["tf32_tflops"] * 1e12) * 1e3,
            "cpu_check_rows": EMBED_TEXT_CHECK_ROWS, "cpu_check_s": cpu_s,
            "max_abs_err_vs_cpu_f32": err, "tol": TOWER_F32_ATOL}
    if err > TOWER_F32_ATOL:
        raise AssertionError(f"embed: MiniLM rows on the card off the CPU's by {err}")
    return line


def embed_image_tower(work: Path, seed: int, dev) -> dict:
    """The CLIP tower at ViT-B/32 width, bf16, batch 64: where PIL imports,
    `encode_image_files` over EMBED_IMAGES seeded PNGs plus a corrupt and a
    missing file (2 failures); without PIL (printed as "decode": "absent")
    the tower alone on seeded pixel arrays. Then EMBED_IMAGE_CHECK_ROWS rows
    against the tower in f32 on the CPU: bf16 within TOWER_BF16_ATOL, the
    card in f32 within TOWER_F32_ATOL."""
    import torch

    from plotpointe_tpu_torch.models.encoders import ViTImageEncoder
    from plotpointe_tpu_torch.models.image_io import encode_image_files, load_image_batch

    try:
        import PIL  # noqa: F401
        decode = "PIL"
    except ImportError:
        decode = "absent"
    cpu = ViTImageEncoder().init_params(torch.Generator().manual_seed(0)).eval()  # encode_image_files' init
    line = {"decode": decode, "batch": 64, "precision": "bfloat16"}
    if decode == "PIL":
        uris = write_pngs(work / "pngs", EMBED_IMAGES, seed)
        t0 = time.perf_counter()
        emb, ok, fails = encode_image_files(uris, device=dev)
        sync()
        line |= {"files": len(uris), "encode_s": time.perf_counter() - t0, "failures": fails}
        if fails != 2 or list(np.flatnonzero(~ok)) != [EMBED_IMAGES, EMBED_IMAGES + 1]:
            raise AssertionError(f"embed: {fails} failures at {np.flatnonzero(~ok)}, want the last 2")
        pixels, _ = load_image_batch(uris[:EMBED_IMAGE_CHECK_ROWS])
        f32, _, _ = encode_image_files(uris[:EMBED_IMAGE_CHECK_ROWS], compute_dtype="float32", device=dev)
    else:
        pixels = np.random.default_rng(seed + 13).normal(
            size=(EMBED_IMAGES, 224, 224, 3)).astype(np.float32)
        card = ViTImageEncoder().init_params(torch.Generator().manual_seed(0)).to(dev, torch.bfloat16).eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            emb = np.concatenate([card(torch.as_tensor(pixels[s:s + 64]).to(dev, torch.bfloat16))
                                  .float().cpu().numpy() for s in range(0, EMBED_IMAGES, 64)])
        emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12
        line |= {"pixel_arrays": EMBED_IMAGES, "encode_s": time.perf_counter() - t0}
        card32 = ViTImageEncoder().init_params(torch.Generator().manual_seed(0)).to(dev).eval()
        with torch.no_grad():
            f32 = card32(torch.as_tensor(pixels[:EMBED_IMAGE_CHECK_ROWS], device=dev)).cpu().numpy()
        pixels = pixels[:EMBED_IMAGE_CHECK_ROWS]
    check_rows("embed clip", emb, EMBED_IMAGES, 512)
    with torch.no_grad():
        want = cpu(torch.as_tensor(pixels)).numpy()
    want /= np.linalg.norm(want, axis=1, keepdims=True) + 1e-12
    bf16_err = float(np.abs(emb[:EMBED_IMAGE_CHECK_ROWS] - want).max())
    f32_err = float(np.abs(f32 - want).max())

    card = cpu.to(dev, torch.bfloat16)
    x = torch.as_tensor(pixels[:64]).to(dev, torch.bfloat16)
    with torch.no_grad():
        batch_ms = time_ms(lambda: card(x), iters=10, warmup=2)
    flop = 64 * vit_flops_per_image()
    line |= {"images_per_s": EMBED_IMAGES / line["encode_s"], "tower_batch_ms": batch_ms,
             "tower_images_per_s": 64 / batch_ms * 1e3, "flop_per_batch": flop,
             "bound_ms_bf16": flop / (spec()["bf16_tflops"] * 1e12) * 1e3,
             "bf16_max_abs_err_vs_cpu_f32": bf16_err, "bf16_tol": TOWER_BF16_ATOL,
             "f32_max_abs_err_vs_cpu_f32": f32_err, "f32_tol": TOWER_F32_ATOL}
    if bf16_err > TOWER_BF16_ATOL or f32_err > TOWER_F32_ATOL:
        raise AssertionError(f"embed: CLIP rows off the CPU's: bf16 {bf16_err}, f32 {f32_err}")
    return line


def embed_zero_egress(work: Path, items: dict, dev) -> dict:
    """The zero-egress default at the full catalog: `embed_text_stage` with
    the hash encoder, `embed_image_stage` on the URL-hash path unchunked,
    and again in 4 chunks + `merge_image_chunks` over its first
    IMAGE_CHUNK_CHECK_ROWS rows (bit-equal to those), then `fuse_stage` at
    FusionConfig's defaults on the card: losses finite and falling from epoch
    1 to 5, one step's loss and gradients on the card against the CPU
    (GRAD_TOL), `fuse_all_items` on the card against the CPU on the trained
    parameters (FUSE_ALL_ATOL)."""
    import torch

    from plotpointe_tpu_torch.config import FusionConfig
    from plotpointe_tpu_torch.models import fusion
    from plotpointe_tpu_torch.models.embed_stages import (
        compose_item_text, embed_image_stage, embed_text_stage, fuse_stage, image_rows, merge_image_chunks)
    from plotpointe_tpu_torch.models.encoders import hash_text_encoder
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    out = work / "zero_egress"
    n = len(items["asin"])
    t0 = time.perf_counter()
    compose_item_text(items)
    compose_s = time.perf_counter() - t0
    hash_s, encode = [0.0], hash_text_encoder(dim=384)

    def timed_hash(texts):
        t = time.perf_counter()
        r = encode(texts)
        hash_s[0] += time.perf_counter() - t
        return r

    t0 = time.perf_counter()
    txt, _ = embed_text_stage(items, str(out), encoder=timed_hash)
    text_stage_s = time.perf_counter() - t0
    check_rows("embed hash text", txt, n, 384)
    t0 = time.perf_counter()
    img, meta = embed_image_stage(items, str(out))
    image_stage_s = time.perf_counter() - t0
    n_img = len(image_rows(items))
    n_check = min(IMAGE_CHUNK_CHECK_ROWS, n_img)
    per = (n_check + 3) // 4
    t0 = time.perf_counter()
    for c in range(4):
        embed_image_stage(items, str(out / "chunks"), chunk_start=c * per,
                          chunk_end=min((c + 1) * per, n_check), chunk_id=c)
    merged, merged_items = merge_image_chunks(str(out / "chunks"), 4)
    chunks_s = time.perf_counter() - t0
    store = ArtifactStore()
    whole_items = store.load_parquet(str(out / "img_items.parquet"))
    same = (np.array_equal(merged, img[:n_check])
            and list(merged_items["asin"]) == list(whole_items["asin"][:n_check]))
    if not same or meta["n_images"] != n_img:
        raise AssertionError(f"embed: 4 merged chunks differ from the unchunked image stage's first {n_check} "
                             f"of {n_img} rows")

    walls, captured = {}, {}
    plain_train, plain_fuse = fusion.train_fusion, fusion.fuse_all_items

    def timed_train(*a, **kw):
        t = time.perf_counter()
        r = plain_train(*a, **kw)
        sync()
        walls["fuse_train_s"] = time.perf_counter() - t
        captured["model"], captured["args"] = r[0], a
        return r

    def timed_fuse(*a, **kw):
        t = time.perf_counter()
        r = plain_fuse(*a, **kw)
        walls["fuse_inference_s"] = time.perf_counter() - t
        return r

    fusion.train_fusion, fusion.fuse_all_items = timed_train, timed_fuse
    try:
        t0 = time.perf_counter()
        fused, cfg_out = fuse_stage(str(out), items=items, device=dev)
        fuse_s = time.perf_counter() - t0
    finally:
        fusion.train_fusion, fusion.fuse_all_items = plain_train, plain_fuse
    cfg = FusionConfig()
    check_rows("embed fused", fused, n, cfg.output_dim)
    hist = [cfg_out["train_history"][f"epoch_{e}_loss"] for e in range(1, cfg.epochs + 1)]
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError(f"embed: fusion losses {hist}")

    # one step on the card against the CPU: the same init, rows and dropout mask
    txt_all, img_aligned, img_row = captured["args"][:3]
    has = np.flatnonzero(img_row >= 0)[: cfg.batch_size]
    tb, ib = txt_all[has], img_aligned[img_row[has]]
    keep = fusion.dropout_keep((len(has), cfg.hidden_dim), cfg.dropout, torch.Generator().manual_seed(1))
    step = {}
    for d in ("cpu", dev):
        m = fusion.FusionModel(cfg, d).init_params(torch.Generator().manual_seed(cfg.seed))
        loss, _, _ = fusion.fusion_loss(m, torch.as_tensor(tb, device=d), torch.as_tensor(ib, device=d),
                                        keep.to(d))
        loss.backward()
        step[str(torch.device(d))] = (float(loss.detach()),
                                      {k: p.grad.cpu() for k, p in m.named_parameters()})
    (l_cpu, g_cpu), (l_dev, g_dev) = step["cpu"], step[str(torch.device(dev))]
    grad_err = {k: float((g_dev[k] - g_cpu[k]).abs().max()) for k in g_cpu}
    grad_ok = all(torch.allclose(g_dev[k], g_cpu[k], **GRAD_TOL) for k in g_cpu)
    loss_ok = abs(l_dev - l_cpu) <= LOSS_RTOL * abs(l_cpu)

    host = fusion.FusionModel(cfg, "cpu")
    host.load_state_dict({k: v.cpu() for k, v in captured["model"].state_dict().items()})
    t0 = time.perf_counter()
    want = plain_fuse(host, txt_all, img_aligned, img_row)
    fuse_cpu_s = time.perf_counter() - t0
    fuse_err = float(np.abs(fused - want).max())
    line = {"catalog_rows": n, "image_rows": n_img, "compose_s": compose_s, "hash_encode_s": hash_s[0],
            "text_stage_s": text_stage_s, "image_stage_s": image_stage_s, "image_4_chunks_merge_s": chunks_s,
            "chunk_check_rows": n_check, "chunks_equal_unchunked": same, "fuse_stage_s": fuse_s, **walls,
            "fuse_inference_cpu_s": fuse_cpu_s,
            "fusion_losses": hist, "first_step_loss": {"card": l_dev, "cpu": l_cpu},
            "first_step_grad_max_abs_err": grad_err, "grad_tol": GRAD_TOL,
            "fuse_all_max_abs_err_vs_cpu": fuse_err, "fuse_all_tol": FUSE_ALL_ATOL}
    if not (grad_ok and loss_ok) or fuse_err > FUSE_ALL_ATOL:
        raise AssertionError(f"embed: fusion on the card off the CPU: loss {l_dev} vs {l_cpu}, grads "
                             f"{grad_err}, fuse_all {fuse_err}")
    return line


def phase_embed(work: Path, inter, seed: int, dev) -> dict:
    """Path 12, counters at 0 first: the MiniLM tower (f32), the CLIP tower
    (bf16) and the zero-egress default stages at the full catalog, each held
    to the CPU. The path runs plain PyTorch ops (the JAX towers and fusion
    are plain XLA ops), so no kernel of the port is expected to launch."""
    from plotpointe_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    items = embed_catalog(inter, seed)
    catalog_s = time.perf_counter() - t0
    (work / "embed").mkdir()
    cuda_build.reset_counters()
    t0 = time.perf_counter()
    text = embed_text_tower(work / "embed", items, seed, dev)
    emit({"phase": "embed", "part": "minilm", **text})
    image = embed_image_tower(work / "embed", seed, dev)
    emit({"phase": "embed", "part": "clip", **image})
    zero = embed_zero_egress(work / "embed", items, dev)
    launches = counts()
    emit({"phase": "embed", "part": "zero_egress", **zero})
    emit({"phase": "embed", "catalog_s": catalog_s, "wall_s": time.perf_counter() - t0,
          "launches": launches, "ok": True})
    return launches


def pipeline_args(workdir: Path, shape: dict, dev=None) -> list:
    argv = ["pipeline", "--workdir", str(workdir)]
    for k, v in shape.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv + (["--device", str(dev)] if dev is not None else [])


def phase_pipeline(work: Path, dev) -> dict:
    """Path 13: `cli pipeline --in-process` at a tenth of the Amazon shape
    (PIPELINE), counters at 0 first: it must end "complete", launch kernels
    10, 1, 2 and 3 and leave every sentinel artifact; then the same command with
    `--continue` must skip every sentinel stage. Then, in a fresh workdir,
    the subprocess mode `--parallel --image-chunks 4` at JAX's defaults
    (every lane on the card): exit 0, and its merged img.npy and
    img_items.parquet equal to an unchunked image stage's."""
    from plotpointe_tpu_torch import cli
    from plotpointe_tpu_torch.models.embed_stages import embed_image_stage
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    wd = work / "pipeline"
    argv = pipeline_args(wd, PIPELINE, dev) + ["--in-process"]
    cuda_build.reset_counters()
    t0 = time.perf_counter()
    out, code = in_process_cli(argv)
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    done = json.loads(out.strip().splitlines()[-1]) if code == 0 else {}
    sentinels = {k: (wd / rel).exists() for k, rel in cli._STAGE_SENTINELS.items()
                 if k != "merge_images"} | {"embed_image": (wd / "embeddings" / "img.npy").exists()}
    missing = [k for k in PATH_KERNELS["pipeline"] if launches[k] == 0]
    metrics = sorted(p.name for p in (wd / "models").glob("metrics_*.json"))
    emit({"phase": "pipeline", "run": "in_process", "shape": PIPELINE, "exit_code": code, "wall_s": wall,
          "result": done, "sentinels": sentinels, "metrics_files": metrics, "launches": launches,
          "ok": code == 0 and done.get("pipeline") == "complete" and all(sentinels.values()) and not missing})
    if code != 0 or done.get("pipeline") != "complete" or not all(sentinels.values()) or missing:
        raise AssertionError(f"pipeline: exit {code}, sentinels {sentinels}, not launched {missing}: "
                             f"{out[-2000:]}")

    t0 = time.perf_counter()
    out, code = in_process_cli(argv + ["--continue"])
    again = json.loads(out.strip().splitlines()[-1]) if code == 0 else {}
    want_skipped = set(sentinels)
    skipped_ok = set(again.get("skipped", ())) == want_skipped
    emit({"phase": "pipeline", "run": "continue", "exit_code": code, "wall_s": time.perf_counter() - t0,
          "result": again, "ok": code == 0 and skipped_ok})
    if code != 0 or not skipped_ok:
        raise AssertionError(f"pipeline --continue: exit {code}, skipped {again.get('skipped')}, "
                             f"want {sorted(want_skipped)}")

    wd2 = work / "pipeline_parallel"
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "plotpointe_tpu_torch.cli", "pipeline",
                           "--workdir", str(wd2), "--parallel", "--image-chunks", "4"],
                          cwd=here, capture_output=True, text=True, timeout=900)
    par_wall = time.perf_counter() - t0
    par = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else {}
    same = False
    if proc.returncode == 0:
        store = ArtifactStore()
        whole, _ = embed_image_stage(store.load_items(str(wd2 / "staging")), str(work / "pipeline_unchunked"))
        same = (np.array_equal(np.load(wd2 / "embeddings" / "img.npy"), whole)
                and list(store.load_parquet(str(wd2 / "embeddings" / "img_items.parquet"))["asin"])
                == list(store.load_parquet(str(work / "pipeline_unchunked" / "img_items.parquet"))["asin"]))
    emit({"phase": "pipeline", "run": "parallel_subprocess", "image_chunks": 4, "exit_code": proc.returncode,
          "wall_s": par_wall, "result": par, "img_equal_unchunked": same,
          "ok": proc.returncode == 0 and same})
    if proc.returncode != 0 or not same:
        raise AssertionError(f"pipeline --parallel: exit {proc.returncode}, img equal {same}: "
                             f"{proc.stderr[-3000:]}")
    return launches


# -- path 14: sharded training ---------------------------------------------------

SHARD_COUNTS = (2, 4)  # local graphs of the main graph checked kernel by kernel
SHARDED_LOSS_RTOL = {"gat": 5e-4, "gat_2_heads": 5e-4, "lightgcn": 5e-3}  # bf16 rows (the bands of
# tests/test_sharded_trainer.py: fused 5e-4, LightGCN fused 5e-3)
SHARDED_METRICS_ATOL = 2e-3
SHARDED_EXPORT = dict(rtol=5e-3, atol=5e-5)
SMOKE_STEP_RTOL = 5e-4  # the 2-process step's loss vs one process's, the same global batch
NVLINK_LABEL = "prediction (NVLink spec), not measured"


def check_local_graphs(errs, rng, graph, h0, a_s, a_d, dev) -> dict:
    """Path 14 (a): the main graph cut into 2 and 4 destination ranges; on
    each rank's local graph kernels 1, 2 and 3 (bf16 rows, the dropout mask
    over canonical ids from e_lo), 8 and 9 at 2 heads and 7 at D 64 (both
    directions) against their plain versions on the same local graph; then
    the owned rows of every shard combined against the unsharded kernel's
    output. Returns the owned-row differences."""
    import torch

    from plotpointe_tpu_torch.graphs.csr import symmetric_normalized_weights
    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst, attention_bwd_dst_mh, attention_bwd_dst_mh_plain, attention_bwd_dst_plain,
        attention_bwd_src, attention_bwd_src_plain, attention_fwd, attention_fwd_mh,
        attention_fwd_mh_plain, attention_fwd_plain, dropout_mask, dropout_mask_mh, node_terms_mh_plain,
        node_terms_plain)
    from plotpointe_tpu_torch.ops.spmm_kernel import spmm_csr, spmm_csr_plain
    from plotpointe_tpu_torch.parallel.spmd import local_graph, shard_graph_by_edges

    n, bf16 = graph.n_nodes, torch.bfloat16
    ct = torch.as_tensor(rng.normal(size=(n, 128)).astype(np.float32), device=dev)
    h2 = torch.stack([h0[:, 0], torch.roll(h0[:, 0], 17, -1)], 1).contiguous()
    s2, d2 = torch.cat([a_s, torch.roll(a_s, 17, -1)]), torch.cat([a_d, torch.roll(a_d, 17, -1)])
    ct2 = torch.as_tensor(rng.normal(size=(n, 2, 128)).astype(np.float32), device=dev)
    x64 = torch.as_tensor(rng.normal(size=(n, 64)).astype(np.float32), device=dev)
    vals = torch.as_tensor(symmetric_normalized_weights(graph), device=dev)
    out = {}
    with torch.no_grad():
        full = attention_fwd(h0, a_s, a_d, graph, dropout_mask(graph, 0.1, 7, dev), bf16)
        full_mh = attention_fwd_mh(h2, s2, d2, graph, dropout_mask_mh(graph, 0.1, 7, 2, dev), bf16)
        full_y = spmm_csr(x64, vals, graph.row_ptr, graph.src, bf16)
        rows, gs, gd = node_terms_plain(h0[:, 0], a_s, a_d, bf16)
        rows2, gs2, gd2 = node_terms_mh_plain(h2, s2, d2, bf16)
        for n_sh in SHARD_COUNTS:
            layout = shard_graph_by_edges(graph, n_sh)
            owned = {"gat_fwd": [], "gat_fwd den": [], "gat_fwd_mh": [], "spmm_csr": []}
            for k in range(n_sh):
                loc = local_graph(graph, layout, k)
                lg, lo, hi, e_lo = loc.graph, loc.lo, loc.hi, loc.e_lo
                what = f"main {n_sh}-way shard {k} N={n} E_local={lg.n_edges} e_lo={e_lo}"
                mask = dropout_mask(lg, 0.1, 7, dev, e_lo)
                got = attention_fwd(h0, a_s, a_d, lg, mask, bf16)
                want = attention_fwd_plain(h0, a_s, a_d, lg, mask, bf16)
                errs.check("gat_fwd", what + " rows=bfloat16 mask=True out", got[0], want[0], ATTN_TOL)
                errs.check("gat_fwd", what + " rows=bfloat16 mask=True den", got[1], want[1], ATTN_TOL)
                owned["gat_fwd"].append(got[0][lo:hi])
                owned["gat_fwd den"].append(got[1][lo:hi])
                args = (rows, gs, gd, ct, want[0][:, 0], want[1], lg, mask)
                got1, want1 = attention_bwd_dst(*args), attention_bwd_dst_plain(*args)
                for part, x, y in zip(("de_sum", "godot", "da_src"), got1, want1):
                    errs.check("gat_bwd_dst", f"{what} rows=bfloat16 mask=True {part}", x, y, GRAD_TOL)
                args2 = (rows, ct.to(bf16), a_s, gs, gd, want[1], want1[1], lg, mask)
                errs.check("gat_bwd_src", what + " rows=bfloat16 mask=True dh (local transpose)",
                           attention_bwd_src(*args2), attention_bwd_src_plain(*args2), GRAD_TOL)
                mask2 = dropout_mask_mh(lg, 0.1, 7, 2, dev, e_lo)
                got = attention_fwd_mh(h2, s2, d2, lg, mask2, bf16)
                want = attention_fwd_mh_plain(h2, s2, d2, lg, mask2, bf16)
                errs.check("gat_fwd_mh", what + " H=2 rows=bfloat16 mask=True out", got[0], want[0], ATTN_TOL)
                owned["gat_fwd_mh"].append(got[0][lo:hi])
                args = (rows2, gs2, gd2, ct2, want[0], want[1], lg, mask2)
                for part, x, y in zip(("de_sum", "godot", "da_src"), attention_bwd_dst_mh(*args),
                                      attention_bwd_dst_mh_plain(*args)):
                    errs.check("gat_bwd_dst_mh", f"{what} H=2 rows=bfloat16 mask=True {part}", x, y, GRAD_TOL)
                v_l = vals[e_lo:e_lo + lg.n_edges]
                y = spmm_csr(x64, v_l, lg.row_ptr, lg.src, bf16)
                errs.check("spmm_csr", what + " D=64 rows=bfloat16 dst", y,
                           spmm_csr_plain(x64, v_l, lg.row_ptr, lg.src, bf16), ATTN_TOL)
                owned["spmm_csr"].append(y[lo:hi])
                vt = v_l[lg.t_eid.long()].contiguous()
                errs.check("spmm_csr", what + " D=64 rows=bfloat16 local transpose",
                           spmm_csr(x64, vt, lg.t_ptr, lg.t_dst, bf16),
                           spmm_csr_plain(x64, vt, lg.t_ptr, lg.t_dst, bf16), ATTN_TOL)
                del lg, loc, got, want, got1, want1, args, args2
            for name, want_full in (("gat_fwd", full[0]), ("gat_fwd den", full[1]),
                                    ("gat_fwd_mh", full_mh[0]), ("spmm_csr", full_y)):
                comb = torch.cat(owned[name])
                diff = float((comb - want_full).abs().max())
                out[f"{name} {n_sh}-way"] = {"max_abs_diff": diff, "equal_bits": bool(torch.equal(comb, want_full))}
                errs.check(name.split()[0], f"main {n_sh}-way owned rows combined vs unsharded {name}",
                           comb, want_full, ATTN_TOL)
            del owned
            torch.cuda.empty_cache()
    sync()
    emit({"phase": "sharded", "part": "a", "what": "kernels on local graphs", "owned_rows_vs_unsharded": out,
          "shard_counts": SHARD_COUNTS, "max_abs_err": dict(errs.max)})
    return out


def sharded_and_single(label: str, cfg, work: Path, dev):
    """`train_from_artifacts` with cfg.mesh_shape "data:1" (this process is
    the world of one) and without, on the same seed, counters at 0 before the
    sharded run: its losses, test metrics and exported item rows held to the
    unsharded run's. Returns (sharded trainer, unsharded trainer, launches)."""
    import dataclasses

    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.pipeline import train_from_artifacts

    runs = {}
    for mesh in ("data:1", None):
        c = dataclasses.replace(cfg, mesh_shape=mesh, run_id=None)
        cuda_build.reset_counters()
        t0 = time.perf_counter()
        res = train_from_artifacts(c, str(work / "staging"), str(work / "embeddings"),
                                   str(work / f"models_{label}_{mesh or 'single'}"), device=dev)
        sync()
        runs[mesh] = res, counts(), time.perf_counter() - t0
    (sh, launches, sh_wall), (un, _, un_wall) = runs["data:1"], runs[None]
    rtol = SHARDED_LOSS_RTOL[label]
    loss_ok = all(abs(a["loss"] - b["loss"]) <= rtol * abs(b["loss"])
                  for a, b in zip(sh["history"], un["history"]))
    metrics_ok = all(abs(sh["test"][k] - v) <= SHARDED_METRICS_ATOL for k, v in un["test"].items())
    items_sh, items_un = sh["trainer"].export_item_embeddings(), un["trainer"].export_item_embeddings()
    export_err = float(np.abs(items_sh - items_un).max())
    export_ok = bool(np.allclose(items_sh, items_un, **SHARDED_EXPORT) and np.isfinite(items_sh).all())
    emit({"phase": "sharded", "part": "b", "model": label, "mesh": "data:1",
          "backend": sh["trainer"].mesh.backend, "losses": [h["loss"] for h in sh["history"]],
          "losses_unsharded": [h["loss"] for h in un["history"]], "loss_rtol": rtol,
          "test": sh["test"], "test_unsharded": un["test"], "export_max_abs_err": export_err,
          "wall_s": sh_wall, "wall_unsharded_s": un_wall, "launches": launches,
          "ok": loss_ok and metrics_ok and export_ok})
    if not (loss_ok and metrics_ok and export_ok):
        raise AssertionError(f"sharded {label} at world 1 disagrees with the unsharded run: losses "
                             f"{loss_ok}, metrics {metrics_ok}, export {export_err}")
    return sh["trainer"], un["trainer"], launches


def smoke_processes(argv_of, n: int, timeout: int = 300) -> list:
    """`tools/multihost_smoke` in n processes at once; their JSON lines."""
    from plotpointe_tpu_torch.parallel.multihost import free_port

    here = Path(__file__).resolve().parent
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "plotpointe_tpu_torch.tools.multihost_smoke",
                               "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                               "--process-id", str(k), *argv_of], cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for k in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"multihost_smoke {argv_of} exited {p.returncode}: {err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def phase_sharded(errs, rng, work: Path, s, graph, h0, a_s, a_d, dev) -> dict:
    """Path 14, sharded training. (a) `check_local_graphs`. (b) in a world of
    one NCCL rank (this process): `train_from_artifacts` with --mesh data:1
    and without, for the GAT (2 epochs of one 200,000-triple step, dropout
    0.1, bf16 rows, 1,000-negative eval), the 2-head GAT (1 epoch) and
    LightGCN (one epoch of the mini-batch protocol), each sharded run held to
    its unsharded twin; the sharded GAT step's wall and device busy beside
    the unsharded step's; the step's collectives from the recorder, held to
    the audit's at n = 1. (c) `tools/multihost_smoke` as 2 processes on this
    card over gloo (one step, then --fit) and as 1 process: both ranks' loss
    equal, within SMOKE_STEP_RTOL of the one process's, and the 2-rank
    step's recorded collectives held to the audit's at n = 2 (at the tool's
    shape). (d) `dryrun_multichip(1)`. (e) the audit at 1, 2, 4 and 8 shards
    of the main graph and the predicted efficiency at 8 H100s from (b)'s
    step and NVLink's 450 GB/s spec. Returns the launches of (b)."""
    import torch
    import torch.distributed as dist

    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.data.synthetic import synthetic_interactions
    from plotpointe_tpu_torch.parallel.collectives import record_collectives
    from plotpointe_tpu_torch.parallel.mesh import make_mesh
    from plotpointe_tpu_torch.tools import scaling_audit as sa
    from plotpointe_tpu_torch.tools.multichip_dryrun import dryrun_multichip
    from plotpointe_tpu_torch.tools.multihost_smoke import one_step_problem

    t_path = time.perf_counter()
    local = check_local_graphs(errs, rng, graph, h0, a_s, a_d, dev)
    t_a = time.perf_counter() - t_path

    # (b) the world of one: NCCL, this process, every collective a self-copy
    mesh = make_mesh({"data": 1}, device=dev)
    gat = dict(hidden_dim=128, layers=2, attn_dropout=0.1, samples_per_epoch=200_000,
               eval_neg_k=1000, attn_impl="auto", seed=0)
    by_model = {}
    sh_gat, un_gat, by_model["gat"] = sharded_and_single("gat", TrainConfig(epochs=2, **gat), work, dev)
    _, _, by_model["gat_2_heads"] = sharded_and_single(
        "gat_2_heads", TrainConfig(epochs=1, heads=MH_HEADS, **gat), work, dev)
    _, _, by_model["lightgcn"] = sharded_and_single(
        "lightgcn", TrainConfig(model_family="lightgcn", epochs=1, eval_neg_k=1000, seed=0, **LIGHTGCN),
        work, dev)
    launches = {k: sum(m[k] for m in by_model.values()) for k in by_model["gat"]}
    missing = [k for k in PATH_KERNELS["sharded"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"sharded: kernels not launched on the sharded path: {missing}")
    step_s = time_train_step("sharded_gat_world1", sh_gat, s, mesh="data:1", backend=mesh.backend)
    un_step_s = time_train_step("unsharded_gat_same_config", un_gat, s)
    u, i, j, seeds = sh_gat._sample()
    with record_collectives() as colls:
        loss = sh_gat._loss(u, i, j, seeds)
        sh_gat.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    sync()
    audit1 = sa.audit_collectives(1, sh_gat.graph, s.n_users, hidden=128, layers=2, heads=1, feat_dim=384)
    same1 = sa.same_collectives(colls, audit1["collectives"])
    emit({"phase": "sharded", "part": "b", "what": "GAT step at world 1 vs unsharded",
          "step_s": step_s, "unsharded_step_s": un_step_s, "collective_calls": len(colls),
          "collective_bytes": sum(c["bytes"] for c in colls), "collectives": colls,
          "audit_equals_recorder_n1": same1, "launches": launches, "ok": same1})
    if not same1:
        raise AssertionError(f"audit at n=1 {audit1['collectives']} != recorder {colls}")

    # (c) two processes on this one card over gloo, at the tool's own shape
    step2 = smoke_processes(["--device", "cuda", "--backend", "gloo"], 2)
    fit2 = smoke_processes(["--device", "cuda", "--backend", "gloo", "--fit"], 2)
    (one,) = smoke_processes(["--device", "cuda", "--backend", "gloo"], 1)
    inter = synthetic_interactions(n_users=96, n_items=64, n_interactions=1500, seed=5)
    tiny_splits = build_splits(inter, *build_node_maps(inter))
    tiny = one_step_problem(tiny_splits, 2, "cpu")[0]
    audit2 = sa.audit_collectives(2, tiny, tiny_splits.n_users, hidden=16, layers=2, heads=1,
                                  feat_dim=16)
    same2 = sa.same_collectives(step2[0]["collectives"], audit2["collectives"])
    ok_c = (step2[0]["loss"] == step2[1]["loss"] and fit2[0]["loss"] == fit2[1]["loss"]
            and abs(step2[0]["loss"] - one["loss"]) <= SMOKE_STEP_RTOL * abs(one["loss"])
            and all(r["backend"] == "gloo" and r["staged"] for r in step2 + fit2) and same2)
    emit({"phase": "sharded", "part": "c", "what": "2 processes on one card over gloo (correctness, "
          "not speed)", "step": [{k: r[k] for k in ("loss", "grad_user_norm", "backend", "device",
                                                   "staged", "step_s")} for r in step2],
          "one_process_loss": one["loss"], "fit": [{k: r[k] for k in ("loss", "best_val_ndcg20",
                                                                      "test_ndcg20", "fit_s")} for r in fit2],
          "audit_equals_recorder_n2": same2, "ok": ok_c})
    if not ok_c:
        raise AssertionError(f"2-process smoke: {step2} {fit2} one {one} audit {same2}")

    # (d) the dry run in this world of one
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, dev)
    emit({"phase": "sharded", "part": "d", "dryrun_multichip": dry, "wall_s": time.perf_counter() - t0,
          "ok": dry["ok"]})

    # (e) the audit at the main graph's shape and the NVLink prediction
    audits = [sa.audit_collectives(n, sh_gat.graph, s.n_users, hidden=128, layers=2, heads=1,
                                   feat_dim=384) for n in (1, 2, 4, 8)]
    pred = sa.predict_efficiency(audits, step_s)
    emit({"phase": "sharded", "part": "e", "what": "scaling audit, Amazon shape",
          "audits": [{k: a[k] for k in ("n_shards", "collective_count", "collective_ops",
                                        "payload_bytes_per_device", "wire_bytes_per_chip", "max_rows")}
                     for a in audits],
          "step_time_1card_s": step_s, "link": "H100 SXM NVLink 4, 450 GB/s per direction (NVIDIA spec)",
          "predicted": pred, "label": NVLINK_LABEL})
    dist.destroy_process_group()
    emit({"phase": "sharded", "wall_s": time.perf_counter() - t_path, "part_a_s": t_a,
          "owned_rows_equal_bits": {k: v["equal_bits"] for k, v in local.items()}})
    return launches


# -- path 15: the deployment tools ---------------------------------------------------

DEPLOY_JOBS = {"graph_build": ("build_graphs_h100.yaml", ("knn_topk",)),
               "train_gat": ("train_gat_h100.yaml", ("gat_fwd", "gat_bwd_dst", "gat_bwd_src"))}
DEPLOY_EPOCHS = 2  # the training job's EPOCHS (the spec's default is 20)
H100_LINE = "--accelerator=type=nvidia-h100-80gb,count=1"


@contextlib.contextmanager
def environ(**kv):
    """os.environ with `kv` set inside the block (children inherit it)."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def fds_to(path: Path):
    """This process's file descriptors 1 and 2, and so its children's output,
    appended to `path` inside the block."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with open(path, "ab") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, keep in zip((1, 2), saved):
            os.dup2(keep, fd)
            os.close(keep)


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def provision_round(work: Path) -> dict:
    """Path 15 (a): `cli provision` on deploy_torch/infra.yaml into a fresh
    root, the first apply as `python -m plotpointe_tpu_torch.cli` in a
    subprocess, the rest through `cli.main` in this process (a process
    start costs 7-10 s on the card's host): apply creates every resource, a
    second apply is all noops, each provisioned queue takes one record and
    gives it back, `render` prints the gpu_vm's `gcloud compute instances
    create` line, and destroy leaves an empty state and no materialised
    directory."""
    import yaml

    from plotpointe_tpu_torch.serving.eventqueue import DurableQueue

    here = Path(__file__).resolve().parent
    spec_path = here / "deploy_torch" / "infra.yaml"
    n = len(yaml.safe_load(spec_path.read_text())["resources"])
    root = work / "infra"
    walls = {}

    def prov(cmd, label):
        argv = ["provision", cmd, "--spec", str(spec_path), "--root", str(root)]
        t0 = time.perf_counter()
        if label == "subprocess":
            proc = subprocess.run([sys.executable, "-m", "plotpointe_tpu_torch.cli", *argv], cwd=here,
                                  capture_output=True, text=True, timeout=120)
            out, code = proc.stdout, proc.returncode
        else:
            out, code = in_process_cli(argv)
        if code != 0:
            raise AssertionError(f"cli provision {cmd} exited {code}: {out[-2000:]}")
        walls[f"{cmd}_{label}"] = time.perf_counter() - t0
        return out

    first = last_json(prov("apply", "subprocess"))["apply"]
    state = json.loads((root / "state.json").read_text())["resources"]
    local = {rid: r["path"] for rid, r in state.items() if "path" in r}
    external = {rid: r["command"] for rid, r in state.items() if r.get("external")}
    materialised = len(local) == 4 and all(Path(p).is_dir() for p in local.values())
    again = last_json(prov("apply", "in_process"))["apply"]
    queues = {}
    for rid, path in local.items():
        if rid.startswith("event_queue."):
            q = DurableQueue(path)
            q.publish({"probe": rid})
            ((off, rec),) = q.pull()
            q.ack([off])
            queues[rid] = rec == {"probe": rid} and q.backlog() == 0
            q.close()
    vm_lines = [ln for ln in prov("render", "in_process").splitlines()
                if ln.startswith("gcloud compute instances create ")]
    gone = last_json(prov("destroy", "in_process"))["apply"]
    after = json.loads((root / "state.json").read_text())["resources"]
    left = [p for p in local.values() if Path(p).exists()]
    checks = {
        "apply_created_all": first == {"create": n, "replace": 0, "delete": 0, "noop": 0},
        "state_has_all": len(state) == n and set(local) | set(external) == set(state),
        "materialised": materialised,
        "external_recorded": any(rid.startswith("gpu_vm.") and H100_LINE in c for rid, c in external.items()),
        "reapply_all_noop": again == {"create": 0, "replace": 0, "delete": 0, "noop": n},
        "queues_round_trip": len(queues) == 2 and all(queues.values()),
        "render_gpu_vm_line": len(vm_lines) == 1 and H100_LINE in vm_lines[0]
                              and vm_lines[0].endswith("--provisioning-model=SPOT"),
        "destroy_empty": gone["delete"] == n and after == {} and not left,
    }
    emit({"phase": "deploy", "part": "a", "what": "cli provision apply, re-apply, queues, render, destroy",
          "resources": n, "apply": first, "reapply": again, "destroy": gone, "gpu_vm_line": vm_lines,
          "checks": checks, "walls_s": walls, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"deploy (a): {checks}")
    return walls


def run_spec(spec: dict, overrides: dict, log: Path, **env) -> tuple[int, float]:
    """`tools.jobs.run_job` on a spec dict with `env` in the children's
    environment and every output line appended to `log`: (rc, wall)."""
    from plotpointe_tpu_torch.tools.jobs import run_job

    here = Path(__file__).resolve().parent
    pythonpath = os.pathsep.join(filter(None, [str(here), os.environ.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    with environ(PYTHONPATH=pythonpath, **env), fds_to(log):
        rc = run_job(spec, overrides)
    return rc, time.perf_counter() - t0


def phase_deploy(work: Path, dev) -> dict:
    """Path 15, the deployment tools. (a) `provision_round`. (b) `cli jobs
    list` (in this process) shows the 8 port specs; then `run_job` runs the graph-build spec
    and the GAT training spec with ARTIFACTS at path 13's `--parallel`
    workdir (its staging and embeddings) and EPOCHS 2: each returns 0 and
    leaves its artifacts (kNN npz, checkpoint, metrics with finite losses),
    and the launch logs of its child processes show kernel 10, then
    kernels 1, 2 and 3, launched on the card; the training spec again with
    CUDA_VISIBLE_DEVICES empty and no restarts must exit non-zero naming
    CUDA. Returns the launches: this process's, counters at 0 first, plus
    its children's."""
    import yaml

    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.tools.jobs import load_job

    here = Path(__file__).resolve().parent
    t_path = time.perf_counter()
    emit({"phase": "deploy", "yaml": yaml.__version__})
    walls = {"provision": provision_round(work)}

    t0 = time.perf_counter()
    out, code = in_process_cli(["jobs", "list", "--dir", str(here / "deploy_torch" / "jobs")])
    rows = json.loads(out) if code == 0 else []
    walls["jobs_list"] = time.perf_counter() - t0
    listed = len(rows) == 8 and all(r["accelerator"] == "nvidia-h100-80gb" for r in rows)

    src = work / "pipeline_parallel"
    arts, hidden = work / "deploy_artifacts", work / "deploy_cuda_hidden"
    for d in (arts, hidden):
        d.mkdir()
        for sub in ("staging", "embeddings"):
            (d / sub).symlink_to(src / sub, target_is_directory=True)
    launch_log, log = work / "deploy_launches.jsonl", work / "deploy_jobs.log"
    overrides = {"ARTIFACTS": str(arts), "EPOCHS": str(DEPLOY_EPOCHS)}
    cuda_build.reset_counters()
    jobs = {}
    for label, (fname, kernels) in DEPLOY_JOBS.items():
        start = len(launch_log.read_text().splitlines()) if launch_log.exists() else 0
        rc, wall = run_spec(load_job(here / "deploy_torch" / "jobs" / fname), overrides, log,
                            PLOTPOINTE_LAUNCH_LOG=str(launch_log))
        children = [json.loads(ln) for ln in launch_log.read_text().splitlines()[start:]]
        by_child = {k: sum(c["launches"][k] for c in children) for k in cuda_build.COUNTERS}
        jobs[label] = {"rc": rc, "wall_s": wall, "child_processes": len(children),
                       "launches": {k: v for k, v in by_child.items() if v},
                       "kernels_launched": all(by_child[k] > 0 for k in kernels)}
    launches = counts()
    for label in jobs:
        for k, v in jobs[label]["launches"].items():
            launches[k] += v
    missing = [k for k in PATH_KERNELS["deploy"] if launches[k] == 0]

    n_items = np.load(arts / "embeddings" / "txt_interacted.npy", mmap_mode="r").shape[0]
    knn = check_knn_artifacts(arts / "graphs", "txt", n_items) if jobs["graph_build"]["rc"] == 0 else None
    metrics = sorted((arts / "models").glob("metrics_*.json"))
    ckpts = sorted((arts / "models" / "checkpoints").glob("*.npz"))
    losses = [h["loss"] for h in json.loads(metrics[0].read_text())["history"]] if metrics else []
    checks = {
        "jobs_list_8_h100": listed,
        "graph_build_rc0": jobs["graph_build"]["rc"] == 0,
        "ui_artifacts": all((arts / "graphs" / f).exists() for f in ("ui_edges.npz", "node_maps.json",
                                                                    "ui_stats.json")),
        "knn_artifacts": knn is not None,
        "train_rc0": jobs["train_gat"]["rc"] == 0,
        "checkpoint_and_metrics": len(ckpts) == 1 and len(metrics) == 1
                                  and (arts / "models" / "resume.pt").exists(),
        "losses_finite": len(losses) == DEPLOY_EPOCHS and bool(np.isfinite(losses).all()),
        "kernels_in_children": all(j["kernels_launched"] for j in jobs.values()) and not missing,
    }
    emit({"phase": "deploy", "part": "b", "what": "jobs list, run_job of the graph-build and GAT training "
          "specs on path 13's --parallel artifacts", "artifacts_of": str(src.name), "overrides": {
              "EPOCHS": DEPLOY_EPOCHS}, "jobs": jobs, "knn": knn, "losses": losses, "launches": launches,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"deploy (b): {checks} {jobs}: {log.read_text()[-3000:]}")

    # the training command cannot drift onto the CPU: no card, no run
    spec = dict(load_job(here / "deploy_torch" / "jobs" / "train_gat_h100.yaml"), restart_on_preemption=False)
    hidden_log = work / "deploy_cuda_hidden.log"
    rc, wall = run_spec(spec, {"ARTIFACTS": str(hidden), "EPOCHS": "1"}, hidden_log, CUDA_VISIBLE_DEVICES="")
    text = hidden_log.read_text()
    refused = rc != 0 and "CUDA is not available" in text
    walls["jobs"] = {label: j["wall_s"] for label, j in jobs.items()}
    walls["train_cuda_hidden"] = wall
    emit({"phase": "deploy", "part": "b", "what": "training spec with CUDA_VISIBLE_DEVICES= and no restarts",
          "rc": rc, "wall_s": wall, "names_cuda": "CUDA is not available" in text,
          "wrote_nothing": not (hidden / "models").exists(), "ok": refused})
    if not refused:
        raise AssertionError(f"deploy: the training job ran without a card (rc {rc}): {text[-2000:]}")
    emit({"phase": "deploy", "wall_s": time.perf_counter() - t_path, "walls_s": walls})
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


def eval_rank_inputs(d: int, dev, exact: bool, seed: int = 0):
    """One eval chunk at the Amazon shape: 2,048 of 192,403 users, each with a
    positive and 1,000 negatives of 63,001 items, rows of width d, from a
    generator of its own (the numpy stream is left as it was). exact: rows
    of quarters in [-2, 2], so every score is exact in f32 and any order of
    sums gives the same bits; the first 100 users' positives and half
    their negatives among 64 copies of one row (exact ties), a NaN user and
    an infinite item (non-finite positives). Else normal rows."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n_users, n_items, c, k = 192_403, 63_001, EVAL_CHUNK, EVAL_NEG_K
    if exact:
        U = torch.randint(-8, 9, (n_users, d), generator=g, device=dev).float() / 4
        I = torch.randint(-8, 9, (n_items, d), generator=g, device=dev).float() / 4
    else:
        U = torch.randn(n_users, d, generator=g, device=dev)
        I = torch.randn(n_items, d, generator=g, device=dev)
    users = torch.randint(0, n_users, (c,), generator=g, device=dev, dtype=torch.int32)
    pos = torch.randint(0, n_items, (c,), generator=g, device=dev, dtype=torch.int32)
    negs = torch.randint(0, n_items, (c, k), generator=g, device=dev, dtype=torch.int32)
    if exact:
        I[1:64] = I[0]
        U[7], I[5] = float("nan"), float("inf")
        pos[:100] = torch.randint(0, 64, (100,), generator=g, device=dev, dtype=torch.int32)
        negs[:100, :k // 2] = torch.randint(0, 64, (100, k // 2), generator=g, device=dev, dtype=torch.int32)
        users[100], pos[101], negs[102, 0] = 7, 5, 5
    return U, I, users, pos, negs


def check_eval_rank(errs, dev) -> None:
    """The eval's rank kernel against its plain version (the dense f32
    product and gathers, TF32 off) at one eval chunk, D 64 and 128: equal
    ranks and ties on rows whose scores are exact, and on a second launch;
    on normal rows the disagreements are printed (0 where cuBLAS sums each
    score in one ascending chain, as the kernel does)."""
    import torch

    from plotpointe_tpu_torch.ops.eval_kernel import eval_rank, eval_rank_plain

    for d in (64, 128):
        args = eval_rank_inputs(d, dev, exact=True)
        what = f"C={EVAL_CHUNK} neg_k={EVAL_NEG_K} 63,001 x {d} quarters"
        got = eval_rank(*args)
        errs.equal("eval_rank", what, got, eval_rank_plain(*args))
        errs.same_bits("eval_rank", what, got, eval_rank(*args))
        args = eval_rank_inputs(d, dev, exact=False)
        got, want = eval_rank(*args), eval_rank_plain(*args)
        emit({"phase": "check", "kernel": "eval_rank", "case": f"C={EVAL_CHUNK} neg_k={EVAL_NEG_K} 63,001 x {d} "
              "normal rows", "rank_differ": int((got[0] != want[0]).sum()),
              "ties_differ": int((got[1] != want[1]).sum()), "users_with_ties": int((want[1] > 0).sum())})
        del args, got, want
    sync()


def launch_ms(fn, key: str, iters: int = 50) -> float:
    """Mean device time of one launch of the CUDA kernels whose names hold
    `key`, over `iters` calls of `fn` under torch.profiler: each kernel's
    recorded time over the number of records, so a profile that drops
    records (it happens) still gives the mean of those it kept."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if key in e.key]
    return sum(e.device_time_total for e in hits) / max(1, sum(e.count for e in hits)) / 1e3


def read_gbps(mb: int) -> float:
    """Kernel 6's read rate over an mb-MB bf16 array (`launch_ms`): at 24 MB
    the array stays in the L2, at 256 MB every pass reads device memory. A
    24 MB pass is a few microseconds, so its ramp counts: a low estimate of
    the L2's rate."""
    import torch

    from plotpointe_tpu_torch.utils.profiling import stream_probe

    x = torch.randn(mb * 512, 1024, device="cuda").to(torch.bfloat16)
    return x.numel() * 2 / launch_ms(lambda: stream_probe(x, 64), "stream") / 1e6


def time_eval_rank(rows_out, dev) -> None:
    """The eval's rank kernel at one eval chunk (2,048 users, 1 + 1,000
    candidates of 63,001 rows) at D 128 (GAT) and 64 (LightGCN), beside its
    plain version, which is also the one PyTorch computation of the same
    ranks (`library_ms`: the dense f32 product and gathers). Bound: the
    candidate rows read once each (2,048 x 1,001 x D x 4 bytes) with the
    ids, the user rows and the outputs; also the rows' bytes alone at the
    measured L2 (24 MB) and device-memory (256 MB) read rates."""
    from plotpointe_tpu_torch.ops.eval_kernel import eval_rank, eval_rank_plain

    l2, hbm = read_gbps(24), read_gbps(256)
    rows = EVAL_CHUNK * (1 + EVAL_NEG_K)
    for d in (128, 64):
        args = eval_rank_inputs(d, dev, exact=False)
        nbytes = {"rows": rows * d * 4, "users": EVAL_CHUNK * d * 4, "ids": rows * 4, "out": EVAL_CHUNK * 8}
        line = timing_row(
            "eval_rank", f"C={EVAL_CHUNK} neg_k={EVAL_NEG_K} I=63,001 x {d} float32",
            lambda: eval_rank(*args), lambda: eval_rank_plain(*args), nbytes, 2 * rows * d, "float32",
            library=lambda: eval_rank_plain(*args), library_what="U[users] @ I.T and two gathers",
            device_ms=launch_ms(lambda: eval_rank(*args), "eval_rank", 20), l2_gbps=l2, hbm_gbps=hbm,
            rows_at_l2_ms=nbytes["rows"] / l2 / 1e6, rows_at_hbm_ms=nbytes["rows"] / hbm / 1e6)
        if d == 128:
            rows_out["eval_rank"] = line
        del args


def phase_timing(rng, graph, h0, a_s, a_d, catalog, trainer, s, dev, hgraph=None):
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
                "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": fb,
                "library_ms": time_ms(lambda: torch.sum(x[:8, :d], dtype=torch.float32))}
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
    time_gatv2(rows, graph, dev, rng)
    if hgraph is not None:
        time_hgt(rows, hgraph, dev, rng)
    time_eval_rank(rows, dev)
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
    walls, t_run = {}, [time.perf_counter()]

    def mark(label: str) -> None:  # the host seconds since the last mark, for the walls line
        now = time.perf_counter()
        walls[label] = now - t_run[-1]
        t_run.append(now)

    name = phase_device()
    phase_build()
    mark("device_build")
    rng = np.random.default_rng(args.seed)
    inter, s, feats, graph, (h0, a_s, a_d) = phase_data(args, rng, dev)
    catalog = torch.as_tensor(rng.normal(size=(CATALOG, 128)).astype(np.float32), device=dev)
    mark("data")

    errs = Errors()
    phase_check(errs, rng, graph, h0, a_s, a_d, catalog, dev)
    write_artifacts(work, inter, feats)
    hgraph = hgt_graph(s, feats, work, dev)
    check_hgt(errs, "main", hgraph, dev)
    mark("check")
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
    # path 4b: GATv2 at 2 heads (the gatv2-amazon configuration), trained, then exported
    v2_trainer, v2_ckpt, _, by_path["gatv2_train"] = phase_train(
        "train_gatv2", TrainConfig(heads=MH_HEADS, attention="gatv2", **gat), work, dev,
        PATH_KERNELS["gatv2_train"],
        {"n_layers": args.layers, "hidden_dim": 128, "heads": MH_HEADS, "attention": "gatv2"})
    phase_step_parity("train_gatv2", v2_trainer)
    del v2_trainer
    by_path["gatv2_export"] = phase_serve("export_gatv2", work, v2_ckpt, inter, feats, s.n_items, 128,
                                          0, 0, dev, PATH_KERNELS["gatv2_export"])
    # path 4c: HGT at 8 heads x 32 x 3 layers (the hgt-amazon configuration) over the typed graph
    hgt_cfg = TrainConfig(model_family="hgt", hidden_dim=256, layers=3, heads=8, epochs=args.epochs,
                          samples_per_epoch=200_000, eval_neg_k=1000, attn_impl="auto", seed=args.seed,
                          knn_edges=str(work / "graphs" / "ii_edges_hgt.npz"))
    hgt_trainer, _, _, by_path["hgt_train"] = phase_train(
        "train_hgt", hgt_cfg, work, dev, PATH_KERNELS["hgt_train"],
        {"model_family": "hgt", "n_layers": 3, "hidden_dim": 256, "heads": 8})
    phase_step_parity("train_hgt", hgt_trainer)
    del hgt_trainer
    mark("paths_1_4")
    # path 5: the graph-build stage, then kNN's fast mode
    by_path["graph_build"], by_path["graph_build_fast"], knn_feats, build_knn_s = phase_graph_build(
        errs, work, inter, s, args.seed, dev)
    mark("graph_build")
    # path 6: the smoke check and the measured peaks
    by_path["tooling"], peaks = phase_tooling(errs, dev)
    # path 7: the legacy attention contracts on a tiled graph
    by_path.update(phase_legacy(errs, rng, s, feats, graph, args.layers, dev))
    mark("tooling_legacy")
    # paths 8 and 9: the quality anchor at full shape, then the ablation sweep on its data
    by_path["anchor"], anchor_data = phase_anchor(work, dev)
    mark("anchor")
    by_path["ablate"] = phase_ablate(work, anchor_data, dev)
    del anchor_data
    mark("ablate")
    # paths 10 and 11: telemetry, feedback and the env entry point on path 2's export; served QPS
    by_path["serve_telemetry"] = phase_serve_telemetry(work, dev)
    by_path["serve_bench"] = phase_serve_bench(dev)
    mark("serve_telemetry_bench")
    # paths 12 and 13: the embedding stages at full width, then `cli pipeline`
    by_path["embed"] = phase_embed(work, inter, args.seed, dev)
    mark("embed")
    by_path["pipeline"] = phase_pipeline(work, dev)
    mark("pipeline")
    # path 14: sharded training (local-graph kernels, the world of one, 2 processes, audit)
    by_path["sharded"] = phase_sharded(errs, rng, work, s, graph, h0, a_s, a_d, dev)
    mark("sharded")
    # path 15: provision and the job specs (kernels 10, 1, 2, 3 in the jobs' child processes)
    by_path["deploy"] = phase_deploy(work, dev)
    mark("deploy")

    rows = phase_timing(rng, graph, h0, a_s, a_d, catalog, trainer, s, dev, hgraph)
    time_train_step("gat", trainer, s, samples=trainer.cfg.samples_per_epoch)
    time_train_step("lightgcn", lg_trainer, s, batch=LIGHTGCN["batch_size"],
                    negatives_per_positive=LIGHTGCN["neg_per_pos"], steps_per_epoch=lg_steps,
                    epoch_s=lg_res["history"][0]["step_time_s"])
    time_train_step("gat_2_heads", mh_trainer, s, samples=mh_trainer.cfg.samples_per_epoch)
    time_knn(rows, knn_feats, build_knn_s)
    time_tooling_and_legacy(rows, graph, h0, a_s, a_d, dev)
    mark("timing")
    emit({"phase": "walls", "walls_s": walls, "total_s": t_run[-1] - t_run[0]})

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
