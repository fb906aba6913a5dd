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
           on the main graph); the attention ops' and the SpMM operator's
           gradients vs autograd of the plain goldens
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
           within ATTN_TOL where rows stay f32, and for v2 within the
           training step's band: layer 2 rounds rows to bf16, and rows that
           differ in the last f32 bit may round apart); each kernel must
           have launched
  timing   CUDA-event times of each kernel, its plain version and, where one
           PyTorch call computes the same function, that call; the bound with
           its reckoning; `host_us_per_launch`, the host's time to issue one
           call of the kernel 12 and kernel 7 wrappers beside
           `torch.addcmul`; kernel 1 split into its two CUDA kernels and timed on
           a graph of the same size without degree skew; the training step
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
and kernels 10 and 11 on the graph-build subsets at 63,001 x 128 and x 384
with their ptxas report (`time_knn_trees`), for the port in the checkout DIR
(an earlier commit, say) and for this one, each tree in a process of its
own that builds its own kernels, in turns (DIR, this, this, DIR) on one
card; both trees read the same graph and rows, saved once; every line
carries its "tree".
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
SERVE_RTOL = 1e-4  # served scores vs the plain CPU answer
CATALOG = 498_196  # the reference's serving catalog
SOURCES = {
    "gat_fwd": ("plotpointe_tpu_torch/csrc/gat_fwd.cu", "plotpointe_tpu/ops/gat_fused.py:91"),
    "gat_bwd_dst": ("plotpointe_tpu_torch/csrc/gat_bwd_dst.cu", "plotpointe_tpu/ops/gat_fused.py:185"),
    "gat_bwd_src": ("plotpointe_tpu_torch/csrc/gat_bwd_src.cu", "plotpointe_tpu/ops/gat_fused.py:344"),
    "gather_fence": ("plotpointe_tpu_torch/csrc/gather_fence.cu", "plotpointe_tpu/ops/gat_fused.py:43"),
    "topk_chunkmax": ("plotpointe_tpu_torch/csrc/topk_chunkmax.cu", "plotpointe_tpu/ops/topk_kernel.py:140"),
    "topk_rescore": ("plotpointe_tpu_torch/csrc/topk_rescore.cu", "plotpointe_tpu/ops/topk_kernel.py:175"),
    "spmm_csr": ("plotpointe_tpu_torch/csrc/spmm_csr.cu", "plotpointe_tpu/ops/spmm_kernel.py:34"),
    "gat_fwd_mh": ("plotpointe_tpu_torch/csrc/gat_fwd_mh.cu", "plotpointe_tpu/ops/gat_fused.py:460"),
    "gat_bwd_dst_mh": ("plotpointe_tpu_torch/csrc/gat_bwd_dst_mh.cu",
                       "plotpointe_tpu/ops/gat_fused.py:557"),
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
                "serve": ("gat_fwd", "topk_chunkmax", "topk_rescore"),
                "lightgcn_train": ("spmm_csr",),
                "lightgcn_serve": ("spmm_csr", "topk_chunkmax", "topk_rescore"),
                "mh_train": ("gat_fwd_mh", "gat_bwd_dst_mh", "gat_bwd_src"),
                "mh_export": ("gat_fwd_mh",),
                "graph_build": ("knn_topk",),
                "graph_build_fast": ("knn_topk_fast",),
                "tooling": ("smoke_affine", "stream_probe"),
                "legacy_v2": ("fused_layer",),
                "legacy_v1": ("fused_segment_reduce",),
                "legacy_v1_mh": ("onehot_reduce",)}
# the legacy phase's configurations: (path, hidden, heads); v2 takes 1 head
# with D % 128 == 0, v1 the rest (64 is the reference's hidden-dim ablation)
LEGACY = (("legacy_v2", 128, 1), ("legacy_v1", 64, 1), ("legacy_v1_mh", 128, 2))
LIGHTGCN = dict(embed_dim=64, n_prop_layers=3, batch_size=8192, neg_per_pos=5)
MH_HEADS = 2
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
                    help="only time kernels 7, 10, 11, 12, 13, 15 and host_us_per_launch, for "
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
    """`time_rule2` with the package of the checkout `--rows-of` on the graph
    saved at `--graph`, then `time_knn_trees` on the rows saved at
    `--knn-rows`; each line labelled `--tree`."""
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
    del graph, z
    torch.cuda.empty_cache()
    from plotpointe_tpu_torch.graphs.knn import l2_normalize

    feats = {k: l2_normalize(v.to("cuda")) for k, v in torch.load(args.knn_rows).items()}
    time_knn_trees(feats, args.tree)
    return 0


def run_compare(args, work: Path) -> int:
    """Kernels 7, 12, 13 and 15 and the launch path's host time on the main
    graph of `run`, then kernels 10 and 11 on its graph-build subsets
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
          "ptxas": ptxas_report(("knn_topk", "knn_topk_fast"))})


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
        CHUNK_MARGIN, chunk_max, chunk_max_plain, n_chunks_of, rescore, rescore_plain)

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
        for label, n, b in (("small", 5000, 8), ("main", CATALOG, 64)):
            for dt in (torch.float32, torch.bfloat16):
                x = catalog[:n].to(dt)
                q = torch.as_tensor(rng.normal(size=(b, 128)).astype(np.float32), device=dev).to(dt)
                what = f"{label} N={n} B={b} {str(dt)[6:]}"
                cm = chunk_max(x, q)
                errs.check("topk_chunkmax", what, cm, chunk_max_plain(x, q), SCORE_TOL)
                cid = torch.topk(cm, min(32 + CHUNK_MARGIN, cm.shape[1]), dim=1)[1].to(torch.int32)
                cid[:, -1] = n_chunks_of(n) - 1  # the tail chunk, partly past N
                errs.check("topk_rescore", what + f" R={cid.shape[1]}", rescore(x, q, cid),
                           rescore_plain(x, q, cid), SCORE_TOL)
    sync()
    check_knn(errs, "small", small_knn_rows(rng, dev))


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
    emit({"phase": "build", "tree": tree, "ptxas": ptxas_report(("knn_topk", "knn_topk_fast"))})


def ptxas_report(names) -> dict:
    """Each library's `nvcc -Xptxas -v` lines (registers, spills, entry
    functions) from the `<lib>.log` its build wrote."""
    from plotpointe_tpu_torch.ops import cuda_build

    out = {}
    for name in names:
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
            # compulsory bytes: each input read once, each output written once;
            # the per-edge row gathers and B1's per-warp partial rows of
            # da_src (a scratch buffer of this design) are not compulsory traffic
            b1_bytes = {"rows": n * d * isz, "g": n * d * 4, "out": n * d * 4, "src": e * 4,
                        "mask": e * 4, "row_ptr": (n + 1) * 4, "gs_gd_den": 3 * n * 4,
                        "de_sum_godot": 2 * n * 4, "da_src": d * 4}
            b2_bytes = {"rows": n * d * isz, "g_rounded": n * d * isz, "a_src": d * 4,
                        "gs_gd_den_godot": 4 * n * 4, "t_ptr": (n + 1) * 4, "t_dst": e * 4,
                        "t_eid": e * 4, "mask": e * 4, "dh": n * d * 4}
            ops = 4 * e * d  # per edge: one row dot product and one row axpy
            for kname, fn, plain, nbytes in (
                    ("gat_bwd_dst", lambda: attention_bwd_dst(*a1), lambda: attention_bwd_dst_plain(*a1), b1_bytes),
                    ("gat_bwd_src", lambda: attention_bwd_src(*a2), lambda: attention_bwd_src_plain(*a2), b2_bytes)):
                b_ms, b_by = bound(sum(nbytes.values()), ops, "float32")
                line = {"phase": "timing", "kernel": kname, "shape": shape, "ms": time_ms(fn),
                        "plain_ms": time_ms(plain, 5), "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "bound_bytes": nbytes, "bound_ops": ops}
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
            for k, pats in (("gat_fwd", ("aggregate<",)), ("gat_fwd node_terms", ("node_terms<",)),
                            ("gat_bwd_dst", ("bwd_dst<",)), ("gat_bwd_src", ("bwd_src<",)),
                            ("gat_fwd_mh", ("aggregate_mh<",)),
                            ("gat_fwd_mh node_terms", ("node_terms_mh<",)),
                            ("gat_bwd_dst_mh", ("bwd_dst_mh<",)),
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
    the host's microseconds per call of the kernel 12 and kernel 7 wrappers
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
        emit({"phase": "timing", "what": "host_us_per_launch", "tree": tree, "calls": 200,
              "smoke_affine [256, 128] f32": host_us_per_launch(lambda: affine(small)),
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
            m_bytes = 0 if mk is None else hh * e * 4
            shape = f"N={n} E={e} H={hh} D={d} rows={dname} mask={0.1 if mk is not None else 0}"
            fwd_bytes = {"h": n * hh * d * 4, "a": 2 * hh * d * 4, "row_ptr": (n + 1) * 4,
                         "src": e * 4, "mask": m_bytes, "out": n * hh * d * 4, "den": n * hh * 4}
            fwd_ops = 2 * e * hh * d + 4 * n * hh * d
            rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, rows_dt)
            out, den = attention_fwd_mh(h, a_s, a_d, graph, mask=mk, hs_dtype=rows_dt)
            a1 = (rows, gs, gd, ct, out, den, graph, mk)
            b1_bytes = {"rows": n * hh * d * isz, "g": n * hh * d * 4, "out": n * hh * d * 4,
                        "src": e * 4, "mask": m_bytes, "row_ptr": (n + 1) * 4,
                        "gs_gd_den": 3 * n * hh * 4, "de_sum_godot": 2 * n * hh * 4,
                        "da_src": hh * d * 4}
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
                        "library_ms": None, "bound_bytes": nbytes, "bound_ops": ops}
                emit(line)
                if rows_dt == torch.bfloat16:
                    rows_out[kname] = line  # the training path's rows and mask
            del rows, out, den, a1


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


def phase_legacy(errs, rng, s, feats, graph, layers: int, dev) -> dict:
    """Path 7: the GAT forward (train=True, dropout 0.1) and the backward of
    a fixed linear loss on the main graph marked `.with_tiling()`, per
    LEGACY configuration, with the kernels (counters at 0 first) and under
    `reference_versions()`. Returns each configuration's launches."""
    import torch

    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.ops.gat_fused import reference_versions
    from plotpointe_tpu_torch.train.checkpoint import params_from_jax

    tiled = graph.with_tiling()
    x_feats = torch.as_tensor(feats, device=dev)
    by_path = {}
    for label, hidden, heads in LEGACY:
        model = GATModel(s.n_users, s.n_items, 384, hidden, n_layers=layers, heads=heads,
                         attn_dropout=0.1)
        model.load_state_dict(params_from_jax(random_gat_params(rng, s.n_users, 384, hidden, layers,
                                                                heads)))
        model.to(dev)
        ct = torch.as_tensor(rng.normal(size=(graph.n_nodes, hidden)).astype(np.float32), device=dev)
        seeds = [int(x) for x in rng.integers(0, 2**32, layers)]
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
            runs[plain] = (out.detach(), {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                           counts(), time.perf_counter() - t0)
            del out
        (out_k, grads_k, launches, wall_k), (out_p, grads_p, plain_launches, wall_p) = runs[False], runs[True]
        f32_rows = label != "legacy_v2"
        scale = float(out_p.abs().max())
        out_tol = ATTN_TOL if f32_rows else dict(rtol=STEP_RTOL, atol=STEP_ATOL_OF_MAX * scale)
        out_err = float((out_k - out_p).abs().max())
        out_ok = bool(torch.allclose(out_k, out_p, **out_tol)) and bool(torch.isfinite(out_k).all())
        grad_err = {n: float((grads_k[n] - g).abs().max()) for n, g in grads_p.items()}
        bad = [n for n, g in grads_p.items() if not torch.allclose(grads_k[n], g, **GRAD_TOL)]
        missing = [k for k in PATH_KERNELS[label] if launches[k] == 0]
        in_plain = [k for k in PATH_KERNELS[label] if plain_launches[k]]
        ok = out_ok and not bad and not missing and not in_plain
        emit({"phase": "legacy", "path": label, "hidden": hidden, "heads": heads, "layers": layers,
              "contract": "v2" if label == "legacy_v2" else "v1", "dropout": 0.1,
              "fwd_bwd_s": wall_k, "fwd_bwd_plain_s": wall_p, "out_shape": list(out_k.shape),
              "out_max_abs_err_vs_plain": out_err, "out_tol": out_tol,
              "grad_max_abs_err_vs_plain": grad_err, "grad_tol": GRAD_TOL,
              "launches": {k: v for k, v in launches.items() if v}, "ok": ok})
        if not ok:
            raise AssertionError(f"{label}: output ok {out_ok}, gradients off {bad}, kernels not "
                                 f"launched {missing}, launched under the plain versions {in_plain}")
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
        rows_out["fused_layer"] = timing_row(
            "fused_layer", f"N={n} E={e} D={d} rows=bfloat16 mask=0.1",
            lambda: fused_layer(h0, a_s, a_d, graph, m1), lambda: fused_layer_plain(h0, a_s, a_d, graph, m1),
            {"h": n * d * 4, "a": 2 * d * 4, "row_ptr": (n + 1) * 4, "src": e * 4, "mask": e * 4,
             "out": n * d * 4, "den": n * 4}, 2 * e * d + 4 * n * d, "float32")
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
    from plotpointe_tpu_torch.ops.gat_fused import attention_fwd, attention_fwd_plain
    from plotpointe_tpu_torch.ops.gat_fused import gather_fence, gather_fence_plain
    from plotpointe_tpu_torch.ops.topk_kernel import (
        CHUNK, CHUNK_MARGIN, chunk_max, chunk_max_plain, n_chunks_of, rescore, rescore_plain,
        topk_mips, topk_mips_ref)

    n, e, d = graph.n_nodes, graph.n_edges, 128
    rows = {}
    with torch.no_grad():
        for rows_dt in (torch.float32, torch.bfloat16):
            k_ms = time_ms(lambda: attention_fwd(h0, a_s, a_d, graph, hs_dtype=rows_dt))
            p_ms = time_ms(lambda: attention_fwd_plain(h0, a_s, a_d, graph, hs_dtype=rows_dt), 5)
            b_ms, b_by = bound(4 * (2 * n * d + 2 * d + (n + 1) + e + n), 2 * e * d + 4 * n * d,
                               "float32")
            line = {"phase": "timing", "kernel": "gat_fwd", "shape": f"N={n} E={e} D={d}",
                    "rows": str(rows_dt)[6:], "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None}
            emit(line)
            rows.setdefault("gat_fwd", line)  # f32 rows: the export's mode
        # where kernel 1's time goes: its two CUDA kernels, and the same N and
        # E with uniform in-degrees (no hot rows)
        uni = build_graph(rng.integers(0, n, e), rng.integers(0, n, e), n).to(dev)
        split = {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for rows_dt in (torch.float32, torch.bfloat16):
                for _ in range(5):
                    attention_fwd(h0, a_s, a_d, graph, hs_dtype=rows_dt)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "node_terms" in ev.key or "aggregate" in ev.key:
                split[ev.key.split("::")[-1].split("(")[0]] = ev.device_time_total / ev.count / 1e3
        emit({"phase": "timing", "kernel": "gat_fwd", "profile_ms_per_call": split,
              "uniform_graph_ms": {str(r)[6:]: time_ms(lambda: attention_fwd(h0, a_s, a_d, uni, hs_dtype=r))
                                   for r in (torch.float32, torch.bfloat16)}})
        del uni
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
            for b in (8, 64):
                q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev).to(dt)
                k = 32  # the served kk: k=20 plus history, rounded up to 32
                nc = n_chunks_of(CATALOG)
                r = k + CHUNK_MARGIN
                cid = torch.topk(chunk_max(x, q), r, dim=1)[1].to(torch.int32)
                uniq = int(torch.unique(cid).numel())
                shape = f"N={CATALOG} D={d} B={b} {dname}"
                cm_b = bound(CATALOG * d * sz + b * d * sz + b * nc * 4, 2 * b * CATALOG * d, dname)
                rs_b = bound(uniq * CHUNK * d * sz + b * d * sz + b * r * 4 + b * r * CHUNK * 4,
                             2 * b * r * CHUNK * d, dname)
                lines = {
                    "topk_chunkmax": (time_ms(lambda: chunk_max(x, q)),
                                      time_ms(lambda: chunk_max_plain(x, q), 5), cm_b, None),
                    "topk_rescore": (time_ms(lambda: rescore(x, q, cid)),
                                     time_ms(lambda: rescore_plain(x, q, cid), 5), rs_b, None),
                    "topk_mips": (time_ms(lambda: topk_mips(x, q, k)),
                                  time_ms(lambda: topk_mips_ref(x, q, k), 5),
                                  (cm_b[0] + rs_b[0], cm_b[1]),
                                  time_ms(lambda: torch.topk(q @ x.T, k, dim=1))),
                }
                for kname, (k_ms, p_ms, (b_ms, b_by), lib) in lines.items():
                    line = {"phase": "timing", "kernel": kname, "shape": shape, "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "ops_dtype": dname,
                            "library_ms": lib}
                    emit(line)
                    if dt == torch.float32 and b == 64:
                        rows[kname] = line  # the served dtype at the batcher's cap
    time_rule2(rows, graph, dev)
    time_multihead(rows, graph, dev, rng)
    return rows


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
                        "sol_fraction_dev": sol_fraction_dev(t, peaks), "shape": t["shape"]})
    if "jax" in sys.modules or any(m.startswith("plotpointe_tpu.") or m == "plotpointe_tpu"
                                   for m in sys.modules):
        raise AssertionError("the port pulled in JAX or the JAX package")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
