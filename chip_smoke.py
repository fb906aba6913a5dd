#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (plotpointe_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--epochs 3] [--layers 2]

Drives the port's two paths end to end at full width (GAT, hidden 128,
1 head, 384-d item features; `--layers` deep) and holds every CUDA kernel
against its plain PyTorch version. Phases, one JSON line each:

  device   the card (and `nvidia-smi` name + power limit on a line of its own)
  build    nvcc builds of the kernels, all sources at once
  data     seeded interactions at the Amazon-Electronics cardinalities
           (192,403 users x 63,001 items x 1,689,116 interactions, lognormal
           degree skew sigma 0.83 / 1.52) and 384-d item features
  check    each kernel vs its plain version on the card, at a small shape and
           at the main paths' shapes (tolerances below); the attention op's
           gradients vs autograd of the plain golden
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
  timing   CUDA-event times of each kernel, its plain version and, where one
           PyTorch call computes the same function, that call; the bound with
           its reckoning; kernel 1 split into its two CUDA kernels and timed on
           a graph of the same size without degree skew; the training step
           split into sampling, forward, backward and optimizer, and its
           device time by kernel with the idle share (torch.profiler); one
           eval pass
  kernels  one {"kernels": [...]} line
  last     {"ok": true, "device": {...}}

Exits non-zero, printing no result, without CUDA or without the package.
Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 off the tensor cores; bf16 tensor cores
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)  # same rows, f32 sums, another order
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)  # tests/test_gat_fused.py:53-55: sums with cancellation
FENCE_TOL = dict(rtol=1e-5, atol=1e-5)  # at most 8 x 128 f32 terms, another order
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
}
# the kernels each path must launch; gather_fence is on neither (the port's
# backward kernels gather rows themselves, so there are no two XLA gathers
# to order) and is only checked and timed
PATH_KERNELS = {"train": ("gat_fwd", "gat_bwd_dst", "gat_bwd_src"),
                "serve": ("gat_fwd", "topk_chunkmax", "topk_rescore")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def amazon_shaped_interactions(seed: int, n_users=192_403, n_items=63_001, n=1_689_116):
    """Interactions as column arrays: lognormal user/item degree weights."""
    rng = np.random.default_rng(seed)
    wu = rng.lognormal(0.0, 0.83, n_users)
    wi = rng.lognormal(0.0, 1.52, n_items)
    return {
        "user_id": rng.choice(n_users, n, p=wu / wu.sum()).astype(np.int64),
        "asin": rng.choice(n_items, n, p=wi / wi.sum()).astype(np.int64),
        "ts": rng.integers(1_100_000_000, 1_500_000_000, n),
        "rating": rng.integers(1, 6, n).astype(np.float64),
    }


def random_gat_params(rng, n_users: int, feat_dim: int, hidden: int, layers: int):
    """JAX-keyed parameters with the JAX package's init distributions."""
    def xavier(shape, fan_in, fan_out):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-a, a, shape).astype(np.float32)

    lim = 1.0 / math.sqrt(feat_dim)
    p = {"['user_emb']": (0.1 * rng.normal(size=(n_users, hidden))).astype(np.float32),
         "['item_proj']['w']": rng.uniform(-lim, lim, (feat_dim, hidden)).astype(np.float32),
         "['item_proj']['b']": np.zeros(hidden, np.float32)}
    for li in range(layers):
        p[f"['layers'][{li}]['w']"] = xavier((hidden, 1, hidden), hidden, hidden)
        p[f"['layers'][{li}]['a_src']"] = xavier((1, hidden), 1, hidden)
        p[f"['layers'][{li}]['a_dst']"] = xavier((1, hidden), 1, hidden)
    return p


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(args, Path(tmp))


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
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": took})


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


def phase_train(args, work: Path, inter, feats, dev):
    """Path 1: `train_from_artifacts` at full width. Returns the trainer, the
    checkpoint path and the launches."""
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.pipeline import train_from_artifacts
    from plotpointe_tpu_torch.train.checkpoint import load_checkpoint, params_to_jax

    staging, emb, models = work / "staging", work / "embeddings", work / "models"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz", **inter)
    np.save(emb / "fused_interacted.npy", feats)
    cfg = TrainConfig(hidden_dim=128, layers=args.layers, heads=1, attn_dropout=0.1,
                      epochs=args.epochs, samples_per_epoch=200_000, eval_neg_k=1000,
                      attn_impl="auto", seed=args.seed)
    cuda_build.reset_counters()
    t0 = time.perf_counter()
    res = train_from_artifacts(cfg, str(staging), str(emb), str(models), device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    trainer = res["trainer"]
    for h in res["history"]:
        emit({"phase": "train", "epoch": h["epoch"], "loss": h["loss"], "step_s": h["step_time_s"],
              "eval_s": h["eval_time_s"], "val_ndcg@20": h.get("val_ndcg@20"),
              "val_recall@20": h.get("val_recall@20")})
    losses = [h["loss"] for h in res["history"]]
    ckpt = Path(res["checkpoint_uri"])
    flat, config = load_checkpoint(ckpt)
    best = params_to_jax(trainer.model.state_dict())  # the best parameters after fit
    jax_format = (sorted(flat) == sorted(best) and "train_config" in config
                  and all(np.array_equal(flat[k], best[k]) for k in best)
                  and config["n_layers"] == args.layers and config["hidden_dim"] == 128)
    missing = [k for k in PATH_KERNELS["train"] if launches[k] == 0]
    emit({"phase": "train", "wall_s": wall, "epochs": args.epochs, "losses": losses,
          "rows": str(trainer.model.hs_dtype)[6:], "best_val_ndcg@20": res["best_val_ndcg@20"],
          "test": res["test"], "checkpoint_keys": sorted(flat), "checkpoint_jax_format": jax_format,
          "launches": launches, "ok": not missing and jax_format and bool(np.isfinite(losses).all())})
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    if missing:
        raise AssertionError(f"kernels not launched on the training path: {missing}")
    if not jax_format:
        raise AssertionError(f"best checkpoint {ckpt} is not the best parameters in the JAX format")
    return trainer, ckpt, launches


def phase_step_parity(trainer) -> None:
    """The first training step with the kernels vs with their plain versions,
    on the same card tensors (these launches are not the path's)."""
    import torch

    from plotpointe_tpu_torch.ops.gat_fused import reference_versions
    from plotpointe_tpu_torch.train.trainer import STREAM_INIT, STREAM_TRAIN

    tr = trainer
    tr.model.init_params(tr._reseed(STREAM_INIT, 0))
    tr._reseed(STREAM_TRAIN, 1)
    u, i, j, seeds = tr._sample()
    out = {}
    for plain in (False, True):
        tr.model.zero_grad(set_to_none=True)
        with reference_versions() if plain else contextlib.nullcontext():
            loss = tr._loss(u, i, j, seeds)
            loss.backward()
        out[plain] = (float(loss.detach()), {n: p.grad.detach().clone()
                                             for n, p in tr.model.named_parameters()})
    (lk, gk), (lp, gp) = out[False], out[True]
    worst, bad = {}, []
    for name, want in gp.items():
        scale = float(want.abs().max())
        worst[name] = float((gk[name] - want).abs().max()) / max(scale, 1e-30)
        if not torch.allclose(gk[name], want, rtol=STEP_RTOL, atol=STEP_ATOL_OF_MAX * scale):
            bad.append(name)
    loss_ok = abs(lk - lp) <= LOSS_RTOL * abs(lp)
    emit({"phase": "train", "check": "first step, kernels vs plain versions", "loss_kernels": lk,
          "loss_plain": lp, "grad_max_abs_err_over_max": worst,
          "tol": {"rtol": STEP_RTOL, "atol_of_max": STEP_ATOL_OF_MAX, "loss_rtol": LOSS_RTOL},
          "ok": loss_ok and not bad})
    if not loss_ok or bad:
        raise AssertionError(f"training step: loss {lk} vs {lp}, gradients off: {bad}")
    tr.model.zero_grad(set_to_none=True)


def phase_main(work: Path, ckpt, inter, s, feats, dev):
    """Path 2: export the trained checkpoint and serve it over HTTP."""
    import torch

    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig
    from plotpointe_tpu_torch.tools.export import export_item_embeddings

    cuda_build.reset_counters()
    t0 = time.perf_counter()
    out_npy = str(work / "item_embeddings.npy")
    emb = export_item_embeddings(ckpt, inter, feats, out_npy, device=dev)
    t_export = time.perf_counter() - t0
    hist_rng = np.random.default_rng(1)
    histories = [hist_rng.choice(s.n_items, size=int(hist_rng.integers(1, 21)), replace=False).tolist()
                 for _ in range(72)]
    single_srv, _ = serve("127.0.0.1", 0, block=False)
    batch_srv, _ = serve("127.0.0.1", 0, block=False, micro_batch=True, micro_batch_max=64,
                         micro_batch_wait_ms=5.0)
    replies = [None] * 72
    try:
        urls = [f"http://127.0.0.1:{srv.server_address[1]}" for srv in (single_srv, batch_srv)]
        for u in urls:
            code, body = post(f"{u}/startup", {"item_embeddings_uri": out_npy, "use_device": True})
            if code != 200:
                raise AssertionError(f"/startup answered {code}: {body}")
        t1 = time.perf_counter()
        for i in range(8):
            replies[i] = post(f"{urls[0]}/recommend", {"item_ids": histories[i], "k": 20})
        t_single = time.perf_counter() - t1
        barrier = threading.Barrier(64)

        def client(i):
            barrier.wait()
            replies[i] = post(f"{urls[1]}/recommend", {"item_ids": histories[i], "k": 20})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8, 72)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        t_batch = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = counts()
        stats = batch_srv.state.batcher.stats
        batches = (stats.n_requests, stats.n_batches, stats.max_batch)
    finally:
        for srv in (single_srv, batch_srv):
            srv.shutdown()
            srv.server_close()
            srv.state.close()

    codes = [r[0] if r else None for r in replies]
    if any(c != 200 for c in codes):
        raise AssertionError(f"/recommend replies not all 200: {codes}")
    plain_rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=out_npy, device="cpu",
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
    t1 = time.perf_counter()
    emb_cpu = export_item_embeddings(ckpt, inter, feats, str(work / "cpu_items.npy"), device="cpu")
    t_export_cpu = time.perf_counter() - t1
    export_err = float(np.max(np.abs(emb - emb_cpu)))
    if emb.shape != (s.n_items, 128) or not np.isfinite(emb).all() \
            or not np.allclose(emb, emb_cpu, **ATTN_TOL):
        raise AssertionError(f"export on the card: shape {emb.shape}, max err vs CPU {export_err}")
    missing = [k for k in PATH_KERNELS["serve"] if launches[k] == 0]
    emit({"phase": "main", "checkpoint": "trained", "export_s": t_export,
          "export_cpu_s": t_export_cpu, "export_shape": list(emb.shape),
          "export_max_abs_err_vs_cpu": export_err, "single_requests": 8,
          "single_wall_s": t_single, "concurrent_requests": 64, "concurrent_wall_s": t_batch,
          "batcher_requests_batches_max": batches, "status_codes": sorted(set(codes)),
          "served_max_rel_err_vs_plain": worst, "launches": launches, "ok": not missing})
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")
    return launches


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


def time_train_step(trainer, s) -> None:
    """The training step split into phases (host clock around synchronised
    work), and one eval pass over the val split."""
    tr = trainer
    phases = {"sample": [], "forward": [], "backward": [], "optimizer": []}
    for it in range(4):  # the first is a warm-up
        sync()
        t0 = time.perf_counter()
        u, i, j, seeds = tr._sample()
        sync()
        t1 = time.perf_counter()
        loss = tr._loss(u, i, j, seeds)
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
    emit({"phase": "timing", "what": "training step", "samples": tr.cfg.samples_per_epoch,
          "seconds_by_phase": step, "step_s": sum(step.values()), "repeats": 3,
          "eval_pass_s": eval_s, "eval_users": len(s.val_u), "eval_neg_k": tr.cfg.eval_neg_k,
          "val_ndcg@20": val["ndcg@20"]})
    profile_train_step(tr, sum(step.values()))


def profile_train_step(tr, step_s: float) -> None:
    """Device time of one training step by kernel (torch.profiler), and the
    device's idle share against the unprofiled step's wall time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        tr._train_step()
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
    ours = {k: sum(v for n, v in by_kernel.items() if pat in n)
            for k, pat in (("gat_fwd", "aggregate<"), ("gat_fwd node_terms", "node_terms<"),
                           ("gat_bwd_dst", "bwd_dst<"), ("gat_bwd_src", "bwd_src<"))}
    emit({"phase": "timing", "what": "training step profile", "device_busy_ms": busy,
          "step_wall_ms_unprofiled": step_s * 1e3, "idle_share": 1.0 - busy / (step_s * 1e3),
          "profiled_wall_ms": wall * 1e3, "port_kernels_ms": ours, "kernels_seen": len(by_kernel),
          "top_kernels_ms": top})


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
                            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
                    emit(line)
                    if dt == torch.float32 and b == 64:
                        rows[kname] = line  # the served dtype at the batcher's cap
    time_train_step(trainer, s)
    return rows


def run(args, work: Path, dev="cuda") -> int:
    import torch

    import plotpointe_tpu_torch  # noqa: F401  (without the package: fail before any output)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    rng = np.random.default_rng(args.seed)
    inter, s, feats, graph, (h0, a_s, a_d) = phase_data(args, rng, dev)
    catalog = torch.as_tensor(rng.normal(size=(CATALOG, 128)).astype(np.float32), device=dev)

    errs = Errors()
    phase_check(errs, rng, graph, h0, a_s, a_d, catalog, dev)
    trainer, ckpt, train_launches = phase_train(args, work, inter, feats, dev)
    phase_step_parity(trainer)
    serve_launches = phase_main(work, ckpt, inter, s, feats, dev)
    rows = phase_timing(rng, graph, h0, a_s, a_d, catalog, trainer, s, dev)

    by_path = {"train": train_launches, "serve": serve_launches}
    kernels = []
    for kname, (src_path, replaces) in SOURCES.items():
        t = rows[kname]
        paths = {p: by_path[p][kname] for p, ks in PATH_KERNELS.items() if kname in ks}
        kernels.append({"name": kname, "route": "cuda", "source": src_path, "replaces": replaces,
                        "launches": sum(paths.values()), "launches_by_path": paths,
                        "max_abs_err": errs.max[kname], "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "shape": t["shape"]})
    if "jax" in sys.modules or any(m.startswith("plotpointe_tpu.") or m == "plotpointe_tpu"
                                   for m in sys.modules):
        raise AssertionError("the port pulled in JAX or the JAX package")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
