#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (plotpointe_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--layers 2]

Drives the port's serving path end to end at full width and holds every
CUDA kernel of that path against its plain PyTorch version. Phases, one JSON
line each:

  device   the card (and `nvidia-smi` name + power limit on a line of its own)
  build    nvcc builds of the kernels, all sources at once
  data     seeded interactions at the Amazon-Electronics cardinalities
           (192,403 users x 63,001 items x 1,689,116 interactions, lognormal
           degree skew sigma 0.83 / 1.52), 384-d item features, and a random
           GAT (hidden 128, heads 1) saved as a JAX-format checkpoint
  check    each kernel vs its plain version on the card, at a small shape and
           at the main path's shapes (tolerances below)
  main     the main path with every launch counter set to 0 first:
           `export_item_embeddings` on the card, then two stdlib HTTP servers
           (8 single /recommend requests; 64 concurrent ones micro-batched);
           every reply must be 200 and its scores must match the plain CPU
           answer; the export must match the CPU export; every kernel must
           have launched
  timing   CUDA-event times of each kernel, its plain version and, where one
           PyTorch call computes the same function, that call; the bound;
           kernel 1 split into its two CUDA kernels (torch.profiler) and
           timed on a graph of the same size without degree skew
  kernels  one {"kernels": [...]} line
  last     {"ok": true, "device": {...}}

Exits non-zero, printing no result, without CUDA or without the package.
Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
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
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)  # f32 dot products of width 128, another order
SERVE_RTOL = 1e-4  # served scores vs the plain CPU answer
CATALOG = 498_196  # the reference's serving catalog
SOURCES = {
    "gat_fwd": ("plotpointe_tpu_torch/csrc/gat_fwd.cu", "plotpointe_tpu/ops/gat_fused.py:91"),
    "topk_chunkmax": ("plotpointe_tpu_torch/csrc/topk_chunkmax.cu", "plotpointe_tpu/ops/topk_kernel.py:140"),
    "topk_rescore": ("plotpointe_tpu_torch/csrc/topk_rescore.cu", "plotpointe_tpu/ops/topk_kernel.py:175"),
}


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
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(args, Path(tmp))


def run(args, work: Path) -> int:
    import torch

    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph, build_graph
    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.ops import cuda_build
    from plotpointe_tpu_torch.ops.gat_fused import attention_fwd, attention_fwd_plain, hash_mask
    from plotpointe_tpu_torch.ops.topk_kernel import (
        CHUNK, CHUNK_MARGIN, chunk_max, chunk_max_plain, n_chunks_of, rescore, rescore_plain,
        topk_mips, topk_mips_ref)
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig
    from plotpointe_tpu_torch.tools.export import export_item_embeddings
    from plotpointe_tpu_torch.train.checkpoint import params_from_jax, save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # -- device ---------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)

    # -- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    took = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": took})

    # -- data -----------------------------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    inter = amazon_shaped_interactions(args.seed)
    u2i, i2i = build_node_maps(inter)
    s = build_splits(inter, u2i, i2i)
    feats = rng.normal(size=(s.n_items, 384)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    params = random_gat_params(rng, s.n_users, 384, 128, args.layers)
    config = {"model_family": "gat", "n_users": s.n_users, "n_items": s.n_items, "feat_dim": 384,
              "hidden_dim": 128, "n_layers": args.layers, "heads": 1, "attn_dropout": 0.1,
              "use_bias": False}
    ckpt = save_checkpoint(work / "gat.npz", params, config)
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w).to(dev)
    model = GATModel.from_config(config)
    model.load_state_dict(params_from_jax(params))
    model.to(dev)
    with torch.no_grad():
        x0 = model.node_features(torch.as_tensor(feats, device=dev))
        h0 = torch.einsum("nf,fhd->nhd", x0, model.layers[0].w).contiguous()
    a_s, a_d = model.layers[0].a_src.detach(), model.layers[0].a_dst.detach()
    catalog = torch.as_tensor(rng.normal(size=(CATALOG, 128)).astype(np.float32), device=dev)
    emit({"phase": "data", "seconds": time.perf_counter() - t0, "n_users": s.n_users,
          "n_items": s.n_items, "n_interactions": len(inter["user_id"]), "n_train": s.n_train,
          "graph_nodes": graph.n_nodes, "graph_edges": graph.n_edges,
          "max_in_degree": int((graph.row_ptr[1:] - graph.row_ptr[:-1]).max()),
          "layers": args.layers, "hidden": 128, "feat_dim": 384, "catalog": [CATALOG, 128]})

    # -- check: every kernel vs its plain version, small and main-path shapes -
    errs = Errors()
    cuda_build.reset_counters()
    with torch.no_grad():
        small_n, small_e = 3000, 30_000
        src = rng.integers(0, small_n, small_e)
        dst = np.where(rng.random(small_e) < 0.2, 5, rng.integers(0, small_n - 100, small_e))
        gsmall = build_graph(src, dst, small_n).to(dev)
        hs_ = torch.as_tensor(rng.normal(size=(small_n, 1, 128)).astype(np.float32), device=dev)
        mask_main = hash_mask(7, torch.arange(graph.n_edges, device=dev), 0.1)
        mask_small = hash_mask(7, torch.arange(gsmall.n_edges, device=dev), 0.1)
        for label, g, h, m in (("small", gsmall, hs_, mask_small), ("main", graph, h0, mask_main)):
            for rows in (torch.float32, torch.bfloat16):
                for masked in (False, True):
                    mk = m if masked else None
                    got = attention_fwd(h, a_s, a_d, g, mask=mk, hs_dtype=rows)
                    want = attention_fwd_plain(h, a_s, a_d, g, mask=mk, hs_dtype=rows)
                    what = f"{label} N={g.n_nodes} E={g.n_edges} rows={str(rows)[6:]} mask={masked}"
                    errs.check("gat_fwd", what + " out", got[0], want[0], ATTN_TOL)
                    errs.check("gat_fwd", what + " den", got[1], want[1], ATTN_TOL)
                    del got, want
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
    torch.cuda.synchronize()

    # -- main path --------------------------------------------------------------
    cuda_build.reset_counters()
    t0 = time.perf_counter()
    out_npy = str(work / "item_embeddings.npy")
    emb = export_item_embeddings(ckpt, inter, feats, out_npy)
    t_export = time.perf_counter() - t0
    hist_rng = np.random.default_rng(args.seed + 1)
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
        launches = {k: c.count for k, c in cuda_build.COUNTERS.items()}
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
    missing = [k for k, v in launches.items() if v == 0]
    emit({"phase": "main", "export_s": t_export, "export_cpu_s": t_export_cpu,
          "export_shape": list(emb.shape), "export_max_abs_err_vs_cpu": export_err,
          "single_requests": 8, "single_wall_s": t_single, "concurrent_requests": 64,
          "concurrent_wall_s": t_batch, "batcher_requests_batches_max": batches,
          "status_codes": sorted(set(codes)), "served_max_rel_err_vs_plain": worst,
          "launches": launches, "ok": not missing})
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # -- timing -----------------------------------------------------------------
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

    kernels = []
    for kname, (src_path, replaces) in SOURCES.items():
        t = rows[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src_path, "replaces": replaces,
                        "launches": launches[kname], "max_abs_err": errs.max[kname],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "shape": t["shape"]})
    if "jax" in sys.modules or any(m.startswith("plotpointe_tpu.") or m == "plotpointe_tpu"
                                   for m in sys.modules):
        raise AssertionError("the port pulled in JAX or the JAX package")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
