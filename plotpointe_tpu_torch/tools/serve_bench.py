"""Served-QPS benchmark: HTTP in -> HTTP out, micro-batching on vs off.

Counterpart of `plotpointe_tpu/tools/serve_bench.py`. It starts the stdlib
transport in-process, loads a seeded catalog at the given shape, fires
`--clients` concurrent keep-alive clients for `--seconds`, and reports
end-to-end QPS and latency percentiles for both serving modes (single
requests, micro-batched), then drives the `MicroBatcher` directly from as
many submitter threads (`loopback`: no HTTP, no JSON).

    python -m plotpointe_tpu_torch.tools.serve_bench --items 498196 --d 128 \\
        --clients 64 --seconds 10 [--device cuda] [--pallas] [--json]

`--device` names the torch device the table lives on (default cuda; cpu
runs the kernels' plain versions); `--pallas` asks for the top-K kernels
explicitly, which CUDA takes by default. Latency percentiles are the
sorted-index ones: p50 = lat[n // 2], p95 = lat[int(0.95 n)].
"""
from __future__ import annotations

import argparse
import http.client
import json
import tempfile
import threading
import time
from pathlib import Path

import numpy as np


def _client_loop(port: int, payloads, stop_at: float, lat_out: list):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    i = 0
    while time.perf_counter() < stop_at:
        body = payloads[i % len(payloads)]
        i += 1
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/recommend", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                continue
        except (http.client.HTTPException, OSError):
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            continue
        lat_out.append(time.perf_counter() - t0)
    conn.close()


def _percentiles(lats: list) -> dict:
    lat = np.array(sorted(lats))
    return {"latency_p50_ms": round(float(lat[len(lat) // 2]) * 1000, 2) if len(lat) else None,
            "latency_p95_ms": round(float(lat[int(len(lat) * 0.95)]) * 1000, 2) if len(lat) else None}


def _warm_buckets(runtime, hist, k: int, max_batch: int = 64) -> None:
    """One batched call at every power-of-two batch bucket: on the GPU this
    loads the kernel libraries and allocates the top-K kernels' scratch for
    each shape before anything is timed."""
    b = 1
    while b <= max_batch:
        runtime.top_k_for_batch([np.asarray(hist, np.int32)] * b, [k] * b, max_batch=max_batch)
        b *= 2


def measure(runtime, micro_batch: bool, clients: int, seconds: float,
            n_items: int, k: int = 20, wait_ms: float = 20.0,
            in_flight: int = 16) -> dict:
    from plotpointe_tpu_torch.serving.httpd import serve

    server, _ = serve(host="127.0.0.1", port=0, runtime=runtime, block=False,
                      micro_batch=micro_batch, micro_batch_max=64,
                      micro_batch_wait_ms=wait_ms,
                      micro_batch_in_flight=in_flight)
    port = server.server_address[1]
    rng = np.random.default_rng(0)
    payloads = [json.dumps({"item_ids": rng.choice(n_items, size=5, replace=False).tolist(),
                            "k": k}).encode() for _ in range(256)]
    try:
        hist = list(range(1, 6))
        if runtime.cfg.use_device:
            runtime.top_k_for_user_items(hist, k=k)
            if micro_batch:
                _warm_buckets(runtime, hist, k)
        # then warm the HTTP path itself
        warm: list = []
        _client_loop(port, payloads, time.perf_counter() + 2.0, warm)
        lats: list = []
        stop_at = time.perf_counter() + seconds
        threads = [threading.Thread(target=_client_loop, args=(port, payloads, stop_at, lats))
                   for _ in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        out = {"mode": "micro_batch" if micro_batch else "single",
               "served_qps": round(len(lats) / wall), "n_requests": len(lats), **_percentiles(lats)}
        if micro_batch and server.state.batcher is not None:
            out["mean_batch"] = round(server.state.batcher.stats.mean_batch, 1)
        return out
    finally:
        server.shutdown()
        server.server_close()
        server.state.close()


def measure_loopback(runtime, clients: int, seconds: float, n_items: int,
                     k: int = 20, wait_ms: float = 15.0, in_flight: int = 4,
                     max_batch: int = 64) -> dict:
    """Drive the MicroBatcher directly (no HTTP, no serialization):
    submitter threads call batcher.submit() as handler threads would.
    `dispatch_ms` is the host wall of one full batch scored alone."""
    from plotpointe_tpu_torch.serving.batching import MicroBatcher

    batcher = MicroBatcher(runtime, max_batch=max_batch, max_wait_ms=wait_ms,
                           timeout_s=120.0, max_in_flight=in_flight)
    rng = np.random.default_rng(0)
    hists = [rng.choice(n_items, size=5, replace=False).astype(np.int32)
             for _ in range(256)]
    try:
        dispatch_ms = None
        if runtime.cfg.use_device:
            _warm_buckets(runtime, hists[0], k, max_batch)
            t0 = time.perf_counter()
            runtime.top_k_for_batch([hists[0]] * max_batch, [k] * max_batch,
                                    max_batch=max_batch)
            dispatch_ms = round((time.perf_counter() - t0) * 1000, 1)
        lats: list = []
        lock = threading.Lock()

        def loop(stop_at):
            i = 0
            local = []
            while time.perf_counter() < stop_at:
                t0 = time.perf_counter()
                try:
                    batcher.submit(hists[i % len(hists)], k)
                except Exception:  # noqa: BLE001 - count only successes
                    continue
                local.append(time.perf_counter() - t0)
                i += 1
            with lock:
                lats.extend(local)

        loop(time.perf_counter() + 1.0)  # warm-up
        lats.clear()
        stop_at = time.perf_counter() + seconds
        threads = [threading.Thread(target=loop, args=(stop_at,)) for _ in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        return {"mode": "loopback", "dispatch_ms": dispatch_ms,
                "served_qps": round(len(lats) / wall), "n_requests": len(lats),
                **_percentiles(lats), "mean_batch": round(batcher.stats.mean_batch, 1)}
    finally:
        batcher.close()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--items", type=int, default=498_196)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda", help="torch device of the table (default: cuda)")
    ap.add_argument("--pallas", action="store_true",
                    help="use the top-K kernels (the default on CUDA)")
    ap.add_argument("--table-dtype", default="bfloat16")
    ap.add_argument("--loopback-only", action="store_true",
                    help="skip the HTTP modes; measure only the direct-batcher path")
    ap.add_argument("--in-flight", type=int, default=4)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(args.items, args.d)).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "item_embeddings.npy"
        np.save(path, emb)
        rt = RecommenderRuntime(ServingConfig(
            item_embeddings_uri=str(path), device=args.device,
            use_kernel_topk=True if args.pallas else None, table_dtype=args.table_dtype))
        rt.startup()

        single = None if args.loopback_only else measure(
            rt, False, args.clients, args.seconds, args.items)
        micro = None if args.loopback_only else measure(
            rt, True, args.clients, args.seconds, args.items)
        loopback = measure_loopback(rt, args.clients, args.seconds, args.items,
                                    in_flight=args.in_flight)
    result = {"items": args.items, "d": args.d, "clients": args.clients,
              "device": args.device, "single": single, "micro_batch": micro,
              "loopback": loopback}
    if single and micro:
        result["speedup"] = round(micro["served_qps"] / max(single["served_qps"], 1), 1)
    print(json.dumps(result) if args.json else json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
