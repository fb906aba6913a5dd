"""Serving traffic: open-loop POST /recommend over HTTP to the port's own
stdlib server, `serving.httpd.serve(micro_batch=True, ...)` with the
configuration's batcher settings (those of `cli serve --micro-batch`),
bound to 127.0.0.1 on port 0 in this process. The load generator
(`benchmark/loadgen.py`) is a process of its own.

Set-up draws the served table on the device from the seed (unit f32 rows,
the deployed type), hands it to a `RecommenderRuntime` through an artifact
store that returns it (nothing is written to disk), builds each user's
history from the seeded interactions, the schedule from the cell's
traffic, and warms every (batch bucket, k) shape the schedule can reach,
then offers the cell's own traffic for two seconds over HTTP (the batcher's
threads and the handlers' path) without measuring it. The window is the schedule: each request is timed from
its due time to the last byte of its reply; a failed or timed-out one
counts as infinitely late.

Every run records the server process's pauses over the window (each
garbage collection, through `gc.callbacks`, and each wake-up of a watchdog
thread that came more than 20 ms late) and logs them beside the slowest
requests, on the same monotonic clock as the load generator's stamps.

A traced run wraps the batcher's dispatch (`MicroBatcher._run`) on the
instance and traces the device over the whole window. After it, the
server is stopped and a sample of the replies, drawn from the seed with the
longest histories in it, is held to the exact top-k.

Cell parameters (`traffic`): `rate_per_s`, `arrivals`, `k`, `check_sample`."""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from benchmark import checks, data, traffic
from benchmark.core import Observation, Outcome
from benchmark.reference import data as refdata
from benchmark.reference.topk import exact
from benchmark.tracing import Profile

LOADGEN = Path(__file__).resolve().parents[1] / "loadgen.py"
LONGEST = 8  # the longest histories always among the replies checked
WARM_SECONDS = 2.0  # the cell's own traffic, offered once before the window and not measured
WATCH_PERIOD_S, WATCH_LATE_S = 0.005, 0.020  # the watchdog's sleep, and the lateness it logs


class Pauses:
    """The server process's pauses while it is entered: each garbage
    collection (start, generation, seconds) and each watchdog wake-up more
    than WATCH_LATE_S late (due, seconds late)."""

    def __init__(self):
        self.collections, self.stalls = [], []
        self._gc_start = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def _on_gc(self, phase: str, info: dict) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._gc_start = now
        elif self._gc_start is not None:
            self.collections.append((self._gc_start, info["generation"], now - self._gc_start))

    def _watch(self) -> None:
        last = time.perf_counter()
        while not self._stop.wait(WATCH_PERIOD_S):
            now = time.perf_counter()
            if now - last > WATCH_PERIOD_S + WATCH_LATE_S:
                self.stalls.append((last + WATCH_PERIOD_S, now - last - WATCH_PERIOD_S))
            last = now

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        gc.callbacks.remove(self._on_gc)

    def summary(self, t0: float) -> str:
        gens = {}
        for _, g, s in self.collections:
            n, total, most = gens.get(g, (0, 0.0, 0.0))
            gens[g] = (n + 1, total + s, max(most, s))
        longest = sorted(self.collections, key=lambda c: -c[2])[:5]
        stalls = sorted(self.stalls, key=lambda c: -c[1])[:8]
        return ("garbage collections by generation (count, total ms, longest ms) "
                + json.dumps({g: [n, round(tot * 1e3, 3), round(m * 1e3, 3)] for g, (n, tot, m) in gens.items()})
                + "; longest (s into the window, generation, ms) "
                + json.dumps([[round(a - t0, 3), g, round(s * 1e3, 3)] for a, g, s in longest])
                + f"; watchdog late by over {WATCH_LATE_S * 1e3:.0f} ms: {len(self.stalls)} times, "
                + f"{sum(s for _, s in self.stalls) * 1e3:.1f} ms in all, longest (s into the window, ms) "
                + json.dumps([[round(a - t0, 3), round(s * 1e3, 3)] for a, s in stalls]))


class TableStore:
    """An artifact store that serves the seeded table from memory."""

    def __init__(self, table: np.ndarray):
        self.table = table

    def load_npy(self, uri: str) -> np.ndarray:
        return self.table


def percentile(sorted_values, q: float) -> float:
    """The sorted-index percentile (the port's serve_bench arithmetic)."""
    if not sorted_values:
        return math.inf
    return sorted_values[min(len(sorted_values) - 1, int(len(sorted_values) * q))]


def histories_of(config: dict, seed: int) -> list:
    return refdata.train_items_by_user(refdata.splits(data.interactions_of(config, seed)))


def start(ctx, sv: dict, table: np.ndarray):
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig

    runtime = RecommenderRuntime(ServingConfig(item_embeddings_uri="seeded-table",
                                               table_dtype=sv["table_dtype"], device=str(ctx.device)),
                                 store=TableStore(table))
    runtime.startup()
    server, _ = serve("127.0.0.1", 0, runtime=runtime, block=False, micro_batch=True,
                      micro_batch_max=sv["micro_batch_max"], micro_batch_wait_ms=sv["micro_batch_wait_ms"],
                      micro_batch_in_flight=sv["micro_batch_in_flight"])
    return runtime, server


def stop(server) -> None:
    server.shutdown()
    server.server_close()
    server.state.close()


def warm(runtime, server, sched, sv: dict) -> None:
    """Every (batch bucket, k rounded to 32) the schedule can reach, then a
    few requests over HTTP."""
    hist = max((h for _, h, _ in sched), key=len)
    k = max(kk for _, _, kk in sched)
    lengths = sorted({min(len(hist), max(1, 32 * m - k))
                      for m in range(1, -(-(k + len(hist)) // 32) + 1)})
    b = 1
    while b <= sv["micro_batch_max"]:
        for n in lengths:
            runtime.top_k_for_batch([np.asarray(hist[:n], np.int32)] * b, [k] * b,
                                    max_batch=sv["micro_batch_max"])
        b *= 2
    url = f"http://127.0.0.1:{server.server_address[1]}/recommend"
    for _, h, kk in sched[:8]:
        req = urllib.request.Request(url, json.dumps({"item_ids": h, "k": kk}).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            r.read()


def launch_loadgen(port: int, sched) -> subprocess.Popen:
    proc = subprocess.Popen([sys.executable, str(LOADGEN), "--port", str(port)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    proc.stdin.write(json.dumps({"schedule": sched}) + "\n")
    proc.stdin.flush()
    return proc


def drive(proc: subprocess.Popen, seconds: float) -> dict:
    """Start the schedule and wait for the load generator's report."""
    if proc.stderr.readline().strip() != "ready":
        raise RuntimeError("the load generator did not start")
    proc.stdin.write("go\n")
    proc.stdin.flush()
    out, err = proc.communicate(timeout=seconds + 120)
    if proc.returncode != 0:
        raise RuntimeError(f"the load generator failed ({proc.returncode}): {err[-2000:]}")
    return json.loads(out)


def summarise(report: dict) -> dict:
    rows = report["rows"]
    lat = sorted((r[2] - r[0]) if r[3] == 200 else math.inf for r in rows)
    late = sorted(r[1] - r[0] for r in rows)
    ok = [r for r in rows if r[3] == 200]
    end = max((r[2] for r in ok), default=report["t0"])
    return {"n": len(rows), "ok": len(ok), "p50_ms": percentile(lat, 0.5) * 1e3,
            "p95_ms": percentile(lat, 0.95) * 1e3, "p99_ms": percentile(lat, 0.99) * 1e3,
            "late_median_ms": percentile(late, 0.5) * 1e3, "late_max_ms": late[-1] * 1e3 if late else 0.0,
            "completed_per_s": len(ok) / max(end - report["t0"], 1e-9)}


def slowest(report: dict, sched, n: int = 10) -> str:
    """The n slowest requests: s into the window when due, ms late to be
    sent, ms from sent to reply, history length."""
    rows = sorted(range(len(report["rows"])), key=lambda i: -(
        math.inf if report["rows"][i][2] is None else report["rows"][i][2] - report["rows"][i][0]))[:n]
    out = []
    for i in rows:
        due, sent, done, _ = report["rows"][i]
        served = math.inf if done is None else (done - sent) * 1e3
        out.append(f"[{due - report['t0']:.3f}, {(sent - due) * 1e3:.1f}, {served:.1f}, {len(sched[i][1])}]")
    return " ".join(out)


def timeline(report: dict, step: float = 1.0) -> str:
    """Per `step` seconds of due times: requests, median and max latency (ms)."""
    rows = sorted(report["rows"], key=lambda r: r[0])
    out, i = [], 0
    while i < len(rows):
        t_end = report["t0"] + step * (int((rows[i][0] - report["t0"]) / step) + 1)
        part = []
        while i < len(rows) and rows[i][0] < t_end:
            part.append((rows[i][2] - rows[i][0]) * 1e3 if rows[i][3] == 200 else math.inf)
            i += 1
        part.sort()
        out.append(f"{len(part)}:{part[len(part) // 2]:.1f}/{part[-1]:.1f}")
    return " ".join(out)


def run(ctx) -> Outcome:
    sv, tr = ctx.config["serving"], ctx.cell["traffic"]
    dev = ctx.device
    n, d = sv["catalog_rows"], sv["dim"]
    table = data.unit_rows(data.derive(ctx.seed, "table"), n, d, dev).cpu().numpy()
    hist = histories_of(ctx.config, ctx.seed)
    sched = traffic.schedule(tr, data.derive(ctx.seed, "traffic"), ctx.seconds, hist)
    ctx.log(f"setup pieces table, histories and schedule {time.time() - ctx.t_start:.3f} s after start")
    runtime, server = start(ctx, sv, table)
    proc = None
    try:
        proc = launch_loadgen(server.server_address[1], sched)
        warm(runtime, server, sched, sv)
        warm_sched = traffic.schedule(tr, data.derive(ctx.seed, "traffic") + 1, WARM_SECONDS, hist)
        drive(launch_loadgen(server.server_address[1], warm_sched), WARM_SECONDS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.time() - ctx.t_start
        batcher = server.state.batcher
        obs = None
        cpu0 = os.times()
        if ctx.trace:
            ctx.spans.wrap(batcher, "_run", "dispatch", lambda a, kw, out: {"batch": len(a[0])})
            stats0 = (batcher.stats.n_requests, batcher.stats.n_batches)
            with Pauses() as pauses, Profile(dev) as prof:
                report = drive(proc, ctx.seconds)
            obs = Observation(ctx.config, {"catalog_rows": n, "dim": d, "k": tr["k"],
                                           "table_dtype": sv["table_dtype"]}, ctx.spans,
                              {"requests": batcher.stats.n_requests - stats0[0],
                               "batches": batcher.stats.n_batches - stats0[1]}, prof.trace)
            ctx.spans.unwrap()
        else:
            with Pauses() as pauses:
                report = drive(proc, ctx.seconds)
        cpu1 = os.times()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        stop(server)
    summary = summarise(report)
    if obs is not None:
        obs.host = {"recommend_p95_ms": summary["p95_ms"]}
    ctx.log("window " + json.dumps(summary))
    ctx.log(f"server process CPU over the window {cpu1.user - cpu0.user:.3f} s user, "
            f"{cpu1.system - cpu0.system:.3f} s system; pauses: " + pauses.summary(report["t0"]))
    ctx.log("slowest requests (s due, ms late, ms served, history) " + slowest(report, sched))
    ctx.log("by second (requests:p50/max ms) " + timeline(report))
    failed = summary["n"] - summary["ok"]
    e2e = {"recommend_p95_ms": summary["p95_ms"], "recommend_p50_ms": summary["p50_ms"]}
    t_check = time.perf_counter()
    numbers = {"score_gap": compare(ctx, table, sched, report, tr["k"], tr["check_sample"])}
    ctx.log(f"reference check {time.perf_counter() - t_check:.3f} s")
    return Outcome(setup_s, e2e, summary["n"], failed, numbers, peak, obs)


def sample_of(seed: int, sched, report: dict, size: int) -> list:
    """The replies checked: those of the longest histories and a seeded draw
    of the rest; a request with no reply is always among them."""
    n = len(sched)
    by_len = sorted(range(n), key=lambda i: -len(sched[i][1]))[:LONGEST]
    rng = np.random.default_rng(data.derive(seed, "sample"))
    rest = rng.permutation(n)[:max(0, size - len(by_len))].tolist()
    missing = [i for i, r in enumerate(report["rows"]) if r[3] != 200]
    return sorted(set(by_len) | set(rest) | set(missing))


def compare(ctx, table: np.ndarray, sched, report: dict, k: int, size: int) -> float:
    pick = sample_of(ctx.seed, sched, report, size)
    replies = []
    for i in pick:
        if report["rows"][i][3] != 200 or report["replies"][i] is None:
            return math.inf
        replies.append(json.loads(report["replies"][i]))
    x = torch.as_tensor(table, device=ctx.device)
    hs = [sched[i][1] for i in pick]
    ref = exact(x, hs, [r["indices"] for r in replies], k)
    return max(checks.reply_gap(r["indices"], r["scores"], h, k, table.shape[0], at, top)
               for r, h, (at, top, _) in zip(replies, hs, ref))
