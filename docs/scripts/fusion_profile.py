#!/usr/bin/env python3
"""Where a `train_fusion` run's time goes on one card: FusionConfig's
defaults (5 epochs of 1,024) on seeded unit rows of path 12's sizes
(498,196 text rows of 384, 149,669 image rows of 512), three runs in one
process: the first (a fresh process), the second (warm), the third under
torch.profiler (CPU and CUDA: the top ops by self CPU time, and the
device-busy share of the run's wall).

    python3 docs/scripts/fusion_profile.py
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    import torch

    from plotpointe_tpu_torch.models.fusion import train_fusion

    if not torch.cuda.is_available():
        print("fusion_profile: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    txt = rng.standard_normal((498_196, 384), dtype=np.float32)
    img = rng.standard_normal((149_669, 512), dtype=np.float32)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    row = np.full(len(txt), -1, np.int64)
    row[rng.choice(len(txt), len(img), replace=False)] = np.arange(len(img))
    for run in ("first", "warm"):
        t0 = time.perf_counter()
        _, hist = train_fusion(txt, img, row, device="cuda")
        torch.cuda.synchronize()
        print(json.dumps({"run": run, "wall_s": time.perf_counter() - t0, "history": hist}), flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        train_fusion(txt, img, row, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    top = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    print(json.dumps({"run": "profiled", "wall_s": wall, "device_busy_s": busy,
                      "top_self_cpu": [{"op": e.key, "calls": e.count,
                                        "self_cpu_s": e.self_cpu_time_total / 1e6,
                                        "self_device_s": e.self_device_time_total / 1e6} for e in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
