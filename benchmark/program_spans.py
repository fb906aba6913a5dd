"""The program's own spans (`plotpointe_tpu_torch/utils/tracing.py`, on while
a `torch.profiler` records) for the per-layer readers: the finished records
that lie inside a traced run's region, the device trace's window where there
is one, else the measured window. A run whose traced rank is another process
ships that rank's records in the observation. A program without the span
recorder gives none, and the readers of these spans then return None."""
from __future__ import annotations

from bisect import bisect_right
from typing import Optional, Sequence, Tuple


def records(obs, *names: str) -> list:
    """The records named `names` inside the traced region, oldest first:
    the observation's own (`obs.records`, taken in another process) where
    it carries them, else this process's recorder's."""
    t0, t1 = (obs.trace.t0, obs.trace.t1) if obs.trace is not None else obs.window
    if obs.records is not None:
        return [r for r in obs.records if t0 <= r.t0 and r.t1 <= t1 and r.name in names]
    try:
        from plotpointe_tpu_torch.utils import tracing
    except ImportError:
        return []
    return [r for r in tracing.records(t0, t1) if r.name in names]


def device_ms_per(obs, name: str, per: str) -> Optional[float]:
    """The device intervals of span `name`, summed, over the number of spans
    `per`, in ms (None without a device interval or without `per`)."""
    recs = records(obs, name, per)
    parts = [r.d1 - r.d0 for r in recs if r.name == name and r.d0 is not None]
    n = sum(r.name == per for r in recs)
    return sum(parts) / n * 1e3 if parts and n else None


def host_ms_mean(obs, name: str) -> Optional[float]:
    """The mean host interval of span `name`, in ms."""
    recs = records(obs, name)
    return sum(r.t1 - r.t0 for r in recs) / len(recs) * 1e3 if recs else None


def covered(intervals: Sequence[Tuple[float, float]], t0: float, t1: float) -> float:
    """How much of [t0, t1] the sorted, disjoint `intervals` cover."""
    i = max(0, bisect_right(intervals, (t0, float("inf"))) - 1)
    total = 0.0
    while i < len(intervals) and intervals[i][0] < t1:
        a, b = intervals[i]
        total += max(0.0, min(b, t1) - max(a, t0))
        i += 1
    return total



NCCL = "nccl"  # NCCL's kernels are named ncclDevKernel_* / ncclKernel_*


def nccl_ms_per_step(obs, exposed: bool = False) -> Optional[float]:
    """The union of the traced device's NCCL kernels inside the device
    intervals of the program's `train.step` spans, per step, in ms; with
    `exposed`, only the part during which no other kernel ran (None without
    a device trace, a step or an NCCL kernel)."""
    from benchmark.tracing import merged

    steps = sorted((r.d0, r.d1) for r in records(obs, "train.step") if r.d0 is not None)
    if obs.trace is None or not steps:
        return None
    nccl = merged([o for o in obs.trace.ops if NCCL in o[0].lower()])
    if not nccl:
        return None
    others = merged([o for o in obs.trace.ops if NCCL not in o[0].lower()])
    total = 0.0
    for a, b in nccl:
        for s0, s1 in steps:
            x0, x1 = max(a, s0), min(b, s1)
            if x1 > x0:
                total += (x1 - x0) - (covered(others, x0, x1) if exposed else 0.0)
    return total / len(steps) * 1e3
