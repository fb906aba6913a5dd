"""What a traced run (`--trace 1`) observes, for the per-layer readers.

Spans come from this benchmark's own wrappers: `wrap(obj, method, name)`
puts a timing wrapper on one instance's method (the program's files are not
touched), with a device synchronise at each boundary, and records (name,
start, end, meta) on the host clock. Counters are the program's own
(launch counters, the batcher's stats), read as differences over the
traced region. Device operations come from `torch.profiler` (CUDA
activity only): each kernel, copy and set with its start and length on the
trace clock, which a marker kernel launched right after a synchronise ties
to the host clock. A region whose trace holds no device operation is
retried by the cell's driver (`drivers/`); none is ever read as zero."""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    meta: Dict[str, Any] = field(default_factory=dict)


class Spans:
    def __init__(self, device):
        self.device = device
        self.items: List[Span] = []
        self._lock = threading.Lock()
        self._undo: List[Callable[[], None]] = []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, obj, method: str, name: str, meta_of: Optional[Callable] = None) -> None:
        inner = getattr(obj, method)

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            self.sync()
            t1 = time.perf_counter()
            meta = meta_of(args, kwargs, out) if meta_of else {}
            with self._lock:
                self.items.append(Span(name, t0, t1, meta))
            return out

        setattr(obj, method, timed)
        self._undo.append(lambda: delattr(obj, method))

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()

    def named(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> List[Span]:
        return [s for s in self.items if s.name == name and s.t0 >= t0 and s.t1 <= t1]


@dataclass
class DeviceTrace:
    """Device operations of one traced region: (name, start_s, length_s),
    start on the host clock."""
    ops: List[Tuple[str, float, float]]
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return sum(b - a for a, b in merged(self.ops))

    def time_of(self, patterns) -> float:
        return sum(d for n, _, d in self.ops if any(p in n for p in patterns))


MARKER = "spin"  # torch.cuda._sleep's kernel


def merged(ops) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return [(a, b) for a, b in out]


class Profile:
    """`with Profile(device) as p:` traces the device over the block; after
    it, `p.trace` is a DeviceTrace (None off CUDA or when the profiler
    recorded no device operation)."""

    def __init__(self, device):
        self.device = device
        self.trace: Optional[DeviceTrace] = None

    def __enter__(self):
        if self.device.type != "cuda":
            return self
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()
        torch.cuda._sleep(1000)  # the marker: starts right after t0 on the device
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        if self.device.type != "cuda":
            return False
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        ops = []
        for ev in self._prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ops.append((ev.name, ev.time_range.start / 1e6, (ev.time_range.end - ev.time_range.start) / 1e6))
        marks = [o for o in ops if MARKER in o[0]]
        ops = [o for o in ops if MARKER not in o[0]]
        if not ops:
            return False
        base = marks[0][1] if marks else min(o[1] for o in ops)
        shift = self._t0 - base
        self.trace = DeviceTrace([(n, s + shift, d) for n, s, d in ops], self._t0, t1)
        return False


def breakdown(trace: DeviceTrace, spans: List[Span], top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost host span open at each gap's middle."""
    by_name: Dict[str, float] = {}
    for n, _, d in trace.ops:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + d
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged(trace.ops)
    edges = [trace.t0] + [x for ab in busy for x in ab] + [trace.t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps = sorted(gaps, key=lambda ab: ab[0] - ab[1])[:top]

    def host_at(t: float) -> str:
        open_ = [s for s in spans if s.t0 <= t <= s.t1]
        return min(open_, key=lambda s: s.t1 - s.t0).name if open_ else "outside any span"

    idle = [[host_at((a + b) / 2), b - a] for a, b in gaps]
    return {"device_ops": [[n, s] for n, s in device_ops], "idle_gaps": idle}


def idle_share(trace: Optional[DeviceTrace]) -> Optional[float]:
    """100 (1 - busy / wall) of a traced region, or None without one."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
