"""Spans inside the port: named intervals at the layer boundaries of training,
evaluation and serving, on the host clock and, where asked, on the device's.

    with tracing.span("train.optimizer", device=self.device):
        self._opt_step()

Off by default. Spans record between `enable()` and `disable()`, and while a
`torch.profiler` records (`torch.autograd.profiler._is_profiler_enabled`), so
a profiled region gets the program's spans with no flag of its own. Off,
`span` reads two flags and returns one shared no-op.

A record holds its name, its host start and end on `time.perf_counter()`, its
id, its parent's id (the innermost span open on the same thread), the
thread's name, a request id `rid` (given, else the parent's) and `meta`.
`begin` opens a span that another thread may `end` (a request's wait in the
batcher's queue). A span with `device` set (True: the current CUDA device; a
torch.device: that one, when it is a CUDA device) also records a CUDA timing
event at each edge on the current stream, and never synchronises. `records`
turns the events into `perf_counter` seconds (`d0`, `d1`) through one anchor
event per recording period, recorded right after a `torch.cuda.synchronize()`
(a period ends at `enable`, `disable`, or a span that finds tracing off), so
the device intervals share the clock of the host spans.

The records live in a bounded buffer that counts what it drops;
`write_chrome_trace` writes them as Chrome trace events for Perfetto.
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional

import torch

MAX_RECORDS = 500_000  # ~450 bytes a record: ~220 MB when full

_profiler = torch.autograd.profiler
_enabled = False
_records: "collections.deque[_Span]" = collections.deque(maxlen=MAX_RECORDS)
_dropped = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_rids = itertools.count(1)
_anchors: Dict[int, tuple] = {}  # device index -> (event, perf_counter seconds)


class _Noop:
    """What `span` and `begin` return while tracing is off."""
    __slots__ = ()
    rid = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def end(self) -> None:
        pass

    def note(self, **meta) -> None:
        pass


NOOP = _Noop()


class _Span:
    """One span; after it ends, one record of the buffer."""
    __slots__ = ("name", "id", "parent", "thread", "rid", "meta", "t0", "t1", "d0", "d1",
                 "_events", "_anchor", "_stream", "_stack")

    def __init__(self, name: str, rid, device, meta: Dict[str, Any]):
        stack = _stack()
        top = stack[-1] if stack else None
        self.name, self.id, self.meta = name, next(_ids), meta
        self.parent = top.id if top is not None else None
        self.rid = rid if rid is not None else (top.rid if top is not None else None)
        self.thread = threading.current_thread().name
        self.t1 = self.d0 = self.d1 = None
        self._events = self._anchor = self._stream = self._stack = None
        idx = _cuda_index(device)
        self.t0 = time.perf_counter()
        if idx is not None:
            self._anchor = _anchor(idx)
            self._stream = torch.cuda.current_stream(idx)
            self._events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            self._events[0].record(self._stream)

    def __enter__(self):
        self._stack = _stack()
        self._stack.append(self)
        return self

    def __exit__(self, *exc):
        self._stack.remove(self)
        self.end()
        return False

    def end(self) -> None:
        """Close the span (from any thread) and keep its record."""
        global _dropped
        if self.t1 is not None:
            return
        if self._events is not None:
            self._events[1].record(self._stream)
        self.t1 = time.perf_counter()
        with _lock:
            if len(_records) == _records.maxlen:
                _dropped += 1
            _records.append(self)

    def note(self, **meta) -> None:
        """Add to the span's meta."""
        self.meta.update(meta)

    def _resolve(self) -> None:
        if self._events is None:
            return
        (ev0, ev1), (anchor, t_anchor) = self._events, self._anchor
        try:
            ev1.synchronize()
            self.d0 = t_anchor + anchor.elapsed_time(ev0) / 1e3
            self.d1 = t_anchor + anchor.elapsed_time(ev1) / 1e3
        except RuntimeError:  # an event that never ran (its launch raised)
            self.d0 = self.d1 = None
        self._events = self._anchor = self._stream = None


def _stack() -> List[_Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index a span's events go on, or None for none."""
    if device is True:
        return torch.cuda.current_device() if torch.cuda.is_initialized() else None
    if isinstance(device, torch.device) and device.type == "cuda":
        return device.index if device.index is not None else torch.cuda.current_device()
    return None


def _anchor(idx: int) -> tuple:
    """The recording period's anchor on device `idx`: an event recorded right
    after a synchronise, and the host clock's reading between the two."""
    a = _anchors.get(idx)
    if a is None:
        with _lock:
            a = _anchors.get(idx)
            if a is None:
                stream = torch.cuda.current_stream(idx)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)  # creates the event, so the record below only records
                torch.cuda.synchronize(idx)
                t = time.perf_counter()
                ev.record(stream)
                a = _anchors[idx] = (ev, t)
    return a


def span(name: str, *, rid=None, device=False, **meta):
    """A context manager timing its block as span `name` (NOOP when off)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        if _anchors:
            _anchors.clear()
        return NOOP
    return _Span(name, rid, device, meta)


def active() -> bool:
    """Whether spans record now: enabled, or a profiler records."""
    return _enabled or _profiler._is_profiler_enabled


def begin(name: str, *, rid=None, **meta):
    """A span opened now and closed by its `end()`, from any thread; it is
    no thread's parent (NOOP when off)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return NOOP
    return _Span(name, rid, False, meta)


def request_id() -> Optional[int]:
    """The request id of the innermost span open on this thread, else a new
    one; None when tracing is off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return None
    stack = _stack()
    if stack and stack[-1].rid is not None:
        return stack[-1].rid
    return next(_rids)


def enable() -> None:
    global _enabled
    _enabled = True
    _anchors.clear()


def disable() -> None:
    global _enabled
    _enabled = False
    _anchors.clear()


def clear(max_records: int = MAX_RECORDS) -> None:
    """Drop every record and the drop count; the buffer keeps `max_records`."""
    global _records, _dropped
    with _lock:
        _records, _dropped = collections.deque(maxlen=max_records), 0


def dropped() -> int:
    """How many records the full buffer has dropped since `clear`."""
    return _dropped


def records(t0: float = float("-inf"), t1: float = float("inf")) -> List[_Span]:
    """The finished records that lie inside host window [t0, t1], oldest
    first, with device times (`d0`, `d1`, None without events) resolved."""
    with _lock:
        out = [r for r in _records if t0 <= r.t0 and r.t1 <= t1]
    for r in out:
        r._resolve()
    return out


def write_chrome_trace(path: str) -> int:
    """Every record as Chrome trace events (JSON, for Perfetto or
    chrome://tracing): process 1 the host, a track a thread; process 2 the
    device, a track for the device intervals of each host thread. Returns
    the number of records written."""
    recs = records()
    base = min((r.t0 for r in recs), default=0.0)
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for r in recs:
        tid = tids.setdefault(r.thread, len(tids) + 1)
        args = {"id": r.id, "parent": r.parent, "rid": r.rid, **r.meta}
        events.append({"ph": "X", "name": r.name, "pid": 1, "tid": tid, "ts": (r.t0 - base) * 1e6,
                       "dur": (r.t1 - r.t0) * 1e6, "args": args})
        if r.d0 is not None:
            events.append({"ph": "X", "name": r.name, "pid": 2, "tid": tid,
                           "ts": (r.d0 - base) * 1e6, "dur": (r.d1 - r.d0) * 1e6, "args": args})
    meta = [{"ph": "M", "name": "process_name", "pid": p, "args": {"name": n}}
            for p, n in ((1, "host"), (2, "device"))]
    meta += [{"ph": "M", "name": "thread_name", "pid": p, "tid": tid, "args": {"name": name}}
             for name, tid in tids.items() for p in (1, 2)]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events, "displayTimeUnit": "ms",
                   "otherData": {"dropped": dropped(), "clock": "time.perf_counter"}}, f)
    return len(recs)
