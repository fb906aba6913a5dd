"""Request coalescing (micro-batching) for the serving path.

Counterpart of `plotpointe_tpu/serving/batching.py`. The top-K kernels'
cost is dominated by streaming the catalog, and that stream is per batch,
not per query. Concurrent HTTP handler threads submit into a queue; one
dispatcher thread coalesces up to `max_batch` queries (waiting at most
`max_wait_ms` for stragglers), runs ONE batched scoring call, and fans the
results back to the waiting handlers.

The straggler wait is paid only when a straggler can come. A request that
finds the queue behind it empty, and was submitted at least `max_wait_ms`
after the request before it, finds the batcher idle: it is dispatched at
once as a batch of one. Any other request opens a window of `max_wait_ms`
that closes early at `max_batch` requests. So a burst (closed-loop clients,
saturation) coalesces as it always did, and sparse open-loop arrivals stop
waiting for a window that stays empty. The JAX batcher always waits.

Batch sizes are bucketed to powers of two (padded by repeating the last
query) so the batched path sees few shapes.

Counters (`BatcherStats`): requests, batches, the largest batch, and
`n_immediate`, the batches dispatched with no straggler wait.

Spans (`utils/tracing.py`): `batch.queue`, one a request under its request
id, from `submit`'s put to the start of its batch's `_run`; `batch.run`, one
a batch, with its size, its bucket, the request ids it serves and `waited`
(False for a batch dispatched at once).
"""
from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from plotpointe_tpu_torch.utils import tracing


@dataclass
class _Slot:
    item_ids: np.ndarray
    k: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Tuple[np.ndarray, np.ndarray]] = None
    error: Optional[Exception] = None
    queued: Any = tracing.NOOP  # the open `batch.queue` span
    submitted: float = 0.0  # time.perf_counter() at submit


@dataclass
class BatcherStats:
    n_requests: int = 0
    n_batches: int = 0
    max_batch: int = 0
    n_immediate: int = 0  # batches dispatched with no straggler wait

    @property
    def mean_batch(self) -> float:
        return self.n_requests / self.n_batches if self.n_batches else 0.0


class MicroBatcher:
    """Coalesces concurrent recommend() calls into batched device scoring.

    A request that reaches an idle batcher (nothing queued behind it, no
    request submitted within `max_wait_ms` before it) is scored at once;
    any other waits at most `max_wait_ms` for stragglers.

    submit() blocks the calling (HTTP handler) thread until its result is
    ready — ThreadingHTTPServer gives every request its own thread, so the
    server stays fully async from the client's point of view.
    """

    def __init__(self, runtime, max_batch: int = 64, max_wait_ms: float = 3.0,
                 timeout_s: float = 30.0, max_in_flight: int = 4):
        self.runtime = runtime
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.timeout_s = timeout_s
        self.stats = BatcherStats()
        self._stats_lock = threading.Lock()
        self._q: "queue.Queue[_Slot]" = queue.Queue()
        self._stop = threading.Event()
        # pipelined dispatch: up to `max_in_flight` batches scored
        # concurrently, so host-side work of one batch overlaps another's
        # device time
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=max(1, int(max_in_flight)))
        self._sem = threading.Semaphore(max(1, int(max_in_flight)))
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)  # type: ignore[arg-type] - wake the dispatcher
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)

    # -- handler-thread side -------------------------------------------------

    def submit(self, item_ids: Sequence[int], k: int) -> Tuple[np.ndarray, np.ndarray]:
        slot = _Slot(item_ids=np.asarray(list(item_ids), dtype=np.int32), k=int(k))
        slot.queued = tracing.begin("batch.queue")
        slot.submitted = time.perf_counter()
        self._q.put(slot)
        if not slot.event.wait(self.timeout_s):
            raise TimeoutError("micro-batch dispatch timed out")
        if slot.error is not None:
            raise slot.error
        assert slot.result is not None
        return slot.result

    # -- dispatcher side -----------------------------------------------------

    def _dispatch_loop(self) -> None:
        last = -math.inf  # submit time of the newest request taken
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            batch = [first]
            # idle: no straggler is queued, and the arrivals say none is due
            waited = not (self._q.empty() and first.submitted - last >= self.max_wait_s)
            if waited:
                deadline = time.perf_counter() + self.max_wait_s
                while len(batch) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is None:
                        break
                    batch.append(nxt)
            last = batch[-1].submitted
            self._sem.acquire()
            self._pool.submit(self._run_release, batch, waited)

    def _run_release(self, batch: List[_Slot], waited: bool) -> None:
        try:
            self._run(batch, waited)
        finally:
            self._sem.release()

    def _run(self, batch: List[_Slot], waited: bool) -> None:
        for s in batch:
            s.queued.end()
        n, rids = len(batch), [s.queued.rid for s in batch]
        with tracing.span("batch.run", batch=n, bucket=bucket_size(n, self.max_batch), rids=rids,
                          waited=waited):
            with self._stats_lock:
                self.stats.n_requests += len(batch)
                self.stats.n_batches += 1
                self.stats.max_batch = max(self.stats.max_batch, len(batch))
                self.stats.n_immediate += int(not waited)
            try:
                results = self.runtime.top_k_for_batch(
                    [s.item_ids for s in batch], [s.k for s in batch],
                    max_batch=self.max_batch,
                )
                for s, (idx, sc) in zip(batch, results):
                    s.result = (idx, sc)
            except Exception as e:  # noqa: BLE001 - propagate to every waiter
                for s in batch:
                    s.error = e
            finally:
                for s in batch:
                    s.event.set()


def bucket_size(n: int, max_batch: int) -> int:
    """Next power-of-two bucket >= n (capped), so the kernels see few batch shapes."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max(max_batch, n))
