"""Durable at-least-once event queue: segment files, an ack log and a DLQ.

Counterpart of `plotpointe_tpu/serving/eventqueue.py`, with the same on-disk
format, so either package opens a queue directory the other wrote:

  segment-<first offset, 12 digits>.jsonl   {"o": offset, "d": record} a line
  acks.jsonl                                {"o": offset} a line
  attempts.jsonl                            {"o": offset, "n": attempts} a line
  dlq.jsonl                                 {"o", "d", "attempts", "reason"} a line

Semantics:

  * **publish** appends one JSON line to the active segment file and flushes
    (+fsync unless PLOTPOINTE_QUEUE_NOSYNC=1). A record is durable the moment
    publish returns; a crash later cannot lose it.
  * **pull/ack** implement at-least-once delivery: consumers pull unacked
    records, process, then ack. Acks append to an ack log (same
    crash-safety); anything pulled but not acked is redelivered after
    `lease_s` or on restart. Duplicates are possible (at-least-once),
    loss is not.
  * **nack / max_attempts**: each redelivery increments a persisted attempt
    count; after `max_attempts` (default 5) the record moves to `dlq.jsonl`
    and is acked out of the main flow.
  * **segments** rotate at `segment_bytes`; fully-acked segments are deleted
    by `compact()` so the disk footprint tracks the unacked backlog, not
    total history.

`DurableQueueSink` adapts the queue to the telemetry sink interface
(serving/telemetry.py), and `Deliverer` is the subscription worker: it pulls
batches, hands them to a delivery callback, acks on success and nacks on
failure.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple


def _append_line(f, obj: Dict[str, Any], sync: bool) -> None:
    f.write(json.dumps(obj) + "\n")
    f.flush()
    if sync:
        os.fsync(f.fileno())


class DurableQueue:
    SEGMENT_PREFIX = "segment-"

    def __init__(self, root: str | Path, max_attempts: int = 5,
                 segment_bytes: int = 8 * 1024 * 1024, lease_s: float = 30.0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_attempts = int(max_attempts)
        self.segment_bytes = int(segment_bytes)
        self.lease_s = float(lease_s)
        self._sync = os.environ.get("PLOTPOINTE_QUEUE_NOSYNC") != "1"
        self._lock = threading.Lock()
        self._acked: set = set()
        self._attempts: Dict[int, int] = {}
        self._leases: Dict[int, float] = {}
        self._next_offset = 0
        self._seg_f = None
        self._seg_path: Optional[Path] = None
        self._ack_f = None
        self._recover()

    # -- recovery ------------------------------------------------------------

    def _segments(self) -> List[Path]:
        return sorted(self.root.glob(self.SEGMENT_PREFIX + "*.jsonl"),
                      key=lambda p: int(p.stem.split("-")[1]))

    def _recover(self) -> None:
        """Rebuild offset counter, ack set, and attempt counts from disk.
        Tolerates a torn final line in any log (crash mid-write): the partial
        line is ignored — for segments that record was never 'published'.

        The offset high-water mark is the max over SEGMENTS **and** the
        ack/attempt logs: after compact() deletes fully-acked segments, the
        surviving segments alone under-count, and a restart would reissue
        already-acked offsets — new publishes would then be treated as acked
        and silently never delivered (at-least-once violation)."""
        hi = -1
        ack_path = self.root / "acks.jsonl"
        if ack_path.exists():
            for line in ack_path.read_text().splitlines():
                try:
                    rec = json.loads(line)
                    off = int(rec["o"])
                    self._acked.add(off)
                    hi = max(hi, off)
                except (json.JSONDecodeError, KeyError, ValueError):
                    continue  # torn tail
        att_path = self.root / "attempts.jsonl"
        if att_path.exists():
            for line in att_path.read_text().splitlines():
                try:
                    rec = json.loads(line)
                    off = int(rec["o"])
                    self._attempts[off] = int(rec["n"])
                    hi = max(hi, off)
                except (json.JSONDecodeError, KeyError, ValueError):
                    continue
        for seg in self._segments():
            for off, _ in self._iter_segment(seg):
                hi = max(hi, off)
        self._next_offset = hi + 1
        self._ack_f = open(ack_path, "a")

    def _iter_segment(self, seg: Path):
        for line in seg.read_text().splitlines():
            try:
                rec = json.loads(line)
                yield int(rec["o"]), rec["d"]
            except (json.JSONDecodeError, KeyError, ValueError):
                continue  # torn tail from a crash mid-write

    # -- producer ------------------------------------------------------------

    def publish(self, record: Dict[str, Any]) -> int:
        with self._lock:
            off = self._next_offset
            self._next_offset += 1
            if self._seg_f is None or self._seg_f.tell() >= self.segment_bytes:
                if self._seg_f is not None:
                    self._seg_f.close()
                self._seg_path = self.root / f"{self.SEGMENT_PREFIX}{off:012d}.jsonl"
                self._seg_f = open(self._seg_path, "a")
            _append_line(self._seg_f, {"o": off, "d": record}, self._sync)
            return off

    # -- consumer ------------------------------------------------------------

    def pull(self, max_records: int = 100) -> List[Tuple[int, Dict[str, Any]]]:
        """Unacked, unleased records in offset order (re-leases expired ones)."""
        now = time.monotonic()
        out = []
        with self._lock:
            if self._seg_f is not None:
                self._seg_f.flush()
            for seg in self._segments():
                for off, data in self._iter_segment(seg):
                    if off in self._acked:
                        continue
                    if self._leases.get(off, -1e18) > now:
                        continue
                    self._leases[off] = now + self.lease_s
                    out.append((off, data))
                    if len(out) >= max_records:
                        return out
        return out

    def ack(self, offsets) -> None:
        with self._lock:
            for off in offsets:
                if off in self._acked:
                    continue
                _append_line(self._ack_f, {"o": int(off)}, self._sync)
                self._acked.add(int(off))
                self._leases.pop(off, None)

    def nack(self, offset: int, record: Optional[Dict[str, Any]] = None,
             reason: str = "") -> bool:
        """Failed delivery: release the lease and bump the persisted attempt
        count; at max_attempts move to the DLQ (and ack out of the main flow).
        Returns True if the record was dead-lettered."""
        with self._lock:
            n = self._attempts.get(offset, 0) + 1
            self._attempts[offset] = n
            with open(self.root / "attempts.jsonl", "a") as f:
                _append_line(f, {"o": int(offset), "n": n}, self._sync)
            self._leases.pop(offset, None)
            if n >= self.max_attempts:
                if record is None:
                    record = dict(self._find(offset) or {})
                with open(self.root / "dlq.jsonl", "a") as f:
                    _append_line(f, {"o": int(offset), "d": record,
                                     "attempts": n, "reason": reason}, self._sync)
                _append_line(self._ack_f, {"o": int(offset)}, self._sync)
                self._acked.add(int(offset))
                return True
            return False

    def _find(self, offset: int):
        for seg in self._segments():
            for off, data in self._iter_segment(seg):
                if off == offset:
                    return data
        return None

    # -- introspection / maintenance ----------------------------------------

    def backlog(self) -> int:
        with self._lock:
            if self._seg_f is not None:
                self._seg_f.flush()
            n = 0
            for seg in self._segments():
                n += sum(1 for off, _ in self._iter_segment(seg) if off not in self._acked)
            return n

    def read_all(self) -> List[Dict[str, Any]]:
        """Every durable record (acked or not) — the 'BQ table scan' analog
        used by drift aggregation."""
        with self._lock:
            if self._seg_f is not None:
                self._seg_f.flush()
            return [d for seg in self._segments() for _, d in self._iter_segment(seg)]

    def dead_letters(self) -> List[Dict[str, Any]]:
        dlq = self.root / "dlq.jsonl"
        if not dlq.exists():
            return []
        out = []
        for line in dlq.read_text().splitlines():
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return out

    def compact(self) -> int:
        """Delete segments whose every record is acked. Returns segments removed."""
        removed = 0
        with self._lock:
            segs = self._segments()
            for seg in segs:
                if self._seg_path is not None and seg == self._seg_path:
                    continue  # active segment
                if all(off in self._acked for off, _ in self._iter_segment(seg)):
                    seg.unlink()
                    removed += 1
        return removed

    def close(self) -> None:
        with self._lock:
            if self._seg_f is not None:
                self._seg_f.close()
                self._seg_f = None
            if self._ack_f is not None:
                self._ack_f.close()
                self._ack_f = None


class DurableQueueSink:
    """Telemetry-sink adapter (interface of telemetry.JsonlSink): emit() is a
    durable publish; read_all() feeds drift aggregation."""

    def __init__(self, root: str | Path, max_attempts: int = 5):
        self.queue = DurableQueue(root, max_attempts=max_attempts)

    def emit(self, record: Dict[str, Any]) -> None:
        try:
            self.queue.publish(record)
        except OSError:
            pass  # sink never raises into the request path

    def read_all(self) -> List[Dict[str, Any]]:
        return self.queue.read_all()


class Deliverer:
    """Subscription worker: pull -> deliver(batch item) -> ack, nack on error.

    `deliver` is called once per record; raising marks that record failed
    (attempt count + eventual DLQ), other records in the batch still ack —
    the per-message granularity of a Pub/Sub subscription."""

    def __init__(self, queue: DurableQueue, deliver: Callable[[Dict[str, Any]], None],
                 batch_size: int = 100):
        self.queue = queue
        self.deliver = deliver
        self.batch_size = batch_size

    def run_once(self) -> Dict[str, int]:
        batch = self.queue.pull(self.batch_size)
        ok, failed, dead = [], 0, 0
        for off, rec in batch:
            try:
                self.deliver(rec)
                ok.append(off)
            except Exception as e:  # noqa: BLE001 - failure -> redelivery/DLQ
                failed += 1
                if self.queue.nack(off, rec, reason=f"{type(e).__name__}: {e}"[:200]):
                    dead += 1
        self.queue.ack(ok)
        return {"delivered": len(ok), "failed": failed, "dead_lettered": dead}

    def drain(self, max_rounds: int = 1000) -> Dict[str, int]:
        total = {"delivered": 0, "failed": 0, "dead_lettered": 0}
        for _ in range(max_rounds):
            r = self.run_once()
            for k in total:
                total[k] += r[k]
            if r["delivered"] == 0 and r["failed"] == 0:
                break
        return total
