"""Structured JSONL event logging: `log_event(event, run_id, **fields)`
writes one JSON line (stdout by default) and never raises; `timed` is a
scoped wall-clock timer.

Counterpart of `plotpointe_tpu/utils/logging.py` (`log_event`, `timed`); a
field that JSON cannot encode is written as its repr.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Dict, Iterator, Optional

_SCHEMA_VERSION = 1


def log_event(event: str, run_id: Optional[str] = None, stream=None, **fields: Any) -> None:
    """Emit one structured JSON line. Logging must never kill a run: any
    exception raised while the line is built or written is swallowed."""
    try:
        record: Dict[str, Any] = {"schema": _SCHEMA_VERSION, "ts": time.time(), "event": str(event)}
        if run_id is not None:
            record["run_id"] = str(run_id)
        for k, v in fields.items():
            try:
                json.dumps(v)
                record[k] = v
            except (TypeError, ValueError):
                record[k] = repr(v)
        out = stream if stream is not None else sys.stdout
        out.write(json.dumps(record, sort_keys=False) + "\n")
        out.flush()
    except Exception:
        pass


@contextlib.contextmanager
def timed(name: str, sink: Optional[Dict[str, float]] = None, emit: bool = False) -> Iterator[None]:
    """Wall-clock scope timer (host clock): records the seconds into
    `sink[name]` and/or logs a `timing` event. Work queued on the card is
    not waited for: synchronise inside the scope to time it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = dt
        if emit:
            log_event("timing", name=name, seconds=dt)
