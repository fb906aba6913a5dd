"""Serving telemetry: request/feedback event logging + drift aggregation.

Counterpart of `plotpointe_tpu/serving/telemetry.py`, with the same record
keys, so `cli drift` of either package reads what the other's server wrote.
Events go to pluggable sinks: a JSONL file each by default, or the durable
at-least-once queue (serving/eventqueue.py) with `durable=True`.

Schemas:
  request:  request_id, ts, user_key, item_ids, scores, latency_ms,
            experiment, model_version
  feedback: request_id, ts, user_key, item_id, event_type, value
  reject:   ts, kind, reason, payload
  drift:    hour, n_requests, score_mean, score_std, latency_p50_ms,
            latency_p95_ms
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


class JsonlSink:
    """Append-only JSONL sink; never raises into the request path."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def emit(self, record: Dict[str, Any]) -> None:
        try:
            line = json.dumps(record)
            with self._lock, open(self.path, "a") as f:
                f.write(line + "\n")
        except (OSError, TypeError, ValueError):
            pass

    def read_all(self) -> List[Dict[str, Any]]:
        if not self.path.exists():
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


class ServingTelemetry:
    def __init__(
        self,
        request_sink: Optional[JsonlSink] = None,
        feedback_sink: Optional[JsonlSink] = None,
        root: str = "tmp/telemetry",
        experiment: str = "default",
        model_version: str = "unknown",
        durable: Optional[bool] = None,
    ):
        """durable=True routes requests and feedback through the file-backed
        at-least-once queue (serving/eventqueue.py) instead of plain JSONL
        appends. None auto-detects an existing queue under `root` (so
        `cli drift` reads whatever layout the server wrote)."""
        if durable is None:
            durable = any((Path(root) / "requests").glob("segment-*.jsonl"))
        self.durable = durable
        if durable:
            from plotpointe_tpu_torch.serving.eventqueue import DurableQueueSink

            self.requests = request_sink or DurableQueueSink(Path(root) / "requests")
            self.feedback = feedback_sink or DurableQueueSink(Path(root) / "feedback")
        else:
            self.requests = request_sink or JsonlSink(Path(root) / "requests.jsonl")
            self.feedback = feedback_sink or JsonlSink(Path(root) / "feedback.jsonl")
        # dead-letter sink: malformed or rejected events land here for triage
        self.rejects = JsonlSink(Path(root) / "rejects" / "rejects.jsonl")
        self.experiment = experiment
        self.model_version = model_version

    def log_request(
        self,
        item_ids: List[int],
        scores: List[float],
        latency_ms: float,
        user_key: Optional[str] = None,
        request_id: Optional[str] = None,
    ) -> str:
        rid = request_id or str(uuid.uuid4())
        self.requests.emit(
            {
                "request_id": rid,
                "ts": time.time(),
                "user_key": user_key,
                "item_ids": [int(x) for x in item_ids],
                "scores": [float(s) for s in scores],
                "latency_ms": float(latency_ms),
                "experiment": self.experiment,
                "model_version": self.model_version,
            }
        )
        return rid

    def log_feedback(
        self, request_id: str, item_id: int, event_type: str, value: float = 1.0, user_key: Optional[str] = None
    ) -> None:
        self.feedback.emit(
            {
                "request_id": request_id,
                "ts": time.time(),
                "user_key": user_key,
                "item_id": int(item_id),
                "event_type": str(event_type),
                "value": float(value),
            }
        )

    def log_reject(self, kind: str, payload: Any, reason: str) -> None:
        """Dead-letter a malformed or rejected event."""
        self.rejects.emit(
            {
                "ts": time.time(),
                "kind": str(kind),
                "reason": str(reason),
                "payload": repr(payload)[:2048],
            }
        )

    def aggregate_drift(self) -> List[Dict[str, Any]]:
        """Hourly request aggregates: n, score mean/std, latency p50/p95."""
        rows = self.requests.read_all()
        by_hour: Dict[int, List[Dict]] = defaultdict(list)
        for r in rows:
            by_hour[int(r["ts"] // 3600)].append(r)
        out = []
        for hour in sorted(by_hour):
            rs = by_hour[hour]
            scores = np.array([s for r in rs for s in r["scores"]], dtype=np.float64)
            lat = np.array([r["latency_ms"] for r in rs], dtype=np.float64)
            out.append(
                {
                    "hour": hour * 3600,
                    "n_requests": len(rs),
                    "score_mean": float(scores.mean()) if scores.size else 0.0,
                    "score_std": float(scores.std()) if scores.size else 0.0,
                    "latency_p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
                    "latency_p95_ms": float(np.percentile(lat, 95)) if lat.size else 0.0,
                }
            )
        return out
