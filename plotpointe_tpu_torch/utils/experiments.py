"""Local experiment tracking: one JSONL file per run.

Counterpart of `plotpointe_tpu/utils/experiments.py::ExperimentTracker`:
the same calls (start_run / log_params / log_metrics / log_time_series /
log_artifact / end_run, read_run / list_runs) and the same records, under
`{root}/{experiment}/{run}.jsonl`, with `index.jsonl` listing the runs.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

from plotpointe_tpu_torch.utils.logging import log_event


class ExperimentTracker:
    def __init__(self, experiment: str, root: str = "tmp/experiments"):
        self.experiment = experiment
        self.root = Path(root) / experiment
        self.root.mkdir(parents=True, exist_ok=True)
        self._run: Optional[str] = None
        self._fh = None

    # -- lifecycle -----------------------------------------------------------

    def start_run(self, run_name: Optional[str] = None) -> str:
        self._run = run_name or f"run_{int(time.time())}"
        self._fh = open(self.root / f"{self._run}.jsonl", "a")
        self._write({"type": "run_start", "run": self._run, "experiment": self.experiment})
        with open(self.root / "index.jsonl", "a") as f:
            f.write(json.dumps({"run": self._run, "ts": time.time()}) + "\n")
        return self._run

    def end_run(self, status: str = "complete") -> None:
        self._write({"type": "run_end", "status": status})
        if self._fh:
            self._fh.close()
            self._fh = None
        self._run = None

    def __enter__(self):
        if self._run is None:
            self.start_run()
        return self

    def __exit__(self, exc_type, *_):
        self.end_run("failed" if exc_type else "complete")

    # -- logging -------------------------------------------------------------

    def log_params(self, params: Dict[str, Any]) -> None:
        self._write({"type": "params", "params": params})

    def log_metrics(self, metrics: Dict[str, float]) -> None:
        self._write({"type": "metrics", "metrics": {k: float(v) for k, v in metrics.items()}})

    def log_time_series(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        self._write({"type": "time_series", "step": step,
                     "metrics": {k: float(v) for k, v in metrics.items()}})

    def log_artifact(self, uri: str, kind: str = "file") -> None:
        self._write({"type": "artifact", "uri": str(uri), "kind": kind})

    # -- reading back --------------------------------------------------------

    def read_run(self, run_name: str) -> list:
        with open(self.root / f"{run_name}.jsonl") as f:
            return [json.loads(line) for line in f if line.strip()]

    def list_runs(self) -> list:
        index = self.root / "index.jsonl"
        if not index.exists():
            return []
        with open(index) as f:
            return [json.loads(line)["run"] for line in f if line.strip()]

    # -- internals -----------------------------------------------------------

    def _write(self, record: Dict[str, Any]) -> None:
        """One record, stamped with the time and the run. A record that
        cannot be written is reported by `log_event`, not raised."""
        if self._fh is None:
            raise RuntimeError("no active run; call start_run() first")
        record = {"ts": time.time(), "run": self._run, **record}
        try:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        except (OSError, TypeError, ValueError):
            log_event("experiment_log_failed", run_id=self._run)
