"""Finds a cell's files by name, runs its driver, reads its metrics and
builds the result line.

  BENCHMARK.json (repo root)        the cells and the metrics of each
  benchmark/workloads/<cell>.json   configuration, driver, traffic, limits, why
  benchmark/configs/<config>.json   widths, dataset sizes, training settings
  benchmark/drivers/<driver>.py     `run(ctx) -> Outcome`, one per kind of traffic
  benchmark/metrics/<metric>.py     `read(obs) -> float | None`, one per per-layer metric

A new cell, configuration or per-layer metric is new files and entries in
BENCHMARK.json; nothing here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from benchmark import checks
from benchmark.counts import peaks
from benchmark.tracing import DeviceTrace, Spans, breakdown

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "plotpointe_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return load_json(path)


def load_cell(name: str, root: Path = BENCH_DIR) -> dict:
    return load_json(root / "workloads" / f"{name}.json")


def load_config(name: str, root: Path = BENCH_DIR) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def load_driver(name: str) -> Callable:
    return importlib.import_module(f"benchmark.drivers.{name}").run


def load_reader(name: str, root: Path = BENCH_DIR) -> Callable:
    """The reader `metrics/<name>.py` under `root`, else under this folder."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The cell's `end_to_end` or `per_layer` metrics: those that list it
    under `workloads`. An end-to-end metric with no list (`setup_s`) is
    every cell's; a per-layer metric always has its list."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


@dataclass
class Context:
    """What a driver gets: the cell, its configuration, the run's arguments,
    the spans recorder of a traced run and the chips its BENCHMARK.json
    entry asks for."""
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    spans: Spans
    chips: int = 1
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What a driver returns."""
    setup_s: float
    e2e: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]  # the gaps compared, by name
    memory_peak_bytes: int
    obs: Optional["Observation"] = None


@dataclass
class Observation:
    """What the per-layer readers read, over the traced region."""
    config: dict
    shapes: Dict[str, Any]
    spans: Spans
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Optional[DeviceTrace] = None
    kind: str = "cpu"  # the GPU_SPECS row on a card; "cpu" reads no share of a peak
    window: tuple = (float("-inf"), float("inf"))  # the measured window on the host clock
    host: Dict[str, float] = field(default_factory=dict)  # readings of the host's clock
    # the program's span records where another process took them (a rank); None: this process's
    records: Optional[List[Any]] = None
    # (busy_s, window_s) averaged over the chips, where each traced its own device
    device_busy: Optional[Tuple[float, float]] = None


def device_info(device: torch.device, peak: int, count: int = 1) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": int(count), "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": int(count),
            "memory_peak_bytes": int(peak)}


def chips_of(bench: dict, name: str) -> int:
    """The chips cell `name` asks for in BENCHMARK.json (1 if it is not there)."""
    return next((int(w["chips"]) for w in bench["workloads"] if w["name"] == name), 1)


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             bench: Optional[dict] = None, root: Path = BENCH_DIR, device=None) -> dict:
    """Run cell `name` once; returns the result object (its `checks` last)."""
    bench = bench if bench is not None else load_benchmark()
    cell = load_cell(name, root)
    config = load_config(cell["config"], root)
    dev = torch.device(device or "cuda")
    chips = chips_of(bench, name)
    ctx = Context(cell, config, int(seed), float(seconds), bool(trace), dev, t_start, Spans(dev), chips)
    out = load_driver(cell["driver"])(ctx)
    if out.obs is not None and dev.type == "cuda":
        out.obs.kind = peaks.generation(torch.cuda.get_device_name(dev))
    limits = cell["limits"]
    correct = checks.verdict(out.numbers, limits)
    if trace:
        metrics, extra = {}, {}
        for m in metrics_of(bench, name, "per_layer"):
            value = load_reader(m["name"], root)(out.obs) if out.obs is not None else None
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev_info = device_info(dev, out.memory_peak_bytes, chips)
        if out.obs is not None and out.obs.trace is not None:
            busy, window = out.obs.device_busy or (out.obs.trace.busy_s(), out.obs.trace.window_s)
            dev_info["busy_s"], dev_info["window_s"] = busy, window
            extra["breakdown"] = breakdown(out.obs.trace, out.obs.spans.items)
    else:
        wanted = {m["name"]: m["unit"] for m in metrics_of(bench, name, "end_to_end")}
        values = {"setup_s": out.setup_s, **out.e2e}
        metrics = {k: {"value": float(values[k]), "unit": u} for k, u in wanted.items() if k in values}
        dev_info, extra = device_info(dev, out.memory_peak_bytes, chips), {}
    return {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": dev_info, **extra,
            "checks": {k: {"value": out.numbers.get(k, math.inf), "limit": lim}
                       for k, lim in limits.items()}}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def checks_text(result: dict) -> str:
    return "\n".join(f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                     for k, v in result["checks"].items())


def dumps(result: dict) -> str:
    """The result line; a non-finite number is written as a string."""
    def clean(x):
        if isinstance(x, float) and not math.isfinite(x):
            return str(x)
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, list):
            return [clean(v) for v in x]
        return x
    return json.dumps(clean(result))
