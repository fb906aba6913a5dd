"""Promotion gate: may a candidate run replace the baseline?

Counterpart of `plotpointe_tpu/tools/promotion_gate.py` (`GateSpec`,
`evaluate`, `main`): metrics files in the trainer's {"val": {...},
"test": {...}} schema, one record per metric with the keys metric / split /
mode / tolerance / current / baseline / pass / reason, exit 0 on pass and
3 on fail (`cli gate`). Several metrics in one call must all pass.

    python -m plotpointe_tpu_torch.tools.promotion_gate --current C --baseline B \\
        [--split test] [--metric ndcg@20[,recall@20]] [--mode improve_or_equal] [--tol 0]
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

# mode -> (predicate(current, baseline, tol), reason template). FP_SLACK
# absorbs float round-trip noise so equal values always pass improve_or_equal.
FP_SLACK = 1e-12
_MODES: Dict[str, Tuple[Callable[[float, float, float], bool], str]] = {
    "improve_or_equal": (
        lambda c, b, t: c + FP_SLACK >= b - t,
        "current {c:.6f} >= baseline {b:.6f} - tol {t}",
    ),
    "no_regression": (
        lambda c, b, t: c + t + FP_SLACK >= b,
        "current {c:.6f} + tol {t} >= baseline {b:.6f}",
    ),
}


def _lookup(metrics: Dict[str, Any], split: str, metric: str) -> float:
    """metrics[split][metric], raising KeyError that names the missing key."""
    try:
        by_split = metrics[split]
    except (KeyError, TypeError):
        raise KeyError(f"Split not in metrics: {split}") from None
    try:
        return float(by_split[metric])
    except (KeyError, TypeError):
        raise KeyError(f"Metric not in metrics[{split}]: {metric}") from None


@dataclass
class GateSpec:
    """One promotion decision: which metrics must hold, on which split, how."""

    split: str = "test"
    metrics: List[str] = field(default_factory=lambda: ["ndcg@20"])
    mode: str = "improve_or_equal"
    tol: float = 0.0

    def check(self, current: Dict[str, Any], baseline: Dict[str, Any]) -> Tuple[bool, List[Dict]]:
        """(all pass, one record per metric in `metrics` order)."""
        if self.mode not in _MODES:
            raise ValueError(f"Unknown mode: {self.mode}")
        predicate, template = _MODES[self.mode]
        records = []
        for m in self.metrics:
            c = _lookup(current, self.split, m)
            b = _lookup(baseline, self.split, m)
            ok = bool(predicate(c, b, self.tol))
            records.append(
                {
                    "metric": m,
                    "split": self.split,
                    "mode": self.mode,
                    "tolerance": self.tol,
                    "current": c,
                    "baseline": b,
                    "pass": ok,
                    "reason": template.format(c=c, b=b, t=self.tol),
                }
            )
        return all(r["pass"] for r in records), records


def _load_metrics(uri: str) -> Dict[str, Any]:
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    return ArtifactStore().load_json(uri)


def evaluate(current_path, baseline_path, split: str, metric: str, mode: str,
             tol: float) -> Tuple[bool, Dict]:
    """One metric: (pass, its record)."""
    spec = GateSpec(split=split, metrics=[metric], mode=mode, tol=tol)
    ok, records = spec.check(_load_metrics(str(current_path)), _load_metrics(str(baseline_path)))
    return ok, records[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Promotion gate evaluator")
    ap.add_argument("--current", required=True, help="candidate metrics JSON")
    ap.add_argument("--baseline", required=True, help="baseline metrics JSON")
    ap.add_argument("--split", default="test")
    ap.add_argument("--metric", default="ndcg@20",
                    help="metric key, or comma-separated list: every one must pass")
    ap.add_argument("--mode", choices=sorted(_MODES), default="improve_or_equal")
    ap.add_argument("--tol", type=float, default=0.0)
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    args = ap.parse_args(argv)

    spec = GateSpec(
        split=args.split,
        metrics=[m.strip() for m in args.metric.split(",") if m.strip()],
        mode=args.mode,
        tol=args.tol,
    )
    ok, records = spec.check(_load_metrics(args.current), _load_metrics(args.baseline))
    # one metric prints its bare record; several print {"pass", "checks"}
    payload = records[0] if len(records) == 1 else {"pass": ok, "checks": records}
    text = json.dumps(payload, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    raise SystemExit(0 if ok else 3)


if __name__ == "__main__":
    main()
