"""Each driver at a test-only size on the CPU (the kernels' plain versions)
gives one result line of the benchmark's form, correct against the reference."""
import json

import pytest

from benchmark import core
from benchmark.tests.conftest import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def check_form(result: dict, trace: bool) -> None:
    line = core.dumps(result)
    assert "\n" not in line
    parsed = json.loads(line)
    assert list(parsed)[:5] == KEYS and list(parsed)[-1] == "checks"
    assert ("breakdown" in parsed) == (trace and "busy_s" in parsed["device"])
    for name, m in parsed["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    assert set(parsed["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in parsed["checks"].values():
        assert set(v) == {"value", "limit"}
    assert core.checks_text(result).count("\n") == len(parsed["checks"]) - 1


@pytest.mark.parametrize("cell", ["tiny.gat.train", "tiny.lightgcn.train", "tiny.gat.train.ref",
                                  "tiny.gat.serve"])
def test_driver_end_to_end_run(tiny_bench, cell):
    r = run_tiny(tiny_bench, cell)
    check_form(r, trace=False)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    wanted = {m["name"] for m in core.metrics_of(tiny_bench, cell, "end_to_end")}
    assert set(r["metrics"]) == wanted and "setup_s" in wanted


@pytest.mark.parametrize("cell,spans", [("tiny.gat.train", ("step_ms", "eval_ms")),
                                        ("tiny.gat.serve", ("batch_mean",))])
def test_driver_traced_run(tiny_bench, cell, spans):
    """On the CPU a traced run reads the host's spans and counters; no
    device metric and no share of a peak is written."""
    r = run_tiny(tiny_bench, cell, trace=True)
    check_form(r, trace=True)
    assert r["correct"]
    assert set(spans) <= set(r["metrics"])
    assert not any(k.endswith("_roofline") or "mfu" in k or k.startswith("idle_share") for k in r["metrics"])
    assert r["device"]["platform"] == "cpu" and "busy_s" not in r["device"]
