"""BENCHMARK.json against the rules of its format, and every file it names
found by name; a cell, a configuration and a metric added as files only."""
import json
import re
import shutil

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.load_benchmark()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}[section]
    names = [e["name"] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys - {"workloads"} and set(e) >= keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e and section in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_end_to_end_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        assert len(core.metrics_of(BENCH, cell, "end_to_end")) >= 2
        assert core.metrics_of(BENCH, cell, "per_layer")


def test_per_layer_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "device" in layers


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = core.load_cell(cell)
    assert spec["config"] == entry["config"] and entry["chips"] in (1, 4)
    assert core.load_config(spec["config"])["name"] == entry["config"]
    assert callable(core.load_driver(spec["driver"]))
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    assert spec["why"] == entry["why"]


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    """A cell on four chips costs four times the chip time in every later
    check: at most a quarter of the cells, rounded down, and always one."""
    fours = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4), fours


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_config_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    spec = json.loads((core.REPO / entry["file"]).read_text())
    assert spec["name"] == config and spec["source"] == entry["source"]
    assert spec["reduced"] == entry["reduced"]
    assert entry["file"].startswith("benchmark/configs/")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads_by_name(metric):
    assert callable(core.load_reader(metric))


def test_a_cell_config_and_metric_added_as_files_only(tmp_path):
    """A test-only cell, configuration and per-layer metric placed beside the
    others are found by name; no file of the harness changes."""
    root = tmp_path / "benchmark"
    for d in ("configs", "workloads", "metrics"):
        shutil.copytree(core.BENCH_DIR / d, root / d)
    config = json.loads((root / "configs" / "gat-amazon.json").read_text())
    config["name"] = "gat-amazon-wide"
    (root / "configs" / "gat-amazon-wide.json").write_text(json.dumps(config))
    cell = dict(core.load_cell("gat.train"), config="gat-amazon-wide", why="test-only")
    (root / "workloads" / "gat.train.wide.json").write_text(json.dumps(cell))
    (root / "metrics" / "fits_seen.py").write_text("def read(obs):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "gat.train.wide", "config": "gat-amazon-wide",
                               "traffic": "fit.4x32", "chips": 1, "why": "test-only"})
    bench["per_layer"].append({"name": "fits_seen", "unit": "fits", "better": "higher",
                               "source": "program_counter", "layer": "trainer (train/trainer.py)",
                               "moves": "train_triples_per_s", "workloads": ["gat.train.wide"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_triples_per_s":
            m["workloads"].append("gat.train.wide")
    assert core.load_cell("gat.train.wide", root)["config"] == "gat-amazon-wide"
    assert core.load_config("gat-amazon-wide", root)["model"]["hidden_dim"] == 128
    assert [m["name"] for m in core.metrics_of(bench, "gat.train.wide", "per_layer")] == ["fits_seen"]
    assert core.load_reader("fits_seen", root)(None) == 1.0
    assert core.load_reader("step_ms", root) is not None
