"""The four-chip cell's harness on the CPU: the mesh driver at a test size
on 4 gloo ranks (spawned as on the cards), correct on a sound run and not
with a fault planted on every rank; its readers on hand-built traces in
which NCCL kernels overlap compute kernels; no rank loads JAX."""
import functools
import json
import math
import sys
import time
import types

import pytest
import torch

from benchmark import core, data
from benchmark.core import Observation
from benchmark.counts import collectives
from benchmark.drivers import train_fit_mesh
from benchmark.tests.conftest import CELLS, run_tiny
from benchmark.tests.test_bench_drivers import check_form
from benchmark.tools import faults
from benchmark.tracing import DeviceTrace, Spans

CELL = "tiny.gat.train.mesh4"
# What `gat.train.mesh4` takes in BENCHMARK.json once it is added there (PERF.md §7): its entry,
# the metrics whose readers read its observation unchanged, and its own per-layer metrics.
ENTRY = {"name": "gat.train.mesh4", "config": "gat-amazon", "traffic": "fit.4x32.mesh4", "chips": 4}
SHARED = ("train_triples_per_s", "step_ms", "eval_ms", "idle_share.train", "sample_ms", "forward_ms",
          "backward_ms", "optimizer_ms", "step_idle_ms", "eval_scores_ms")
COLLECTIVES = "collectives (parallel/collectives.py over NCCL)"
OWN = [{"name": "comm_ms", "unit": "ms", "better": "lower", "source": "device_trace",
        "layer": COLLECTIVES},
       {"name": "comm_exposed_ms", "unit": "ms", "better": "lower", "source": "device_trace",
        "layer": COLLECTIVES},
       {"name": "wire_mb", "unit": "MB", "better": "lower", "source": "program_counter",
        "layer": COLLECTIVES},
       {"name": "mesh_mfu", "unit": "%", "better": "higher", "source": "program_span",
        "layer": "training step (whole, 4 chips)"}]


def with_mesh_cell(bench: dict, cell: str) -> dict:
    """`bench` with `cell` added as `gat.train.mesh4` is to be."""
    bench["workloads"].append(dict(ENTRY, name=cell, why=core.load_cell("gat.train.mesh4")["why"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in SHARED:
            m["workloads"].append(cell)
    bench["per_layer"] += [dict(m, moves="train_triples_per_s", workloads=[cell]) for m in OWN]
    return bench


@pytest.fixture
def mesh_bench(tiny_bench):
    return with_mesh_cell(tiny_bench, CELL)


def test_the_cells_entries_follow_the_format():
    """Added to BENCHMARK.json, the entries pass the format's rules."""
    from benchmark.tests import test_bench_spec as spec

    bench = with_mesh_cell(json.loads(json.dumps(core.load_benchmark())), "gat.train.mesh4")
    spec.BENCH = bench
    try:
        for section in ("configs", "workloads", "end_to_end", "per_layer"):
            spec.test_names_units_and_keys(section)
        spec.test_end_to_end_rules()
        spec.test_per_layer_rules()
        spec.test_at_most_a_quarter_of_the_cells_take_four_chips()
        spec.test_every_cell_loads_by_name("gat.train.mesh4")
        for m in OWN:
            spec.test_every_metric_reader_loads_by_name(m["name"])
    finally:
        spec.BENCH = core.load_benchmark()


def test_sound_run_is_correct_on_four_ranks(mesh_bench):
    r = run_tiny(mesh_bench, CELL)
    check_form(r, trace=False)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["count"] == 4
    assert set(r["metrics"]) == {"setup_s", "train_triples_per_s"}


def test_traced_run_reads_the_wire_bytes_the_audit_predicts(mesh_bench):
    """On the CPU a traced run reads the harness's spans and the recorded
    collectives; no device metric and no share of a peak is written."""
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.tools.scaling_audit import audit_collectives

    seed = 2 ** 31 + 7
    r = run_tiny(mesh_bench, CELL, trace=True, seed=seed)
    check_form(r, trace=True)
    assert r["correct"]
    assert {"step_ms", "eval_ms", "wire_mb"} <= set(r["metrics"])
    assert not ({"comm_ms", "comm_exposed_ms", "mesh_mfu", "idle_share.train"} & set(r["metrics"]))
    config = core.load_config("tiny-gat", CELLS)
    inter = data.interactions_of(config, seed)
    s = build_splits(inter, *build_node_maps(inter))
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    m = config["model"]
    audit = audit_collectives(4, graph, s.n_users, hidden=m["hidden_dim"], layers=m["layers"],
                              heads=m["heads"], feat_dim=m["feat_dim"])
    assert r["metrics"]["wire_mb"]["value"] == pytest.approx(audit["wire_bytes_per_chip"] / 1e6, rel=1e-6)


@pytest.mark.parametrize("fault,number", [("grad_exchange_left_out", "grad_gap"),
                                          ("overlay_stale", "loss_gap"),
                                          ("half_batch", "grad_gap"),
                                          ("state_unchanged", "change_gap")])
def test_a_fault_on_every_rank_fails_the_check(mesh_bench, monkeypatch, fault, number):
    monkeypatch.setattr(core, "load_driver",
                        lambda name: functools.partial(train_fit_mesh.run, plant=faults.FAULTS[fault]))
    r = run_tiny(mesh_bench, CELL)
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]
    if fault == "state_unchanged":
        assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def load_jax_in_the_rank(trainer):
    sys.modules["jax"] = types.ModuleType("jax")


def test_no_rank_loads_jax_and_one_that_does_fails_the_run():
    cell = core.load_cell(CELL, CELLS)
    config = core.load_config(cell["config"], CELLS)
    rows = train_fit_mesh.spawn_ranks(cell, config, [(5, None)], None, False, time.time(),
                                      torch.device("cpu"))
    assert len(rows) == 4 and all(rank[0]["forbidden"] == [] for rank in rows)
    assert math.isfinite(rows[0][0]["numbers"]["loss_gap"])
    with pytest.raises(RuntimeError, match="JAX"):
        train_fit_mesh.spawn_ranks(cell, config, [(5, load_jax_in_the_rank)], None, False, time.time(),
                                   torch.device("cpu"))


# -- the readers on hand-built traces ------------------------------------------------------------


def rec(name, t0, t1, d=None):
    d0, d1 = d if d is not None else (None, None)
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, d0=d0, d1=d1, id=0, parent=None, meta={})


STEPS = [rec("train.step", 0.0, 1.0, (0.0, 1.0)), rec("train.step", 2.0, 3.0, (2.0, 3.0)),
         rec("eval", 4.0, 6.0)]
OPS = [("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 0.1, 0.2),  # 0.1-0.3
       ("void gat_fwd::attention_walk<__nv_bfloat16>", 0.2, 0.3),  # 0.2-0.5: hides 0.2-0.3
       ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", 0.9, 0.2),  # 0.9-1.1: 0.1 inside the step
       ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 2.5, 0.2),  # 2.5-2.7, alone
       ("sm90_xmma_gemm_f32f32", 2.6, 0.05),  # 2.6-2.65: hides 0.05
       ("ncclDevKernel_AllGather_RING_LL", 5.0, 0.5)]  # in the eval: not a step's


def mesh_obs(ops=OPS, records=STEPS, **kw):
    shapes = {"n_users": 192_403, "n_items": 63_001, "n_edges_global": 2_657_622, "feat_dim": 384,
              "hidden_dim": 128, "layers": 2, "triples_per_step": 200_000, "n_shards": 4,
              "steps_per_epoch_run": 32}
    return Observation({"peak": {"dtype": "float32"}}, shapes, Spans(torch.device("cpu")),
                       trace=DeviceTrace(list(ops), -1.0, 10.0), records=list(records), **kw)


def read(name, obs):
    return core.load_reader(name)(obs)


def test_comm_ms_is_the_nccl_time_inside_the_steps():
    obs = mesh_obs()
    assert read("comm_ms", obs) == pytest.approx((0.2 + 0.1 + 0.2) / 2 * 1e3)
    assert read("comm_exposed_ms", obs) == pytest.approx((0.1 + 0.1 + 0.15) / 2 * 1e3)


@pytest.mark.parametrize("ops", [OPS, OPS[:3], [(n, s, 1.0) for n, s, _ in OPS]],
                         ids=["spread", "first_step", "long"])
def test_exposed_never_exceeds_comm(ops):
    obs = mesh_obs(ops=ops)
    assert 0.0 <= read("comm_exposed_ms", obs) <= read("comm_ms", obs)


def test_collective_readers_without_what_they_read():
    assert read("comm_ms", mesh_obs(ops=[o for o in OPS if "nccl" not in o[0].lower()])) is None
    assert read("comm_ms", mesh_obs(records=[])) is None
    assert read("comm_exposed_ms", Observation({}, {}, Spans(torch.device("cpu")), records=STEPS)) is None
    assert read("wire_mb", mesh_obs()) is None  # no step's collectives recorded
    assert read("mesh_mfu", mesh_obs()) is None  # a CPU run: no peak


def test_the_records_a_rank_shipped_are_the_ones_read(monkeypatch):
    """An observation that carries records is read from them, not from this
    process's recorder."""
    from plotpointe_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "records", lambda *a: pytest.fail("read this process's recorder"))
    obs = mesh_obs(records=[rec("train.step", 0.0, 1.0, (0.0, 1.0)),
                            rec("train.sample", 0.0, 0.1, (0.0, 0.002)), rec("train.sample", 20.0, 21.0)])
    assert read("sample_ms", obs) == pytest.approx(2.0)  # the second lies outside the traced region


def test_wire_mb_is_the_ring_traffic_of_a_step():
    counters = {"all_gather_bytes": 3 * 400.0e6, "reduce_scatter_bytes": 3 * 1600.0e6,
                "all_reduce_bytes": 3 * 4.0e6, "recorded_steps": 3}
    mb = read("wire_mb", mesh_obs(counters=counters))
    assert mb == pytest.approx(400.0 * 3 + 1600.0 * 3 / 4 + 2 * 4.0 * 3 / 4)
    assert collectives.wire_bytes({"all_to_all": 5.0}, 4) == 5.0


def test_mesh_mfu_counts_the_global_step_against_every_chip():
    from benchmark.counts import flops

    obs = mesh_obs(kind="h100", window=(0.0, 10.0))
    obs.spans.items.extend([types.SimpleNamespace(name="epoch", t0=0.0, t1=0.32),
                            types.SimpleNamespace(name="epoch", t0=1.0, t1=1.32)])
    step_s = 0.64 / 64
    work = flops.gat_step_flops(192_403, 63_001, 2_657_622, 384, 128, 2, 200_000)
    assert read("mesh_mfu", obs) == pytest.approx(100.0 * work / (step_s * 4 * 67e12))
