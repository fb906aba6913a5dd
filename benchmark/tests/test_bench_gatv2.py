"""The GATv2 cell's harness on the CPU (the op's plain versions):
`drivers/train_fit_gatv2.py` at a test size gives a correct result line; half of each batch left out
and the evals' negatives from other streams fail, and a program without
GATv2 fails at once; the control is not correct under the cell's limits;
its readers load by name, read a hand-built trace and read nothing of a
GAT fit."""
import math

import pytest
import torch

from benchmark import core
from benchmark.core import Observation
from benchmark.counts import gatv2 as counts
from benchmark.tests.conftest import CELLS, run_tiny
from benchmark.tests.test_bench_drivers import check_form
from benchmark.tracing import DeviceTrace, Spans

CELL = "tiny.gatv2.train"
OWN = ("gatv2_roofline", "gatv2_mfu", "gatv2_attn_ms")


def test_sound_run_is_correct(tiny_bench):
    r = run_tiny(tiny_bench, CELL)
    check_form(r, trace=False)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "train_triples_per_s"}


def test_traced_run_reads_the_host_spans(tiny_bench):
    """On the CPU a traced run reads the window's spans; the op's device
    intervals, the device trace and the shares of a peak are the card's."""
    r = run_tiny(tiny_bench, CELL, trace=True)
    check_form(r, trace=True)
    assert r["correct"]
    assert {"step_ms", "eval_ms"} <= set(r["metrics"])
    assert not set(OWN) & set(r["metrics"])


def test_half_the_batch_left_out(tiny_bench, monkeypatch):
    from plotpointe_tpu_torch.train import trainer

    bpr = trainer.LOSSES["bpr"]
    monkeypatch.setitem(trainer.LOSSES, "bpr", lambda pos, neg: bpr(pos[: len(pos) // 2],
                                                                     neg[: len(neg) // 2]))
    r = run_tiny(tiny_bench, CELL)
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] > r["checks"]["grad_gap"]["limit"]


def test_eval_negatives_from_other_streams(tiny_bench, monkeypatch):
    from plotpointe_tpu_torch.train import trainer

    reseed = trainer.Trainer._reseed
    monkeypatch.setattr(trainer.Trainer, "_reseed", lambda self, stream, index: reseed(
        self, stream, index + 1 if stream == trainer.STREAM_EVAL else index))
    r = run_tiny(tiny_bench, CELL)
    assert not r["correct"]
    assert r["checks"]["eval_gap"]["value"] > r["checks"]["eval_gap"]["limit"]


def test_a_program_without_gatv2_fails_at_once(tiny_bench, monkeypatch):
    """The parent commit's program has no `TrainConfig.attention`: the run
    raises before it builds anything (a clean, quick failure)."""
    from plotpointe_tpu_torch.config import TrainConfig

    monkeypatch.delitem(TrainConfig.__dataclass_fields__, "attention")
    with pytest.raises(RuntimeError, match="attention"):
        run_tiny(tiny_bench, CELL)


def test_the_control_is_not_correct():
    from benchmark.tools.control_gatv2 import readings

    cell = core.load_cell(CELL, CELLS)
    row = readings(cell, core.load_config(cell["config"], CELLS), 2 ** 31 + 7, torch.device("cpu"))
    limits = cell["limits"]
    assert any(row["control"][k] > limits[k] for k in limits), row["control"]
    assert row["half_batch"]["grad_gap"] > limits["grad_gap"]
    assert row["other_negatives"]["eval_gap"] > limits["eval_gap"]


@pytest.mark.parametrize("metric", OWN)
def test_the_readers_load_by_name_and_read_nothing_of_a_gat_fit(metric):
    shapes = {"n_users": 10, "n_items": 5, "n_nodes": 15, "n_edges": 40, "feat_dim": 8, "hidden_dim": 32,
              "layers": 2, "heads": 1, "rows": "bfloat16", "samples_per_epoch": 64, "model_family": "gat",
              "steps_per_epoch_run": 2}
    obs = Observation({"peak": {"dtype": "float32"}}, shapes, Spans(torch.device("cpu")),
                      counters={"gat_fwd": 6, "gat_bwd_dst": 2, "gat_bwd_src": 2, "steps": 2},
                      trace=DeviceTrace([("attention_walk", 0.0, 1e-3)], 0.0, 1.0), kind="h100")
    assert core.load_reader(metric)(obs) is None


def test_roofline_and_mfu_on_a_hand_built_fit():
    n, e, hh, d = 1000, 20000, 2, 128
    shapes = {"n_users": 600, "n_items": 400, "n_nodes": n, "n_edges": e, "feat_dim": 64, "hidden_dim": d,
              "layers": 2, "heads": hh, "rows": "bfloat16", "samples_per_epoch": 5000,
              "model_family": "gat", "attention": "gatv2", "steps_per_epoch_run": 4}
    spans = Spans(torch.device("cpu"))
    ops = [("void (anonymous namespace)::gatv2_fwd_walk<__nv_bfloat16, 1>(...)", 0.1, 2e-3),
           ("void (anonymous namespace)::gatv2_bwd_dst_walk<__nv_bfloat16, 1>(...)", 0.2, 3e-3),
           ("gatv2_sum_slots(...)", 0.3, 1e-4),
           ("void (anonymous namespace)::gatv2_bwd_src_walk<__nv_bfloat16, 1>(...)", 0.4, 2e-3),
           ("sm80_xmma_gemm_f32f32", 0.5, 5e-3)]
    obs = Observation({"peak": {"dtype": "float32"}}, shapes, spans,
                      counters={"gatv2_fwd": 1, "gatv2_bwd_dst": 1, "gatv2_bwd_src": 1, "steps": 1},
                      trace=DeviceTrace(ops, 0.0, 1.0), kind="h100")
    bound = (counts.fwd_bound_s(n, e, hh, d) + counts.bwd_dst_bound_s(n, e, hh, d)
             + counts.bwd_src_bound_s(n, e, hh, d))
    assert core.load_reader("gatv2_roofline")(obs) == pytest.approx(100 * bound / 7.1e-3)
    from benchmark.tracing import Span

    spans.items += [Span("epoch", 0.0, 0.04), Span("epoch", 0.05, 0.09)]
    flops = counts.step_flops(600, 400, e, 64, d, 2, hh, 5000)
    assert core.load_reader("gatv2_mfu")(obs) == pytest.approx(100 * flops / (0.01 * 67e12))
    assert math.isfinite(core.load_reader("gatv2_mfu")(obs))


def test_attention_share_reads_the_ops_spans_inside_steps():
    from types import SimpleNamespace

    def rec(name, t0, t1, d0=None, d1=None):
        return SimpleNamespace(name=name, t0=t0, t1=t1, d0=d0, d1=d1)

    records = [rec("train.step", 0.0, 1.0), rec("attn.forward", 0.1, 0.2, 0.1, 0.13),
               rec("attn.backward", 0.5, 0.6, 0.5, 0.56), rec("train.step", 2.0, 3.0),
               rec("attn.forward", 2.1, 2.2, 2.1, 2.12), rec("attn.forward", 5.0, 5.1, 5.0, 5.05)]
    obs = Observation({}, {}, Spans(torch.device("cpu")), records=records,
                      trace=DeviceTrace([("x", 0.0, 1.0)], 0.0, 10.0))
    assert core.load_reader("gatv2_attn_ms")(obs) == pytest.approx((0.03 + 0.06 + 0.02) / 2 * 1e3)
