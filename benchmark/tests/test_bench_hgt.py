"""The HGT cell's harness on the CPU (the op's plain versions):
`drivers/train_fit_hgt.py` at a test size gives a correct result line; half
of each batch left out, the evals' negatives from other streams and a state
left unchanged fail, and a program without the HGT fails at once; the
control is not correct under the cell's limits; its readers load by name,
read hand-built traces and spans, and read nothing of a GAT fit."""
import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import core
from benchmark.core import Observation
from benchmark.counts import hgt as counts
from benchmark.tests.conftest import CELLS, run_tiny
from benchmark.tests.test_bench_drivers import check_form
from benchmark.tracing import DeviceTrace, Span, Spans

CELL = "tiny.hgt.train"
OWN = ("hgt_roofline", "hgt_mfu", "hgt_attn_ms", "hgt_dense_ms")


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


def test_a_state_left_unchanged(tiny_bench, monkeypatch):
    from plotpointe_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Trainer, "_opt_step", lambda self: None)
    r = run_tiny(tiny_bench, CELL)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_program_without_hgt_fails_at_once(tiny_bench, monkeypatch):
    """The parent commit's program has no `models/hgt.py`: the run raises
    before it builds anything (a clean, quick failure)."""
    import sys

    monkeypatch.setitem(sys.modules, "plotpointe_tpu_torch.models.hgt", None)
    with pytest.raises(RuntimeError, match="no HGT"):
        run_tiny(tiny_bench, CELL)


def test_the_control_is_not_correct():
    from benchmark.tools.control_hgt import readings

    cell = core.load_cell(CELL, CELLS)
    row = readings(cell, core.load_config(cell["config"], CELLS), 2 ** 31 + 7, torch.device("cpu"))
    limits = cell["limits"]
    assert any(row["control"][k] > limits[k] for k in limits), row["control"]
    assert row["half_batch"]["grad_gap"] > limits["grad_gap"]
    assert row["other_negatives"]["eval_gap"] > limits["eval_gap"]
    assert row["unchanged"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("metric", OWN)
def test_the_readers_load_by_name_and_read_nothing_of_a_gat_fit(metric):
    shapes = {"n_users": 10, "n_items": 5, "n_nodes": 15, "n_edges": 40, "feat_dim": 8, "hidden_dim": 32,
              "layers": 2, "heads": 1, "rows": "bfloat16", "samples_per_epoch": 64, "model_family": "gat",
              "steps_per_epoch_run": 2}
    obs = Observation({"peak": {"dtype": "float32"}}, shapes, Spans(torch.device("cpu")),
                      counters={"gat_fwd": 6, "gat_bwd_dst": 2, "gat_bwd_src": 2, "steps": 2},
                      trace=DeviceTrace([("attention_walk", 0.0, 1e-3)], 0.0, 1.0), kind="h100", records=[])
    assert core.load_reader(metric)(obs) is None


def test_roofline_and_mfu_on_a_hand_built_fit():
    u, i, e, hh, f = 600, 400, 20000, 8, 256
    n, s, d = u + i, u + 2 * i, f // hh
    shapes = {"n_users": u, "n_items": i, "n_nodes": n, "n_rows": s, "n_edges": e, "feat_dim": 64,
              "hidden_dim": f, "layers": 3, "heads": hh, "rows": "bfloat16", "samples_per_epoch": 5000,
              "model_family": "hgt", "steps_per_epoch_run": 4}
    spans = Spans(torch.device("cpu"))
    ops = [("void (anonymous namespace)::hgt_fwd_walk<__nv_bfloat16, 1>(...)", 0.1, 2e-3),
           ("void (anonymous namespace)::hgt_fwd_combine(...)", 0.15, 1e-4),
           ("void (anonymous namespace)::hgt_bwd_dst_walk<__nv_bfloat16, 1>(...)", 0.2, 3e-3),
           ("gatv2_sum_slots(...)", 0.3, 1e-4),
           ("void (anonymous namespace)::hgt_bwd_src_walk<2>(...)", 0.4, 2e-3),
           ("sm80_xmma_gemm_f32f32", 0.5, 5e-3)]
    obs = Observation({"peak": {"dtype": "float32"}}, shapes, spans,
                      counters={"hgt_fwd": 1, "hgt_bwd_dst": 1, "hgt_bwd_src": 1, "steps": 1},
                      trace=DeviceTrace(ops, 0.0, 1.0), kind="h100")
    bound = (counts.fwd_bound_s(n, s, e, hh, d) + counts.bwd_dst_bound_s(n, s, e, hh, d)
             + counts.bwd_src_bound_s(n, s, e, hh, d))
    assert core.load_reader("hgt_roofline")(obs) == pytest.approx(100 * bound / 7.2e-3)
    spans.items += [Span("epoch", 0.0, 0.04), Span("epoch", 0.05, 0.09)]
    flops = counts.step_flops(u, i, e, 64, f, 3, hh, 5000)
    assert core.load_reader("hgt_mfu")(obs) == pytest.approx(100 * flops / (0.01 * 67e12))
    assert math.isfinite(core.load_reader("hgt_mfu")(obs))


def test_the_step_flops_at_hgt_amazon_shapes():
    """At hgt-amazon's shapes a step is ~1.3-1.4 TFLOP (the dense products
    ~1.3, the edge attention ~0.04 at E ~3.92 M)."""
    flops = counts.step_flops(192403, 63001, 2657622 + 1260020, 384, 256, 3, 8, 200000)
    assert 1.3e12 < flops < 1.45e12


def _rec(name, t0, t1, d0=None, d1=None, **meta):
    return SimpleNamespace(name=name, t0=t0, t1=t1, d0=d0, d1=d1, meta=meta)


def test_attention_and_dense_shares_read_the_spans_inside_steps():
    records = [_rec("train.step", 0.0, 1.0), _rec("attn.forward", 0.1, 0.2, 0.1, 0.13, kind="hgt"),
               _rec("attn.backward", 0.5, 0.6, 0.5, 0.56, kind="hgt"),
               _rec("attn.forward", 0.3, 0.4, 0.3, 0.31, kind="gatv2"),
               _rec("hgt.project", 0.05, 0.09, 0.05, 0.07), _rec("hgt.update", 0.25, 0.3, 0.25, 0.26),
               _rec("train.step", 2.0, 3.0), _rec("attn.forward", 2.1, 2.2, 2.1, 2.12, kind="hgt"),
               _rec("hgt.project", 2.6, 2.7, 2.6, 2.64),
               _rec("attn.forward", 5.0, 5.1, 5.0, 5.05, kind="hgt"), _rec("hgt.update", 5.2, 5.3, 5.2, 5.3)]
    obs = Observation({}, {}, Spans(torch.device("cpu")), records=records,
                      trace=DeviceTrace([("x", 0.0, 1.0)], 0.0, 10.0))
    assert core.load_reader("hgt_attn_ms")(obs) == pytest.approx((0.03 + 0.06 + 0.02) / 2 * 1e3)
    assert core.load_reader("hgt_dense_ms")(obs) == pytest.approx((0.02 + 0.01 + 0.04) / 2 * 1e3)
