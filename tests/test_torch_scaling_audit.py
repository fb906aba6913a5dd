"""The port's scaling audit (tools/scaling_audit.py); mirrors
tests/test_scaling_audit.py. The ring wire model and the efficiency bound
are JAX's formulas, held equal on one collective list; the audit's
per-step collectives (from the shapes) are held equal to what the recorder
lists in a real step on 1 and 2 gloo CPU ranks; the measured CPU trend
runs (correctness and overhead, not speedup)."""
import numpy as np
import pytest

from plotpointe_tpu.tools import scaling_audit as jax_audit
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.parallel.cases import run_cases
from plotpointe_tpu_torch.parallel.multihost import spawn
from plotpointe_tpu_torch.tools import scaling_audit as sa
from plotpointe_tpu_torch.train.checkpoint import params_to_jax

COLLS = [{"op": "all_reduce", "bytes": 255405 * 128 * 4},
         {"op": "all_gather", "bytes": 48101 * 128 * 4},
         {"op": "reduce_scatter", "bytes": 192404 * 128 * 2},
         {"op": "all_to_all", "bytes": 1000}]
NU, NI, F, H, HEADS = 70, 50, 24, 16, 2


def test_wire_model_ring_formulas():
    n = 4
    for kind, want in (("all_reduce", 2 * 100 * 3 / 4), ("all_gather", 100 * 3),
                       ("reduce_scatter", 100 * 3 / 4)):
        assert sa.wire_bytes_per_chip([{"op": kind, "bytes": 100}], n) == pytest.approx(want)
    assert sa.wire_bytes_per_chip([{"op": "all_reduce", "bytes": 100}], 1) == 0.0
    for n in (1, 2, 4, 8):  # JAX's formulas, unchanged
        assert sa.wire_bytes_per_chip(COLLS, n) == jax_audit.wire_bytes_per_chip(COLLS, n)


def test_predict_efficiency_equals_jax_at_the_same_rate():
    audits = [{"n_shards": 1, "wire_bytes_per_chip": 0},
              {"n_shards": 2, "wire_bytes_per_chip": int(1e9)},
              {"n_shards": 8, "wire_bytes_per_chip": int(2e9)}]
    got = sa.predict_efficiency(audits, 0.2, link_gbps=jax_audit.ICI_GBPS["v5e"])
    assert got == jax_audit.predict_efficiency(audits, 0.2, gen="v5e")
    eff = sa.predict_efficiency(audits, step_time_1chip_s=0.2)
    assert eff["gat_scaling_pred_eff_1dev"] == 1.0
    assert 0 < eff["gat_scaling_pred_eff_8dev"] < eff["gat_scaling_pred_eff_2dev"] < 1
    assert sa.NVLINK_GBPS["h100_sxm"] == 450.0  # NVIDIA's per-direction spec, not a measurement


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    tu, ti = rng.integers(0, NU, 500), rng.integers(0, NI, 500)
    src, dst = np.concatenate([tu, ti + NU]), np.concatenate([ti + NU, tu])
    model = GATModel(NU, NI, F, hidden_dim=H, n_layers=2, heads=HEADS, attn_dropout=0.0)
    model.init_params(__import__("torch").Generator().manual_seed(0))
    case = dict(kind="gat_step", src=src, dst=dst, n_nodes=NU + NI, builder="make_sharded_gat_step",
                model=model.config_dict(), params=params_to_jax(model.state_dict()),
                item_feats=rng.normal(size=(NI, F)).astype(np.float32),
                **{k: rng.integers(0, n, 64).astype(np.int32) for k, n in zip("uij", (NU, NI, NI))})
    return build_graph(src, dst, NU + NI), case


@pytest.mark.multihost
@pytest.mark.parametrize("n", [1, 2])
def test_audit_equals_the_recorded_step(problem, n):
    """Every collective of a real step, as the recorder lists it on each
    rank, is one the audit predicts from the shapes, and no other."""
    graph, case = problem
    want = sa.audit_collectives(n, graph, NU, hidden=H, layers=2, heads=HEADS, feat_dim=F)
    for (got,) in spawn(run_cases, n, ([case],), device="cpu", timeout_s=120):
        assert sa.same_collectives(got["collectives"], want["collectives"]), \
            (got["collectives"], want["collectives"])
        assert sa.summarize(got["collectives"], n)["wire_bytes_per_chip"] == want["wire_bytes_per_chip"]


def test_static_audit_small_shape():
    """At a small shape: the same collectives at 2 and 8 shards, wire bytes
    that grow with the shard count, all_reduce, all_gather and
    reduce_scatter among them."""
    g = sa.synthetic_graph(2_000, 600, 20_000)
    a2, a8 = (sa.audit_collectives(n, g, 2_000, hidden=32, layers=2, feat_dim=64) for n in (2, 8))
    assert a2["collective_count"] == a8["collective_count"] >= 8
    assert a8["wire_bytes_per_chip"] > a2["wire_bytes_per_chip"] > 0
    assert set(a2["collective_ops"]) == {"all_reduce", "all_gather", "reduce_scatter"}
    assert sa.audit_collectives(1, g, 2_000)["wire_bytes_per_chip"] == 0


@pytest.mark.multihost
def test_measured_cpu_trend_runs():
    out = sa.measured_cpu_trend([1, 2], n_users=300, n_items=100, n_edges=3_000, hidden=16,
                                batch=256)
    assert set(out) == {"cpu_mesh_edges_per_sec_1dev", "cpu_mesh_edges_per_sec_2dev"}
    assert all(v > 0 for v in out.values())
