"""The frozen byte and FLOP counts against values worked out by hand at the
main graph's shapes: 192,403 users + 63,001 items = 255,404 nodes, 2,657,622
edges, hidden 128, 384-d features, 200,000 triples a step; LightGCN at 64-d,
3 rounds, 8,192 x 5; the 498,196 x 128 f32 catalog."""
import pytest

from benchmark.counts import attention, flops, peaks, spmm, topk

N, E, D = 255_404, 2_657_622, 128


def test_attention_bytes():
    assert sum(attention.fwd_mh_bytes(N, E, 1, D, True).values()) == 284_838_932
    assert sum(attention.fwd_mh_bytes(N, E, 1, D, False).values()) == 284_838_932 - 10_630_488
    assert sum(attention.bwd_dst_bytes(N, E, 1, D, 2, True).values()) == 354_308_308
    assert sum(attention.bwd_src_bytes(N, E, D, 2).values()) == 298_533_756


def test_attention_bounds_are_the_bytes_over_the_memory_rate():
    assert attention.fwd_bound_s(N, E, D, True) == pytest.approx(284_838_932 / 3.35e12)
    assert attention.bwd_dst_bound_s(N, E, D) == pytest.approx(354_308_308 / 3.35e12)
    assert attention.bwd_src_bound_s(N, E, D) == pytest.approx(298_533_756 / 3.35e12)


def test_spmm_bytes_and_bound():
    assert sum(spmm.spmm_bytes(N, E, 64, 2).values()) == 120_357_732
    assert spmm.spmm_bound_s(N, E, 64) == pytest.approx(120_357_732 / 3.35e12)


def test_topk_bound():
    assert sum(topk.topk_bytes(1, 498_196, 128, 20, 4).values()) == 255_077_024
    assert topk.topk_bound_s(1, 498_196, 128, 20) == pytest.approx(255_077_024 / 3.35e12)
    # at 64 queries the three TF32 passes still take less than the catalog's stream
    assert topk.topk_bound_s(64, 498_196, 128, 20) == pytest.approx(
        (255_076_352 + 64 * 512 + 64 * 160) / 3.35e12)


def test_model_flops_of_a_step():
    assert flops.gat_step_flops(192_403, 63_001, E, 384, 128, 2, 200_000) == 67_774_878_720
    assert flops.lightgcn_step_flops(192_403, 63_001, E, 64, 3, 8_192, 5) == 2_059_928_064


def test_peaks():
    assert peaks.peak_flops("float32") == 67e12
    assert peaks.generation("NVIDIA H100 80GB HBM3") == "h100"
    assert peaks.bound_s(3.35e9, 0.0, "float32") == pytest.approx(1e-3)
