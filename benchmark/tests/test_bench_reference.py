"""The reference's own pieces: its draws are the stated ones (held here to
the program's, which a test may import), its splits and graph, the
traffic's schedule and the percentile arithmetic."""
import numpy as np
import pytest
import torch

from benchmark import data, traffic
from benchmark.drivers.serve_open_loop import percentile
from benchmark.reference import data as refdata
from benchmark.reference import sampling


def test_nth_outside_is_the_programs_rank_to_item():
    from plotpointe_tpu_torch.train.sampling import rank_to_item

    g = torch.Generator().manual_seed(3)
    n_items, rows, width = 500, 64, 40
    avoid = torch.sort(torch.randint(0, n_items, (rows, width), generator=g), dim=1)[0]
    avoid = torch.stack([torch.cat([torch.unique(r), torch.full((width,), n_items)])[:width] for r in avoid])
    count = (avoid < n_items).sum(1)
    r = (torch.rand((rows, 7), generator=g) * (n_items - count)[:, None]).long()
    assert torch.equal(sampling.nth_outside(r, avoid), rank_to_item(r, avoid).long())


def test_splits_and_graph_are_the_programs():
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph

    inter = data.amazon_shaped_interactions(5, 300, 200, 4000)
    want = build_splits(inter, *build_node_maps(inter))
    got = refdata.splits(inter)
    for k in ("train_u", "train_i", "val_u", "val_i", "test_u", "test_i"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    g = refdata.graph(got, "cpu")
    w = build_bipartite_graph(want.train_u, want.train_i, want.n_users, want.n_items)
    assert torch.equal(g.src, w.src.long()) and torch.equal(g.dst, w.dst.long())


def test_stream_seed_is_the_programs():
    from plotpointe_tpu_torch.utils.prng import stream_seed

    for seed in (0, 42, 2 ** 31 + 5, 2 ** 40):
        assert sampling.stream_seed(seed, 1, 7) == stream_seed(seed, 1, 7)


def test_schedule_offers_the_same_load_for_every_seed():
    hist = [np.arange(1 + i % 5) for i in range(50)]
    params = {"rate_per_s": 300, "arrivals": "poisson", "k": 20}
    a, b = traffic.schedule(params, 1, 5.0, hist), traffic.schedule(params, 2, 5.0, hist)
    assert len(a) == len(b) == 1500
    assert a[-1][0] == pytest.approx(b[-1][0])
    assert [t for t, _, _ in a] != [t for t, _, _ in b]
    assert all(x[0] <= y[0] for x, y in zip(a, a[1:]))


def test_sorted_index_percentiles():
    v = sorted(float(x) for x in range(1, 101))
    assert percentile(v, 0.5) == 51.0 and percentile(v, 0.95) == 96.0
    assert percentile([], 0.95) == float("inf")
