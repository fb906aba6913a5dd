"""HGT (`graphs/hetero.py`, `ops/hgt.py`, `models/hgt.py`) against the plain
reference `benchmark/reference/hgt.py`, which imports nothing of the port.

On the CPU (the op's plain versions): the typed graph's block offsets,
relations, transpose and canonical ids, a target with no in-edges and an
item whose only in-edges are kNN ones; the port's initial weights equal the
reference's bit for bit; its forward, BPR loss and the gradient of every
leaf match the reference's autograd at 2 heads x 16, 2 layers and three
relations, at f32 rows and at bf16 rows rounded straight through; bf16
rows fail the f32 bands; the softmax over all of a target's in-edges
differs from one softmax a relation; the config round-trips; `cli train
--model-family hgt` fits and its export round-trips; the sharded trainer
refuses HGT; the spans of a step.

Tolerances (the repo's parity bands) and why: the forward within rtol 1e-4
/ atol 1e-5 (both sides run the same products; the op's softmax sums in
another order than the reference's blocks); the loss rtol 1e-5; each
leaf's gradient, over its largest reference entry, within rtol 5e-4 / atol
1e-4 (the port's backward is written out, B1 and B2, where the reference's
is autograd: the same sums in another order; measured 1e-6 of the largest
entry at most). The gradients at this size are ~1e-3 and below, so the
band is taken relative to each leaf's scale: absolute it would hold
anything. bf16 rows move the forward by ~7e-5 and the relation weights'
and prior's gradients by ~1e-3 of their largest entries.

On the card (`-m cuda`, skipped without one): the three kernels against
their plain versions at 8 heads x 32 on a typed graph of the main graph's
sizes (rows of several thousand entries split across blocks, empty rows),
both row types, the same bits on a second call; 2 heads x 16 padded and 16
heads x 32 through `hgt_attention` against `reference_versions()`;
misshapen rows raising. Kernel tolerances: rtol 1e-4 / atol 1e-5 on the
forward, the attention gradient band (rtol 5e-4 / atol 1e-4) on the
per-edge terms and on sums over a node's edges, the sums widened by twice
the bound of an f32 sum in any order.
"""
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import data  # noqa: E402
from benchmark.reference import hgt as rh  # noqa: E402
from benchmark.reference import sampling  # noqa: E402
from plotpointe_tpu_torch import cli, reference_versions  # noqa: E402
from plotpointe_tpu_torch.config import TrainConfig  # noqa: E402
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits  # noqa: E402
from plotpointe_tpu_torch.graphs.hetero import build_hetero_graph  # noqa: E402
from plotpointe_tpu_torch.models.hgt import HGTModel  # noqa: E402
from plotpointe_tpu_torch.ops import cuda_build  # noqa: E402
from plotpointe_tpu_torch.ops import hgt as op  # noqa: E402
from plotpointe_tpu_torch.utils import tracing  # noqa: E402
from plotpointe_tpu_torch.utils.prng import stream_seed  # noqa: E402

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
LOSS_RTOL = 1e-5
ZERO_SHARE = 1e-4
CFG = dict(hidden_dim=32, layers=2, heads=2, lr=1e-3, l2=1e-4, samples_per_epoch=512, steps_per_epoch=4,
           model_family="hgt")


@pytest.fixture(scope="module")
def small():
    """300 users x 200 items of seeded Amazon-shaped data, 16-d features,
    5 kNN neighbours an item: the port's typed graph and the reference's."""
    inter = data.amazon_shaped_interactions(7, 300, 200, 5000)
    feats = data.unit_rows(11, 200, 16, "cpu")
    rows, cols = rh.knn_edges(feats, 5, 0.0)
    s = build_splits(inter, *build_node_maps(inter))
    g = build_hetero_graph(s.train_u, s.train_i, s.n_users, s.n_items, rows, cols)
    prep = rh.prepare(inter, feats.numpy(), rows, cols, "cpu")
    gen = torch.Generator().manual_seed(3)
    triples = sampling.bpr_triples(gen, prep.train_users, prep.table, prep.deg, s.n_items, 512)
    return s, g, prep, feats, triples, (rows, cols), inter


def _port(s, rows=torch.float32):
    return HGTModel(s.n_users, s.n_items, 16, hidden_dim=32, n_layers=2, heads=2, hs_dtype=rows)


def _port_run(model, g, feats, triples, n_users):
    u, i, j = triples
    z = model(feats, g, train=True)
    pos, neg = (z[u] * z[n_users + i]).sum(-1), (z[u] * z[n_users + j]).sum(-1)
    loss = -torch.log(torch.sigmoid(pos - neg) + 1e-8).mean()
    names = [n for n, _ in model.named_parameters()]
    return z.detach(), loss.detach(), dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def _ref_run(p, prep, rows, triples):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    with torch.no_grad():
        z = rh.embed(p, prep, CFG, rows)
    loss = rh.loss_of(p, prep, CFG, rows, *triples)
    return z, loss.detach(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _hold_grads(got, want, keys=None):
    """Each leaf's gradient over its largest reference entry within
    GRAD_TOL; raises AssertionError naming the first leaf outside. A leaf
    whose reference gradient is under ZERO_SHARE of the median leaf's (the
    last layer's item output bias: every item score difference cancels it,
    so it is round-off) is held to that floor instead."""
    med = float(torch.stack([w.abs().max() for w in want.values()]).median())
    for k in keys or want:
        scale = want[k].abs().max()
        if scale < ZERO_SHARE * med:
            assert float(got[k].abs().max()) < ZERO_SHARE * med, k
            continue
        torch.testing.assert_close(got[k] / scale, want[k] / scale, **GRAD_TOL, msg=k)


def test_typed_graph_blocks_transpose_and_canonical_ids():
    """Two users, three items: item 2 has no interaction and only kNN
    in-edges; then a graph whose users and items but one have no in-edges."""
    g = build_hetero_graph(np.array([0, 0, 1]), np.array([0, 1, 1]), 2, 3,
                           np.array([2, 2, 0]), np.array([0, 1, 2]))
    assert (g.n_nodes, g.n_rows, g.offsets, g.rel_edges) == (5, 8, (0, 2, 5, 8), (3, 3, 3))
    src, dst, rel = g.src.numpy(), g.dst.numpy(), g.rel.numpy()
    edges = {(int(a), int(b), int(r)) for a, b, r in zip(src, dst, rel)}
    assert edges == {(0, 2, 0), (0, 3, 0), (1, 3, 0),  # rates: user u -> item node 2 + i, row u
                     (2, 0, 1), (3, 0, 1), (3, 1, 1),  # rated_by: item node -> user, row 2 + i
                     (5 + 0, 4, 2), (5 + 1, 4, 2), (5 + 2, 2, 2)}  # similar: j -> i, row 5 + j
    assert np.all(np.diff(dst) >= 0) and np.all(rel == (src >= 2).astype(int) + (src >= 5))
    deg = np.diff(g.row_ptr.numpy())
    assert deg.tolist() == [2, 1, 2, 2, 2]
    # item 2 (node 4) gathers only from the kNN block
    assert set(rel[dst == 4]) == {2}
    t_ptr, t_dst, t_eid = g.t_ptr.numpy(), g.t_dst.numpy(), g.t_eid.numpy()
    assert len(t_ptr) == g.n_rows + 1 and t_ptr[-1] == g.n_edges
    assert np.array_equal(np.sort(t_eid), np.arange(g.n_edges))
    for r in range(g.n_rows):
        ids = t_eid[t_ptr[r]:t_ptr[r + 1]]
        assert np.all(src[ids] == r) and np.array_equal(t_dst[t_ptr[r]:t_ptr[r + 1]], dst[ids])
    # targets with no in-edges (nodes 1, 3 and 4): zero output, lse -inf
    q = torch.randn(5, 2, 8)
    kv = torch.randn(8, 2, 2, 8)
    p = torch.ones(3, 2)
    g1 = build_hetero_graph(np.array([0]), np.array([0]), 2, 3, np.array([], np.int64), np.array([], np.int64))
    out, lse = op.hgt_fwd_plain(q, kv, p, g1, 0.3)
    assert torch.equal(out[[1, 3, 4]], torch.zeros(3, 2, 8)) and torch.isinf(lse[[1, 3, 4]]).all()
    assert torch.isfinite(lse[[0, 2]]).all() and out[[0, 2]].abs().sum() > 0
    with pytest.raises(ValueError, match="interacted items"):
        build_hetero_graph(np.array([0]), np.array([0]), 2, 3, np.array([3]), np.array([0]))


def test_initial_weights_are_the_references(small):
    s, _, prep, _, _, _, _ = small
    model = _port(s)
    model.init_params(torch.Generator().manual_seed(stream_seed(5, 0, 0)))
    want = rh.init_params(prep, CFG, 5, "cpu")
    got = model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["layers.0.k_rel"].shape == (3, 2, 16, 16) and got["layers.1.skip.item"].item() == 1.0


@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_loss_and_grads_match_the_reference(small, rows):
    s, g, prep, feats, triples, _, _ = small
    p = rh.init_params(prep, CFG, 5, "cpu")
    model = _port(s, rows)
    model.load_state_dict(p)
    z, loss, grads = _port_run(model, g, feats, triples, s.n_users)
    zr, loss_r, grads_r = _ref_run(p, prep, rows, triples)
    torch.testing.assert_close(z, zr, **FWD_TOL)
    torch.testing.assert_close(loss, loss_r, rtol=LOSS_RTOL, atol=0.0)
    _hold_grads(grads, grads_r)


def test_bf16_rows_fail_the_f32_bands(small):
    """The port at bf16 rows against the reference at f32 rows fails the
    forward's band and the relation weights' gradient band."""
    s, g, prep, feats, triples, _, _ = small
    p = rh.init_params(prep, CFG, 5, "cpu")
    model = _port(s, torch.bfloat16)
    model.load_state_dict(p)
    z, _, grads = _port_run(model, g, feats, triples, s.n_users)
    zr, _, grads_r = _ref_run(p, prep, torch.float32, triples)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(z, zr, **FWD_TOL)
    for k in ("layers.0.k_rel", "layers.0.p_rel"):
        with pytest.raises(AssertionError):
            _hold_grads(grads, grads_r, [k])


def test_the_softmax_spans_every_relation(small):
    """One softmax over a target's in-edges of all three relations is not a
    softmax a relation summed over the relations (each item has in-edges of
    rates and of similar)."""
    s, g, _, _, _, _, _ = small
    torch.manual_seed(0)
    q, kv, p = torch.randn(g.n_nodes, 2, 16), torch.randn(g.n_rows, 2, 2, 16), torch.rand(3, 2) + 0.5
    out, _ = op.hgt_fwd_plain(q, kv, p, g, 0.25)
    src, dst, rel = g.src.long(), g.dst.long(), g.rel.long()
    sc = (q[dst] * kv[src, 0]).sum(-1) * p[rel] * 0.25
    per_rel = torch.zeros_like(out)
    for r in range(3):
        e = rel == r
        num = torch.exp(sc[e])
        den = torch.zeros(g.n_nodes, 2).index_add_(0, dst[e], num)
        per_rel.index_add_(0, dst[e], (num / den[dst[e]])[:, :, None] * kv[src[e], 1])
    items = slice(s.n_users, g.n_nodes)
    assert float((out[items] - per_rel[items]).norm() / per_rel[items].norm()) > 0.1


def test_config_round_trips():
    model = HGTModel(5, 4, 8, hidden_dim=32, n_layers=2, heads=2)
    cfg = model.config_dict()
    assert cfg["model_family"] == "hgt" and (cfg["hidden_dim"], cfg["n_layers"], cfg["heads"]) == (32, 2, 2)
    again = HGTModel.from_config(cfg)
    assert again.config_dict() == cfg
    assert [n for n, _ in again.named_parameters()] == [n for n, _ in model.named_parameters()]
    with pytest.raises(ValueError, match="multiple of heads"):
        HGTModel(5, 4, 8, hidden_dim=30, heads=4)
    assert TrainConfig(model_family="hgt", knn_edges="x.npz").to_dict()["knn_edges"] == "x.npz"
    assert TrainConfig.from_dict(TrainConfig(model_family="hgt").to_dict()).model_family == "hgt"


def test_cli_train_hgt_and_its_export(small, tmp_path, capsys):
    """`cli train --model-family hgt --knn-edges` fits through `Trainer.fit`;
    `cli export` gives the item rows of the reference's f32 forward of the
    checkpoint's weights, hidden wide."""
    from plotpointe_tpu_torch.train.checkpoint import load_checkpoint, params_from_jax

    s, _, prep, feats, _, (rows, cols), inter = small
    staging, emb, models, graphs = (tmp_path / d for d in ("staging", "emb", "models", "graphs"))
    for d in (staging, emb, graphs):
        d.mkdir()
    np.savez(staging / "interactions.npz", **inter)
    np.save(emb / "fused_interacted.npy", feats.numpy())
    np.savez(graphs / "ii_edges_fused.npz", row=rows.astype(np.int32), col=cols.astype(np.int32),
             data=np.ones(len(rows), np.float32))
    cli.main(["train", "--model-family", "hgt", "--knn-edges", str(graphs / "ii_edges_fused.npz"),
              "--staging-prefix", str(staging), "--embeddings-prefix", str(emb), "--models-prefix",
              str(models), "--heads", "2", "--layers", "2", "--epochs", "2", "--samples-per-epoch", "512",
              "--eval-neg-k", "50", "--hidden-dim", "32", "--device", "cpu"])
    assert "ndcg@20" in json.loads(capsys.readouterr().out)["test"]
    (ckpt,) = (models / "checkpoints").glob("*.npz")
    flat, config = load_checkpoint(ckpt)
    assert config["model_family"] == "hgt" and config["heads"] == 2
    assert config["train_config"]["knn_edges"] == str(graphs / "ii_edges_fused.npz")
    np.save(tmp_path / "feats.npy", feats.numpy())
    cli.main(["export", "--checkpoint", str(ckpt), "--staging-prefix", str(staging),
              "--features", str(tmp_path / "feats.npy"), "--out", str(tmp_path / "items.npy"),
              "--device", "cpu"])
    got = np.load(tmp_path / "items.npy")
    assert got.shape == (s.n_items, 32)
    with torch.no_grad():
        want = rh.embed(params_from_jax(flat), prep, CFG, torch.float32)[s.n_users:]
    np.testing.assert_allclose(got, want.numpy(), **FWD_TOL)


def test_sharded_trainer_refuses_hgt(small):
    from plotpointe_tpu_torch.train.sharded import ShardedTrainer

    s, g, _, feats, _, _, _ = small
    cfg = TrainConfig(model_family="hgt", hidden_dim=32, heads=2, mesh_shape="data:1")
    with pytest.raises(ValueError, match="hgt"):
        ShardedTrainer(_port(s), cfg, g, s, item_feats=feats.numpy())


def test_a_step_records_the_spans(small):
    """Traced, a forward and backward records `attn.forward` and
    `attn.backward` (kind hgt, the edges of each relation) and `hgt.project`
    and `hgt.update` in both passes, each backward span inside the
    backward."""
    s, g, prep, feats, triples, _, _ = small
    model = _port(s)
    model.load_state_dict(rh.init_params(prep, CFG, 5, "cpu"))
    tracing.clear()
    tracing.enable()
    try:
        _port_run(model, g, feats, triples, s.n_users)
    finally:
        tracing.disable()
    recs = tracing.records()
    names = [(r.name, r.meta.get("pass")) for r in recs]
    for name in ("hgt.project", "hgt.update"):
        assert names.count((name, "forward")) == 2 and names.count((name, "backward")) == 2
    attn = [r for r in recs if r.name.startswith("attn.")]
    assert len(attn) == 4 and all(r.meta["kind"] == "hgt" and r.meta["edges"] == list(g.rel_edges)
                                  for r in attn)
    back = {(r.name, r.meta["layer"]): r for r in recs if r.meta.get("pass") == "backward"}
    forward_end = max(r.t1 for r in recs if r.meta.get("pass") == "forward" or r.name == "attn.forward")
    for li in range(2):  # a layer's backward: the update's, then the op's, then the projection's
        op_bwd = next(r for r in attn if r.name == "attn.backward" and r.meta["layer"] == li)
        assert forward_end <= back["hgt.update", li].t0 <= back["hgt.update", li].t1 <= op_bwd.t0
        assert op_bwd.t1 <= back["hgt.project", li].t0 <= back["hgt.project", li].t1
    tracing.clear()


def test_kernel_width_pads_to_a_kernel_row():
    assert op.kernel_width(8, 32) == 32 and op.kernel_width(2, 16) == 128
    assert op.kernel_width(16, 32) == 32 and op.kernel_width(4, 20) == 64
    for heads, d in ((8, 32), (2, 128), (16, 32), (32, 8)):
        op.check_shape(heads, d)
    for heads, d in ((1, 256), (3, 64), (8, 16), (2, 256)):
        with pytest.raises(ValueError, match="heads"):
            op.check_shape(heads, d)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)
SUM_TOL = dict(rtol=5e-4, atol=1e-4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_graph(rng, n_users=192403, n_items=63001, n_inter=1689116, k=20):
    """The main graph's sizes: lognormal item popularity (items with
    thousands of in-edges, split across blocks), users with none, the kNN
    block."""
    wi = rng.lognormal(0.0, 1.52, n_items)
    u = rng.integers(0, n_users - 1000, n_inter)
    i = rng.choice(n_items, n_inter, p=wi / wi.sum())
    rows = np.repeat(np.arange(n_items), k)
    cols = (rows + rng.integers(1, n_items, len(rows))) % n_items
    return build_hetero_graph(u, i, n_users, n_items, rows, cols)


def _inputs(rng, g, heads, d, rows, dev):
    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)
    q, kv = t(g.n_nodes, heads, d, scale=0.5), t(g.n_rows, 2, heads, d, scale=0.5)
    p = torch.as_tensor(rng.uniform(0.5, 1.5, (3, heads)).astype(np.float32), device=dev)
    return q, kv.to(rows).contiguous(), p, t(g.n_nodes, heads, d)


def _hold_row_sums(got, want, rows, terms_abs):
    """A row's sum over its edges within SUM_TOL plus twice the bound of an
    f32 sum in any order, (its entries) x 2^-24 x sum |terms|."""
    shape = (-1,) + (1,) * (got.dim() - 1)
    depth = torch.bincount(rows, minlength=got.shape[0]).to(got.dtype).view(shape)
    mag = torch.zeros_like(got).index_add_(0, rows, terms_abs)
    bound = SUM_TOL["atol"] + SUM_TOL["rtol"] * want.abs() + 2 * 2.0 ** -24 * depth * mag
    excess = (got - want).abs() - bound
    assert bool((excess <= 0).all()), float(excess.max())


def _kernels_against_plain(g, q, kv, p, grad, scale):
    out, lse = op.hgt_fwd(q, kv, p, g, scale)
    want_out, want_lse = op.hgt_fwd_plain(q, kv, p, g, scale)
    torch.testing.assert_close(out, want_out, **KERNEL_TOL)
    torch.testing.assert_close(lse, want_lse, **KERNEL_TOL)
    dq, dp, edge = op.hgt_bwd_dst(q, kv, p, grad, want_out, want_lse, g, scale)
    w_dq, w_dp, w_edge = op.hgt_bwd_dst_plain(q, kv, p, grad, want_out, want_lse, g, scale)
    torch.testing.assert_close(edge, w_edge, **SUM_TOL)
    src, dst = g.src.long(), g.dst.long()
    heads = q.shape[1]
    _hold_row_sums(dq, w_dq, dst, w_edge[:, :heads, None].abs() * kv[:, 0].float()[src].abs())
    torch.testing.assert_close(dp, w_dp, rtol=SUM_TOL["rtol"], atol=SUM_TOL["atol"] * g.n_edges ** 0.5)
    dkv = op.hgt_bwd_src(q, grad, w_edge, g)
    terms = torch.stack([w_edge[:, :heads, None].abs() * q[dst].abs(),
                         w_edge[:, heads:, None].abs() * grad[dst].abs()], 1)
    _hold_row_sums(dkv, op.hgt_bwd_src_plain(q, grad, w_edge, g), src, terms)
    again = (*op.hgt_fwd(q, kv, p, g, scale), *op.hgt_bwd_dst(q, kv, p, grad, want_out, want_lse, g, scale),
             op.hgt_bwd_src(q, grad, w_edge, g))
    for x, y in zip((out, lse, dq, dp, edge, dkv), again):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def card_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return _card_graph(np.random.default_rng(5)).to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernels_match_plain_at_eight_heads_of_32(cuda, card_graph, rows):
    rng = np.random.default_rng(6)
    q, kv, p, grad = _inputs(rng, card_graph, 8, 32, rows, cuda)
    names = ("hgt_fwd", "hgt_bwd_dst", "hgt_bwd_src")
    before = [cuda_build.COUNTERS[k].count for k in names]
    _kernels_against_plain(card_graph, q, kv, p, grad, 1 / math.sqrt(32))
    after = [cuda_build.COUNTERS[k].count for k in names]
    assert [y - x for x, y in zip(before, after)] == [2, 2, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("heads,d", [(16, 32), (2, 128), (32, 8)])
def test_kernels_match_plain_at_other_widths(cuda, heads, d):
    rng = np.random.default_rng(heads * d)
    g = _card_graph(rng, 3000, 1000, 30000, 5).to(cuda)
    q, kv, p, grad = _inputs(rng, g, heads, d, torch.bfloat16, cuda)
    _kernels_against_plain(g, q, kv, p, grad, 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,d", [(2, 16), (8, 32)])
def test_the_op_matches_its_plain_versions(cuda, heads, d):
    """`hgt_attention` (D padded where it must be) forward and gradients on
    the kernels against the same op inside `reference_versions()`."""
    rng = np.random.default_rng(heads + d)
    g = _card_graph(rng, 3000, 1000, 30000, 5).to(cuda)
    q, kv, p, grad = (t.float().requires_grad_(True) for t in _inputs(rng, g, heads, d, torch.float32, cuda))

    def run():
        out = op.hgt_attention(q, kv, p, g, torch.bfloat16, layer=0)
        return (out, *torch.autograd.grad((out * grad.detach()).sum(), (q, kv, p)))

    got = run()
    with reference_versions():
        want = run()
    torch.testing.assert_close(got[0], want[0], **KERNEL_TOL)
    for x, y in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(x, y, **SUM_TOL)
    torch.testing.assert_close(got[3], want[3], rtol=SUM_TOL["rtol"], atol=SUM_TOL["atol"] * g.n_edges ** 0.5)


@pytest.mark.cuda
def test_misshapen_rows_raise(cuda):
    rng = np.random.default_rng(1)
    g = _card_graph(rng, 3000, 1000, 30000, 5).to(cuda)
    q, kv, p, _ = _inputs(rng, g, 3, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="heads"):
        op.hgt_fwd(q, kv, p, g, 0.1)
    q, kv, p, _ = _inputs(rng, g, 8, 32, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="aligned|contiguous"):
        op.hgt_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), kv, p, g, 0.1)
