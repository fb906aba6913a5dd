"""GATv2 (`ops/gatv2.py`, `models/gat.py` with `attention="gatv2"`) against
the plain reference `benchmark/reference/gatv2.py`, which imports nothing
of the port.

On the CPU (the op's plain versions): the port's initial weights equal the
reference's bit for bit; its forward, BPR loss and the gradient of every
leaf match the reference's autograd at 1 and 2 heads, with and without
dropout, at f32 rows and at bf16 rows rounded straight through; the
original GAT's logit on the same weights does not; old configs load as the
GAT; `cli train --attention gatv2` fits and its export round-trips; the
sharded trainer refuses GATv2.

Tolerances and why:
  forward: the embeddings within 1e-5 of their norm; loss: rtol 1e-5. Both
    sides run the same ops in the same order (equal bits in a quiet
    process), but a threaded f32 GEMM on the CPU may split its sums another
    way from call to call (seen: 3e-6 absolute at once under the tier-1
    run); bf16 rows move the embeddings by ~2e-3 of their norm, 200 times
    the band.
  gradients: each leaf within 1e-4 of its largest entry. The port's
    backward is written out (B1 and B2) where the reference's is autograd:
    the same sums in another order, with the softmax's cancellation
    (measured: 1.1e-5 at most); bf16 rows move them by more than 1e-3.

On the card (`-m cuda`, skipped without one): the three kernels against
their plain versions at the configuration's 2 heads x 128 on a graph with
rows of 10,000 entries (pieces split across blocks), empty rows and a star,
both row types, with and without dropout, the same bits on a second call;
1, 3 and 8 heads and D 32 to 512; D 96 padded and 12 heads in groups
through `gatv2_attention` against `reference_versions()`; misshapen rows
raising. Kernel tolerances: rtol 1e-4 / atol 1e-5 on values and the
attention gradient band of tests/test_torch_cuda.py (rtol 5e-4 / atol
1e-4) on the per-edge terms and on sums over a node's edges, the sums
widened by twice the bound of an f32 sum in any order (entries x 2^-24 x
sum |terms|: a star's 10,000 terms cancel); the signs equal wherever |z| is
above 1e-6 (both sides form z by one f32 add of the same operands: equal
bits everywhere, but a tie at 0 would not be a fault).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import data  # noqa: E402
from benchmark.reference import gatv2 as rg  # noqa: E402
from benchmark.reference import sampling  # noqa: E402
from benchmark.reference import training as ref  # noqa: E402
from plotpointe_tpu_torch import cli, reference_versions  # noqa: E402
from plotpointe_tpu_torch.config import TrainConfig  # noqa: E402
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits  # noqa: E402
from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph, build_graph  # noqa: E402
from plotpointe_tpu_torch.models.gat import GATModel  # noqa: E402
from plotpointe_tpu_torch.ops import cuda_build  # noqa: E402
from plotpointe_tpu_torch.ops import gatv2 as op  # noqa: E402
from plotpointe_tpu_torch.ops.gat_fused import dropout_mask_mh  # noqa: E402
from plotpointe_tpu_torch.utils.prng import stream_seed  # noqa: E402

FWD_SHARE = 1e-5  # of the embeddings' norm; the loss's rtol
GRAD_SHARE = 1e-4  # of each leaf's largest gradient entry
SEEDS = [123456789, 4000000000]  # a uint32 dropout seed per layer
CFG = dict(hidden_dim=32, layers=2, lr=1e-3, l2=1e-4, samples_per_epoch=512, steps_per_epoch=4,
           model_family="gat")


@pytest.fixture(scope="module")
def small():
    """300 users x 200 items of seeded Amazon-shaped data, 16-d features:
    the port's splits and graph and the reference's own."""
    inter = data.amazon_shaped_interactions(7, 300, 200, 5000)
    feats = data.unit_rows(11, 200, 16, "cpu").numpy()
    s = build_splits(inter, *build_node_maps(inter))
    g = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    prep = ref.prepare(inter, feats, "gat", "cpu")
    assert torch.equal(prep.graph.src, g.src.long()) and torch.equal(prep.graph.dst, g.dst.long())
    gen = torch.Generator().manual_seed(3)
    triples = sampling.bpr_triples(gen, prep.train_users, prep.table, prep.deg, s.n_items, 512)
    return s, g, prep, torch.as_tensor(feats), triples


def _port(s, heads, rate, rows, attention="gatv2"):
    return GATModel(s.n_users, s.n_items, 16, hidden_dim=32, n_layers=2, heads=heads, attn_dropout=rate,
                    hs_dtype=rows, attention=attention)


def _port_run(model, g, feats, triples, n_users):
    u, i, j = triples
    z = model(feats, g, train=True, seeds=SEEDS)
    pos, neg = (z[u] * z[n_users + i]).sum(-1), (z[u] * z[n_users + j]).sum(-1)
    loss = -torch.log(torch.sigmoid(pos - neg) + 1e-8).mean()
    names = [n for n, _ in model.named_parameters()]
    return z.detach(), loss.detach(), dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def _ref_run(p, prep, cfg, rows, triples):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    with torch.no_grad():
        z = rg.embed(p, prep, cfg, rows, SEEDS, train=True)
    loss = rg.loss_of(p, prep, cfg, rows, *triples, SEEDS)
    return z, loss.detach(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _norm_gap(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _grad_gaps(got, want):
    return {k: float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)) for k in want}


def test_initial_weights_are_the_references(small):
    s, _, prep, _, _ = small
    for heads in (1, 2):
        model = _port(s, heads, 0.1, torch.float32)
        model.init_params(torch.Generator().manual_seed(stream_seed(5, 0, 0)))
        want = rg.init_params(prep, dict(CFG, heads=heads), 5, "cpu")
        got = model.state_dict()
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("heads", [1, 2])
def test_forward_loss_and_grads_match_the_reference(small, heads, rate, rows):
    s, g, prep, feats, triples = small
    cfg = dict(CFG, heads=heads, attn_dropout=rate)
    p = rg.init_params(prep, cfg, 5, "cpu")
    model = _port(s, heads, rate, rows)
    model.load_state_dict(p)
    z, loss, grads = _port_run(model, g, feats, triples, s.n_users)
    zr, loss_r, grads_r = _ref_run(p, prep, cfg, rows, triples)
    assert _norm_gap(z, zr) <= FWD_SHARE
    torch.testing.assert_close(loss, loss_r, rtol=FWD_SHARE, atol=0.0)
    gaps = _grad_gaps(grads, grads_r)
    assert max(gaps.values()) <= GRAD_SHARE, gaps


def test_bf16_rows_fail_the_f32_tolerances(small):
    """The bands above are tight enough to tell the row types apart: the
    port at bf16 rows against the reference at f32 rows fails the forward's
    and the gradients'. (The loss at the initial weights is ln 2 within
    2e-7 at either row type: every score is near 0.)"""
    s, g, prep, feats, triples = small
    cfg = dict(CFG, heads=2, attn_dropout=0.1)
    p = rg.init_params(prep, cfg, 5, "cpu")
    model = _port(s, 2, 0.1, torch.bfloat16)
    model.load_state_dict(p)
    z, loss, grads = _port_run(model, g, feats, triples, s.n_users)
    zr, loss_r, grads_r = _ref_run(p, prep, cfg, torch.float32, triples)
    assert _norm_gap(z, zr) > 100 * FWD_SHARE
    assert max(_grad_gaps(grads, grads_r).values()) > 10 * GRAD_SHARE


def test_the_gatv2_logit_is_not_gats(small):
    """The original GAT on the same weights (W = W_l, a_src = a_dst = a)
    lies far outside the forward band."""
    s, g, prep, feats, _ = small
    cfg = dict(CFG, heads=2, attn_dropout=0.0)
    p = rg.init_params(prep, cfg, 5, "cpu")
    v2 = _port(s, 2, 0.0, torch.float32)
    v2.load_state_dict(p)
    gat = _port(s, 2, 0.0, torch.float32, attention="gat")
    gat.load_state_dict({k: v for k, v in p.items() if not k.startswith("layers.")}, strict=False)
    with torch.no_grad():
        for li, layer in enumerate(gat.layers):
            layer.w.copy_(p[f"layers.{li}.w_l"])
            layer.a_src.copy_(p[f"layers.{li}.a"])
            layer.a_dst.copy_(p[f"layers.{li}.a"])
        z2, z1 = v2(feats, g), gat(feats, g)
    assert _norm_gap(z1, z2) > 1e3 * FWD_SHARE


def test_old_config_loads_as_the_gat_and_gatv2_round_trips():
    old = {"model_family": "gat", "n_users": 5, "n_items": 4, "feat_dim": 8, "hidden_dim": 32,
           "n_layers": 2, "heads": 1, "attn_dropout": 0.1, "use_bias": False}
    model = GATModel.from_config(old)
    assert model.attention == "gat" and hasattr(model.layers[0], "a_src")
    v2 = GATModel.from_config({**old, "heads": 2, "attention": "gatv2"})
    assert v2.config_dict()["attention"] == "gatv2"
    assert sorted(n for n, _ in v2.named_parameters() if n.startswith("layers.0.")) == \
        ["layers.0.a", "layers.0.w_l", "layers.0.w_r"]
    assert GATModel.from_config(v2.config_dict()).config_dict() == v2.config_dict()
    with pytest.raises(ValueError, match="attention"):
        GATModel.from_config({**old, "attention": "gatv3"})
    with pytest.raises(ValueError, match="1 to 8 heads"):
        GATModel.from_config({**old, "heads": 9, "attention": "gatv2"})
    assert TrainConfig().attention == "gat"


def test_cli_train_gatv2_and_its_export(small, tmp_path, capsys):
    """`cli train --attention gatv2 --heads 2` fits through `Trainer.fit`;
    the checkpoint records the attention, and `cli export` gives the item
    rows of the reference's f32 forward of the checkpoint's weights."""
    from plotpointe_tpu_torch.train.checkpoint import load_checkpoint, params_from_jax

    s, _, prep, feats, _ = small
    inter = data.amazon_shaped_interactions(7, 300, 200, 5000)
    staging, emb, models = tmp_path / "staging", tmp_path / "emb", tmp_path / "models"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz", **inter)
    np.save(emb / "fused_interacted.npy", feats.numpy())
    cli.main(["train", "--staging-prefix", str(staging), "--embeddings-prefix", str(emb),
              "--models-prefix", str(models), "--attention", "gatv2", "--heads", "2", "--epochs", "2",
              "--samples-per-epoch", "512", "--eval-neg-k", "50", "--hidden-dim", "32",
              "--device", "cpu"])
    assert "ndcg@20" in json.loads(capsys.readouterr().out)["test"]
    (ckpt,) = (models / "checkpoints").glob("*.npz")
    flat, config = load_checkpoint(ckpt)
    assert config["attention"] == "gatv2" and config["heads"] == 2
    assert config["train_config"]["attention"] == "gatv2"
    np.save(tmp_path / "feats.npy", feats.numpy())
    cli.main(["export", "--checkpoint", str(ckpt), "--staging-prefix", str(staging),
              "--features", str(tmp_path / "feats.npy"), "--out", str(tmp_path / "items.npy"),
              "--device", "cpu"])
    got = np.load(tmp_path / "items.npy")
    p = params_from_jax(flat)
    with torch.no_grad():
        want = rg.embed(p, prep, dict(CFG, heads=2, attn_dropout=0.1), torch.float32)[s.n_users:]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_sharded_trainer_refuses_gatv2(small):
    from plotpointe_tpu_torch.train.sharded import ShardedTrainer

    s, g, _, feats, _ = small
    cfg = TrainConfig(hidden_dim=32, heads=2, attention="gatv2", mesh_shape="data:1")
    with pytest.raises(ValueError, match="gatv2"):
        ShardedTrainer(_port(s, 2, 0.1, torch.float32), cfg, g, s, item_feats=feats.numpy())


def test_signs_pack_and_the_kernels_dropout_arguments():
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.random((50, 2, 32)) > 0.5)
    for vec in (4, 8):
        packed = op.pack_signs(pos, vec)
        assert packed.shape == (50, 64 // vec) and packed.dtype == torch.uint8
        assert torch.equal(op.unpack_signs(packed, 2, 32), pos)
    masked, seed, thresh, scale, off = op._drop(0.1, 4000000000, 7)
    mask = dropout_mask_mh(build_graph(np.arange(5), np.arange(5), 5), 0.1, 4000000000, 2, "cpu", 7)
    assert (masked, seed, off) == (1, 4000000000, 7) and thresh == int(0.9 * 2 ** 32)
    assert set(mask.unique().tolist()) <= {0.0, scale}
    assert op._drop(0.0, 5, 0)[0] == 0 and op._drop(0.1, None, 0)[0] == 0


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


def _card_graph(rng, n=6000, e=60000):
    """Destination 3 has 10,000 in-edges and source 5 10,000 out-edges
    (split rows in both walks); the last sixth of the nodes has no edge at
    all."""
    src = rng.integers(0, n * 5 // 6, e)
    dst = rng.integers(0, n * 5 // 6, e)
    dst[:10000], src[10000:20000] = 3, 5
    return build_graph(src, dst, n)


def _inputs(rng, g, heads, d, rows, dev):
    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)
    xl, xr = t(g.n_nodes, heads, d, scale=0.3), t(g.n_nodes, heads, d, scale=0.3)
    a = t(heads, d, scale=0.3)
    return xl.to(rows).contiguous(), xr, a, t(g.n_nodes, heads, d)


def _hold(got, want, tol):
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **tol)


def _hold_row_sums(got, want, rows, terms_abs):
    """A node's sum over its edges (dxr over in-edges, dxl over out-edges)
    within SUM_TOL plus twice the bound of an f32 sum in any order, (its
    entries) x 2^-24 x sum |terms|: the star's 10,000 terms of either sign
    cancel to a small sum that the band alone would hold to ~1e-4."""
    depth = torch.bincount(rows, minlength=got.shape[0]).to(got.dtype)[:, None, None]
    mag = torch.zeros_like(got).index_add_(0, rows, terms_abs)
    bound = SUM_TOL["atol"] + SUM_TOL["rtol"] * want.abs() + 2 * 2.0 ** -24 * depth * mag
    excess = (got - want).abs() - bound
    assert bool((excess <= 0).all()), float(excess.max())


def _kernels_against_plain(g, rl, xr, a, grad, rate, seed):
    out, den = op.gatv2_fwd(rl, xr, a, g, rate, seed)
    want_out, want_den = op.gatv2_fwd_plain(rl, xr, a, g, rate, seed)
    _hold((out, den), (want_out, want_den), KERNEL_TOL)
    dxr, da, edge, signs = op.gatv2_bwd_dst(rl, xr, a, grad, want_out, want_den, g, rate, seed)
    w_dxr, w_da, w_edge, w_signs = op.gatv2_bwd_dst_plain(rl, xr, a, grad, want_out, want_den, g, rate, seed)
    _hold((edge,), (w_edge,), SUM_TOL)
    _hold_row_sums(dxr, w_dxr, g.dst.long(), w_edge[:, :, 1:2].abs() * a.abs())
    torch.testing.assert_close(da, w_da, rtol=SUM_TOL["rtol"], atol=SUM_TOL["atol"] * g.n_edges ** 0.5)
    z = rl.float()[g.src.long()] + xr[g.dst.long()]
    clear = (z.abs() > 1e-6).reshape(g.n_edges, -1, op.vec_of(rl.dtype)).all(-1)
    assert torch.equal(signs[clear], w_signs[clear])
    dxl = op.gatv2_bwd_src(grad, a, w_edge, w_signs, g)
    terms = w_edge[:, :, :1].abs() * grad[g.dst.long()].abs() + w_edge[:, :, 1:2].abs() * a.abs()
    _hold_row_sums(dxl, op.gatv2_bwd_src_plain(grad, a, w_edge, w_signs, g), g.src.long(), terms)
    again = (op.gatv2_fwd(rl, xr, a, g, rate, seed),
             op.gatv2_bwd_dst(rl, xr, a, grad, want_out, want_den, g, rate, seed),
             op.gatv2_bwd_src(grad, a, w_edge, w_signs, g))
    for x, y in zip((out, den, dxr, da, edge, signs, dxl), (*again[0], *again[1], again[2])):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernels_match_plain_at_two_heads_of_128(cuda, rows, rate):
    rng = np.random.default_rng(5)
    g = _card_graph(rng).to(cuda)
    rl, xr, a, grad = _inputs(rng, g, 2, 128, rows, cuda)
    before = [cuda_build.COUNTERS[k].count for k in ("gatv2_fwd", "gatv2_bwd_dst", "gatv2_bwd_src")]
    _kernels_against_plain(g, rl, xr, a, grad, rate, 2 ** 32 - 5)
    after = [cuda_build.COUNTERS[k].count for k in ("gatv2_fwd", "gatv2_bwd_dst", "gatv2_bwd_src")]
    assert [y - x for x, y in zip(before, after)] == [2, 2, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("heads,d", [(1, 32), (1, 128), (1, 512), (3, 64), (8, 128), (2, 512)])
@pytest.mark.parametrize("rows", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernels_match_plain_at_other_widths(cuda, heads, d, rows):
    rng = np.random.default_rng(heads * d)
    g = _card_graph(rng, n=3000, e=25000).to(cuda)
    rl, xr, a, grad = _inputs(rng, g, heads, d, rows, cuda)
    _kernels_against_plain(g, rl, xr, a, grad, 0.1, 77)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,d", [(2, 96), (12, 32), (2, 128)])
def test_the_op_matches_its_plain_versions(cuda, heads, d):
    """`gatv2_attention` (D padded, heads in groups) forward and gradients
    on the kernels against the same op inside `reference_versions()`."""
    rng = np.random.default_rng(heads + d)
    g = _card_graph(rng, n=3000, e=25000).to(cuda)
    xl, xr, a, grad = (t.float().requires_grad_(True) for t in _inputs(rng, g, heads, d, torch.float32, cuda))

    def run():
        out = op.gatv2_attention(xl, xr, a, g, 0.1, 99, torch.bfloat16, layer=0)
        return (out, *torch.autograd.grad((out * grad.detach()).sum(), (xl, xr, a)))

    got = run()
    with reference_versions():
        want = run()
    _hold(got[:1], want[:1], KERNEL_TOL)
    _hold(got[1:3], want[1:3], SUM_TOL)
    torch.testing.assert_close(got[3], want[3], rtol=SUM_TOL["rtol"], atol=SUM_TOL["atol"] * g.n_edges ** 0.5)


@pytest.mark.cuda
def test_misshapen_rows_raise(cuda):
    rng = np.random.default_rng(1)
    g = _card_graph(rng, n=3000, e=25000).to(cuda)
    rl, xr, a, _ = _inputs(rng, g, 2, 96, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="power of two"):
        op.gatv2_fwd(rl, xr, a, g)
    rl, xr, a, _ = _inputs(rng, g, 2, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="aligned|contiguous"):
        op.gatv2_fwd(rl, xr.transpose(1, 2).contiguous().transpose(1, 2), a, g)
