"""The port's sharded attention, SpMM and steps on 2 gloo CPU ranks against
the JAX package: its sharded steps on 2 of conftest's 8 virtual devices
(parameters carried across) and its XLA goldens; mirrors
tests/test_spmd.py. One spawn of 2 ranks runs every case
(`parallel/cases.run_cases`); each test holds its own case."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.graphs.csr import build_bipartite_graph
from plotpointe_tpu.graphs.csr import symmetric_normalized_weights as jax_weights
from plotpointe_tpu.models.gat import GATModel as JaxGAT
from plotpointe_tpu.ops.segment import segment_softmax_attention as jax_golden
from plotpointe_tpu.ops.segment import spmm as jax_spmm_golden
from plotpointe_tpu.parallel.mesh import make_mesh as jax_make_mesh
from plotpointe_tpu.parallel.sharded_table import device_put_row_sharded as jax_put_rows
from plotpointe_tpu.parallel.spmd import (
    make_sharded_gat_step_fused as jax_fused_step, make_sharded_spmm as jax_sharded_spmm,
    make_sharded_train_step as jax_train_step, shard_graph_by_edges as jax_shard_edges,
    shard_layout_by_tiles)
from plotpointe_tpu.train.losses import bpr_loss
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.parallel.cases import run_cases
from plotpointe_tpu_torch.parallel.multihost import spawn
from plotpointe_tpu_torch.parallel.spmd import local_graph, shard_graph_by_edges
from plotpointe_tpu_torch.train.checkpoint import params_from_jax
from plotpointe_tpu_torch.train.losses import bpr_loss as port_bpr

F32 = dict(rtol=5e-4, atol=1e-4)  # ROADMAP's f32 band for sharded steps against JAX's
FWD = dict(rtol=1e-4, atol=1e-5)  # forward rows: the same function, sums in another order
NU, NI, H, B = 60, 40, 16, 64


def _flat(params) -> dict:
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _flat_grads(grads) -> dict:
    return {k: v for k, v in params_from_jax(_flat(grads)).items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    tu = rng.integers(0, NU, 400).astype(np.int32)
    ti = rng.integers(0, NI, 400).astype(np.int32)
    src, dst = np.concatenate([tu, ti + NU]), np.concatenate([ti + NU, tu])
    g = build_bipartite_graph(tu, ti, NU, NI, pad_multiple=64)
    feats = rng.normal(size=(NI, 16)).astype(np.float32)
    model = JaxGAT(n_users=NU, n_items=NI, feat_dim=16, hidden_dim=H, n_layers=2)
    params = model.init(jax.random.key(0))
    u, i, j = (rng.integers(0, n, B).astype(np.int32) for n in (NU, NI, NI))
    h2 = rng.normal(size=(NU + NI, 2, H)).astype(np.float32)
    h1 = rng.normal(size=(NU + NI, 1, H)).astype(np.float32)
    a = [rng.normal(size=(k, H)).astype(np.float32) for k in (2, 2, 1, 1)]
    ct2, ct1 = (rng.normal(size=s).astype(np.float32) for s in ((NU + NI, 2, H), (NU + NI, 1, H)))
    x = rng.normal(size=(NU + NI, 16)).astype(np.float32)
    ctx = rng.normal(size=(NU + NI, 16)).astype(np.float32)
    return dict(g=g, src=src, dst=dst, feats=feats, model=model, params=params, u=u, i=i, j=j,
                h2=h2, h1=h1, a=a, ct2=ct2, ct1=ct1, x=x, ctx=ctx)


def _cases(s):
    graph = dict(src=s["src"], dst=s["dst"], n_nodes=NU + NI)
    cfg = s["model"].config_dict() | {"attn_dropout": 0.0}
    step = dict(kind="gat_step", **graph, model=cfg, params=_flat(s["params"]),
                item_feats=s["feats"], u=s["u"], i=s["i"], j=s["j"])
    vals = build_graph(s["src"], s["dst"], NU + NI)
    from plotpointe_tpu_torch.graphs.csr import symmetric_normalized_weights

    spmm = dict(kind="spmm", **graph, values=symmetric_normalized_weights(vals), x=s["x"],
                ct=s["ctx"])
    return {
        "attention": dict(kind="attention", **graph, h=s["h2"], a_src=s["a"][0], a_dst=s["a"][1],
                          ct=s["ct2"]),
        "attention_fused": dict(kind="attention", **graph, h=s["h1"], a_src=s["a"][2],
                                a_dst=s["a"][3], ct=s["ct1"], hs_dtype="float32"),
        "train_step": dict(step, builder="make_sharded_train_step"),
        "fused_step": dict(step, builder="make_sharded_gat_step_fused", hs_dtype="float32",
                           overlay_dtype=None),
        "fused_step_bf16": dict(step, builder="make_sharded_gat_step_fused", hs_dtype="float32",
                                overlay_dtype="bfloat16"),
        "fused_step_dropout": dict(step, builder="make_sharded_gat_step_fused", hs_dtype="float32",
                                   overlay_dtype=None, dropout_rate=0.3, seeds=[123456789, 987654]),
        "spmm": dict(spmm, overlay_dtype=None),
        "spmm_bf16": dict(spmm, overlay_dtype="bfloat16"),
    }


@pytest.fixture(scope="module")
def ranks(setup):
    cases = _cases(setup)
    out = spawn(run_cases, 2, (list(cases.values()),), device="cpu", timeout_s=300)
    return [dict(zip(cases, r)) for r in out]


@pytest.fixture(scope="module")
def mesh2():
    return jax_make_mesh({"data": 2}, devices=jax.devices()[:2])


def _jax_ref_loss(s, p):
    gd = s["g"].to_device()
    z = s["model"].apply(p, jnp.asarray(s["feats"]), gd)
    U, I = z[:NU], z[NU:]
    return bpr_loss(jnp.sum(U[s["u"]] * I[s["i"]], -1), jnp.sum(U[s["u"]] * I[s["j"]], -1))


def _hold_grads(got: dict, want: dict, tol=F32):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **tol)


def test_partition_owns_whole_destinations(setup):
    """Each rank's local graph holds every in-edge of its destination range
    and nothing else; the ranges are balanced by edge count."""
    g = build_graph(setup["src"], setup["dst"], NU + NI)
    for n in (2, 3, 4):
        lay = shard_graph_by_edges(g, n)
        assert lay.bounds[0] == 0 and lay.bounds[-1] == NU + NI and sum(lay.counts) == NU + NI
        rp = g.row_ptr.numpy()
        for k in range(n):
            loc = local_graph(g, lay, k)
            lo, hi = loc.lo, loc.hi
            assert loc.e_lo == rp[lo] and loc.graph.n_edges == rp[hi] - rp[lo]
            deg = np.diff(loc.graph.row_ptr.numpy())
            np.testing.assert_array_equal(deg[lo:hi], np.diff(rp)[lo:hi])
            assert deg[:lo].sum() == deg[hi:].sum() == 0
            np.testing.assert_array_equal(loc.graph.src.numpy(), g.src.numpy()[rp[lo]:rp[hi]])
            order = np.lexsort((loc.graph.dst.numpy(), loc.graph.src.numpy()))
            np.testing.assert_array_equal(loc.graph.t_eid.numpy(), order)
        assert max(np.diff(lay.e_bounds)) <= g.n_edges / n + np.diff(rp).max()


@pytest.mark.multihost
def test_sharded_attention_matches_jax_golden(setup, ranks):
    """2 heads (kernel 8's dispatch) at f32 rows: the output and the
    gradients of h, a_src, a_dst on every rank = autograd of JAX's golden."""
    s = setup
    args = [jnp.asarray(s["h2"]), jnp.asarray(s["a"][0]), jnp.asarray(s["a"][1])]
    gd = s["g"].to_device()
    out, vjp = jax.vjp(lambda *xs: jax_golden(*xs, gd), *args)
    grads = vjp(jnp.asarray(s["ct2"]))
    for r in ranks:
        got = r["attention"]
        np.testing.assert_allclose(got["out"], np.asarray(out), **FWD)
        for k, w in zip(("dh", "da_src", "da_dst"), grads):
            np.testing.assert_allclose(got[k], np.asarray(w), err_msg=k, **F32)


@pytest.mark.multihost
def test_sharded_fused_attention_matches_jax_golden(setup, ranks):
    s = setup
    args = [jnp.asarray(s["h1"]), jnp.asarray(s["a"][2]), jnp.asarray(s["a"][3])]
    gd = s["g"].to_device()
    out, vjp = jax.vjp(lambda *xs: jax_golden(*xs, gd), *args)
    grads = vjp(jnp.asarray(s["ct1"]))
    for r in ranks:
        got = r["attention_fused"]
        np.testing.assert_allclose(got["out"], np.asarray(out), **FWD)
        for k, w in zip(("dh", "da_src", "da_dst"), grads):
            np.testing.assert_allclose(got[k], np.asarray(w), err_msg=k, **F32)


@pytest.mark.multihost
def test_sharded_train_step_matches_jax(setup, ranks, mesh2):
    """The legacy replicated step = JAX's `make_sharded_train_step` on 2
    devices (and its single-device reference), parameters carried across."""
    s = setup
    g2 = jax_shard_edges(s["g"], 2)
    step = jax_train_step(s["model"], "bpr", mesh2, NU, NI)
    grads, loss = step(s["params"], jnp.asarray(s["feats"]), jnp.asarray(g2.src), jnp.asarray(g2.dst),
                       *(jnp.asarray(s[k]) for k in "uij"))
    want_loss = float(_jax_ref_loss(s, s["params"]))
    for r in ranks:
        got = r["train_step"]
        np.testing.assert_allclose(got["loss"], float(loss), **F32)
        np.testing.assert_allclose(got["loss"], want_loss, **F32)
        _hold_grads(got["grads"], _flat_grads(grads))


@pytest.mark.multihost
def test_sharded_fused_gat_step_matches_jax(setup, ranks, mesh2):
    """Kernels 1-3 per rank (f32 rows, exact overlays) = JAX's fused step on
    2 devices: loss and gradients, padded user rows' gradients exactly 0."""
    s = setup
    stacked = shard_layout_by_tiles(s["g"], 2, nb=8, eb=128)
    sp = dict(s["params"], user_emb=jax_put_rows(s["params"]["user_emb"], mesh2))
    step = jax_fused_step(s["model"], "bpr", mesh2, NU, NI, stacked, hs_dtype=jnp.float32,
                          overlay_dtype=None)
    grads, loss = step(sp, jnp.asarray(s["feats"]), jax.random.key(9), *(jnp.asarray(s[k]) for k in "uij"))
    want = _flat_grads(grads)
    for r in ranks:
        got = r["fused_step"]
        np.testing.assert_allclose(got["loss"], float(loss), **F32)
        _hold_grads(got["grads"], want)
        assert got["grads"]["user_emb"].shape[0] == 60  # padded to the mesh: 60 divides 2
    # both ranks hold the same loss; each its own block of the user grads
    assert ranks[0]["fused_step"]["loss"] == ranks[1]["fused_step"]["loss"]


@pytest.mark.multihost
def test_sharded_fused_gat_step_bf16_overlay(ranks):
    """bf16 overlays (JAX's default) round each written value only: the loss
    within 5e-3 of the exact step, gradients finite and near."""
    for r in ranks:
        exact, cheap = r["fused_step"], r["fused_step_bf16"]
        np.testing.assert_allclose(cheap["loss"], exact["loss"], rtol=5e-3)
        for k, v in cheap["grads"].items():
            assert np.isfinite(v).all(), k
        np.testing.assert_allclose(cheap["grads"]["user_emb"], exact["grads"]["user_emb"], atol=5e-4)


@pytest.mark.multihost
def test_sharded_dropout_step_equals_single_device(setup, ranks):
    """With attention dropout the ranks draw the single-device hash mask
    (canonical ids from e_lo on): the 2-rank step's loss and gradients =
    the single-device forward's with the same seeds."""
    s = setup
    cfg = s["model"].config_dict() | {"attn_dropout": 0.3}
    model = GATModel.from_config(cfg)
    model.load_state_dict(params_from_jax(_flat(s["params"])))
    g = build_graph(s["src"], s["dst"], NU + NI)
    z = model(torch.as_tensor(s["feats"]), g, train=True, seeds=[123456789, 987654])
    U, I = z[:NU], z[NU:]
    u, i, j = (torch.as_tensor(s[k]).long() for k in "uij")
    loss = port_bpr((U[u] * I[i]).sum(-1), (U[u] * I[j]).sum(-1))
    loss.backward()
    loss = loss.detach()
    want = {k: p.grad for k, p in model.named_parameters()}
    for r in ranks:
        got = r["fused_step_dropout"]
        np.testing.assert_allclose(got["loss"], float(loss), **F32)
        _hold_grads(got["grads"], want)
    assert ranks[0]["fused_step_dropout"]["loss"] != ranks[0]["fused_step"]["loss"]


@pytest.mark.multihost
def test_sharded_spmm_matches_jax(setup, ranks, mesh2):
    """Kernel 7 per rank + the exact overlay = JAX's `make_sharded_spmm` on
    2 devices (f32 rows): y and the gradient of sum(y * ct)."""
    s = setup
    vals = jax_weights(s["g"])
    op = jax_sharded_spmm(mesh2, s["g"], vals, nb=8, eb=128, xs_dtype=jnp.float32, overlay_dtype=None)
    x, ct = jnp.asarray(s["x"]), jnp.asarray(s["ctx"])
    y, vjp = jax.vjp(op, x)
    (dx,) = vjp(ct)
    gd = s["g"].to_device()
    want_y = jax_spmm_golden(gd, jnp.asarray(vals), x)
    for r in ranks:
        got = r["spmm"]
        np.testing.assert_allclose(got["y"], np.asarray(y), **FWD)
        np.testing.assert_allclose(got["y"], np.asarray(want_y), **FWD)
        np.testing.assert_allclose(got["dx"], np.asarray(dx), **F32)


@pytest.mark.multihost
def test_sharded_spmm_bf16_overlay(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["spmm_bf16"]["y"], r["spmm"]["y"], rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(r["spmm_bf16"]["dx"], r["spmm"]["dx"], rtol=1e-2, atol=1e-2)
