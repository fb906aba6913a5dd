"""Row-sharded tables and the row-sharded steps on 2 gloo CPU ranks against
the JAX package; mirrors tests/test_sharded_table.py. The pure functions
(`shard_size`, `padded_rows`, `dedup_ids`) are held equal to JAX's; the
lookups to the dense table exactly; the LightGCN and GAT steps to JAX's on
2 of conftest's virtual devices, parameters carried across. One spawn of 2
ranks runs every case."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.graphs.csr import build_bipartite_graph
from plotpointe_tpu.graphs.csr import symmetric_normalized_weights as jax_weights
from plotpointe_tpu.models.gat import GATModel as JaxGAT
from plotpointe_tpu.models.lightgcn import LightGCNModel as JaxLightGCN
from plotpointe_tpu.ops.segment import spmm as jax_spmm_golden
from plotpointe_tpu.parallel import sharded_table as jst
from plotpointe_tpu.parallel.mesh import make_mesh as jax_make_mesh
from plotpointe_tpu.parallel.spmd import (
    make_sharded_gat_step as jax_gat_step, make_sharded_lightgcn_step as jax_lightgcn_step,
    shard_graph_by_edges as jax_shard_edges)
from plotpointe_tpu.train.losses import bpr_loss
from plotpointe_tpu_torch.graphs.csr import build_graph, symmetric_normalized_weights
from plotpointe_tpu_torch.parallel import sharded_table as st
from plotpointe_tpu_torch.parallel.cases import run_cases
from plotpointe_tpu_torch.parallel.multihost import spawn
from plotpointe_tpu_torch.train.checkpoint import params_from_jax

F32 = dict(rtol=5e-4, atol=1e-4)
NU, NI, B = 60, 44, 64
CAPACITY = 3


def _flat(params) -> dict:
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    tu = rng.integers(0, NU, 400).astype(np.int32)
    ti = rng.integers(0, NI, 400).astype(np.int32)
    graph = dict(src=np.concatenate([tu, ti + NU]), dst=np.concatenate([ti + NU, tu]),
                 n_nodes=NU + NI)
    g = build_bipartite_graph(tu, ti, NU, NI, pad_multiple=64)
    u, i, j = (rng.integers(0, n, B).astype(np.int32) for n in (NU, NI, NI))
    table = rng.normal(size=(203, 16)).astype(np.float32)  # 203 rows: padded to 204 on 2 ranks
    pool = rng.choice(203, 10, replace=False)
    lookups = {
        "replicated": dict(ids=rng.integers(0, 203, B), w=rng.normal(size=(B, 16))),
        "batch_sharded": dict(ids=rng.integers(0, 203, B), w=rng.normal(size=(B, 16))),
        "dedup": dict(ids=pool[rng.integers(0, 10, B)], w=rng.normal(size=(B, 16))),
        "dedup_uniform": dict(ids=rng.integers(0, 203, B), w=rng.normal(size=(B, 16))),
        "dedup_overflow": dict(ids=np.arange(B)[::-1].copy(), w=rng.normal(size=(B, 16)),
                               capacity=CAPACITY),
    }
    feats = rng.normal(size=(NI, 12)).astype(np.float32)
    gat = {h: JaxGAT(n_users=NU, n_items=NI, feat_dim=12, hidden_dim=16, n_layers=2, heads=h)
           for h in (1, 2)}
    lg = JaxLightGCN(n_users=NU, n_items=NI, embed_dim=16, n_prop_layers=3)
    return dict(g=g, graph=graph, u=u, i=i, j=j, table=table, lookups=lookups, feats=feats, gat=gat,
                gat_params={h: m.init(jax.random.key(h)) for h, m in gat.items()}, lg=lg,
                lg_params=lg.init(jax.random.key(0)),
                x={d: rng.normal(size=(NU + NI, d)).astype(np.float32) for d in (64, 128)},
                ct={d: rng.normal(size=(NU + NI, d)).astype(np.float32) for d in (64, 128)})


def _cases(s):
    batch = {k: s[k] for k in "uij"}
    cases = {f"lookup_{k}": dict(kind="lookup", table=s["table"],
                                 scheme="replicated" if k == "replicated" else
                                 "batch_sharded" if k == "batch_sharded" else "dedup",
                                 ids=v["ids"].astype(np.int32), w=v["w"].astype(np.float32),
                                 **({"capacity": v["capacity"]} if "capacity" in v else {}))
             for k, v in s["lookups"].items()}
    cases["lightgcn_step"] = dict(kind="lightgcn_step", **s["graph"], model=s["lg"].config_dict(),
                                  params=_flat(s["lg_params"]), **batch)
    for h in (1, 2):
        cases[f"gat_step_{h}"] = dict(kind="gat_step", **s["graph"], builder="make_sharded_gat_step",
                                      model=s["gat"][h].config_dict() | {"attn_dropout": 0.0},
                                      params=_flat(s["gat_params"][h]), item_feats=s["feats"], **batch)
    vals = symmetric_normalized_weights(build_graph(s["graph"]["src"], s["graph"]["dst"], NU + NI))
    for d in (64, 128):
        cases[f"spmm_{d}"] = dict(kind="spmm", **s["graph"], values=vals, x=s["x"][d], ct=s["ct"][d])
    return cases


@pytest.fixture(scope="module")
def ranks(setup):
    cases = _cases(setup)
    out = spawn(run_cases, 2, (list(cases.values()),), device="cpu", timeout_s=300)
    return [dict(zip(cases, r)) for r in out]


@pytest.fixture(scope="module")
def mesh2():
    return jax_make_mesh({"data": 2}, devices=jax.devices()[:2])


def test_shard_sizes_equal_jax():
    for n_rows in (0, 1, 7, 203, 204, 192_403):
        for n in (1, 2, 3, 8):
            assert st.shard_size(n_rows, n) == jst.shard_size(n_rows, n)
            assert st.padded_rows(n_rows, n) == jst.padded_rows(n_rows, n)
    t = np.arange(203 * 3, dtype=np.float32).reshape(203, 3)
    np.testing.assert_array_equal(st.pad_table(t, 8).numpy(), np.asarray(jst.pad_table(t, 8)))


@pytest.mark.parametrize("capacity", [1, 5, 16, 40])
def test_dedup_ids_equal_jax(capacity):
    """Sorted unique ids first, SENTINEL_ID fill, truncated to capacity."""
    rng = np.random.default_rng(capacity)
    ids = rng.integers(0, 12, 40).astype(np.int32)
    got = st.dedup_ids(torch.as_tensor(ids), capacity).numpy()
    np.testing.assert_array_equal(got, np.asarray(jst.dedup_ids(jnp.asarray(ids), capacity)))
    assert st.SENTINEL_ID == int(jst.SENTINEL_ID)


def _dense_grad(s, key):
    want = np.zeros_like(s["table"])
    np.add.at(want, s["lookups"][key]["ids"], s["lookups"][key]["w"].astype(np.float32))
    return want


@pytest.mark.multihost
@pytest.mark.parametrize("key", ["replicated", "batch_sharded"])
def test_lookup_matches_dense(setup, ranks, key):
    s = setup
    for r in ranks:
        got = r[f"lookup_{key}"]
        np.testing.assert_array_equal(got["rows"], s["table"][s["lookups"][key]["ids"]])


@pytest.mark.multihost
@pytest.mark.parametrize("key", ["replicated", "batch_sharded"])
def test_lookup_gradient_scatters_to_owner(setup, ranks, key):
    """The gathered table gradient = the dense scatter-add of w; the pad row
    gets 0."""
    for r in ranks:
        grad = r[f"lookup_{key}"]["grad"]
        np.testing.assert_allclose(grad[:203], _dense_grad(setup, key), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(grad[203:], 0.0)


@pytest.mark.multihost
@pytest.mark.parametrize("key", ["dedup", "dedup_uniform"])
def test_lookup_batch_dedup_matches_dense(setup, ranks, key):
    for r in ranks:
        np.testing.assert_array_equal(r[f"lookup_{key}"]["rows"],
                                      setup["table"][setup["lookups"][key]["ids"]])


@pytest.mark.multihost
def test_lookup_batch_dedup_gradient(setup, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["lookup_dedup"]["grad"][:203], _dense_grad(setup, "dedup"),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.multihost
def test_lookup_batch_dedup_capacity_overflow(setup, ranks):
    """Ids past a rank's unique capacity read zeros: in each rank's block of
    distinct ids, the CAPACITY smallest survive."""
    ids = setup["lookups"]["dedup_overflow"]["ids"]
    rows = ranks[0]["lookup_dedup_overflow"]["rows"]
    for blk in range(2):
        sl = slice(blk * B // 2, (blk + 1) * B // 2)
        keep = set(np.sort(ids[sl])[:CAPACITY])
        for k in range(sl.start, sl.stop):
            want = setup["table"][ids[k]] if ids[k] in keep else 0.0
            np.testing.assert_array_equal(rows[k], want)


@pytest.mark.multihost
def test_sharded_lightgcn_step_matches_jax(setup, ranks, mesh2):
    """Kernel 7 per rank, both tables row-sharded = JAX's sharded LightGCN
    step on 2 devices and its single-device reference; pad rows 0."""
    s = setup
    g2 = jax_shard_edges(s["g"], 2)
    vals = jnp.asarray(jax_weights(g2))
    sp = {k: jst.device_put_row_sharded(v, mesh2) for k, v in s["lg_params"].items()}
    grads, loss = jax_lightgcn_step(s["lg"], "bpr", mesh2, NU, NI)(
        sp, vals, jnp.asarray(g2.src), jnp.asarray(g2.dst), *(jnp.asarray(s[k]) for k in "uij"))
    gd = s["g"].to_device()

    def ref(p):
        z = s["lg"].apply(p, None, gd, norm_values=jnp.asarray(jax_weights(s["g"])))
        U, I = z[:NU], z[NU:]
        return bpr_loss(jnp.sum(U[s["u"]] * I[s["i"]], -1), jnp.sum(U[s["u"]] * I[s["j"]], -1))

    want_loss, want_grads = jax.value_and_grad(ref)(s["lg_params"])
    for r in ranks:
        got = r["lightgcn_step"]
        np.testing.assert_allclose(got["loss"], float(loss), **F32)
        np.testing.assert_allclose(got["loss"], float(want_loss), **F32)
        for k, n_rows in (("user_emb", NU), ("item_emb", NI)):
            np.testing.assert_allclose(got["grads"][k], np.asarray(grads[k]), err_msg=k, **F32)
            np.testing.assert_allclose(got["grads"][k][:n_rows], np.asarray(want_grads[k]), **F32)
            np.testing.assert_array_equal(got["grads"][k][n_rows:], 0.0)


@pytest.mark.multihost
@pytest.mark.parametrize("heads", [1, 2])
def test_sharded_gat_step_matches_jax(setup, ranks, mesh2, heads):
    """The row-sharded GAT step (kernels 1-3, or 8, 9 and 3 at 2 heads, f32
    rows) = JAX's `make_sharded_gat_step` on 2 devices: loss, gradients,
    pad-row gradients 0."""
    s = setup
    g2 = jax_shard_edges(s["g"], 2)
    model, params = s["gat"][heads], s["gat_params"][heads]
    sp = dict(params, user_emb=jst.device_put_row_sharded(params["user_emb"], mesh2))
    masks = jnp.ones((2, g2.n_padded, heads), jnp.float32)
    grads, loss = jax_gat_step(model, "bpr", mesh2, NU, NI)(
        sp, jnp.asarray(s["feats"]), jnp.asarray(g2.src), jnp.asarray(g2.dst), masks,
        *(jnp.asarray(s[k]) for k in "uij"))
    want = params_from_jax(_flat(grads))
    for r in ranks:
        got = r[f"gat_step_{heads}"]
        np.testing.assert_allclose(got["loss"], float(loss), **F32)
        for k, w in want.items():
            np.testing.assert_allclose(got["grads"][k], w.numpy(), err_msg=k, **F32)
        np.testing.assert_array_equal(got["grads"]["user_emb"][NU:], 0.0)


@pytest.mark.multihost
@pytest.mark.parametrize("d", [64, 128])
def test_sharded_spmm_matches_jax_golden(setup, ranks, d):
    s = setup
    gd = s["g"].to_device()
    vals = jnp.asarray(jax_weights(s["g"]))
    x, ct = jnp.asarray(s["x"][d]), jnp.asarray(s["ct"][d])
    y, vjp = jax.vjp(lambda xx: jax_spmm_golden(gd, vals, xx), x)
    (dx,) = vjp(ct)
    for r in ranks:
        np.testing.assert_allclose(r[f"spmm_{d}"]["y"], np.asarray(y), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r[f"spmm_{d}"]["dx"], np.asarray(dx), rtol=1e-4, atol=1e-5)
