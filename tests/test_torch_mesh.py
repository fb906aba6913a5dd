"""The port's mesh of ranks and the multichip dry run: `parse_mesh_shape`
= JAX's; a 2-D mesh (data:2, model:2) on 4 gloo CPU ranks shards over data
and replicates over model; the launcher's and make_mesh's refusals; and
`dryrun_multichip(2)` on 2 spawned gloo ranks."""
import numpy as np
import pytest
import torch

from plotpointe_tpu.parallel.mesh import parse_mesh_shape as jax_parse
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.parallel.cases import run_cases
from plotpointe_tpu_torch.parallel.mesh import make_mesh, parse_mesh_shape
from plotpointe_tpu_torch.parallel.multihost import spawn
from plotpointe_tpu_torch.tools.multichip_dryrun import dryrun_multichip
from plotpointe_tpu_torch.train.checkpoint import params_to_jax
from plotpointe_tpu_torch.train.losses import bpr_loss

NU, NI = 50, 30


@pytest.mark.parametrize("spec", ["data:4,model:2", "data:8", "model:2, data:2", "data:1"])
def test_parse_mesh_shape_equals_jax(spec):
    assert parse_mesh_shape(spec) == jax_parse(spec)
    assert list(parse_mesh_shape(spec)) == list(jax_parse(spec))


def test_more_ranks_than_gpus_raise():
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        spawn(run_cases, n, ([],))


def test_a_mesh_of_several_ranks_needs_them_launched():
    with pytest.raises(ValueError, match="spawn the ranks"):
        make_mesh({"data": 2}, device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.multihost
def test_2d_mesh_shards_over_data_and_replicates_over_model():
    """4 ranks as data:2 x model:2: each rank's data shard is its first
    coordinate; ranks that differ only in "model" compute the same step
    bit for bit, and the step equals the single-device step's loss and
    gradients (the f32 band)."""
    rng = np.random.default_rng(0)
    tu, ti = rng.integers(0, NU, 300), rng.integers(0, NI, 300)
    model = GATModel(NU, NI, 8, hidden_dim=16, n_layers=2, attn_dropout=0.0)
    model.init_params(torch.Generator().manual_seed(0))
    step = dict(kind="gat_step", src=np.concatenate([tu, ti + NU]), dst=np.concatenate([ti + NU, tu]),
                n_nodes=NU + NI, builder="make_sharded_gat_step", model=model.config_dict(),
                params=params_to_jax(model.state_dict()),
                item_feats=rng.normal(size=(NI, 8)).astype(np.float32),
                **{k: rng.integers(0, n, 32).astype(np.int32) for k, n in zip("uij", (NU, NI, NI))})
    out = spawn(run_cases, 4, ([dict(kind="mesh"), step], "data:2,model:2"), device="cpu",
                timeout_s=200)
    g = build_graph(step["src"], step["dst"], NU + NI)
    z = model(torch.as_tensor(step["item_feats"]), g)  # the single-device step, f32 rows
    u, i, j = (torch.as_tensor(step[k]).long() for k in "uij")
    loss = bpr_loss((z[u] * z[NU + i]).sum(-1), (z[u] * z[NU + j]).sum(-1))
    loss.backward()
    for rank, (mesh, got) in enumerate(out):
        assert mesh["rank"] == rank and mesh["coords"] == (rank // 2, rank % 2)
        assert mesh["shard"] == rank // 2 and mesh["n_shards"] == 2
        assert got["loss"] == out[0][1]["loss"]
        np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=5e-4, atol=1e-4)
        for k, p in model.named_parameters():
            np.testing.assert_array_equal(got["grads"][k], out[rank % 2][1]["grads"][k])  # replicas
            np.testing.assert_allclose(got["grads"][k][:p.shape[0]], p.grad.numpy(), rtol=5e-4,
                                       atol=1e-4, err_msg=k)


@pytest.mark.multihost
def test_dryrun_multichip_on_two_gloo_ranks():
    out = dryrun_multichip(2, device="cpu")
    assert out["ok"] and out["n_devices"] == 2
    assert abs(out["gat_fused_loss"] - out["gat_rowsharded_loss"]) < 1e-3
    for k in ("gat_loss", "lightgcn_loss", "sharded_fit_test_ndcg@20"):
        assert np.isfinite(out[k]), k


def _mesh_of(rank: int, n: int):
    from plotpointe_tpu_torch.parallel.mesh import Mesh

    return Mesh((("data", n),), rank, n, torch.device("cpu"), None, (rank,))


def test_host_placement_takes_each_ranks_rows():
    """`put_sharded` / `process_slice` keep JAX's contiguous blocks and its
    divisibility error; `put_replicated` keeps every row; the placements
    name the sharded axis."""
    from plotpointe_tpu_torch.parallel.mesh import replicated, row_sharded
    from plotpointe_tpu_torch.parallel.multihost import process_slice, put_replicated, put_sharded

    data = np.arange(24, dtype=np.float32).reshape(12, 2)
    for rank in range(4):
        mesh = _mesh_of(rank, 4)
        assert row_sharded(mesh) == ("data",) and replicated(mesh) == ()
        assert process_slice(12, mesh, row_sharded(mesh)) == (3 * rank, 3)
        np.testing.assert_array_equal(put_sharded(data, mesh, row_sharded(mesh)).numpy(),
                                      data[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(put_replicated(data, mesh).numpy(), data)
    with pytest.raises(ValueError, match=r"rows \(10\) must divide shards \(4\)"):
        process_slice(10, _mesh_of(0, 4), ("data",))
