"""Multi-process smoke: one process of a sharded training run.

Counterpart of `plotpointe_tpu/tools/multihost_smoke.py`. Launch the SAME
command once per process (the pod-launcher pattern):

    python -m plotpointe_tpu_torch.tools.multihost_smoke \\
        --coordinator 127.0.0.1:12355 --num-processes 2 --process-id $I \\
        [--fit] [--family gat|lightgcn] [--device cpu|cuda|cuda:N] [--backend gloo|nccl]

The default mode runs ONE sharded GAT step (`parallel/spmd.py`) on the
group and prints {"loss": ...}: every process must print the same loss
(the collectives crossed the process boundary). --fit runs a whole
`ShardedTrainer.fit()` (2 epochs, eval, checkpoint). The port runs one
rank per device, so `--devices-per-process` must be 1 (JAX's default is
4 virtual CPU devices a process). `--device cuda` puts process k on
`cuda:<k mod the GPU count>`; two processes on one GPU must take
`--backend gloo` (NCCL refuses them), and then the collectives stage
through host tensors ("staged" in the output). Besides JAX's keys each
line carries the backend, the device, whether staging ran, the step's wall
(a correctness reading: the ranks share one host) and, in the one-step
mode, the step's collectives as the recorder listed them.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--devices-per-process", type=int, default=1,
                    help="must be 1: the port runs one rank per device")
    ap.add_argument("--fit", action="store_true", help="run a full ShardedTrainer.fit()")
    ap.add_argument("--family", choices=["gat", "lightgcn"], default="gat")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    args = ap.parse_args(argv)
    if args.devices_per_process != 1:
        ap.error("--devices-per-process must be 1: the port runs one rank per device")

    import torch
    import torch.distributed as dist

    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.data.synthetic import synthetic_interactions
    from plotpointe_tpu_torch.parallel.collectives import STAGED
    from plotpointe_tpu_torch.parallel.mesh import make_mesh
    from plotpointe_tpu_torch.parallel.multihost import maybe_initialize_distributed

    torch.set_num_threads(1)
    maybe_initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                 args.backend, args.device)
    try:
        assert dist.get_world_size() == args.num_processes
        mesh = make_mesh({"data": args.num_processes}, device=args.device)
        # identical data in every process (seeded); each keeps its shards
        inter = synthetic_interactions(n_users=96, n_items=64, n_interactions=1500, seed=5)
        splits = build_splits(inter, *build_node_maps(inter))
        out = _run_fit(mesh, splits, args.family) if args.fit else _run_one_step(mesh, splits)
        out.update({"process_id": mesh.rank, "n_processes": mesh.world_size,
                    "n_devices": mesh.world_size, "backend": mesh.backend,
                    "device": str(mesh.device), "staged": STAGED.count > 0})
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def one_step_problem(splits, n_shards: int, device):
    """The one-step mode's model, inputs and global batch (seeded, the same
    in every process): a 2-layer GAT at hidden 16 on f32 rows, 16-d item
    features, 256 triples rounded up to the mesh."""
    import torch

    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.models.gat import GATModel

    n_users, n_items = splits.n_users, splits.n_items
    rng = np.random.default_rng(0)
    graph = build_bipartite_graph(splits.train_u, splits.train_i, n_users, n_items).to(device)
    model = GATModel(n_users=n_users, n_items=n_items, feat_dim=16, hidden_dim=16, n_layers=2,
                     attn_dropout=0.0)
    model.init_params(torch.Generator().manual_seed(0))
    feats = torch.as_tensor(rng.normal(size=(n_items, 16)).astype(np.float32), device=device)
    b = ((256 + n_shards - 1) // n_shards) * n_shards
    batch = [torch.as_tensor(rng.integers(0, n, b).astype(np.int32), device=device)
             for n in (n_users, n_items, n_items)]
    return graph, model, feats, batch


def _run_one_step(mesh, splits):
    import torch

    from plotpointe_tpu_torch.parallel.collectives import record_collectives
    from plotpointe_tpu_torch.parallel.sharded_table import device_put_row_sharded
    from plotpointe_tpu_torch.parallel.spmd import make_sharded_gat_step

    graph, model, feats, (u, i, j) = one_step_problem(splits, mesh.n_shards, mesh.device)
    step = make_sharded_gat_step(model, "bpr", mesh, splits.n_users, splits.n_items, graph)
    params = {k: v.detach().to(mesh.device) for k, v in model.named_parameters()}
    params["user_emb"] = device_put_row_sharded(params["user_emb"], mesh)  # this process's rows
    with record_collectives() as colls:
        grads, loss = step(params, feats, None, u, i, j)
    t0 = time.perf_counter()
    step(params, feats, None, u, i, j)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return {"loss": round(float(loss), 6),
            "grad_user_norm": round(float(torch.linalg.norm(grads["user_emb"])), 6),
            "step_s": time.perf_counter() - t0, "collectives": colls}


def _run_fit(mesh, splits, family="gat"):
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.train.sharded import ShardedTrainer

    n_users, n_items = splits.n_users, splits.n_items
    rng = np.random.default_rng(0)
    graph = build_bipartite_graph(splits.train_u, splits.train_i, n_users, n_items)
    feats = rng.normal(size=(n_items, 16)).astype(np.float32)
    if family == "lightgcn":
        from plotpointe_tpu_torch.models.lightgcn import LightGCNModel

        model = LightGCNModel(n_users=n_users, n_items=n_items, embed_dim=16, n_prop_layers=2)
        cfg = TrainConfig(model_family="lightgcn", epochs=2, batch_size=512, eval_neg_k=32,
                          hidden_dim=16)
    else:
        from plotpointe_tpu_torch.models.gat import GATModel

        model = GATModel(n_users=n_users, n_items=n_items, feat_dim=16, hidden_dim=16, n_layers=2)
        cfg = TrainConfig(epochs=2, samples_per_epoch=512, eval_neg_k=32, hidden_dim=16, layers=2)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        trainer = ShardedTrainer(model, cfg, graph, splits, item_feats=feats, mesh=mesh)
        res = trainer.fit(checkpoint_path=os.path.join(td, "best.npz"))
    return {"loss": round(float(res["history"][-1]["loss"]), 6),
            "best_val_ndcg20": round(float(res["best_val_ndcg@20"]), 6),
            "test_ndcg20": round(float(res["test"].get("ndcg@20", 0.0)), 6),
            "fit_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
