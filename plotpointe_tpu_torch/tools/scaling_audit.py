"""Scaling audit of the sharded GAT step: its collectives, their wire
bytes, and a predicted efficiency on NVLink.

Counterpart of `plotpointe_tpu/tools/scaling_audit.py`. What can be shown
without several GPUs:

  1. Collective audit. JAX parses the lowered StableHLO; the port has no
     lowered module, and every collective goes through
     `parallel/collectives.py`, whose recorder lists each call (kind,
     shape, dtype, bytes). `audit_collectives` gives the list a step of
     `make_sharded_gat_step` makes at n shards from the shapes alone (the
     largest owned range of `shard_graph_by_edges`, the table block, the
     replicated parameters); the tests and `chip_smoke.py` hold it equal
     to what the recorder lists in a real step.
  2. Measured CPU trend. The step on n gloo CPU ranks (spawned), as edges a
     second: ranks share one host's cores, so this shows the collectives
     working and their overhead, not a speedup.
  3. Prediction. `wire_bytes_per_chip` (the ring cost per rank) over the
     link rate against the single-card step time gives a no-overlap lower
     bound on scaling efficiency:
         eff(n) = (T1/n) / (T1/n + wire_bytes(n)/BW)
     JAX's formulas, unchanged. BW is NVIDIA's spec for the H100 SXM's
     NVLink 4: 450 GB/s per direction (900 GB/s both ways); no machine here
     can measure it. T1 is the card's own measured sharded GAT step
     (`chip_smoke.py` path 14 prints it), passed as --step-time-s. The
     result is a prediction from a spec, not a measurement.

    python -m plotpointe_tpu_torch.tools.scaling_audit --step-time-s 0.016 [--json]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np

# per-direction link rate, GB/s (NVIDIA's H100 SXM spec: NVLink 4, 18 links;
# 900 GB/s is both directions together)
NVLINK_GBPS = {"h100_sxm": 450.0}
AMAZON = dict(n_users=192_403, n_items=63_001, n_interactions=1_689_116)


def wire_bytes_per_chip(collectives: List[Dict], n: int) -> float:
    """Ring-algorithm wire traffic per rank per step.

    all_reduce of per-rank payload S: 2*S*(n-1)/n on the wire;
    all_gather (operand = local rows S_l): S_l*(n-1) received;
    reduce_scatter (operand = full per-rank S): S*(n-1)/n;
    collective_permute / all_to_all: payload S.
    """
    total = 0.0
    for c in collectives:
        s = float(c["bytes"])
        if c["op"] == "all_reduce":
            total += 2.0 * s * (n - 1) / n
        elif c["op"] == "all_gather":
            total += s * (n - 1)
        elif c["op"] == "reduce_scatter":
            total += s * (n - 1) / n
        else:
            total += s
    return total


def _c(op: str, shape) -> Dict:
    """One collective of an f32 payload of `shape`, as the recorder lists it."""
    return {"op": op, "shape": "x".join(map(str, shape)) or "scalar", "dtype": "float32",
            "bytes": int(np.prod(shape, dtype=np.int64)) * 4}


def step_collectives(n_shards: int, max_rows: int, n_users: int, hidden: int, layers: int,
                     n_replicated: int) -> List[Dict]:
    """The collectives of one `make_sharded_gat_step` step per rank:
    forward, the user table block's all_gather, each layer's owned rows'
    all_gather (padded to `max_rows`) and the loss all_reduce; backward,
    each layer's reduce_scatter, the table's reduce_scatter and one
    all_reduce of the replicated parameters' gradients (`n_replicated`
    values); every payload f32."""
    rs = (n_users + n_shards - 1) // n_shards
    fwd = ([_c("all_gather", (rs, hidden))] + [_c("all_gather", (max_rows, hidden))] * layers
           + [_c("all_reduce", ())])
    bwd = ([_c("reduce_scatter", (n_shards * max_rows, hidden))] * layers
           + [_c("reduce_scatter", (n_shards * rs, hidden)), _c("all_reduce", (n_replicated,))])
    return fwd + bwd


def replicated_param_count(feat_dim: int, hidden: int, layers: int, heads: int = 1,
                           use_bias: bool = False) -> int:
    """Values of the GAT's replicated parameters: item_proj and every layer."""
    per_layer = hidden * heads * hidden + 2 * heads * hidden + (hidden if use_bias else 0)
    return feat_dim * hidden + hidden + layers * per_layer


def audit_collectives(n_shards: int, graph, n_users: int, hidden: int = 128, layers: int = 2,
                      heads: int = 1, feat_dim: int = 384) -> Dict:
    """Static per-step inventory at n shards of `graph` (no execution): the
    partition's largest owned range sizes the overlays."""
    from plotpointe_tpu_torch.parallel.spmd import shard_graph_by_edges

    max_rows = max(shard_graph_by_edges(graph, n_shards).counts)
    colls = step_collectives(n_shards, max_rows, n_users, hidden, layers,
                             replicated_param_count(feat_dim, hidden, layers, heads))
    return summarize(colls, n_shards) | {"max_rows": max_rows}


def summarize(colls: List[Dict], n_shards: int) -> Dict:
    by_op: Dict[str, int] = {}
    for c in colls:
        by_op[c["op"]] = by_op.get(c["op"], 0) + 1
    return {"n_shards": n_shards, "collective_count": len(colls), "collective_ops": by_op,
            "payload_bytes_per_device": int(sum(c["bytes"] for c in colls)),
            "wire_bytes_per_chip": int(wire_bytes_per_chip(colls, n_shards)), "collectives": colls}


def same_collectives(a: List[Dict], b: List[Dict]) -> bool:
    """The same calls (kind, bytes, dtype), in any order."""
    key = lambda c: (c["op"], c["bytes"], c["dtype"])  # noqa: E731
    return sorted(map(key, a)) == sorted(map(key, b))


def predict_efficiency(audits: List[Dict], step_time_1chip_s: float,
                       link_gbps: float = NVLINK_GBPS["h100_sxm"]) -> Dict:
    """No-overlap lower bound on scaling efficiency from the audited wire
    traffic: eff(n) = (T1/n) / (T1/n + wire_bytes(n)/BW)."""
    bw = link_gbps * 1e9
    out = {}
    for a in audits:
        n = a["n_shards"]
        if n == 1:
            out["gat_scaling_pred_eff_1dev"] = 1.0
            continue
        t_comp = step_time_1chip_s / n
        t_comm = a["wire_bytes_per_chip"] / bw
        out[f"gat_scaling_pred_eff_{n}dev"] = round(t_comp / (t_comp + t_comm), 3)
        out[f"gat_scaling_wire_mb_{n}dev"] = round(a["wire_bytes_per_chip"] / 1e6, 1)
    return out


def synthetic_graph(n_users: int, n_items: int, n_edges: int, seed: int = 0):
    """Uniform random bipartite interactions at the given cardinalities."""
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph

    rng = np.random.default_rng(seed)
    return build_bipartite_graph(rng.integers(0, n_users, n_edges), rng.integers(0, n_items, n_edges),
                                 n_users, n_items)


def _trend_rank(n_users: int, n_items: int, n_edges: int, hidden: int, layers: int,
                batch: int) -> Optional[float]:
    """One gloo CPU rank of the measured trend: three timed steps of
    `make_sharded_gat_step`; rank 0 returns edges a second."""
    import torch

    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.parallel.mesh import make_mesh
    from plotpointe_tpu_torch.parallel.sharded_table import device_put_row_sharded
    from plotpointe_tpu_torch.parallel.spmd import make_sharded_gat_step

    mesh = make_mesh(device="cpu")
    rng = np.random.default_rng(0)
    g = synthetic_graph(n_users, n_items, n_edges)
    model = GATModel(n_users=n_users, n_items=n_items, feat_dim=64, hidden_dim=hidden,
                     n_layers=layers, attn_dropout=0.0)
    model.init_params(torch.Generator().manual_seed(0))
    step = make_sharded_gat_step(model, "bpr", mesh, n_users, n_items, g)
    params = {k: v.detach() for k, v in model.named_parameters()}
    params["user_emb"] = device_put_row_sharded(params["user_emb"], mesh)
    feats = torch.as_tensor(rng.normal(size=(n_items, 64)).astype(np.float32))
    b = batch - batch % mesh.n_shards
    u, i, j = (torch.as_tensor(rng.integers(0, n, b).astype(np.int32))
               for n in (n_users, n_items, n_items))
    step(params, feats, None, u, i, j)  # warm-up
    t0 = time.perf_counter()
    for _ in range(3):
        step(params, feats, None, u, i, j)
    dt = (time.perf_counter() - t0) / 3
    return 2 * n_edges * layers / dt if mesh.rank == 0 else None


def measured_cpu_trend(shard_counts, n_users=6_000, n_items=2_000, n_edges=60_000,
                       hidden: int = 64, layers: int = 2, batch: int = 8_192) -> Dict:
    """The step on n spawned gloo CPU ranks for each n: ranks share the
    host's cores, so this shows the collectives and their overhead, NOT a
    speedup."""
    from plotpointe_tpu_torch.parallel.multihost import spawn

    out = {}
    for n in shard_counts:
        eps = spawn(_trend_rank, n, (n_users, n_items, n_edges, hidden, layers, batch),
                    device="cpu")[0]
        out[f"cpu_mesh_edges_per_sec_{n}dev"] = round(eps)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", action="store_true", help="print one JSON line")
    ap.add_argument("--step-time-s", type=float, required=True,
                    help="the card's measured single-card sharded GAT step at the Amazon shape "
                         "(chip_smoke.py path 14)")
    ap.add_argument("--edges", type=int, default=60_000,
                    help="edge count of the measured CPU trend (the audit is at the Amazon shape)")
    ap.add_argument("--shards", default="1,2,4,8")
    ap.add_argument("--skip-measured", action="store_true")
    args = ap.parse_args(argv)

    counts = [int(c) for c in args.shards.split(",")]
    graph = synthetic_graph(AMAZON["n_users"], AMAZON["n_items"], AMAZON["n_interactions"])
    audits = [audit_collectives(c, graph, AMAZON["n_users"]) for c in counts]
    result: Dict = {"gat_scaling_shards": counts, "link": "h100_sxm NVLink 4, 450 GB/s per direction "
                    "(NVIDIA spec)", "prediction": "prediction (NVLink spec), not measured"}
    for a in audits:
        result[f"gat_scaling_collectives_{a['n_shards']}dev"] = a["collective_count"]
    result.update(predict_efficiency(audits, args.step_time_s))
    if not args.skip_measured:
        n_e = args.edges
        result["cpu_trend_note"] = "gloo CPU ranks on one host: correctness and overhead, not speedup"
        result.update(measured_cpu_trend(counts, n_users=max(100, n_e // 10),
                                         n_items=max(50, n_e // 30), n_edges=n_e))
    if args.json:
        print(json.dumps(result))
        return
    print(f"Sharded GAT step collective audit (Amazon shape, H100 SXM NVLink 450 GB/s per "
          f"direction, spec; T1={args.step_time_s * 1e3:.2f} ms measured):")
    for a in audits:
        n = a["n_shards"]
        eff = result.get(f"gat_scaling_pred_eff_{n}dev", 1.0)
        print(f"  {n} shard(s): {a['collective_count']:3d} collectives {a['collective_ops']}, "
              f"wire {a['wire_bytes_per_chip'] / 1e6:8.1f} MB/rank, predicted eff >= {eff:.1%} "
              "(prediction, not measured)")
    for k, v in result.items():
        if k.startswith("cpu_mesh"):
            print(f"  {k}: {v:,} (correctness and overhead, not speedup)")


if __name__ == "__main__":
    main()
