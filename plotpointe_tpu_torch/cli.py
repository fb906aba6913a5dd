"""CLI — `python -m plotpointe_tpu_torch <command>`.

Counterpart of `plotpointe_tpu/cli.py` for the ported commands:
  train   interactions (+ item features for the GAT) -> best checkpoint +
          metrics JSON (GAT or LightGCN; --mesh is a later slice)
  export  checkpoint + interactions (+ item features for the GAT) ->
          item_embeddings.npy
  serve   stdlib HTTP top-K server (--stdlib or $PLOTPOINTE_STDLIB_HTTP; the
          FastAPI app is not ported); --item-embeddings, else
          $ITEM_EMBEDDINGS_URI, is loaded at start
  build-ui      interactions -> ui_edges.npz + node_maps.json + ui_stats.json
  build-subset  full-catalog features + items + interactions ->
                {name}_interacted.npy + interacted_items.json
  build-knn     interacted features -> ii_edges_{name}.npz + ii_{name}_stats.json
  smoke   the five capability checks of tools/smoke_gpu.py (kernel 12
          among them); exit 1 unless every check passes
train, export, serve, build-knn and smoke run on the GPU unless given
`--device cpu`; build-ui and build-subset are numpy on the host. Tables are read from
`{prefix}/interactions.npz` and `{prefix}/items.npz` (column arrays) when
they exist, else from the parquet files.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _cmd_train(args):
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.pipeline import train_from_artifacts

    cfg = TrainConfig.from_env(
        model_family=args.model_family,
        hidden_dim=args.hidden_dim,
        layers=args.layers,
        heads=args.heads,
        epochs=args.epochs,
        samples_per_epoch=args.samples_per_epoch,
        steps_per_epoch=args.steps_per_epoch,
        seed=args.seed,
        eval_neg_k=args.eval_neg_k,
        item_features=args.item_features,
        loss=args.loss,
        structured_logs=args.structured_logs,
        attn_impl=args.attn_impl,
        spmm_impl=args.spmm_impl,
        optimizer=args.optimizer,
        warmup_steps=args.warmup_steps,
        mesh_shape=args.mesh,
    )
    results = train_from_artifacts(cfg, staging_prefix=args.staging_prefix,
                                   embeddings_prefix=args.embeddings_prefix,
                                   models_prefix=args.models_prefix, resume=args.resume,
                                   device=args.device)
    print(json.dumps({"best_val_ndcg@20": results["best_val_ndcg@20"], "test": results["test"]},
                     indent=2))


def _cmd_export(args):
    from plotpointe_tpu_torch.tools.export import export_item_embeddings
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    interactions = store.load_interactions(args.staging_prefix)
    feats = np.asarray(store.load_npy(args.features)) if args.features else None
    emb = export_item_embeddings(store.fetch(args.checkpoint), interactions, feats, args.out,
                                 store=store, device=args.device)
    print(json.dumps({"shape": list(emb.shape), "out": args.out}))


def _cmd_serve(args):
    if not (args.stdlib or os.environ.get("PLOTPOINTE_STDLIB_HTTP")):
        sys.exit("only the stdlib HTTP server is ported: pass --stdlib or set PLOTPOINTE_STDLIB_HTTP")
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig

    rt = None
    uri = args.item_embeddings or os.environ.get("ITEM_EMBEDDINGS_URI")
    if uri:
        rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=uri, topk=args.topk,
                                              device=args.device))
        rt.startup()
    print(json.dumps({"serving": f"http://{args.host}:{args.port}", "loaded": rt is not None,
                      "micro_batch": args.micro_batch}), flush=True)
    serve(args.host, args.port, runtime=rt, block=True, micro_batch=args.micro_batch,
          micro_batch_max=args.micro_batch_max, micro_batch_wait_ms=args.micro_batch_wait_ms)


def _cmd_build_ui(args):
    from plotpointe_tpu_torch.graphs.ui_graph import build_ui_artifacts
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    _, stats = build_ui_artifacts(store.load_interactions(args.staging_prefix), args.output_prefix,
                                  store=store)
    print(json.dumps(stats, indent=2))


def _cmd_build_subset(args):
    from plotpointe_tpu_torch.data.subset import build_interacted_subset
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    subset, asins = build_interacted_subset(
        store.load_npy(args.features, mmap=True), store.load_items(args.staging_prefix),
        store.load_interactions(args.staging_prefix), out_prefix=args.output_prefix,
        feature_name=args.feature_name, store=store)
    print(json.dumps({"shape": list(subset.shape), "n_interacted": len(asins)}))


def _cmd_build_knn(args):
    from plotpointe_tpu_torch.graphs.knn import cosine_knn_graph
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    _, stats = cosine_knn_graph(np.asarray(store.load_npy(args.features)),
                                out_prefix=args.output_prefix, feature_name=args.feature_name,
                                k=args.k, min_similarity=args.min_similarity, store=store,
                                device=args.device)
    print(json.dumps(stats, indent=2))


def _cmd_smoke(args):
    from plotpointe_tpu_torch.tools.smoke_gpu import main as smoke_main

    smoke_main(["--device", args.device])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="plotpointe_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train the GAT or LightGCN")
    t.add_argument("--model-family", choices=["gat", "lightgcn"], default="gat")
    t.add_argument("--staging-prefix", required=True,
                   help="holds interactions.npz (column arrays) or interactions.parquet")
    t.add_argument("--embeddings-prefix", required=True)
    t.add_argument("--models-prefix", required=True)
    t.add_argument("--hidden-dim", type=int, default=128)
    t.add_argument("--layers", type=int, default=2)
    t.add_argument("--heads", type=int, default=1)
    t.add_argument("--epochs", type=int, default=20)
    t.add_argument("--samples-per-epoch", type=int, default=200_000)
    t.add_argument("--steps-per-epoch", type=int, default=1)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--eval-neg-k", type=int, default=1000)
    t.add_argument("--item-features", choices=["fused", "txt"], default="fused")
    t.add_argument("--loss", choices=["bpr", "bce"], default="bpr")
    t.add_argument("--attn-impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="attention row type: pallas (and auto on CUDA) bf16 rows, xla f32 rows")
    t.add_argument("--spmm-impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="LightGCN propagation row type: pallas (and auto on CUDA) bf16 rows, "
                        "xla f32 rows")
    t.add_argument("--optimizer", choices=["adam", "adamw"], default="adam",
                   help="adam = reference parity (coupled L2); adamw decouples decay")
    t.add_argument("--warmup-steps", type=int, default=0, help="linear lr warmup")
    t.add_argument("--structured-logs", action="store_true")
    t.add_argument("--resume", action="store_true",
                   help="save resume state each epoch and continue from it if present")
    t.add_argument("--mesh", default=None, metavar="SPEC", help="sharded training (not ported yet)")
    t.add_argument("--device", default=None, help="default: cuda")
    t.set_defaults(fn=_cmd_train)

    e = sub.add_parser("export", help="checkpoint -> item_embeddings.npy")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--staging-prefix", required=True,
                   help="holds interactions.npz (column arrays) or interactions.parquet")
    e.add_argument("--features", default=None,
                   help="item features npy, first-occurrence order (GAT; LightGCN takes none)")
    e.add_argument("--out", required=True)
    e.add_argument("--device", default=None, help="default: cuda")
    e.set_defaults(fn=_cmd_export)

    s = sub.add_parser("serve", help="top-K retrieval over HTTP")
    s.add_argument("--stdlib", action="store_true",
                   help="stdlib http.server transport (also: $PLOTPOINTE_STDLIB_HTTP)")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--item-embeddings", default=None,
                   help="npy to load at start (default: $ITEM_EMBEDDINGS_URI)")
    s.add_argument("--topk", type=int, default=20)
    s.add_argument("--micro-batch", action="store_true")
    s.add_argument("--micro-batch-max", type=int, default=64)
    s.add_argument("--micro-batch-wait-ms", type=float, default=3.0)
    s.add_argument("--device", default=None, help="default: cuda")
    s.set_defaults(fn=_cmd_serve)

    b = sub.add_parser("build-ui", help="build U-I graph artifacts")
    b.add_argument("--staging-prefix", required=True,
                   help="holds interactions.npz (column arrays) or interactions.parquet")
    b.add_argument("--output-prefix", required=True)
    b.set_defaults(fn=_cmd_build_ui)

    b = sub.add_parser("build-subset", help="slice full-catalog features to interacted items")
    b.add_argument("--staging-prefix", required=True,
                   help="holds items and interactions, each .npz (column arrays) or .parquet")
    b.add_argument("--features", required=True)
    b.add_argument("--output-prefix", required=True)
    b.add_argument("--feature-name", default="txt")
    b.set_defaults(fn=_cmd_build_subset)

    b = sub.add_parser("build-knn", help="build item-item cosine kNN graph")
    b.add_argument("--features", required=True)
    b.add_argument("--output-prefix", required=True)
    b.add_argument("--feature-name", default="fused")
    b.add_argument("--k", type=int, default=20)
    b.add_argument("--min-similarity", type=float, default=0.3)
    b.add_argument("--device", default=None, help="default: cuda")
    b.set_defaults(fn=_cmd_build_knn)

    b = sub.add_parser("smoke", help="GPU capability smoke test (5 checks)")
    b.add_argument("--device", default="cuda", help="default: cuda; cpu runs the plain kernel")
    b.set_defaults(fn=_cmd_smoke)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
