"""CLI — `python -m plotpointe_tpu_torch <command>`.

Counterpart of `plotpointe_tpu/cli.py` for the ported commands:
  export  checkpoint + interactions + item features -> item_embeddings.npy
  serve   stdlib HTTP top-K server (--stdlib; the FastAPI app is not ported)
Both run on the GPU unless given `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load_interactions(store, prefix: str):
    """`{prefix}/interactions.npz` (a dict of column arrays, no pandas needed)
    when it exists, else `{prefix}/interactions.parquet` (needs pandas)."""
    npz = f"{prefix}/interactions.npz"
    if store.exists(npz):
        return store.load_npz(npz)
    return store.load_parquet(f"{prefix}/interactions.parquet")


def _cmd_export(args):
    from plotpointe_tpu_torch.tools.export import export_item_embeddings
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    interactions = load_interactions(store, args.staging_prefix)
    feats = np.asarray(store.load_npy(args.features))
    emb = export_item_embeddings(store.fetch(args.checkpoint), interactions, feats, args.out,
                                 store=store, device=args.device)
    print(json.dumps({"shape": list(emb.shape), "out": args.out}))


def _cmd_serve(args):
    if not args.stdlib:
        sys.exit("only the stdlib HTTP server is ported: pass --stdlib")
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig

    rt = None
    if args.item_embeddings:
        rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=args.item_embeddings,
                                              topk=args.topk, device=args.device))
        rt.startup()
    print(json.dumps({"serving": f"http://{args.host}:{args.port}", "loaded": rt is not None,
                      "micro_batch": args.micro_batch}), flush=True)
    serve(args.host, args.port, runtime=rt, block=True, micro_batch=args.micro_batch,
          micro_batch_max=args.micro_batch_max, micro_batch_wait_ms=args.micro_batch_wait_ms)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="plotpointe_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("export", help="checkpoint -> item_embeddings.npy")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--staging-prefix", required=True,
                   help="holds interactions.npz (column arrays) or interactions.parquet")
    e.add_argument("--features", required=True, help="item features npy, first-occurrence order")
    e.add_argument("--out", required=True)
    e.add_argument("--device", default=None, help="default: cuda")
    e.set_defaults(fn=_cmd_export)

    s = sub.add_parser("serve", help="top-K retrieval over HTTP")
    s.add_argument("--stdlib", action="store_true", help="stdlib http.server transport")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--item-embeddings", default=None, help="npy to load at start")
    s.add_argument("--topk", type=int, default=20)
    s.add_argument("--micro-batch", action="store_true")
    s.add_argument("--micro-batch-max", type=int, default=64)
    s.add_argument("--micro-batch-wait-ms", type=float, default=3.0)
    s.add_argument("--device", default=None, help="default: cuda")
    s.set_defaults(fn=_cmd_serve)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
