"""CLI — `python -m plotpointe_tpu_torch <command>`.

Counterpart of `plotpointe_tpu/cli.py` for the ported commands:
  train   interactions (+ item features for the GAT) -> best checkpoint +
          metrics JSON (GAT or LightGCN; --mesh SPEC trains over a mesh of
          ranks, one per GPU, spawned here, with ShardedTrainer; --trace PATH
          writes this process's spans as a Chrome trace after the fit)
  export  checkpoint + interactions (+ item features for the GAT) ->
          item_embeddings.npy
  serve   top-K server: the stdlib HTTP server (--stdlib or
          $PLOTPOINTE_STDLIB_HTTP; --item-embeddings, else $ITEM_EMBEDDINGS_URI,
          is loaded at start), else the FastAPI app under uvicorn (the
          `serving` extra); --telemetry-dir logs requests and feedback
          (--telemetry-durable: through the durable queue); --trace PATH
          writes the spans as a Chrome trace when the server stops
  drift   hourly drift aggregates of a telemetry directory
  build-ui      interactions -> ui_edges.npz + node_maps.json + ui_stats.json
  build-subset  full-catalog features + items + interactions ->
                {name}_interacted.npy + interacted_items.json
  build-knn     interacted features -> ii_edges_{name}.npz + ii_{name}_stats.json
  smoke   the five capability checks of tools/smoke_gpu.py (kernel 12
          among them); exit 1 unless every check passes
  synth     seeded synthetic interactions + catalog -> parquet (pandas)
  stage     SNAP loose-JSON dumps -> parquet with the contract filters (pandas)
  validate  contract checks of staged data; exit 0, or 2 on a violation
  gate      promotion gate over metrics JSON; exit 0, or 3 on a fail
  validate-manifests  check manifest artifact prefixes; exit 0, or 2
  anchor    the quality anchor (tools/anchor.py); exit 3 on a gate fail
  ablate    the seven-variant single-variable sweep -> ablations_report.json
  embed-text      items -> txt.npy + txt_meta.json (hash encoder on the host,
                  or the MiniLM tower with --weights and --vocab)
  embed-image     items with image_url -> img{_chunkN}.npy + img_items + meta
                  (URL hash on the host, or the CLIP tower on local files)
  merge-images    image chunks -> img.npy + img_items.parquet
  fuse            txt + img -> fused.npy + fusion_config.json (fusion MLP)
  convert-weights local HF MiniLM / CLIP-vision checkpoint -> encoder npz
  pipeline  synth -> validate -> embeddings -> fuse -> graphs -> train, in
            one command (--in-process, --parallel, --continue)
  provision declarative infra plan/apply/destroy/render (tools/provision.py,
            deploy_torch/infra.yaml)
  jobs      per-stage job specs: list/run/race (tools/jobs.py,
            deploy_torch/jobs/*.yaml); like the JAX package's `cli jobs`, it
            exits 0 whatever the job returns (`python -m
            plotpointe_tpu_torch.tools.jobs` exits with the job's code)
train, export, serve, build-knn, smoke, anchor, ablate, embed-text,
embed-image, fuse and pipeline run on the GPU unless given `--device cpu`
(embed-text's hash encoder and embed-image's URL hash run on the host);
the other commands run on the host (synth, stage, image artifacts and
parquet I/O need pandas and pyarrow, the package's `data` extra). Tables
are read from `{prefix}/interactions.npz` and `{prefix}/items.npz` (column
arrays) when they exist, else from the parquet files.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np


@contextlib.contextmanager
def _traced(path):
    """Record the port's spans over the block and write them to `path` as a
    Chrome trace when it ends (nothing without a path)."""
    if not path:
        yield
        return
    from plotpointe_tpu_torch.utils import tracing

    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        n = tracing.write_chrome_trace(path)
        print(json.dumps({"trace": path, "spans": n, "dropped": tracing.dropped()}),
              file=sys.stderr, flush=True)


def _cmd_train(args):
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.pipeline import train_from_artifacts

    cfg = TrainConfig.from_env(
        model_family=args.model_family,
        hidden_dim=args.hidden_dim,
        layers=args.layers,
        heads=args.heads,
        attention=args.attention,
        knn_edges=args.knn_edges,
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
    with _traced(args.trace):
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
                                 store=store, device=args.device, knn_edges=args.knn_edges)
    print(json.dumps({"shape": list(emb.shape), "out": args.out}))


def _cmd_serve(args):
    telemetry = None
    if args.telemetry_dir:
        from plotpointe_tpu_torch.serving.telemetry import ServingTelemetry

        telemetry = ServingTelemetry(root=args.telemetry_dir,
                                     durable=True if args.telemetry_durable else None)
    if not (args.stdlib or os.environ.get("PLOTPOINTE_STDLIB_HTTP")):
        from plotpointe_tpu_torch.serving.app import SERVING_EXTRA, create_app

        app = create_app(telemetry)  # loads $ITEM_EMBEDDINGS_URI at start
        try:
            import uvicorn
        except ImportError as e:
            raise ImportError(SERVING_EXTRA) from e
        with _traced(args.trace):
            uvicorn.run(app, host=args.host, port=args.port)
        return
    from plotpointe_tpu_torch.serving.httpd import serve
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig

    rt = None
    uri = args.item_embeddings or os.environ.get("ITEM_EMBEDDINGS_URI")
    if uri:
        rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=uri, topk=args.topk,
                                              device=args.device))
        rt.startup()
    print(json.dumps({"serving": f"http://{args.host}:{args.port}", "loaded": rt is not None,
                      "telemetry": bool(telemetry), "micro_batch": args.micro_batch}), flush=True)
    with _traced(args.trace):
        serve(args.host, args.port, runtime=rt, telemetry=telemetry, block=True,
              micro_batch=args.micro_batch, micro_batch_max=args.micro_batch_max,
              micro_batch_wait_ms=args.micro_batch_wait_ms)


def _cmd_drift(args):
    from plotpointe_tpu_torch.serving.telemetry import ServingTelemetry

    print(json.dumps(ServingTelemetry(root=args.telemetry_dir).aggregate_drift(), indent=2))


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


def _cmd_synth(args):
    from plotpointe_tpu_torch.data.synthetic import synthetic_catalog, synthetic_interactions
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore, require_pandas

    pd = require_pandas()  # before the work: the tables are written as parquet
    inter, (_, i_fac) = synthetic_interactions(
        args.users, args.items, args.interactions, seed=args.seed, return_factors=True,
        n_clusters=args.clusters, candidate_pool=args.candidate_pool,
        affinity_strength=args.affinity, cluster_pool_bias=args.cluster_pool_bias,
        user_cluster_sigma=args.user_cluster_sigma, item_cluster_sigma=args.item_cluster_sigma)
    items = synthetic_catalog(inter, n_extra_items=args.extra_items, seed=args.seed,
                              item_factors=i_fac)
    store = ArtifactStore()
    store.save_parquet(pd.DataFrame(inter), f"{args.out}/interactions.parquet")
    store.save_parquet(pd.DataFrame(items), f"{args.out}/items.parquet")
    print(json.dumps({"n_interactions": len(inter["asin"]), "n_items": len(items["asin"]),
                      "out": args.out}))


def _cmd_stage(args):
    from plotpointe_tpu_torch.data.stage import stage

    _, stats = stage(args.reviews, args.meta, args.out, max_records=args.max_records)
    print(json.dumps(stats, indent=2))


def _cmd_validate(args):
    from plotpointe_tpu_torch.data.validate import validate
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    rep = validate(store.load_interactions(args.prefix), store.load_items(args.prefix))
    print(json.dumps(rep.to_dict(), indent=2))
    sys.exit(0 if rep.passed else 2)


def _cmd_gate(args):
    from plotpointe_tpu_torch.tools.promotion_gate import main as gate_main

    gate_main(["--current", args.current, "--baseline", args.baseline, "--split", args.split,
               "--metric", args.metric, "--mode", args.mode, "--tol", str(args.tol)])


def _cmd_validate_manifests(args):
    from plotpointe_tpu_torch.tools.manifest_validate import main as mv_main

    mv_main(["--registry", args.registry]
            + (["--manifest-id", args.manifest_id] if args.manifest_id else []))


def _cmd_anchor(args):
    from plotpointe_tpu_torch.tools.anchor import run

    run(args)


ABLATIONS = {  # the JAX sweep's seven single-variable variants
    "fused_bpr_l2_h1": {},
    "bce": {"loss": "bce"},
    "txt": {"item_features": "txt"},
    "heads2": {"heads": 2},
    "layers1": {"layers": 1},
    "layers3": {"layers": 3},
    "lightgcn": {"model_family": "lightgcn"},
}


def _cmd_ablate(args):
    """The single-variable sweep, one variant after another in-process; a
    variant that raises is reported as {"error": ...} and the command then
    exits 1 after writing the report."""
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.pipeline import train_from_artifacts
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    base = dict(
        model_family="gat", hidden_dim=args.hidden_dim, layers=2, heads=1,
        epochs=args.epochs, samples_per_epoch=args.samples_per_epoch,
        steps_per_epoch=args.steps_per_epoch, eval_neg_k=args.eval_neg_k,
        item_features=args.item_features, loss="bpr", attn_impl=args.attn_impl,
        optimizer=args.optimizer, warmup_steps=args.warmup_steps)
    only = None if args.only is None else args.only.split(",")
    report = {}
    for name, delta in ABLATIONS.items():
        if only and name not in only:
            continue
        cfg = TrainConfig(**{**base, **delta}, run_id=f"ablate_{name}")
        try:
            r = train_from_artifacts(cfg, staging_prefix=args.staging_prefix,
                                     embeddings_prefix=args.embeddings_prefix,
                                     models_prefix=f"{args.models_prefix}/{name}",
                                     device=args.device)
            report[name] = {"test": r["test"], "best_val_ndcg@20": r["best_val_ndcg@20"]}
        except Exception as e:  # noqa: BLE001 - one failed variant must not stop the sweep
            report[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
        print(json.dumps({name: report[name]}), flush=True)
    ArtifactStore().save_json(report, f"{args.models_prefix}/ablations_report.json")
    print(json.dumps(report, indent=2))
    failed = [n for n, r in report.items() if "error" in r]
    if failed:
        sys.exit(f"ablation variants failed: {failed}")


def _cmd_embed_text(args):
    from plotpointe_tpu_torch.models.embed_stages import embed_text_stage
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    _, meta = embed_text_stage(store.load_items(args.staging_prefix), args.output_prefix, store=store,
                               batch_size=args.batch_size, weights=args.weights, vocab=args.vocab,
                               device=args.device)
    print(json.dumps(meta, indent=2))


def _cmd_embed_image(args):
    from plotpointe_tpu_torch.models.embed_stages import embed_image_stage
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    _, meta = embed_image_stage(
        store.load_items(args.staging_prefix), args.output_prefix, store=store,
        chunk_start=args.chunk_start, chunk_end=args.chunk_end, chunk_id=args.chunk_id,
        max_items=args.max_items, seed=args.seed, pixels=args.pixels or None,
        allow_remote=args.allow_remote, weights=args.weights, device=args.device)
    print(json.dumps(meta, indent=2))


def _cmd_convert_weights(args):
    from plotpointe_tpu_torch.tools.convert_weights import convert

    cfg = convert(args.family, args.src, args.out, max_len=args.max_len)
    print(json.dumps({"out": args.out, **cfg}))


def _cmd_merge_images(args):
    from plotpointe_tpu_torch.models.embed_stages import merge_image_chunks
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    emb, _ = merge_image_chunks(args.output_prefix, args.n_chunks, store=ArtifactStore())
    print(json.dumps({"n_images": int(emb.shape[0]), "dims": int(emb.shape[1])}))


def _cmd_fuse(args):
    from plotpointe_tpu_torch.config import FusionConfig
    from plotpointe_tpu_torch.models.embed_stages import fuse_stage
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store = ArtifactStore()
    fused, cfg_out = fuse_stage(
        args.embeddings_prefix, out_prefix=args.output_prefix,
        cfg=FusionConfig.from_env(epochs=args.epochs, batch_size=args.batch_size), store=store,
        items=store.load_items(args.staging_prefix), device=args.device)
    print(json.dumps({"shape": list(fused.shape), "n_with_images": cfg_out["n_with_images"]}))


def _pipeline_steps(args):
    """The stage list shared by the serial and parallel modes (the JAX
    package's), each step that takes `--device` given the pipeline's."""
    d = args.workdir
    dev = ["--device", args.device] if args.device else []
    embed_image = [
        ["embed-image", "--staging-prefix", f"{d}/staging", "--output-prefix", f"{d}/embeddings", *dev]
    ]
    merge = []
    if args.parallel and args.image_chunks > 1:
        # ceil-split over the item table; embed-image clamps chunk_end itself
        per = (args.items + args.extra_items + args.image_chunks - 1) // args.image_chunks
        embed_image = [
            ["embed-image", "--staging-prefix", f"{d}/staging", "--output-prefix", f"{d}/embeddings",
             "--chunk-start", str(c * per), "--chunk-end", str((c + 1) * per), "--chunk-id", str(c), *dev]
            for c in range(args.image_chunks)
        ]
        merge = [["merge-images", "--output-prefix", f"{d}/embeddings",
                  "--n-chunks", str(args.image_chunks)]]
    return {
        "synth": ["synth", "--out", f"{d}/staging", "--users", str(args.users), "--items", str(args.items),
                  "--interactions", str(args.interactions), "--extra-items", str(args.extra_items)],
        "validate": ["validate", "--prefix", f"{d}/staging"],
        "embed_text": ["embed-text", "--staging-prefix", f"{d}/staging", "--output-prefix",
                       f"{d}/embeddings", *dev],
        "embed_image": embed_image,
        "merge_images": merge,
        "fuse": ["fuse", "--staging-prefix", f"{d}/staging", "--embeddings-prefix", f"{d}/embeddings",
                 "--epochs", "2", "--batch-size", "256", *dev],
        "build_ui": ["build-ui", "--staging-prefix", f"{d}/staging", "--output-prefix", f"{d}/graphs"],
        "subset_fused": ["build-subset", "--staging-prefix", f"{d}/staging", "--features",
                         f"{d}/embeddings/fused.npy", "--output-prefix", f"{d}/embeddings",
                         "--feature-name", "fused"],
        "subset_txt": ["build-subset", "--staging-prefix", f"{d}/staging", "--features",
                       f"{d}/embeddings/txt.npy", "--output-prefix", f"{d}/embeddings",
                       "--feature-name", "txt"],
        "build_knn": ["build-knn", "--features", f"{d}/embeddings/fused_interacted.npy",
                      "--output-prefix", f"{d}/graphs", *dev],
        "train": ["train", "--staging-prefix", f"{d}/staging", "--embeddings-prefix", f"{d}/embeddings",
                  "--models-prefix", f"{d}/models", "--item-features", "fused",
                  "--epochs", str(args.epochs), "--samples-per-epoch", str(args.samples_per_epoch),
                  "--eval-neg-k", str(args.eval_neg_k), "--hidden-dim", str(args.hidden_dim),
                  "--attn-impl", args.attn_impl, *dev],
    }


_STAGE_SENTINELS = {
    # stage name -> output artifact proving completion (relative to workdir)
    "synth": "staging/interactions.parquet",
    "embed_text": "embeddings/txt.npy",
    "merge_images": "embeddings/img.npy",
    "fuse": "embeddings/fused.npy",
    "build_ui": "graphs/ui_edges.npz",
    "subset_fused": "embeddings/fused_interacted.npy",
    "subset_txt": "embeddings/txt_interacted.npy",
    "build_knn": "graphs/ii_edges_fused.npz",
}


def _stage_done(args, name: str, step=None) -> bool:
    """--continue: a stage is skipped when its output artifact exists
    (validate and train always rerun)."""
    if not args.cont:
        return False
    if name == "embed_image" and step is not None:
        # chunked: the chunk file; unchunked: img.npy
        sfx = ""
        if "--chunk-id" in step:
            sfx = f"_chunk{step[step.index('--chunk-id') + 1]}"
        return os.path.exists(f"{args.workdir}/embeddings/img{sfx}.npy")
    rel = _STAGE_SENTINELS.get(name)
    return rel is not None and os.path.exists(f"{args.workdir}/{rel}")


def _cmd_pipeline(args):
    """The whole pipeline in one command. --in-process runs the stages as
    function calls in this interpreter instead of `python -m
    plotpointe_tpu_torch.cli` subprocesses. --parallel overlaps the
    independent stages as concurrent subprocesses (text || the image chunks,
    then U-I || (subset fused -> kNN) || subset txt); the card admits several
    processes, so every lane keeps the pipeline's device. --continue skips
    stages whose output artifacts exist. The last line is JSON: the JAX
    package's keys plus each stage's wall (`stage_wall_s`)."""
    import subprocess
    import threading
    import time

    base = [sys.executable, "-m", "plotpointe_tpu_torch.cli"]
    S = _pipeline_steps(args)
    t_start = time.time()
    skipped, walls = [], {}  # walls: stage (image chunk) -> seconds
    lock = threading.Lock()

    def run(name, step):
        if _stage_done(args, name, step):
            with lock:
                skipped.append(name)
            print(f"[pipeline] skip (artifact exists): {name}", flush=True)
            return
        t0 = time.time()
        print(f"[pipeline] {' '.join(step)}", flush=True)
        if args.in_process:
            try:
                main(step)
            except SystemExit as e:  # validate et al. exit by design
                if e.code not in (0, None):
                    raise
        else:
            subprocess.run(base + step, check=True)
        key = name + (f"_chunk{step[step.index('--chunk-id') + 1]}" if "--chunk-id" in step else "")
        with lock:
            walls[key] = time.time() - t0

    if args.parallel:
        if args.in_process:
            raise SystemExit("--parallel requires subprocess mode (drop --in-process)")

        def concurrent(lanes):
            errs = []

            def lane(steps):
                try:
                    for name, step in steps:
                        run(name, step)
                except BaseException as e:  # noqa: BLE001 - re-raised below, after every lane ends
                    errs.append(e)

            ts = [threading.Thread(target=lane, args=(ln,)) for ln in lanes]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            if errs:
                raise errs[0]

        run("synth", S["synth"])
        run("validate", S["validate"])
        concurrent([[("embed_text", S["embed_text"])]] + [[("embed_image", c)] for c in S["embed_image"]])
        for m in S["merge_images"]:
            run("merge_images", m)
        run("fuse", S["fuse"])
        concurrent([
            [("build_ui", S["build_ui"])],
            [("subset_fused", S["subset_fused"]), ("build_knn", S["build_knn"])],
            [("subset_txt", S["subset_txt"])],
        ])
        run("train", S["train"])
    else:
        steps = [("synth", S["synth"]), ("validate", S["validate"]), ("embed_text", S["embed_text"])]
        steps += [("embed_image", c) for c in S["embed_image"]]
        steps += [("merge_images", m) for m in S["merge_images"]]
        steps += [("fuse", S["fuse"]), ("build_ui", S["build_ui"]), ("subset_fused", S["subset_fused"]),
                  ("subset_txt", S["subset_txt"]), ("build_knn", S["build_knn"]), ("train", S["train"])]
        for name, step in steps:
            run(name, step)
    print(json.dumps({"pipeline": "complete", "workdir": args.workdir, "parallel": bool(args.parallel),
                      "skipped": skipped, "wall_s": round(time.time() - t_start, 2),
                      "stage_wall_s": walls}))


def _cmd_provision(args):
    from plotpointe_tpu_torch.tools.provision import main

    main(args.rest)


def _cmd_jobs(args):
    # the tool's return code is dropped, as `cli jobs` drops it in the JAX package
    from plotpointe_tpu_torch.tools.jobs import main

    main(args.rest)


TRACE_HELP = ("record the port's spans (utils/tracing.py; off by default) and write them to PATH "
              "as a Chrome trace for Perfetto (train --mesh: the spawned ranks are not traced)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="plotpointe_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train the GAT, HGT or LightGCN")
    t.add_argument("--model-family", choices=["gat", "lightgcn", "hgt"], default="gat",
                   help="hgt: the HGT over the user-item graph and the item kNN graph of "
                        "--knn-edges (one device)")
    t.add_argument("--staging-prefix", required=True,
                   help="holds interactions.npz (column arrays) or interactions.parquet")
    t.add_argument("--embeddings-prefix", required=True)
    t.add_argument("--models-prefix", required=True)
    t.add_argument("--hidden-dim", type=int, default=128)
    t.add_argument("--layers", type=int, default=2)
    t.add_argument("--heads", type=int, default=1)
    t.add_argument("--attention", choices=["gat", "gatv2"], default="gat",
                   help="the GAT's logit: gat (a_src.h_j + a_dst.h_i, then LeakyReLU) or gatv2 "
                        "(a.LeakyReLU(W_l x_j + W_r x_i), 1 to 8 heads; one device)")
    t.add_argument("--knn-edges", default=None, metavar="NPZ",
                   help="hgt: the item kNN artifact (ii_edges_{name}.npz of build-knn)")
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
    t.add_argument("--mesh", default=None, metavar="SPEC",
                   help='train over a mesh of ranks, e.g. "data:8" (ShardedTrainer: one rank per '
                        'GPU, or gloo ranks with --device cpu; the ranks are spawned here unless '
                        'this process is one of them)')
    t.add_argument("--device", default=None, help="default: cuda")
    t.add_argument("--trace", default=None, metavar="PATH", help=TRACE_HELP)
    t.set_defaults(fn=_cmd_train)

    e = sub.add_parser("export", help="checkpoint -> item_embeddings.npy")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--staging-prefix", required=True,
                   help="holds interactions.npz (column arrays) or interactions.parquet")
    e.add_argument("--features", default=None,
                   help="item features npy, first-occurrence order (GAT, HGT; LightGCN takes none)")
    e.add_argument("--knn-edges", default=None, metavar="NPZ",
                   help="HGT: the item kNN artifact (default: the one the checkpoint's training used)")
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
    s.add_argument("--telemetry-dir", default=None, help="log requests and feedback (JSONL)")
    s.add_argument("--telemetry-durable", action="store_true",
                   help="log through the at-least-once durable queue instead")
    s.add_argument("--micro-batch", action="store_true")
    s.add_argument("--micro-batch-max", type=int, default=64)
    s.add_argument("--micro-batch-wait-ms", type=float, default=3.0)
    s.add_argument("--device", default=None, help="default: cuda")
    s.add_argument("--trace", default=None, metavar="PATH", help=TRACE_HELP)
    s.set_defaults(fn=_cmd_serve)

    b = sub.add_parser("drift", help="aggregate serving telemetry into drift stats")
    b.add_argument("--telemetry-dir", required=True)
    b.set_defaults(fn=_cmd_drift)

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

    b = sub.add_parser("synth", help="generate a synthetic staged dataset (parquet)")
    b.add_argument("--out", required=True)
    b.add_argument("--users", type=int, default=2000)
    b.add_argument("--items", type=int, default=1200)
    b.add_argument("--interactions", type=int, default=50_000)
    b.add_argument("--extra-items", type=int, default=0)
    b.add_argument("--seed", type=int, default=42)
    b.add_argument("--clusters", type=int, default=0)
    b.add_argument("--candidate-pool", type=int, default=16)
    b.add_argument("--affinity", type=float, default=3.0)
    b.add_argument("--cluster-pool-bias", type=float, default=0.0)
    b.add_argument("--user-cluster-sigma", type=float, default=0.6)
    b.add_argument("--item-cluster-sigma", type=float, default=0.35)
    b.set_defaults(fn=_cmd_synth)

    b = sub.add_parser("stage", help="stage SNAP loose-JSON dumps into parquet")
    b.add_argument("--reviews", required=True, help="reviews .json(.gz) path")
    b.add_argument("--meta", required=True, help="item metadata .json(.gz) path")
    b.add_argument("--out", required=True)
    b.add_argument("--max-records", type=int, default=None)
    b.set_defaults(fn=_cmd_stage)

    b = sub.add_parser("validate", help="contract-validate staged data")
    b.add_argument("--prefix", required=True,
                   help="holds interactions and items, each .npz (column arrays) or .parquet")
    b.set_defaults(fn=_cmd_validate)

    b = sub.add_parser("gate", help="promotion gate")
    b.add_argument("--current", required=True)
    b.add_argument("--baseline", required=True)
    b.add_argument("--split", default="test")
    b.add_argument("--metric", default="ndcg@20")
    b.add_argument("--mode", default="improve_or_equal")
    b.add_argument("--tol", type=float, default=0.0)
    b.set_defaults(fn=_cmd_gate)

    b = sub.add_parser("validate-manifests", help="check manifest artifact prefixes exist")
    b.add_argument("--registry", default="manifests/registry.json")
    b.add_argument("--manifest-id", default=None)
    b.set_defaults(fn=_cmd_validate_manifests)

    from plotpointe_tpu_torch.tools.anchor import build_parser as anchor_flags

    b = anchor_flags(sub.add_parser(
        "anchor", help="quality anchor: the reference GAT protocol on full-shape "
                       "Amazon-calibrated synthetic data + controlled baselines"))
    b.set_defaults(fn=_cmd_anchor)

    b = sub.add_parser("ablate", help="single-variable ablation sweep + report")
    b.add_argument("--staging-prefix", required=True)
    b.add_argument("--embeddings-prefix", required=True)
    b.add_argument("--models-prefix", required=True)
    b.add_argument("--hidden-dim", type=int, default=128)
    b.add_argument("--steps-per-epoch", type=int, default=1)
    b.add_argument("--epochs", type=int, default=10)
    b.add_argument("--samples-per-epoch", type=int, default=100_000)
    b.add_argument("--eval-neg-k", type=int, default=500)
    b.add_argument("--item-features", default="fused")
    b.add_argument("--attn-impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="attention row type: pallas (and auto on CUDA) bf16 rows, xla f32 rows")
    b.add_argument("--optimizer", choices=["adam", "adamw"], default="adam")
    b.add_argument("--warmup-steps", type=int, default=0)
    b.add_argument("--only", default=None, help="comma-separated variant names")
    b.add_argument("--device", default=None, help="default: cuda")
    b.set_defaults(fn=_cmd_ablate)

    b = sub.add_parser("embed-text", help="text embeddings (txt.npy)")
    b.add_argument("--staging-prefix", required=True,
                   help="holds items.npz (column arrays) or items.parquet")
    b.add_argument("--output-prefix", required=True)
    b.add_argument("--batch-size", type=int, default=128)
    b.add_argument("--weights", default=None, help="converted MiniLM npz (convert-weights)")
    b.add_argument("--vocab", default=None, help="WordPiece vocab.txt for the real-weight path")
    b.add_argument("--device", default=None, help="the MiniLM tower's device (default: cuda)")
    b.set_defaults(fn=_cmd_embed_text)

    b = sub.add_parser("embed-image", help="image embeddings (img.npy), chunk-shardable")
    b.add_argument("--staging-prefix", required=True,
                   help="holds items.npz (column arrays) or items.parquet")
    b.add_argument("--output-prefix", required=True)
    b.add_argument("--chunk-start", type=int, default=None)
    b.add_argument("--chunk-end", type=int, default=None)
    b.add_argument("--chunk-id", type=int, default=None)
    b.add_argument("--max-items", type=int, default=None)
    b.add_argument("--seed", type=int, default=42)
    b.add_argument("--allow-remote", action="store_true",
                   help="download http(s) image_urls (timeout+retry); off by default (zero-egress)")
    b.add_argument("--pixels", action="store_true",
                   help="decode local image files (CLIP preprocessing + ViT encode)")
    b.add_argument("--weights", default=None, help="converted CLIP-vision npz")
    b.add_argument("--device", default=None, help="the CLIP tower's device (default: cuda)")
    b.set_defaults(fn=_cmd_embed_image)

    b = sub.add_parser("convert-weights", help="HF checkpoint dir -> encoder npz (offline)")
    b.add_argument("--family", choices=["minilm", "clip-vision"], required=True)
    b.add_argument("--src", required=True, help="local HF model directory")
    b.add_argument("--out", required=True)
    b.add_argument("--max-len", type=int, default=256)
    b.set_defaults(fn=_cmd_convert_weights)

    b = sub.add_parser("merge-images", help="merge image embedding chunks")
    b.add_argument("--output-prefix", required=True)
    b.add_argument("--n-chunks", type=int, required=True)
    b.set_defaults(fn=_cmd_merge_images)

    b = sub.add_parser("fuse", help="train fusion MLP, emit fused.npy")
    b.add_argument("--staging-prefix", required=True,
                   help="holds items.npz (column arrays) or items.parquet")
    b.add_argument("--embeddings-prefix", required=True)
    b.add_argument("--output-prefix", default=None)
    b.add_argument("--epochs", type=int, default=5)
    b.add_argument("--batch-size", type=int, default=1024)
    b.add_argument("--device", default=None, help="default: cuda")
    b.set_defaults(fn=_cmd_fuse)

    b = sub.add_parser("pipeline", help="run the full synth->train pipeline in one command")
    b.add_argument("--workdir", required=True)
    b.add_argument("--users", type=int, default=2000)
    b.add_argument("--items", type=int, default=1200)
    b.add_argument("--interactions", type=int, default=50_000)
    b.add_argument("--extra-items", type=int, default=300)
    b.add_argument("--epochs", type=int, default=8)
    b.add_argument("--samples-per-epoch", type=int, default=50_000)
    b.add_argument("--eval-neg-k", type=int, default=500)
    b.add_argument("--hidden-dim", type=int, default=64)
    b.add_argument("--attn-impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="attention row type: pallas (and auto on CUDA) bf16 rows, xla f32 rows")
    b.add_argument("--in-process", action="store_true",
                   help="run stages as function calls instead of subprocesses")
    b.add_argument("--parallel", action="store_true",
                   help="overlap independent stages (text || chunked image embeddings, "
                        "graph builds) as concurrent subprocesses")
    b.add_argument("--image-chunks", type=int, default=4,
                   help="image-embedding shards under --parallel")
    b.add_argument("--continue", dest="cont", action="store_true",
                   help="skip stages whose output artifacts already exist")
    b.add_argument("--device", default=None,
                   help="passed to every stage that takes it (default: cuda)")
    b.set_defaults(fn=_cmd_pipeline)

    b = sub.add_parser("provision", add_help=False,
                       help="declarative infra plan/apply/destroy (deploy_torch/infra.yaml)")
    b.add_argument("rest", nargs=argparse.REMAINDER)
    b.set_defaults(fn=_cmd_provision)

    b = sub.add_parser("jobs", add_help=False,
                       help="per-stage job specs: list/run (deploy_torch/jobs/*.yaml)")
    b.add_argument("rest", nargs=argparse.REMAINDER)
    b.set_defaults(fn=_cmd_jobs)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
