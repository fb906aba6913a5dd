"""Quality anchor: the reference's GAT protocol on full-shape
Amazon-calibrated synthetic data, beside controlled baselines, gated.

Counterpart of `plotpointe_tpu/tools/anchor.py` (`run_anchor`, `main`; the
same flags plus `--device`, the same anchor.json and the same gate):

  1. generate the full reference shape (192,403 users x 63,001 items x
     1,689,116 interactions; `--scale mini` / `micro` cut it) with
     `data/synthetic.py::amazon_calibrated_interactions`, which gives the
     JAX package's bits for the same arguments;
  2. score four reference-free baselines under the exact eval protocol
     (chronological leave-last, 1 + 1,000 sampled negatives, strict ranks):
     chance (random scores), popularity (train item degree), inverse
     popularity, and the factor oracle (the generator's own latent factors);
  3. train the GAT (fused features, BPR) under the reference protocol (20
     epochs of one 200,000-sample Adam step) and the beyond-parity schedule
     (`--beyond-steps` steps an epoch), and score the untrained model
     (`gat_init`);
  4. write `{out}/anchor.json` (before the GAT legs and after each) and,
     with `--gate-baseline`, gate the metrics: exit 3 on a violation.

Every leg's eval draws its negatives from a fresh generator seeded
`seed + 11`, so the legs rank against the same negatives (the JAX package
hands every leg one key). The draws are not JAX's: metrics agree with the
JAX package's within sampling noise, the dataset block exactly.
`generator_hash` pins the generator config and the source of this port's
`data/synthetic.py`; the port's own baseline is `tools/anchor_baseline.json`.

    python -m plotpointe_tpu_torch.tools.anchor --scale full --skip-beyond \\
        --gate-baseline plotpointe_tpu_torch/tools/anchor_baseline.json [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import time
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch import resolve_device

SHAPES = {
    "full": dict(n_users=192_403, n_items=63_001, n_interactions=1_689_116),
    "mini": dict(n_users=20_000, n_items=8_000, n_interactions=200_000),
    "micro": dict(n_users=2_000, n_items=1_000, n_interactions=20_000),  # seconds on a CPU
}
REFERENCE_BAND = {"ndcg@20": 0.0160, "recall@20": 0.0433,
                  "source": "PHASE5_ABLATIONS_REPORT.md:20 (fused+BPR, real data)"}
BASELINE = Path(__file__).with_name("anchor_baseline.json")


def generator_config(scale: str, seed: int, affinity: float, n_clusters: int,
                     candidate_pool: int, item_cluster_sigma: float, user_cluster_sigma: float,
                     cluster_pool_bias: float, feature_noise: float) -> Dict[str, Any]:
    """The config `generator_hash` pins (the JAX anchor's `gen_cfg`)."""
    return dict(shape=SHAPES[scale], seed=seed, affinity=affinity, n_clusters=n_clusters,
                candidate_pool=candidate_pool, item_cluster_sigma=item_cluster_sigma,
                user_cluster_sigma=user_cluster_sigma, cluster_pool_bias=cluster_pool_bias,
                feature_noise=feature_noise)


def generator_hash(cfg: Dict[str, Any]) -> str:
    """sha256 of the config and of the source of the port's generator."""
    from plotpointe_tpu_torch.data import synthetic

    text = json.dumps(cfg, sort_keys=True) + inspect.getsource(synthetic)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def anchor_data(cfg: Dict[str, Any]):
    """(interactions, (u_fac, i_fac)) of a `generator_config`."""
    from plotpointe_tpu_torch.data.synthetic import amazon_calibrated_interactions

    return amazon_calibrated_interactions(
        **cfg["shape"], seed=cfg["seed"], affinity_strength=cfg["affinity"],
        return_factors=True, n_clusters=cfg["n_clusters"],
        candidate_pool=cfg["candidate_pool"], item_cluster_sigma=cfg["item_cluster_sigma"],
        user_cluster_sigma=cfg["user_cluster_sigma"], cluster_pool_bias=cfg["cluster_pool_bias"])


def factor_rows(ids: np.ndarray, factors: np.ndarray) -> np.ndarray:
    """The factor row of each id ("U0000012" / "B000000012" is row 12), in
    the order given (first occurrence for the node order)."""
    return factors[np.array([int(x[1:]) for x in ids.tolist()], dtype=np.int64)]


def anchor_features(inter, i_fac: np.ndarray, n_items: int, dim: int, seed: int,
                    noise: float) -> Tuple[np.ndarray, np.ndarray]:
    """(item factor rows, `synthetic_features` at `dim`), both in the
    first-occurrence order of the interacted items (the node order)."""
    from plotpointe_tpu_torch.data.splits import first_occurrence_unique
    from plotpointe_tpu_torch.data.synthetic import synthetic_features

    fac = factor_rows(first_occurrence_unique(np.asarray(inter["asin"])), i_fac)
    return fac, synthetic_features(n_items, dim, seed=seed, factors=fac, noise=noise)


def realized_marginals(inter) -> Dict[str, Any]:
    """Rows, distinct users and items, and the degree mean / std over the
    deduplicated (user, item) pairs: the anchor's `dataset` block."""
    from plotpointe_tpu_torch.data.splits import first_of_each_key

    u_keys, u = np.unique(np.asarray(inter["user_id"]), return_inverse=True)
    i_keys, i = np.unique(np.asarray(inter["asin"]), return_inverse=True)
    keep = first_of_each_key(u, i)
    ud = np.bincount(u[keep])
    idg = np.bincount(i[keep])
    return {
        "rows": int(len(u)),
        "users": int(len(u_keys)),
        "items": int(len(i_keys)),
        "user_deg_mean": round(float(ud.mean()), 2),
        "user_deg_std": round(float(ud.std()), 2),
        "item_deg_mean": round(float(idg.mean()), 2),
        "item_deg_std": round(float(idg.std()), 2),
        "reference_marginals": {"user": [7.07, 6.97], "item": [21.60, 65.34],
                                "note": "reference stats are over the TRAIN split's deduped pairs"},
    }


def _rounded(metrics: Dict[str, float]) -> Dict[str, float]:
    return {k: round(float(v), 4) for k, v in metrics.items()}


def run_anchor(
    scale: str = "full",
    affinity: float = 3.0,
    epochs: int = 20,
    steps_per_epoch: int = 1,
    beyond_steps: int = 32,
    seed: int = 0,
    out: str = "tmp/anchor",
    skip_beyond: bool = False,
    skip_baselines: bool = False,
    skip_reference: bool = False,
    optimizer: str = "adam",
    warmup_steps: int = 0,
    n_clusters: int = 0,
    candidate_pool: int = 16,
    feature_noise: float = 0.3,
    item_cluster_sigma: float = 0.35,
    user_cluster_sigma: float = 0.6,
    cluster_pool_bias: float = 0.0,
    device=None,
) -> Dict[str, Any]:
    """Generate, score the baselines, train the GAT legs; returns the
    anchor.json dict. A leg that raises is recorded as {"error": ...}."""
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.data.splits import (
        build_node_maps, build_splits, first_occurrence_unique, padded_positives)
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.pipeline import make_model
    from plotpointe_tpu_torch.train.evaluate import sampled_eval
    from plotpointe_tpu_torch.train.trainer import STREAM_INIT, Trainer

    dev = resolve_device(device)
    t0 = time.time()
    gen_cfg = generator_config(scale, seed, affinity, n_clusters, candidate_pool,
                               item_cluster_sigma, user_cluster_sigma, cluster_pool_bias,
                               feature_noise)
    inter, (u_fac, i_fac) = anchor_data(gen_cfg)
    realized = realized_marginals(inter)

    u2i, i2i = build_node_maps(inter)
    splits = build_splits(inter, u2i, i2i)
    graph = build_bipartite_graph(splits.train_u, splits.train_i, splits.n_users, splits.n_items,
                                  weight=splits.train_w)
    fac_rows, feats = anchor_features(inter, i_fac, splits.n_items, 128, seed, feature_noise)

    results: Dict[str, Any] = {
        "dataset": realized, "affinity_strength": affinity, "scale": scale,
        "n_clusters": n_clusters, "candidate_pool": candidate_pool,
        "feature_noise": feature_noise,
        "generator_config": gen_cfg, "generator_hash": generator_hash(gen_cfg),
        "protocol": "leave-last chronological, 1+1000 sampled negatives, strict rank",
        "reference_band": dict(REFERENCE_BAND)}

    # the positives table ([n_users, 512]) is built once and kept on the device
    pos_table, deg = padded_positives(splits, max_degree=512)
    pos_table, deg = torch.as_tensor(pos_table, device=dev), torch.as_tensor(deg, device=dev)

    def scores(U, I) -> Dict[str, float]:
        gen = torch.Generator(device=dev).manual_seed(seed + 11)  # every leg: the same negatives
        return _rounded(sampled_eval(torch.as_tensor(np.asarray(U, np.float32), device=dev),
                                     torch.as_tensor(np.asarray(I, np.float32), device=dev),
                                     splits.test_u, splits.test_i, pos_table, deg, gen,
                                     neg_k=1000))

    rng = np.random.default_rng(seed + 7)
    n_u, n_i = splits.n_users, splits.n_items
    train_pop = np.bincount(splits.train_i, minlength=n_i).astype(np.float32)
    if not skip_baselines:
        ones = np.ones((n_u, 1), np.float32)
        results["chance"] = scores(ones, rng.normal(size=(n_i, 1)).astype(np.float32))
        results["popularity"] = scores(ones, np.log1p(train_pop)[:, None])
        results["inverse_popularity"] = scores(ones, -np.log1p(train_pop)[:, None])
        u_rows = factor_rows(first_occurrence_unique(np.asarray(inter["user_id"])), u_fac)
        results["factor_oracle"] = scores(u_rows, fac_rows)

    def train_gat(steps: int, tag: str) -> None:
        cfg = TrainConfig(model_family="gat", hidden_dim=128, layers=2, heads=1,
                          epochs=epochs, samples_per_epoch=200_000, steps_per_epoch=steps,
                          item_features="fused", loss="bpr", seed=seed,
                          optimizer=optimizer, warmup_steps=warmup_steps)
        model = make_model(cfg, n_u, n_i, 128, device=dev)
        # max_pos_degree 128 keeps the positives table modest at full shape;
        # truncation only affects negative exclusion for users above it
        tr = Trainer(model, cfg, graph, splits, item_feats=feats, max_pos_degree=128, device=dev)
        if tag == "gat_reference_protocol":
            # the untrained model (fit() draws the same init): mean
            # aggregation over k random user rows shrinks a popular item's
            # norm ~k^-1/2, so it scores like inverse popularity
            model.init_params(tr._reseed(STREAM_INIT, 0))
            U0, I0 = (x.float().cpu().numpy() for x in tr._forward_eval())
            results["gat_init"] = scores(U0, I0)
            norms = np.linalg.norm(I0, axis=1)
            results["gat_init"]["corr_log_norm_vs_log_degree"] = round(float(
                np.corrcoef(np.log1p(train_pop), np.log(norms + 1e-9))[0, 1]), 3)
        res = tr.fit()
        results[tag] = _rounded(res["test"])
        results[tag]["wall_s"] = round(res.get("wall_time_s", time.time() - t0), 1)

    out_p = Path(out)
    out_p.mkdir(parents=True, exist_ok=True)

    def snapshot() -> None:
        (out_p / "anchor.json").write_text(json.dumps(results, indent=2))

    snapshot()  # the baselines are kept before training
    opt_sfx = "" if optimizer == "adam" else f"_{optimizer}"
    legs = ([] if skip_reference else [(steps_per_epoch, "gat_reference_protocol")]) + (
        [] if skip_beyond else [(beyond_steps, f"gat_beyond_parity_{beyond_steps}steps{opt_sfx}")])
    for steps, tag in legs:
        try:
            train_gat(steps, tag)
        except Exception as e:  # noqa: BLE001 - record it and keep the other legs; main() fails
            results[tag] = {"error": f"{type(e).__name__}: {e}"[:300]}
        snapshot()
    print(json.dumps(results, indent=2))
    return results


def gate(results: Dict[str, Any], spec: Dict[str, Any]) -> Tuple[list, list]:
    """(violations, skipped) of the results against a baseline file's
    `generator_hash` and `min` bands ("section.metric": lowest value). A
    section that did not run is skipped."""
    fails, skipped = [], []
    want_hash = spec.get("generator_hash")
    if want_hash and results.get("generator_hash") != want_hash:
        fails.append(f"generator_hash: {results.get('generator_hash')} != pinned {want_hash}")
    for path, lo in spec.get("min", {}).items():
        sect, metric = path.split(".")
        if sect not in results:
            skipped.append(path)
            continue
        got = results.get(sect, {}).get(metric)
        if got is None or got < lo:
            fails.append(f"{path}: {got} < {lo}")
    if not fails and skipped and len(skipped) == len(spec.get("min", {})):
        fails.append("all gated sections skipped")  # a PASS here would be vacuous
    return fails, skipped


def build_parser(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The anchor's flags (the JAX anchor's, defaults included, plus
    `--device`). The defaults are the calibrated learnable regime of
    `anchor_baseline.json`: category-structured latents and browsing."""
    ap.add_argument("--scale", choices=sorted(SHAPES), default="full")
    ap.add_argument("--affinity", type=float, default=14.0)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--steps-per-epoch", type=int, default=1)
    ap.add_argument("--beyond-steps", type=int, default=32)
    ap.add_argument("--skip-beyond", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="tmp/anchor")
    ap.add_argument("--skip-baselines", action="store_true")
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--optimizer", choices=["adam", "adamw"], default="adam")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--clusters", type=int, default=64,
                    help="category-structured latents: K heavy-tailed clusters (0 = marginal-only)")
    ap.add_argument("--candidate-pool", type=int, default=64)
    ap.add_argument("--feature-noise", type=float, default=0.02)
    ap.add_argument("--item-cluster-sigma", type=float, default=0.35)
    ap.add_argument("--user-cluster-sigma", type=float, default=0.35)
    ap.add_argument("--cluster-pool-bias", type=float, default=0.6,
                    help="share of each candidate pool drawn from the user's own cluster")
    ap.add_argument("--gate-baseline", default=None,
                    help="json with metric bands; exit 3 when outside them")
    ap.add_argument("--device", default=None, help="default: cuda")
    return ap


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Run the anchor of parsed flags, then the gate: prints
    {"anchor_gate": "PASS" | "FAIL", ...} and exits 3 on FAIL; exits 1 if a
    leg failed and no gate caught it."""
    results = run_anchor(
        scale=args.scale, affinity=args.affinity, epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch, beyond_steps=args.beyond_steps,
        seed=args.seed, out=args.out, skip_beyond=args.skip_beyond,
        skip_baselines=args.skip_baselines, skip_reference=args.skip_reference,
        optimizer=args.optimizer, warmup_steps=args.warmup_steps,
        n_clusters=args.clusters, candidate_pool=args.candidate_pool,
        feature_noise=args.feature_noise, item_cluster_sigma=args.item_cluster_sigma,
        user_cluster_sigma=args.user_cluster_sigma, cluster_pool_bias=args.cluster_pool_bias,
        device=args.device)
    if args.gate_baseline:
        fails, skipped = gate(results, json.loads(Path(args.gate_baseline).read_text()))
        if fails:
            print(json.dumps({"anchor_gate": "FAIL", "violations": fails, "skipped": skipped}))
            raise SystemExit(3)
        print(json.dumps({"anchor_gate": "PASS", "skipped": skipped}))
    errors = {k: v["error"] for k, v in results.items() if isinstance(v, dict) and "error" in v}
    if errors:
        raise SystemExit(f"anchor legs failed: {json.dumps(errors)}")
    return results


def main(argv=None) -> Dict[str, Any]:
    return run(build_parser(argparse.ArgumentParser(description=__doc__.split("\n")[0]))
               .parse_args(argv))


if __name__ == "__main__":
    main()
