"""`tools/control.py`'s training readings for an HGT cell
(`drivers/train_fit_hgt.py`): the control (the HGT reference one step
lower: fp8 e4m3 K' and V' rows, TF32 products) and the faults (half of each
batch left out; the evals' negatives from other streams), each held to the
reference by the cell's numbers, on several seeds. A state left unchanged
reads 1 on `change_gap` by the measure and needs no run.

    python benchmark/tools/control_hgt.py --workload hgt.train --seeds 1 2 3

One JSON line per seed on standard output."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def readings(cell: dict, config: dict, seed: int, device) -> dict:
    import torch

    from benchmark import checks, data
    from benchmark.drivers.train_fit import reference_metrics, settings
    from benchmark.reference import hgt as ref_hgt
    from benchmark.reference import sampling
    from benchmark.reference import training as ref

    s = settings(config, cell)
    proto = ref_hgt.protocol(s)
    inter = data.interactions_of(config, seed)
    feats = data.unit_rows(data.derive(seed, "features"), config["dataset"]["n_items"], s["feat_dim"], device)
    knn = ref_hgt.knn_edges(feats, config["knn"]["k"], config["knn"]["min_similarity"])
    tseed = data.derive(seed, "train")
    prep = ref_hgt.prepare(inter, feats.cpu().numpy(), *knn, device)
    n_train = len(prep.splits.train_u)
    steps = ref.steps_to_check(proto, n_train)
    val_index = ref.epoch_of_step(proto, n_train, steps)
    want = ref_hgt.follow(prep, s, tseed, device, steps=steps, rows=s["rows"])

    def numbers(got):
        return {"loss_gap": checks.loss_gap(got.losses, want.losses),
                "grad_gap": checks.grad_gap(got.grad_norms, want.grad_norms),
                "change_gap": checks.change_gap(got.change_norms, want.change_norms, want.grad_norms)}

    out = {"seed": seed, "steps": steps}
    control = ref_hgt.follow(prep, s, tseed, device, steps=steps, rows="float8_e4m3fn", tf32=True)
    out["control"] = numbers(control)
    del control
    half = ref_hgt.follow(prep, s, tseed, device, steps=steps, rows=s["rows"], keep_share=0.5)
    out["half_batch"] = numbers(half)
    del half
    p = want.params
    with torch.no_grad():
        z = ref_hgt.embed(p, prep, s, ref.ROW_TYPES[s["rows"]])
        with ref.matmul_precision(True):
            z_ctl = ref_hgt.embed(p, prep, s, ref.ROW_TYPES["float8_e4m3fn"])
    mine = reference_metrics(z, prep, s, tseed, val_index, device)
    ctl = reference_metrics(z_ctl, prep, s, tseed, val_index, device, tf32=True)
    out["control"]["embed_gap"] = checks.embed_gap(z_ctl, z)
    out["control"]["eval_gap"] = checks.eval_gap(ctl, mine)
    del z_ctl
    other = {"test": ref.evaluate_embeddings(z, prep, s, tseed, "test", sampling.TEST_EVAL_INDEX + 1, device),
             "val": ref.evaluate_embeddings(z, prep, s, tseed, "val", val_index + 1, device)}
    out["other_negatives"] = {"eval_gap": checks.eval_gap(other, mine)}
    out["unchanged"] = {"change_gap": checks.change_gap({k: 0.0 for k in want.change_norms},
                                                        want.change_norms, want.grad_norms)}
    out["reference"] = {"losses": [want.losses[0], want.losses[-1]], "grad_norms": want.grad_norms,
                        "change_norms": want.change_norms, "test": mine["test"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark import core

    cell = core.load_cell(args.workload)
    config = core.load_config(cell["config"])
    for seed in args.seeds:
        t0 = time.time()
        row = readings(cell, config, seed, torch.device("cuda"))
        row["workload"], row["seconds"] = args.workload, time.time() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
