"""The readings a cell's limits are set from that the runs do not make:
the control and the faults, at the cell's own size, on several seeds.

    python benchmark/tools/control.py --workload <cell> --seeds 1 2 3

Training cells: the control is the reference one step lower in precision
(attention or propagation rows in fp8 e4m3 instead of bf16, f32 products
in TF32) put in the program's place; the fault is half of each batch left
out (the mean taken over the rest). Each is followed through the steps a
run checks and compared with the reference by the cell's numbers. As the
program does in a run, the control then evaluates the weights the
reference reached (its own forward and its TF32 ranking) for `embed_gap`
and `eval_gap`. A further fault draws the evals' negatives from
other streams (other negatives). A state left unchanged reads 1 on
`change_gap` by the measure and needs no run.

Serving cells: the control scores in TF32 (f32 with TF32 off is stated)
and answers its own top k for the same sample of requests a run checks.

Mesh cells (`drivers/train_fit_mesh.py`), with `--faults`: the program on
its ranks, one spawn for every seed, read as a run reads its set-up fit,
once sound and once with each fault of `tools/faults.py` planted on every
rank (the reference followed once a seed):

    python benchmark/tools/control.py --workload gat.train.mesh4 --seeds 1 2 3 \
        --faults grad_exchange_left_out overlay_stale

One JSON line per seed (per seed and fault with `--faults`) on standard
output."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def train_readings(cell: dict, config: dict, seed: int, device) -> dict:
    import torch

    from benchmark import checks, data
    from benchmark.drivers.train_fit import reference_metrics, settings
    from benchmark.reference import training as ref

    s = settings(config, cell)
    inter = data.interactions_of(config, seed)
    feats = None
    if s["model_family"] == "gat":
        feats = data.unit_rows(data.derive(seed, "features"), config["dataset"]["n_items"], s["feat_dim"],
                               device).cpu().numpy()
    tseed = data.derive(seed, "train")
    prep = ref.prepare(inter, feats, s["model_family"], device)
    n_train = len(prep.splits.train_u)
    steps = ref.steps_to_check(s, n_train)
    val_index = ref.epoch_of_step(s, n_train, steps)
    want = ref.follow(prep, s, tseed, device, steps=steps, rows=s["rows"])

    def numbers(got):
        return {"loss_gap": checks.loss_gap(got.losses, want.losses),
                "grad_gap": checks.grad_gap(got.grad_norms, want.grad_norms),
                "change_gap": checks.change_gap(got.change_norms, want.change_norms, want.grad_norms)}

    out = {"seed": seed, "steps": steps}
    control = ref.follow(prep, s, tseed, device, steps=steps, rows="float8_e4m3fn", tf32=True)
    out["control"] = numbers(control)
    del control
    half = ref.follow(prep, s, tseed, device, steps=steps, rows=s["rows"], keep_share=0.5)
    out["half_batch"] = numbers(half)
    del half
    p = want.params
    with torch.no_grad():
        z = ref.embed(p, prep, s, ref.ROW_TYPES[s["rows"]])
        with ref.matmul_precision(True):
            z_ctl = ref.embed(p, prep, s, ref.ROW_TYPES["float8_e4m3fn"])
    mine = reference_metrics(z, prep, s, tseed, val_index, device)
    ctl = reference_metrics(z_ctl, prep, s, tseed, val_index, device, tf32=True)
    out["control"]["embed_gap"] = checks.embed_gap(z_ctl, z)
    out["control"]["eval_gap"] = checks.eval_gap(ctl, mine)
    del z_ctl
    other = {"test": ref.evaluate_embeddings(z, prep, s, tseed, "test", 10_001, device),
             "val": ref.evaluate_embeddings(z, prep, s, tseed, "val", val_index + 1, device)}
    out["other_negatives"] = {"eval_gap": checks.eval_gap(other, mine)}
    out["reference"] = {"losses": [want.losses[0], want.losses[-1]], "grad_norms": want.grad_norms,
                        "change_norms": want.change_norms, "test": mine["test"]}
    return out


def serve_readings(cell: dict, config: dict, seed: int, device) -> dict:
    import torch

    from benchmark import checks, data, traffic
    from benchmark.drivers.serve_open_loop import histories_of, sample_of
    from benchmark.reference.topk import exact

    sv, tr = config["serving"], cell["traffic"]
    table = data.unit_rows(data.derive(seed, "table"), sv["catalog_rows"], sv["dim"], device)
    sched = traffic.schedule(tr, data.derive(seed, "traffic"), 20.0, histories_of(config, seed))
    pick = sample_of(seed, sched, {"rows": [[0, 0, 0, 200]] * len(sched)}, tr["check_sample"])
    hs = [sched[i][1] for i in pick]
    k = tr["k"]
    ctl = exact(table, hs, [[0] * k for _ in hs], k, tf32=True)  # the control's own answers
    served = [c[2] for c in ctl]
    ref = exact(table, hs, served, k)
    gap = max(checks.reply_gap(idx, c[1], h, k, table.shape[0], r[0], r[1])
              for idx, c, h, r in zip(served, ctl, hs, ref))
    return {"seed": seed, "control": {"score_gap": gap}, "replies": len(hs)}


def mesh_readings(cell: dict, config: dict, seeds, fault_names, device) -> list:
    """Rank 0's numbers of each seed's set-up fit, sound and with each fault."""
    from benchmark.drivers.train_fit_mesh import spawn_ranks
    from benchmark.tools.faults import FAULTS

    names = [None] + list(fault_names)
    jobs = [(seed, FAULTS[n] if n else None) for seed in seeds for n in names]
    rows = spawn_ranks(cell, config, jobs, None, False, time.time(), device)[0]
    return [{"seed": seed, "fault": n or "none", "numbers": row["numbers"]}
            for (seed, n), row in zip(((seed, n) for seed in seeds for n in names), rows)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="mesh cells: the program sound and with each of these faults planted")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark import core

    cell = core.load_cell(args.workload)
    config = core.load_config(cell["config"])
    dev = torch.device("cuda")
    if args.faults is not None:
        t0 = time.time()
        for row in mesh_readings(cell, config, args.seeds, args.faults, dev):
            row["workload"], row["seconds"] = args.workload, time.time() - t0
            print(json.dumps(row), flush=True)
        return 0
    for seed in args.seeds:
        t0 = time.time()
        fn = serve_readings if cell["driver"] == "serve_open_loop" else train_readings
        row = fn(cell, config, seed, dev)
        row["workload"], row["seconds"] = args.workload, time.time() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
