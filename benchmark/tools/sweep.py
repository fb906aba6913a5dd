"""The knee of the serving cell: the highest offered rate at which
completions keep pace and latency does not grow over the window.

    python benchmark/tools/sweep.py --workload gat.serve --seed 1 --seconds 8 --rates 200 400 800

Sets the server up once as the cell's driver does, then offers each rate
from a fresh load generator for `--seconds`, open loop, and prints one
JSON line a rate: requests, completed share, completions a second,
p50 / p95 / p99 ms, the generator's lateness (median and max ms), and the
median latency of the window's last third over its first third (growth);
on standard error, the server process's pauses and the slowest requests,
as a run logs them."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="gat.serve")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark import core, data, traffic
    from benchmark.drivers import serve_open_loop as so

    cell = core.load_cell(args.workload)
    config = core.load_config(cell["config"])
    sv = config["serving"]
    dev = torch.device("cuda")
    table = data.unit_rows(data.derive(args.seed, "table"), sv["catalog_rows"], sv["dim"], dev).cpu().numpy()
    hist = so.histories_of(config, args.seed)

    class Ctx:
        device = dev

    runtime, server = so.start(Ctx, sv, table)
    try:
        for i, rate in enumerate(args.rates):
            params = dict(cell["traffic"], rate_per_s=rate)
            sched = traffic.schedule(params, data.derive(args.seed + i, "traffic"), args.seconds, hist)
            so.warm(runtime, server, sched, sv)
            proc = so.launch_loadgen(server.server_address[1], sched)
            with so.Pauses() as pauses:
                report = so.drive(proc, args.seconds)
            s = so.summarise(report)
            print(f"rate {rate}: pauses: {pauses.summary(report['t0'])}", file=sys.stderr)
            print(f"rate {rate}: slowest requests (s due, ms late, ms served, history) "
                  f"{so.slowest(report, sched)}", file=sys.stderr, flush=True)
            rows = sorted(report["rows"], key=lambda r: r[0])
            third = max(1, len(rows) // 3)

            def med(part):
                lat = sorted((r[2] - r[0]) if r[3] == 200 else float("inf") for r in part)
                return lat[len(lat) // 2]

            s.update(rate=rate, ok_share=s["ok"] / max(1, s["n"]),
                     growth=med(rows[-third:]) / med(rows[:third]))
            print(json.dumps(s), flush=True)
    finally:
        so.stop(server)
    return 0


if __name__ == "__main__":
    sys.exit(main())
