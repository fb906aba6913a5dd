"""Runs one cell of the port's benchmark once and prints its result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's GPUs. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` also `breakdown`, and last
`checks`, each number compared beside its limit; the same numbers are the
last lines of standard error. Exits non-zero, printing no result, without
enough CUDA devices, when the program cannot be imported, or when JAX or the
JAX package got loaded into this process.

Every build and kernel cache stays in `build/` of the checkout."""
import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": "build/bench/torch_extensions",
          "TRITON_CACHE_DIR": "build/bench/triton", "CUDA_CACHE_PATH": "build/bench/nv_cache"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    for k, v in CACHES.items():
        os.environ[k] = str(REPO / v)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(REPO))

    import torch

    from benchmark import core

    chips = next((w["chips"] for w in core.load_benchmark()["workloads"] if w["name"] == args.workload),
                 None)
    if chips is None:
        print(f"{args.workload} is not a cell of BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = core.forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    print(core.dumps(result), flush=True)
    print(core.checks_text(result), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
