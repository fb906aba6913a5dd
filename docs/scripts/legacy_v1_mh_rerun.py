#!/usr/bin/env python3
"""Run the legacy v1 configuration at 2 heads of `chip_smoke.py`'s legacy
phase (`phase_legacy`: forward with dropout 0.1 and the backward of a fixed
linear loss on the main graph `.with_tiling()`, kernels against
`reference_versions()`, gradients within GRAD_TOL) several times, for the
checkout ROOT (this one by default), on one card.

    python3 docs/scripts/legacy_v1_mh_rerun.py [--root DIR] [--runs 6]

The data are `chip_smoke.py`'s (seed 0); the models alternate between two
seeds (100, 101), so each model runs `--runs` / 2 times on the same inputs.
`phase_legacy` prints its JSON line for each run (the gradients' largest
differences from the plain path's); then one line per run with "ok".
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=6)
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("legacy_v1_mh_rerun: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if not cs.__file__.startswith(root):
        raise AssertionError(f"imported {cs.__file__}, not the chip_smoke.py of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, s, feats, graph, _ = cs.phase_data(SimpleNamespace(seed=0, layers=2, epochs=3),
                                          np.random.default_rng(0), "cuda")
    cs.LEGACY = (("legacy_v1_mh", 128, 2),)
    for i in range(args.runs):
        try:
            cs.phase_legacy(cs.Errors(), np.random.default_rng(100 + i % 2), s, feats, graph, 2, "cuda")
            print(json.dumps({"run": i, "ok": True}), flush=True)
        except AssertionError as e:
            print(json.dumps({"run": i, "ok": False, "error": str(e)[:300]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
