#!/usr/bin/env python3
"""Path 14 (`sharded`) of `chip_smoke.py` alone on one card: the device and
build lines, the data phase at the Amazon shape, then `phase_sharded` with
its checks (kernels on 2- and 4-way local graphs, `train --mesh data:1` on
NCCL beside the unsharded runs, 2 processes over gloo, the dry run, the
scaling audit) and a closing line of its launches and largest errors.

    python3 docs/scripts/sharded_path.py

About 2 minutes on an H100, against the full smoke's ~13.
"""
from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    from types import SimpleNamespace

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("sharded_path: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    rng = np.random.default_rng(0)
    inter, s, feats, graph, (h0, a_s, a_d) = cs.phase_data(
        SimpleNamespace(seed=0, layers=2, epochs=3), rng, "cuda")
    with tempfile.TemporaryDirectory(prefix="sharded_path_") as td:
        work = Path(td)
        cs.write_artifacts(work, inter, feats)
        errs = cs.Errors()
        launches = cs.phase_sharded(errs, rng, work, s, graph, h0, a_s, a_d, "cuda")
    cs.emit({"sharded_path": "done", "launches": {k: v for k, v in launches.items() if v},
             "max_abs_err": errs.max, "wall_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
