#!/usr/bin/env python3
"""Paths 12 (`embed`) and 13 (`pipeline`) of `chip_smoke.py` alone on one
card: the device and build lines, then `phase_embed` and `phase_pipeline`
at the smoke's sizes, each with its checks.

    python3 docs/scripts/embed_paths.py [embed | pipeline]

With an argument only that path runs. About 4 minutes on an H100 (both
paths), against the full smoke's ~11.
"""
from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("embed_paths: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device()
    cs.phase_build()
    only = sys.argv[1:]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="embed_paths_") as tmp:
        if not only or "embed" in only:
            cs.phase_embed(Path(tmp), cs.amazon_shaped_interactions(0), 0, "cuda")
        if not only or "pipeline" in only:
            cs.phase_pipeline(Path(tmp), "cuda")
    cs.emit({"embed_paths_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
