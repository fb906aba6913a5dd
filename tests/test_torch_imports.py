"""The port stands alone: no module of it imports JAX or the JAX package, and
its entry points refuse to drift onto the CPU."""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import plotpointe_tpu_torch
from plotpointe_tpu_torch import resolve_device

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(plotpointe_tpu_torch.__path__,
                                                          "plotpointe_tpu_torch.")
                  if not m.name.endswith("__main__"))


def test_port_imports_no_jax():
    mods = _port_modules()
    for m in ("ops.gat_fused", "cli", "config", "pipeline", "train.trainer", "train.sampling",
              "train.evaluate", "train.losses", "utils.logging", "ops.spmm_kernel",
              "models.lightgcn", "ops.gat_kernel", "ops.knn_kernel", "graphs.knn",
              "graphs.ui_graph", "data.subset", "ops.elementwise", "utils.profiling",
              "tools.smoke_gpu", "models.encoders", "data.synthetic", "data.validate",
              "data.stage", "utils.prng", "utils.experiments", "utils.artifacts",
              "tools.manifest_validate", "tools.promotion_gate", "tools.anchor"):
        assert f"plotpointe_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'plotpointe_tpu' or m.startswith('plotpointe_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_resolve_device_needs_cuda_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
