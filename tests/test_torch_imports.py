"""The port stands alone: no module of it imports JAX or the JAX package, and
its entry points refuse to drift onto the CPU. Its subpackages export the
names the JAX package's do, apart from those with no counterpart by design."""
import ast
import importlib
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
              "tools.manifest_validate", "tools.promotion_gate", "tools.anchor",
              "serving.eventqueue", "serving.telemetry", "serving.app", "tools.serve_bench",
              "native", "models.tokenizer", "models.image_io", "models.fusion",
              "models.embed_stages", "tools.convert_weights", "parallel", "parallel.mesh",
              "parallel.multihost", "parallel.collectives", "parallel.sharded_table",
              "parallel.spmd", "parallel.cases", "train.sharded", "tools.multihost_smoke",
              "tools.scaling_audit", "tools.multichip_dryrun", "tools.provision", "tools.jobs",
              "tools.fetch_fixtures"):
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


def test_resolve_attn_impl_imports_no_jax_and_no_cuda():
    """`ops.segment.resolve_attn_impl` resolves "auto" for a CUDA device
    without JAX, the JAX package or a CUDA context; `tools.fetch_fixtures`
    imports `transformers` only when it runs."""
    code = (
        "import json, sys, torch\n"
        "from plotpointe_tpu_torch.ops.segment import resolve_attn_impl\n"
        "import plotpointe_tpu_torch.tools.fetch_fixtures\n"
        "got = [resolve_attn_impl('auto', d) for d in ('cuda', 'cpu', None)]\n"
        "print(json.dumps([got, torch.cuda.is_initialized(), 'transformers' in sys.modules,"
        " sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'plotpointe_tpu' or m.startswith('plotpointe_tpu.'))]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [["pallas", "xla", "pallas"], False, False, []]


def test_resolve_device_needs_cuda_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_env_entry_point_imports_no_jax():
    """`serving/__main__.py` runs nothing on import (its `__main__` guard), so
    importing it shows what it pulls in."""
    code = (
        "import importlib, json, sys\n"
        "importlib.import_module('plotpointe_tpu_torch.serving.__main__')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'plotpointe_tpu' or m.startswith('plotpointe_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# JAX names with no counterpart by design (ROADMAP.md, "Deliberate differences"):
# an optax pytree, and the top-K entry points, whose port is `ops.topk_mips`
NO_COUNTERPART = {"train": {"TrainState"}, "ops": {"topk_mips_pallas", "topk_mips_xla"}}
SUBPACKAGES = ("data", "models", "ops", "serving", "train", "utils", "graphs", "parallel")


def _jax_all(sub: str) -> list:
    """`__all__` of `plotpointe_tpu/<sub>/__init__.py`, read without importing JAX."""
    tree = ast.parse((ROOT / "plotpointe_tpu" / sub / "__init__.py").read_text())
    (node,) = [n for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "__all__"]
    return ast.literal_eval(node.value)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackages_export_the_jax_names(sub):
    want = [n for n in _jax_all(sub) if n not in NO_COUNTERPART.get(sub, set())]
    mod = importlib.import_module(f"plotpointe_tpu_torch.{sub}")
    for name in want:
        assert getattr(mod, name) is not None, name
    assert set(want) <= set(mod.__all__)
    assert set(mod.__all__) - set(want) <= ({"topk_mips"} if sub == "ops" else set())
    for name in NO_COUNTERPART.get(sub, ()):
        assert name in _jax_all(sub) and not hasattr(mod, name)


def test_module_names_of_item_10():
    from plotpointe_tpu_torch.ops import gat_fused, segment
    from plotpointe_tpu_torch.tools.manifest_validate import prefix_exists
    from plotpointe_tpu_torch.train import Trainer
    from plotpointe_tpu_torch.utils.artifacts import CONTRACTS

    assert gat_fused.EPS == segment.EPS == 1e-9
    assert callable(segment.segment_sum) and callable(segment.weighted_degree)
    assert callable(prefix_exists) and Trainer.__name__ == "Trainer"
    jax_contracts = ast.literal_eval(
        ast.parse((ROOT / "plotpointe_tpu/utils/artifacts.py").read_text()).body[-1].value)
    assert CONTRACTS == jax_contracts
