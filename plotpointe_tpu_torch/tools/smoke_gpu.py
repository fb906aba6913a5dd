"""GPU smoke test: the counterpart of `plotpointe_tpu/tools/smoke_tpu.py`,
with its five checks and report shape {"ok", "checks"}:

  1. device        the card is visible to PyTorch (name, count)
  2. matmul        a bf16 1024 x 1024 `torch.matmul`, with its TFLOP/s (the
                   JAX check times XLA's dot: a library call here too)
  3. kernel        kernel 12 (`csrc/smoke_affine.cu`), o = x * 2 + 1 on
                   [256, 128] f32, built from this package's sources
  4. encode_one    one text through the hash text encoder
  5. encode_batch  256 texts, with items/s

    python -m plotpointe_tpu_torch.tools.smoke_gpu [--device cpu]

`--device cpu` runs the same checks with the kernel's plain version.
Without a card and without `--device cpu` the device check fails and so
does the run: it does not carry on on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import numpy as np
import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_check(checks: Dict, name: str, fn: Callable[[], Dict]) -> None:
    """Record fn's result under `name`; an exception fails the check (the
    report names it) and the run goes on to the next check."""
    try:
        checks[name] = fn()
    except Exception as e:  # noqa: BLE001 - the report is the boundary
        checks[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:200]}


def run_smoke(device: str = "cuda") -> Dict:
    from plotpointe_tpu_torch import resolve_device
    from plotpointe_tpu_torch.models.encoders import hash_text_encoder
    from plotpointe_tpu_torch.ops.elementwise import affine

    checks: Dict = {}
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        checks["device"] = {"ok": False, "error": str(e)}
        return {"ok": False, "checks": checks}
    if dev.type == "cuda":
        checks["device"] = {"ok": True, "n_devices": torch.cuda.device_count(),
                            "kind": torch.cuda.get_device_name(dev), "backend": "cuda"}
    else:
        checks["device"] = {"ok": True, "n_devices": 1, "kind": "cpu", "backend": "cpu"}

    def matmul():
        x = torch.ones((1024, 1024), dtype=torch.bfloat16, device=dev)
        t0 = time.perf_counter()
        y = torch.matmul(x, x)
        _sync(dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(10):
            y = torch.matmul(x, x)
        _sync(dev)
        exec_s = (time.perf_counter() - t0) / 10
        return {"ok": bool(torch.isfinite(y[0, 0]).item()), "first_call_s": round(first_s, 4),
                "tflops": round(2 * 1024 ** 3 / exec_s / 1e12, 2)}

    def kernel():
        out = affine(torch.ones((256, 128), dtype=torch.float32, device=dev))
        total = float(out.sum())
        return {"ok": abs(total - 256 * 128 * 3.0) < 1e-3, "sum": total}

    enc = hash_text_encoder(dim=384)

    def encode_one():
        return {"ok": enc(["smoke test item"]).shape == (1, 384)}

    def encode_batch():
        texts = [f"item number {i} with some description" for i in range(256)]
        t0 = time.perf_counter()
        batch = enc(texts)
        dt = time.perf_counter() - t0
        return {"ok": batch.shape == (256, 384) and bool(np.isfinite(batch).all()),
                "items_per_sec": round(256 / dt, 1)}

    for name, fn in (("matmul", matmul), ("kernel", kernel), ("encode_one", encode_one),
                     ("encode_batch", encode_batch)):
        _run_check(checks, name, fn)
    return {"ok": all(c.get("ok") for c in checks.values()), "checks": checks}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="GPU capability smoke test (5 checks)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain kernel)")
    report = run_smoke(ap.parse_args(argv).device)
    print(json.dumps(report, indent=2))
    raise SystemExit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
