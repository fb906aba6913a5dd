"""The smoke check's elementwise kernel: o = x * 2 + 1.

Counterpart of the Pallas kernel in `plotpointe_tpu/tools/smoke_tpu.py`
(`run_smoke.kernel`, kernel 12) -> `csrc/smoke_affine.cu` (`affine`). The
wrapper runs `affine_plain` for CPU tensors and launches the kernel (or
raises) for CUDA tensors.
"""
from __future__ import annotations

import torch

from plotpointe_tpu_torch.ops import cuda_build as cb

LAUNCHES = cb.COUNTERS["smoke_affine"]


def affine_plain(x: torch.Tensor) -> torch.Tensor:
    """x * 2 + 1, elementwise."""
    return x * 2.0 + 1.0


def affine(x: torch.Tensor) -> torch.Tensor:
    """Kernel 12: x * 2 + 1 over an f32 tensor of any shape. Launches
    `csrc/smoke_affine.cu` for CUDA tensors; runs `affine_plain` for CPU
    tensors."""
    if x.dtype != torch.float32:
        raise ValueError(f"affine takes float32; got {x.dtype}")
    if x.device.type == "cpu":
        return affine_plain(x)
    xs = cb.aligned(x)  # 16-byte loads
    out = torch.empty_like(xs)
    fn = cb.entry("smoke_affine")
    with torch.cuda.device(x.device):
        rc = fn(cb.ptr(xs), cb.ptr(out), xs.numel(), cb.stream_of(xs))
    cb.check(rc, "smoke_affine")
    LAUNCHES.bump()
    return out
