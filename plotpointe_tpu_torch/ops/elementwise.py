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
    if x.is_cpu:
        return affine_plain(x)
    xs = cb.aligned(x)  # 16-byte loads
    out = torch.empty_like(xs)
    cb.launch("smoke_affine", xs.device, xs.data_ptr(), out.data_ptr(), xs.numel())
    LAUNCHES.bump()
    return out
