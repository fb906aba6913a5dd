"""plotpointe_tpu_torch — the recommender engine on PyTorch and hand-written
CUDA for NVIDIA Hopper (sm_90a).

A port of `plotpointe_tpu` (the JAX/Pallas package, kept as the reference).
Module names mirror the JAX package so each counterpart is easy to find.
Plain tensor code is PyTorch; every Pallas kernel on a ported path is a CUDA
C++ kernel under `csrc/`, built with nvcc at first use and bound with ctypes
(`ops/cuda_build.py`). Each kernel wrapper runs its plain PyTorch version for
tensors on the CPU and launches the kernel (or raises) for tensors on CUDA.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU. Raises when CUDA is absent and the caller did not
    ask for the CPU explicitly: an entry point never drifts onto the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path")
    return dev
