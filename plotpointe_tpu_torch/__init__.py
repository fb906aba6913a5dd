"""plotpointe_tpu_torch — the recommender engine on PyTorch and hand-written
CUDA for NVIDIA Hopper (sm_90a).

A port of `plotpointe_tpu` (the JAX/Pallas package, kept as the reference).
Module names mirror the JAX package so each counterpart is easy to find.
Plain tensor code is PyTorch; every Pallas kernel on a ported path is a CUDA
C++ kernel under `csrc/`, built with nvcc at first use and bound with ctypes
(`ops/cuda_build.py`). Each kernel wrapper runs its plain PyTorch version for
tensors on the CPU and launches the kernel (or raises) for tensors on CUDA.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
Inside `reference_versions()` every kernel op runs its plain version on any
device: the reference a kernel path is held to on the card.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__version__ = "0.1.0"
_reference = False  # True only inside `reference_versions()`


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU. Raises when CUDA is absent and the caller did not
    ask for the CPU explicitly: an entry point never drifts onto the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path")
    return dev


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """CUDA f32 matrix products and cuDNN convolutions in full f32 inside the
    block (TF32 off), as the JAX package's HIGH/HIGHEST precisions ask; the
    settings are restored."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def reference_versions() -> Iterator[None]:
    """Inside this block the GAT attention op (`gat_fused.Attention`), the
    static SpMM operator and `knn_topk`'s candidate selection run their
    plain versions on any device, forward and backward: the reference their
    kernels are held to."""
    global _reference
    prev, _reference = _reference, True
    try:
        yield
    finally:
        _reference = prev


def reference_active() -> bool:
    """True inside `reference_versions()`."""
    return _reference
