"""Profiling and speed-of-light accounting on the card.

Counterpart of `plotpointe_tpu/utils/profiling.py`: the card's published
peaks (`GPU_SPECS`), roofline accounting (`Roofline`), the calibration of
what this card delivers (`measure_device_peaks`: a bf16 matrix-product loop
and the read-stream probe, kernel 6 -> `csrc/stream_probe.cu`). The port's
spans and their Chrome trace are `utils/tracing.py`.

`stream_probe` runs `stream_probe_plain` for CPU tensors and launches the
kernel (or raises) for CUDA tensors.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from plotpointe_tpu_torch.ops import cuda_build as cb

# Dense peaks per card (NVIDIA's H100 and H200 data sheets and the Hopper
# architecture white paper, SXM parts at their full power limit); f32 is
# off the tensor cores. The cpu row is the JAX table's placeholder.
GPU_SPECS = {
    "h100": {"bf16_tflops": 989.0, "f32_tflops": 67.0, "tf32_tflops": 495.0, "hbm_gbps": 3350.0},
    "h200": {"bf16_tflops": 989.0, "f32_tflops": 67.0, "tf32_tflops": 495.0, "hbm_gbps": 4800.0},
    "cpu": {"bf16_tflops": 1.0, "f32_tflops": 1.0, "tf32_tflops": 1.0, "hbm_gbps": 50.0},
}
GEN_ENV = "PLOTPOINTE_TORCH_GPU_GEN"  # names a GPU_SPECS row, overriding detection
PROBE_LAUNCHES = cb.COUNTERS["stream_probe"]


def detect_generation() -> str:
    """The GPU_SPECS row of card 0: $PLOTPOINTE_TORCH_GPU_GEN if set, else
    from `torch.cuda.get_device_name()` (an unknown card reads as h100);
    "cpu" without CUDA."""
    gen = os.environ.get(GEN_ENV)
    if gen:
        return gen
    if not torch.cuda.is_available():
        return "cpu"
    kind = torch.cuda.get_device_name(0).lower()
    return "h200" if "h200" in kind else "h100"


@dataclass
class Roofline:
    """Achieved vs attainable for one kernel invocation.

    `measured_peaks`: optional {"tflops": float, "hbm_gbps": float} from
    `measure_device_peaks()`; `sol_fraction_dev` scores against what the
    card delivers, `sol_fraction` against its published peaks."""

    name: str
    seconds: float
    flops: float = 0.0
    bytes_accessed: float = 0.0
    dtype_tflops_key: str = "bf16_tflops"
    measured_peaks: Optional[Dict] = None

    def report(self, gen: Optional[str] = None) -> Dict:
        spec = GPU_SPECS[gen or detect_generation()]
        t_compute = self.flops / (spec[self.dtype_tflops_key] * 1e12) if self.flops else 0.0
        t_memory = self.bytes_accessed / (spec["hbm_gbps"] * 1e9) if self.bytes_accessed else 0.0
        bound = max(t_compute, t_memory)
        out = {
            "kernel": self.name,
            "seconds": self.seconds,
            "achieved_tflops": self.flops / self.seconds / 1e12 if self.seconds else 0.0,
            "achieved_gbps": self.bytes_accessed / self.seconds / 1e9 if self.seconds else 0.0,
            "speed_of_light_s": bound,
            "sol_fraction": bound / self.seconds if self.seconds and bound else 0.0,
            "bound_by": "compute" if t_compute >= t_memory else "memory",
        }
        if self.measured_peaks:
            tc = self.flops / (self.measured_peaks["tflops"] * 1e12) if self.flops else 0.0
            tm = self.bytes_accessed / (self.measured_peaks["hbm_gbps"] * 1e9) if self.bytes_accessed else 0.0
            b = max(tc, tm)
            out["sol_fraction_dev"] = b / self.seconds if self.seconds and b else 0.0
        return out


def stream_probe_plain(x: torch.Tensor, bm: int, c: float = 0.0) -> torch.Tensor:
    """[M, D] -> [M / bm * 8, 128] f32: row 8 g + r is the max over the r-th
    slab of bm / 8 rows of block g, lane l the max over columns = l mod
    128, plus c (the JAX probe's output)."""
    m, d = x.shape
    folded = x.reshape(m // bm * 8, bm // 8, d // 128, 128).amax(dim=(1, 2))
    return folded.float() + c


def stream_probe(x: torch.Tensor, bm: int = 512, c: float = 0.0) -> torch.Tensor:
    """Kernel 6: `stream_probe_plain`'s function over x [M, D] bf16 (D a
    multiple of 128, bm a multiple of 8 dividing M). Launches
    `csrc/stream_probe.cu` for CUDA tensors; runs the plain version for CPU
    tensors."""
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be a bfloat16 [M, D] tensor; got {x.dtype} {tuple(x.shape)}")
    m, d = x.shape
    if d % 128 or bm <= 0 or bm % 8 or m % bm:
        raise ValueError(f"the probe takes D a multiple of 128 and bm a multiple of 8 dividing M; "
                         f"got M={m}, D={d}, bm={bm}")
    if x.is_cpu:
        return stream_probe_plain(x, bm, c)
    xs = cb.aligned(x)
    out = torch.empty((m // bm * 8, 128), dtype=torch.float32, device=x.device)
    cb.launch("stream_probe", xs.device, cb.ptr(xs), float(c), cb.ptr(out), m, d, bm)
    PROBE_LAUNCHES.bump()
    return out


def _best_seconds(fn, device: torch.device, n_iter: int, n_rep: int) -> float:
    """Best of n_rep runs of n_iter back-to-back calls, per call: CUDA events
    on the card, the host clock on the CPU. One warm-up call first."""
    fn()
    best = float("inf")
    for _ in range(n_rep):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            a.record()
            for _ in range(n_iter):
                fn()
            b.record()
            b.synchronize()
            t = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(n_iter):
                fn()
            t = time.perf_counter() - t0
        best = min(best, t / n_iter)
    return best


def measure_device_peaks(device="cuda", mm_shape=(4096, 8192, 4096), probe_shape=(32768, 4096),
                         bm: int = 512, n_iter: int = 8, n_rep: int = 3) -> Dict:
    """What this card delivers: a bf16 [M, K] @ [K, N] `torch.matmul` loop
    (the tensor-core ceiling; JAX left this product to XLA) and kernel 6's
    read stream of a bf16 [M, D] array (256 MB at the defaults, five times
    the 50 MB L2, so every pass reads device memory). Each is the best of
    n_rep runs of n_iter back-to-back launches. The sizes default to the JAX
    package's; a test on the CPU passes small ones. Returns {"tflops",
    "hbm_gbps"}."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    m, k, n = mm_shape
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    t_mm = _best_seconds(lambda: torch.matmul(a, b), dev, n_iter, n_rep)
    del a, b
    pm, pd = probe_shape
    x = torch.randn((pm, pd), generator=gen, device=dev).to(torch.bfloat16)
    t_stream = _best_seconds(lambda: stream_probe(x, bm), dev, n_iter, n_rep)
    return {"tflops": 2.0 * m * k * n / t_mm / 1e12, "hbm_gbps": pm * pd * 2 / t_stream / 1e9}
