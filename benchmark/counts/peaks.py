"""Published dense peaks per card (NVIDIA's H100 and H200 data sheets, SXM
parts at their full power limit; f32 is off the tensor cores). A frozen
copy of the port's `utils/profiling.GPU_SPECS`."""
from __future__ import annotations

GPU_SPECS = {
    "h100": {"bf16_tflops": 989.0, "f32_tflops": 67.0, "tf32_tflops": 495.0, "hbm_gbps": 3350.0},
    "h200": {"bf16_tflops": 989.0, "f32_tflops": 67.0, "tf32_tflops": 495.0, "hbm_gbps": 4800.0},
}
PEAK_KEY = {"float32": "f32_tflops", "bfloat16": "bf16_tflops", "tfloat32": "tf32_tflops"}


def generation(kind: str) -> str:
    """The GPU_SPECS row of a card named `kind` (torch.cuda.get_device_name)."""
    return "h200" if "h200" in kind.lower() else "h100"


def bound_s(nbytes: float, ops: float, dtype: str, gen: str = "h100") -> float:
    """Least seconds for `nbytes` of memory traffic and `ops` operations of
    `dtype` at the published peaks: the larger of the two times."""
    s = GPU_SPECS[gen]
    return max(nbytes / (s["hbm_gbps"] * 1e9), ops / (s[PEAK_KEY[dtype]] * 1e12))


def peak_flops(dtype: str, gen: str = "h100") -> float:
    return GPU_SPECS[gen][PEAK_KEY[dtype]] * 1e12
