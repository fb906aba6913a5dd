"""The segment ops and kernel wrappers; exports the names
`plotpointe_tpu/ops/__init__.py` exports, with `topk_mips` (the kernel
top-K on CUDA, its plain version on the CPU) for JAX's `topk_mips_pallas`
and `topk_mips_xla`."""
from plotpointe_tpu_torch.ops.segment import segment_softmax_attention, segment_sum, spmm
from plotpointe_tpu_torch.ops.topk_kernel import topk_mips

__all__ = [
    "segment_softmax_attention",
    "segment_sum",
    "spmm",
    "topk_mips",
]
