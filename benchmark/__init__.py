"""The benchmark of the PyTorch/CUDA port (`plotpointe_tpu_torch`) on NVIDIA
GPUs: one cell a run, driven by the files under `configs/`, `workloads/`,
`drivers/` and `metrics/` (see `run.py`)."""
