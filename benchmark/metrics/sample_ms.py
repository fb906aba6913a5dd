"""sample_ms: the device interval of the program's `train.sample` span (the
sampler's draws, `train/sampling.py`) in the traced fit, per optimizer step, in ms."""
from benchmark.program_spans import device_ms_per


def read(obs):
    return device_ms_per(obs, "train.sample", "train.step")
