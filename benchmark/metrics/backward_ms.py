"""backward_ms: the device interval of the program's `train.backward` span
(zero_grad and the backward) in the traced fit, per optimizer step, in ms."""
from benchmark.program_spans import device_ms_per


def read(obs):
    return device_ms_per(obs, "train.backward", "train.step")
