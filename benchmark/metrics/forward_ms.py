"""forward_ms: the device interval of the program's `train.forward` span (the
model's forward and the loss) in the traced fit, per optimizer step, in ms."""
from benchmark.program_spans import device_ms_per


def read(obs):
    return device_ms_per(obs, "train.forward", "train.step")
