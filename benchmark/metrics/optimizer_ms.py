"""optimizer_ms: the device interval of the program's `train.optimizer` span
(`Trainer._opt_step`: Adam) in the traced fit, per optimizer step, in ms."""
from benchmark.program_spans import device_ms_per


def read(obs):
    return device_ms_per(obs, "train.optimizer", "train.step")
