"""comm_ms: the device time of the traced rank's NCCL kernels (the
collectives of `parallel/collectives.py`) inside the device intervals of
its `train.step` spans over the traced fit, per step, in ms. A collective's
kernel runs until every rank has joined it, so the wait for the slowest
rank is in it; the evals' collectives are not."""
from benchmark.program_spans import nccl_ms_per_step


def read(obs):
    return nccl_ms_per_step(obs)
