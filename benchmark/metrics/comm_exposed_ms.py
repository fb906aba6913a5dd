"""comm_exposed_ms: the part of comm_ms during which no other kernel ran on
the traced rank's device: the exchange nothing overlaps, per step, in ms."""
from benchmark.program_spans import nccl_ms_per_step


def read(obs):
    return nccl_ms_per_step(obs, exposed=True)
