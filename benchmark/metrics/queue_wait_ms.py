"""queue_wait_ms: the program's `batch.queue` spans over the traced window,
each a request's wait from the batcher's queue to the start of its batch,
mean per request, in ms."""
from benchmark.program_spans import host_ms_mean


def read(obs):
    return host_ms_mean(obs, "batch.queue")
