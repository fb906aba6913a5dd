"""history_mean_ms: the program's `serve.queries` spans over the traced
window (the host mean of each history's rows and the copy to the device,
`RecommenderRuntime._queries`), mean per batch, in ms."""
from benchmark.program_spans import host_ms_mean


def read(obs):
    return host_ms_mean(obs, "serve.queries")
