"""batch_mean: requests per dispatched batch over the traced window, from
the batcher's own counters (`BatcherStats`)."""


def read(obs):
    b = obs.counters.get("batches", 0)
    return obs.counters["requests"] / b if b else None
