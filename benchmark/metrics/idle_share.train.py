"""idle_share.train: the share of the traced fit's wall time in which no
device operation ran (1 - the union of their intervals over the wall), in %."""
from benchmark.tracing import idle_share


def read(obs):
    return idle_share(obs.trace)
