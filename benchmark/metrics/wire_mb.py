"""wire_mb: what the traced rank moves over the links in one training step:
the payloads of the collectives its steps made in the traced fit
(`parallel/collectives.record_collectives`, summed by kind) under ring
algorithms (`counts/collectives.py`), per step, in MB (1e6 bytes)."""
from benchmark.counts import collectives


def read(obs):
    steps = obs.counters.get("recorded_steps", 0)
    if not steps:
        return None
    payload = {op: obs.counters.get(f"{op}_bytes", 0.0) for op in collectives.OPS}
    return collectives.wire_bytes(payload, obs.shapes["n_shards"]) / steps / 1e6
