"""serve_mfu: the scoring FLOPs of the dispatched batches (2 b n d a batch:
every request's query against every catalog row) over the union of the
dispatch spans times the published peak of the configuration's type, in %."""
from benchmark.counts import peaks
from benchmark.tracing import merged


def read(obs):
    if obs.kind not in peaks.GPU_SPECS:
        return None
    batches = obs.spans.named("dispatch")
    if not batches:
        return None
    busy = sum(b - a for a, b in merged([("", s.t0, s.t1 - s.t0) for s in batches]))
    sh = obs.shapes
    work = sum(2.0 * s.meta["batch"] * sh["catalog_rows"] * sh["dim"] for s in batches)
    return 100.0 * work / (busy * peaks.peak_flops(obs.config["peak"]["dtype"], obs.kind))
