"""topk_roofline: kernels 4, 5 and the select kernel (csrc/topk_chunkmax.cu,
topk_rescore.cu, topk_select.cu) over the traced window: the sum over the
dispatched batches of the exact top-k's bound (`counts/topk.py`, from the
batch's requests and the catalog) over the device time of the kernels
below, in %."""
from benchmark.counts import topk

KERNELS = ("chunkmax", "rescore", "select_rows", "sort_tiles", "rank_tiles")


def read(obs):
    if obs.trace is None:
        return None
    device_s = obs.trace.time_of(KERNELS)
    batches = obs.spans.named("dispatch")
    if device_s <= 0 or not batches:
        return None
    sh = obs.shapes
    sz = 4 if sh["table_dtype"] == "float32" else 2
    bound = sum(topk.topk_bound_s(b.meta["batch"], sh["catalog_rows"], sh["dim"], sh["k"], sz)
                for b in batches)
    return 100.0 * bound / device_s
