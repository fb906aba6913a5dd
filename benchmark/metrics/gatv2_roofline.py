"""gatv2_roofline: the GATv2 kernels (csrc/gatv2_fwd.cu, gatv2_bwd_dst.cu,
gatv2_bwd_src.cu) over the traced fit: the sum of each launch's bound
(`counts/gatv2.py`, from the shapes; every launch of the fit, the evals'
forwards included, at the configuration's row type) over the device time of
their CUDA kernels (every kernel named gatv2_*), in %. None where the fit
launched none (a program without them)."""
from benchmark.counts import gatv2

KERNELS = ("gatv2_",)


def read(obs):
    c, sh = obs.counters, obs.shapes
    if obs.trace is None or not c.get("gatv2_fwd"):
        return None
    device_s = obs.trace.time_of(KERNELS)
    if device_s <= 0:
        return None
    n, e, hh, d = sh["n_nodes"], sh["n_edges"], sh["heads"], sh["hidden_dim"]
    isz = 2 if sh["rows"] == "bfloat16" else 4
    bound = (c["gatv2_fwd"] * gatv2.fwd_bound_s(n, e, hh, d, isz)
             + c.get("gatv2_bwd_dst", 0) * gatv2.bwd_dst_bound_s(n, e, hh, d, isz)
             + c.get("gatv2_bwd_src", 0) * gatv2.bwd_src_bound_s(n, e, hh, d, isz))
    return 100.0 * bound / device_s
