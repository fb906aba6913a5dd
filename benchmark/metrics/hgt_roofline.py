"""hgt_roofline: the HGT kernels (csrc/hgt_fwd.cu, hgt_bwd_dst.cu,
hgt_bwd_src.cu) over the traced fit: the sum of each launch's bound
(`counts/hgt.py`, from the shapes; every launch of the fit, the evals'
forwards included, at the configuration's row type) over the device time of
their CUDA kernels (every kernel named hgt_*, and the split rows' combine
`gatv2_sum_slots` that B1 and B2 launch, which nothing else in an HGT fit
launches), in %. None where the fit launched none (a program without
them)."""
from benchmark.counts import hgt

KERNELS = ("hgt_", "gatv2_sum_slots")


def read(obs):
    c, sh = obs.counters, obs.shapes
    if obs.trace is None or not c.get("hgt_fwd"):
        return None
    device_s = obs.trace.time_of(KERNELS)
    if device_s <= 0:
        return None
    n, s, e, hh = sh["n_nodes"], sh["n_rows"], sh["n_edges"], sh["heads"]
    d = sh["hidden_dim"] // hh
    isz = 2 if sh["rows"] == "bfloat16" else 4
    bound = (c["hgt_fwd"] * hgt.fwd_bound_s(n, s, e, hh, d, isz)
             + c.get("hgt_bwd_dst", 0) * hgt.bwd_dst_bound_s(n, s, e, hh, d, isz)
             + c.get("hgt_bwd_src", 0) * hgt.bwd_src_bound_s(n, s, e, hh, d))
    return 100.0 * bound / device_s
