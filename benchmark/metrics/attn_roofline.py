"""attn_roofline: kernels 1, 2 and 3 (csrc/gat_fwd.cu, gat_bwd_dst.cu,
gat_bwd_src.cu) over the traced fit: the sum of each launch's bound
(`counts/attention.py`, from the shapes: the training forwards with the
dropout mask, the eval forwards without) over the sum of the device time of
the kernels below, in %."""
from benchmark.counts import attention

KERNELS = ("node_terms", "attention_walk", "bwd_dst_walk", "bwd_dst_combine", "bwd_src_units",
           "bwd_src_combine", "row_dots")


def read(obs):
    if obs.trace is None:
        return None
    device_s = obs.trace.time_of(KERNELS)
    c, sh = obs.counters, obs.shapes
    if device_s <= 0 or not c.get("gat_fwd"):
        return None
    n, e, d = sh["n_nodes"], sh["n_edges"], sh["hidden_dim"]
    masked = min(c["gat_fwd"], c["steps"] * sh["layers"]) if sh["attn_dropout"] > 0 else 0
    bound = (masked * attention.fwd_bound_s(n, e, d, True)
             + (c["gat_fwd"] - masked) * attention.fwd_bound_s(n, e, d, False)
             + c["gat_bwd_dst"] * attention.bwd_dst_bound_s(n, e, d)
             + c["gat_bwd_src"] * attention.bwd_src_bound_s(n, e, d))
    return 100.0 * bound / device_s
