"""The GATv2 kernels (csrc/gatv2_fwd.cu, gatv2_bwd_dst.cu, gatv2_bwd_src.cu)
and a GATv2 training step, counted from the shapes: each launch's
compulsory bytes in `counts/attention.py`'s convention (each input read
once, each output written once; the per-edge row gathers are not
compulsory) and operations (a multiply and an add count two), and the
model FLOPs of a step.

n nodes, e edges, hh heads, d a head's width, isz the bytes of a rounded
source row's element (2 for bf16 rows), vec the values of a 16-byte chunk
of that row (8 for bf16, 4 for f32): the signs are a byte a chunk. The
dropout multipliers are drawn inside the kernels: no bytes."""
from __future__ import annotations

from benchmark.counts.peaks import bound_s


def _vec(isz: int) -> int:
    return 16 // isz


def fwd_bytes(n: int, e: int, hh: int, d: int, isz: int) -> dict:
    w = n * hh * d
    return {"rl": w * isz, "xr": w * 4, "a": hh * d * 4, "row_ptr": (n + 1) * 4, "src": e * 4,
            "out": w * 4, "den": n * hh * 4}


def bwd_dst_bytes(n: int, e: int, hh: int, d: int, isz: int) -> dict:
    w = n * hh * d
    return {"rl": w * isz, "xr_g_out": 3 * w * 4, "a": hh * d * 4, "den": n * hh * 4,
            "row_ptr": (n + 1) * 4, "src": e * 4, "dxr": w * 4, "da": hh * d * 4,
            "edge_scalars": e * hh * 8, "signs": e * hh * d // _vec(isz)}


def bwd_src_bytes(n: int, e: int, hh: int, d: int, isz: int) -> dict:
    w = n * hh * d
    return {"g": w * 4, "a": hh * d * 4, "edge_scalars": e * hh * 8, "signs": e * hh * d // _vec(isz),
            "t_ptr": (n + 1) * 4, "t_dst": e * 4, "t_eid": e * 4, "dxl": w * 4}


def fwd_ops(e: int, hh: int, d: int) -> int:
    """Per edge, head and value: z's add, the LeakyReLU's multiply, the
    logit's multiply-add and the weighted sum's."""
    return 6 * e * hh * d


def bwd_dst_ops(e: int, hh: int, d: int) -> int:
    """Per edge, head and value: z's add, the LeakyReLU, the logit's and
    g . rl's multiply-adds, dxr's sum and da's multiply-add."""
    return 9 * e * hh * d


def bwd_src_ops(e: int, hh: int, d: int) -> int:
    """Per edge, head and value: al g and ds lrelu' a, two multiply-adds."""
    return 4 * e * hh * d


def fwd_bound_s(n: int, e: int, hh: int, d: int, isz: int = 2) -> float:
    return bound_s(sum(fwd_bytes(n, e, hh, d, isz).values()), fwd_ops(e, hh, d), "float32")


def bwd_dst_bound_s(n: int, e: int, hh: int, d: int, isz: int = 2) -> float:
    return bound_s(sum(bwd_dst_bytes(n, e, hh, d, isz).values()), bwd_dst_ops(e, hh, d), "float32")


def bwd_src_bound_s(n: int, e: int, hh: int, d: int, isz: int = 2) -> float:
    return bound_s(sum(bwd_src_bytes(n, e, hh, d, isz).values()), bwd_src_ops(e, hh, d), "float32")


def step_flops(n_users: int, n_items: int, n_edges: int, feat_dim: int, hidden: int, layers: int,
               heads: int, samples: int) -> float:
    """A GATv2 step: the item projection (forward 2 I F H, backward its
    weight gradient), per layer the two row transforms xl and xr (forward
    2 x 2 N H (heads H); backward twice that: the weights' and x's
    gradients), the attention (forward 6 E heads H, backward twice the
    forward), and the loss's two score dot products a triple (4 S H, twice
    over in the backward), as `counts/flops.py` counts GAT's."""
    n = n_users + n_items
    proj = 2 * n_items * feat_dim * hidden
    transform = 2 * 2 * n * hidden * heads * hidden
    attention = fwd_ops(n_edges, heads, hidden)
    loss = 2 * 2 * samples * hidden
    forward = proj + layers * (transform + attention) + loss
    backward = proj + layers * (2 * transform + 2 * attention) + 2 * loss
    return float(forward + backward)
