"""The HGT kernels (csrc/hgt_fwd.cu, hgt_bwd_dst.cu, hgt_bwd_src.cu) and an
HGT training step, counted from the shapes: each launch's compulsory bytes
in `counts/attention.py`'s convention (each input read once, each output
written once; the per-edge row gathers are not compulsory) and operations
(a multiply and an add count two), and the model FLOPs of a step.

n target nodes, s stacked source rows (users under rates, items under
rated_by and under similar), e edges, hh heads, d a head's width, isz the
bytes of a K' or V' value (2 for bf16 rows). W = hh d. The softmax's
exponentials and the per-edge scalars' arithmetic are not counted."""
from __future__ import annotations

from benchmark.counts.peaks import bound_s

REL = 3


def fwd_bytes(n: int, s: int, e: int, hh: int, d: int, isz: int) -> dict:
    w = hh * d
    return {"q": n * w * 4, "kv": s * 2 * w * isz, "p": REL * hh * 4, "row_ptr": (n + 1) * 4,
            "src": e * 4, "out": n * w * 4, "lse": n * hh * 4}


def bwd_dst_bytes(n: int, s: int, e: int, hh: int, d: int, isz: int) -> dict:
    w = hh * d
    return {"q_g_out": 3 * n * w * 4, "kv": s * 2 * w * isz, "p": REL * hh * 4, "lse": n * hh * 4,
            "row_ptr": (n + 1) * 4, "src": e * 4, "dq": n * w * 4, "dp": REL * hh * 4,
            "edge_scalars": e * 2 * hh * 4}


def bwd_src_bytes(n: int, s: int, e: int, hh: int, d: int) -> dict:
    w = hh * d
    return {"q_g": 2 * n * w * 4, "edge_scalars": e * 2 * hh * 4, "t_ptr": (s + 1) * 4, "t_dst": e * 4,
            "t_eid": e * 4, "dkv": s * 2 * w * 4}


def fwd_ops(e: int, hh: int, d: int) -> int:
    """Per edge, head and value: q . K''s multiply-add and the weighted V'
    sum's."""
    return 4 * e * hh * d


def bwd_dst_ops(e: int, hh: int, d: int) -> int:
    """Per edge, head and value: q . K', g . V' and dq's multiply-adds."""
    return 6 * e * hh * d


def bwd_src_ops(e: int, hh: int, d: int) -> int:
    """Per edge, head and value: dK''s and dV''s multiply-adds."""
    return 4 * e * hh * d


def fwd_bound_s(n: int, s: int, e: int, hh: int, d: int, isz: int = 2) -> float:
    return bound_s(sum(fwd_bytes(n, s, e, hh, d, isz).values()), fwd_ops(e, hh, d), "float32")


def bwd_dst_bound_s(n: int, s: int, e: int, hh: int, d: int, isz: int = 2) -> float:
    return bound_s(sum(bwd_dst_bytes(n, s, e, hh, d, isz).values()), bwd_dst_ops(e, hh, d), "float32")


def bwd_src_bound_s(n: int, s: int, e: int, hh: int, d: int) -> float:
    return bound_s(sum(bwd_src_bytes(n, s, e, hh, d).values()), bwd_src_ops(e, hh, d), "float32")


def step_flops(n_users: int, n_items: int, n_edges: int, feat_dim: int, hidden: int, layers: int,
               heads: int, samples: int) -> float:
    """An HGT step, F = hidden, N = users + items, S = users + 2 items: the
    item projection (forward 2 I feat F, backward its weight gradient), per
    layer the typed K/Q/V products (forward 2 N F 3F), the relation
    transforms of K and V (forward 2 x 2 S heads d^2 = 4 S F d), the edge
    attention (forward `fwd_ops`, backward `bwd_dst_ops` + `bwd_src_ops`)
    and the typed output products (forward 2 N F^2), each product twice
    over in the backward (the weights' and the inputs' gradients: x depends
    on the user table in every layer), and the loss's two score dot
    products a triple (4 S F, twice over in the backward), as
    `counts/flops.py` counts the GAT's."""
    n, s, d = n_users + n_items, n_users + 2 * n_items, hidden // heads
    proj = 2 * n_items * feat_dim * hidden
    dense = 2 * n * hidden * 3 * hidden + 4 * s * hidden * d + 2 * n * hidden * hidden
    loss = 2 * 2 * samples * hidden
    forward = proj + layers * (dense + fwd_ops(n_edges, heads, d)) + loss
    backward = (proj + layers * (2 * dense + bwd_dst_ops(n_edges, heads, d) + bwd_src_ops(n_edges, heads, d))
                + 2 * loss)
    return float(forward + backward)
