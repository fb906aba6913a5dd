"""Kernels 1, 2 and 3 (the GAT attention forward, B1 and B2) at one head:
compulsory bytes (frozen copies of the port's smoke script's
`fwd_mh_bytes`, `bwd_dst_bytes` and `bwd_src_bytes`) and operations, so a
launch's bound is counted from the shapes alone.

n nodes, e edges, hh heads, d the row width, isz the bytes of a rounded
source row's element (2 for bf16 rows)."""
from __future__ import annotations

from benchmark.counts.peaks import bound_s


def fwd_mh_bytes(n: int, e: int, hh: int, d: int, masked: bool) -> dict:
    """The attention forward's compulsory bytes at hh heads: each input read
    once, each output written once (the rounded rows and the per-edge row
    gathers are not)."""
    return {"h": n * hh * d * 4, "a": 2 * hh * d * 4, "row_ptr": (n + 1) * 4, "src": e * 4,
            "mask": hh * e * 4 if masked else 0, "out": n * hh * d * 4, "den": n * hh * 4}


def bwd_dst_bytes(n: int, e: int, hh: int, d: int, isz: int, masked: bool) -> dict:
    """B1's compulsory bytes at hh heads: each input read once, each output
    written once."""
    return {"rows": n * hh * d * isz, "g": n * hh * d * 4, "out": n * hh * d * 4, "src": e * 4,
            "mask": hh * e * 4 if masked else 0, "row_ptr": (n + 1) * 4, "gs_gd_den": 3 * n * hh * 4,
            "de_sum_godot": 2 * n * hh * 4, "da_src": hh * d * 4}


def bwd_src_bytes(n: int, e: int, d: int, isz: int) -> dict:
    """B2's compulsory bytes with the mask: each input read once, dh written
    once."""
    return {"rows": n * d * isz, "g_rounded": n * d * isz, "a_src": d * 4,
            "gs_gd_den_godot": 4 * n * 4, "t_ptr": (n + 1) * 4, "t_dst": e * 4,
            "t_eid": e * 4, "mask": e * 4, "dh": n * d * 4}


def fwd_ops(n: int, e: int, d: int) -> int:
    """gs and gd (2 n d each) and the weighted row sum (2 e d)."""
    return 4 * n * d + 2 * e * d


def bwd_dst_ops(n: int, e: int, d: int) -> int:
    """g . row per edge (2 e d) and d a_src (2 e d)."""
    return 4 * e * d


def bwd_src_ops(n: int, e: int, d: int) -> int:
    """alpha g per edge into dh (2 e d) and the source logit term (2 e d)."""
    return 4 * e * d


def fwd_bound_s(n: int, e: int, d: int, masked: bool, isz: int = 2) -> float:
    return bound_s(sum(fwd_mh_bytes(n, e, 1, d, masked).values()), fwd_ops(n, e, d), "float32")


def bwd_dst_bound_s(n: int, e: int, d: int, isz: int = 2) -> float:
    return bound_s(sum(bwd_dst_bytes(n, e, 1, d, isz, True).values()), bwd_dst_ops(n, e, d), "float32")


def bwd_src_bound_s(n: int, e: int, d: int, isz: int = 2) -> float:
    return bound_s(sum(bwd_src_bytes(n, e, d, isz).values()), bwd_src_ops(n, e, d), "float32")
