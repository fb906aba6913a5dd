"""Kernel 7 (the CSR SpMM of LightGCN's propagation): compulsory bytes, a
frozen copy of the port's smoke script's count (x at the row type, the
indices, the values and the row pointer read once, y written once in f32),
and its 2 e d operations."""
from __future__ import annotations

from benchmark.counts.peaks import bound_s


def spmm_bytes(n: int, e: int, d: int, isz: int) -> dict:
    return {"x": n * d * isz, "idx": e * 4, "values": e * 4, "ptr": (n + 1) * 4, "y": n * d * 4}


def spmm_bound_s(n: int, e: int, d: int, isz: int = 2) -> float:
    return bound_s(sum(spmm_bytes(n, e, d, isz).values()), 2 * e * d, "float32")
