"""The exact top-k inner-product search over a catalog (kernels 4, 5 and the
select kernel together): the operation's compulsory bytes are the catalog
and the queries read once and the k ids and scores written; its operations
are every query's score against every row, 2 b n d, at the fastest route
that keeps f32 scores faithful (three TF32 passes on the tensor cores) for
an f32 catalog, or one bf16 pass for a bf16 one. The chunk-max and rescore
stages are one design's way to that answer, so they are not counted."""
from __future__ import annotations

from benchmark.counts.peaks import bound_s


def topk_bytes(b: int, n: int, d: int, k: int, sz: int) -> dict:
    return {"catalog": n * d * sz, "queries": b * d * sz, "out": b * k * 8}


def topk_bound_s(b: int, n: int, d: int, k: int, sz: int = 4) -> float:
    ops = 2 * b * n * d
    if sz == 4:
        return bound_s(sum(topk_bytes(b, n, d, k, sz).values()), 3 * ops, "tfloat32")
    return bound_s(sum(topk_bytes(b, n, d, k, sz).values()), ops, "bfloat16")
