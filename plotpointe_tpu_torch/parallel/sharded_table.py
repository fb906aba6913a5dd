"""Row-sharded embedding tables and their exact lookups.

Counterpart of `plotpointe_tpu/parallel/sharded_table.py` (`shard_size`,
`padded_rows`, `pad_table`, `device_put_row_sharded`, `local_lookup`,
`lookup_replicated`, `lookup_batch_sharded`, `SENTINEL_ID`, `dedup_ids`,
`lookup_batch_dedup`). A table of R rows is zero-padded to
`padded_rows(R, n)` and split into n equal blocks; rank k holds block k.

Each lookup is exact, and its gradient reaches only the owning rank's
rows, already summed over ranks: the lookups are built from the
collectives of `collectives.py` (`all_reduce_sum`, `all_gather_rows`,
`reduce_scatter_rows`), whose backwards are JAX's transposes of `psum`,
`all_gather` and `psum_scatter`. Schemes, as in JAX:

  lookup_replicated     every rank holds the full id batch; each gathers the
                        rows it owns (zeros elsewhere) and one all_reduce
                        combines them;
  lookup_batch_sharded  ids arrive batch-sharded; an all_gather of the ids,
                        a local masked gather, a reduce_scatter back to the
                        batch shards;
  lookup_batch_dedup    the same over each rank's unique ids only
                        (`dedup_ids`: static shape, sorted unique ids first,
                        SENTINEL_ID fill, truncated to `capacity`; an id past
                        capacity reads zeros).
"""
from __future__ import annotations

from typing import Optional

import torch

from plotpointe_tpu_torch.parallel.collectives import (
    all_gather_rows, all_reduce_sum, reduce_scatter_rows)
from plotpointe_tpu_torch.parallel.mesh import DATA, Mesh

SENTINEL_ID = 2**31 - 1


def shard_size(n_rows: int, n_shards: int) -> int:
    """Rows per shard after padding to an even split."""
    return (n_rows + n_shards - 1) // n_shards


def padded_rows(n_rows: int, n_shards: int) -> int:
    return shard_size(n_rows, n_shards) * n_shards


def pad_table(table, n_shards: int) -> torch.Tensor:
    """Zero-pad dim 0 so the row count divides n_shards evenly."""
    t = torch.as_tensor(table)
    target = padded_rows(t.shape[0], n_shards)
    if target == t.shape[0]:
        return t
    return torch.cat([t, t.new_zeros((target - t.shape[0],) + tuple(t.shape[1:]))])


def device_put_row_sharded(table, mesh: Mesh, axis: str = DATA) -> torch.Tensor:
    """This rank's block of the padded table, on the mesh's device."""
    t = pad_table(table, mesh.size(axis))
    rs = t.shape[0] // mesh.size(axis)
    k = mesh.axis_index(axis)
    return t[k * rs:(k + 1) * rs].to(mesh.device).clone()


def local_lookup(table_l: torch.Tensor, ids: torch.Tensor, rows_per_shard: int,
                 shard: int) -> torch.Tensor:
    """This rank's part of a lookup: rows it owns, zeros elsewhere. table_l
    [rs, d] the local block; ids [B] global row ids."""
    loc = ids.long() - shard * rows_per_shard
    hit = (loc >= 0) & (loc < rows_per_shard)
    rows = table_l[loc.clamp(0, rows_per_shard - 1)]
    return torch.where(hit[:, None], rows, torch.zeros_like(rows))


def lookup_replicated(mesh: Mesh, table_l: torch.Tensor, ids: torch.Tensor,
                      axis: str = DATA) -> torch.Tensor:
    """Rows sharded over `axis`, ids replicated (every rank the same [B])
    -> [B, d] on every rank: each rank's owned rows, one all_reduce."""
    return all_reduce_sum(local_lookup(table_l, ids, table_l.shape[0], mesh.axis_index(axis)), mesh)


def lookup_batch_sharded(mesh: Mesh, table_l: torch.Tensor, ids_l: torch.Tensor,
                         axis: str = DATA) -> torch.Tensor:
    """Rows sharded, ids batch-sharded (this rank's [B/n]) -> this rank's
    [B/n, d]: an all_gather of the int32 ids, the locally owned rows
    gathered, a reduce_scatter of the [B, d] partials back to the batch
    shards."""
    ids_all = all_gather_rows(ids_l, mesh)
    part = local_lookup(table_l, ids_all, table_l.shape[0], mesh.axis_index(axis))
    return reduce_scatter_rows(part, mesh)


def dedup_ids(ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Static-shape in-batch dedup: sorted unique ids first, SENTINEL_ID
    fill, the first `capacity` kept (overflow beyond it is dropped)."""
    s = torch.sort(ids.to(torch.int64))[0]
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    u = torch.where(first, s, torch.full_like(s, SENTINEL_ID))
    return torch.sort(u)[0][:capacity].to(torch.int32)


def lookup_batch_dedup(mesh: Mesh, table_l: torch.Tensor, ids_l: torch.Tensor, axis: str = DATA,
                       unique_capacity: Optional[int] = None) -> torch.Tensor:
    """`lookup_batch_sharded` over each rank's unique ids: this rank dedups
    its [B/n] ids (capacity `unique_capacity`, default B/n), the unique ids
    are exchanged and looked up, and duplicates resolve locally by a sorted
    search; an id past capacity reads zeros."""
    bl = ids_l.shape[0]
    cap = bl if unique_capacity is None else min(unique_capacity, bl)
    u = dedup_ids(ids_l, cap)
    n_rows = table_l.shape[0] * mesh.size(axis)
    mine = lookup_batch_sharded(mesh, table_l, torch.clamp(u, max=n_rows - 1), axis)
    mine = torch.where((u < SENTINEL_ID)[:, None], mine, torch.zeros_like(mine))
    pos = torch.searchsorted(u.to(torch.int64), ids_l.to(torch.int64)).clamp(0, cap - 1)
    ok = u[pos] == ids_l
    return torch.where(ok[:, None], mine[pos], torch.zeros_like(mine[pos]))
