"""Multi-GPU training: one process per rank over `torch.distributed`.

Counterpart of `plotpointe_tpu/parallel/`; exports the names its
`__init__` exports. `mesh.py` (the mesh of ranks), `multihost.py`
(starting the ranks, host arrays to ranks), `collectives.py` (every
collective, with its gradient and the audit's recorder),
`sharded_table.py` (row-sharded tables), `spmd.py` (the partition, the
sharded attention, SpMM and steps), `cases.py` (what spawned ranks run
for the tests and the dry run).
"""
from plotpointe_tpu_torch.parallel.mesh import make_mesh, parse_mesh_shape
from plotpointe_tpu_torch.parallel.spmd import (
    make_sharded_train_step,
    shard_graph_by_edges,
    sharded_attention,
)

__all__ = [
    "make_mesh",
    "parse_mesh_shape",
    "shard_graph_by_edges",
    "sharded_attention",
    "make_sharded_train_step",
]
