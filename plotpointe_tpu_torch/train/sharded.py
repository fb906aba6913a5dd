"""Training over a mesh of ranks: the Trainer protocol, sharded.

Counterpart of `plotpointe_tpu/train/sharded.py::ShardedTrainer`, with the
same `fit` / `evaluate` / `export_item_embeddings` / results contract as
`Trainer`. One process per rank (`parallel/mesh.py`); every rank runs this
class.

  tables     the big tables (the GAT's user table; LightGCN's user and item
             tables) are row-sharded: zero-padded to divide the mesh, each
             rank holding its block as a Parameter. Adam updates each
             rank's own rows; padded rows get zero gradients and, under
             coupled L2, stay exactly 0. The other parameters are
             replicated and get all-reduced gradients.
  steps      `parallel/spmd.py`: the attention or SpMM kernels on the
             rank's local graph (built once here), owned-row overlays.
  sampling   every rank draws the same global batch from the trainer's
             seeded generators (`Trainer._reseed`) and scores its block.
             As in JAX, a GAT step draws `samples_per_epoch` rounded up to
             a multiple of the mesh, and LightGCN's batch_size * neg_per_pos
             pairs must divide it.
  eval       the sharded forward gives every rank the whole node table;
             every rank then computes the single-device metrics.
  export     checkpoints and the resume state gather the tables once;
             rank 0 writes. The resume state has the single-device
             trainer's format (the tables and their Adam moments whole), so
             a run resumes at any world size.

The overlays and the tables travel exact f32 (JAX's trainer sends bf16):
the owned rows are then the single-device forward's bits, and a sharded fit,
dropout included, equals the single-device fit within the sums' rounding
(JAX's draws another dropout stream on its padded shapes).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from plotpointe_tpu_torch.config import TrainConfig
from plotpointe_tpu_torch.data.splits import Splits
from plotpointe_tpu_torch.graphs.csr import Graph, symmetric_normalized_weights
from plotpointe_tpu_torch.parallel.collectives import all_gather_rows
from plotpointe_tpu_torch.parallel.mesh import Mesh, make_mesh
from plotpointe_tpu_torch.parallel.sharded_table import device_put_row_sharded
from plotpointe_tpu_torch.parallel.spmd import make_sharded_gat_step, make_sharded_lightgcn_step
from plotpointe_tpu_torch.train.trainer import Trainer

_MOMENTS = ("exp_avg", "exp_avg_sq")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ShardedTrainer(Trainer):
    """Trainer over this rank's share of a mesh (default: `make_mesh` of
    `cfg.mesh_shape`)."""

    def __init__(self, model, cfg: TrainConfig, graph: Graph, splits: Splits,
                 item_feats: Optional[np.ndarray] = None, mesh: Optional[Mesh] = None,
                 max_pos_degree: int = 512, device=None):
        if model.config_dict().get("model_family") == "hgt":
            raise ValueError("the sharded trainer runs the original GAT and LightGCN; model_family 'hgt' "
                             "trains on one device (no mesh)")
        if model.config_dict().get("attention", "gat") != "gat":
            raise ValueError(f"the sharded trainer runs the original GAT and LightGCN; "
                             f"attention={model.config_dict()['attention']!r} trains on one device "
                             f"(no mesh)")
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh_shape, device=device)
        super().__init__(model, cfg, graph, splits, item_feats=item_feats,
                         max_pos_degree=max_pos_degree, device=self.mesh.device)
        n = self.mesh.n_shards
        self.writes = self.mesh.rank == 0
        args = (model, cfg.loss, self.mesh, self.n_users, self.n_items, self.graph)
        if self._spmm_op is None:
            self.step = make_sharded_gat_step(*args)
            self.n_samples = _round_up(cfg.samples_per_epoch, n)
            self.tables = {"user_emb": self.n_users}
        else:
            pairs = cfg.batch_size * cfg.neg_per_pos
            if pairs % n:
                raise ValueError(f"batch_size*neg_per_pos ({pairs}) must divide the mesh ({n} shards)")
            self.step = make_sharded_lightgcn_step(*args, symmetric_normalized_weights(self.graph))
            self.tables = {"user_emb": self.n_users, "item_emb": self.n_items}
        self.shards: Dict[str, torch.nn.Parameter] = {}

    # -- parameters: table blocks + the model's replicated parameters ----------

    def params(self) -> Dict[str, torch.Tensor]:
        """The step's parameters in the model's order: this rank's table
        blocks in place of the tables."""
        return {k: self.shards.get(k, p) for k, p in self.model.named_parameters()}

    def _init_params(self) -> None:
        super()._init_params()  # the whole model on every rank, from the same seed
        self.shards = {k: torch.nn.Parameter(device_put_row_sharded(getattr(self.model, k).detach(),
                                                                    self.mesh))
                       for k in self.tables}

    def _trained_params(self):
        return list(self.params().values())

    def _gather(self, block: torch.Tensor, n_rows: int) -> torch.Tensor:
        with torch.no_grad():
            return all_gather_rows(block.detach(), self.mesh)[:n_rows]

    def _block(self, full: torch.Tensor) -> torch.Tensor:
        return device_put_row_sharded(full, self.mesh)

    def _full_state(self) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            for k, n_rows in self.tables.items():
                getattr(self.model, k).copy_(self._gather(self.shards[k], n_rows))
        return super()._full_state()

    def _load_params(self, state: Dict[str, torch.Tensor]) -> None:
        super()._load_params(state)
        with torch.no_grad():
            for k in self.tables:
                self.shards[k].copy_(self._block(getattr(self.model, k)))

    def _opt_state(self) -> Dict[str, Any]:
        """The optimizer state with each table's moments gathered whole."""
        out = super()._opt_state()
        sd = out["optimizer"]
        state = dict(sd["state"])
        for idx, name in enumerate(self.params()):
            if name in self.tables and idx in state:
                st = dict(state[idx])
                for m in _MOMENTS:
                    st[m] = self._gather(st[m], self.tables[name])
                state[idx] = st
        out["optimizer"] = {**sd, "state": state}
        return out

    def _load_opt_state(self, opt_state: Dict[str, Any]) -> None:
        sd = opt_state["optimizer"]
        state = dict(sd["state"])
        for idx, name in enumerate(self.params()):
            if name in self.tables and idx in state:
                st = dict(state[idx])
                for m in _MOMENTS:
                    st[m] = self._block(st[m])
                state[idx] = st
        super()._load_opt_state({**opt_state, "optimizer": {**sd, "state": state}})

    # -- the sharded step and forward --------------------------------------------

    def _loss(self, u, i, j, seeds) -> torch.Tensor:
        return self.step.loss(self.params(), self.item_feats, seeds, u, i, j)

    def _lightgcn_loss(self, u, i, j) -> torch.Tensor:
        npp = j.shape[1]  # the pairs in the single-device loss's order
        return self.step.loss(self.params(), u.repeat_interleave(npp), i.repeat_interleave(npp),
                              j.reshape(-1))

    @torch.no_grad()
    def _forward_eval(self):
        if self._spmm_op is None:
            z = self.step.forward(self.params(), self.item_feats)
        else:
            z = self.step.forward(self.params())
        return z[: self.n_users], z[self.n_users:]
