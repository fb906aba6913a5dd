"""LightGCN: user and item embedding tables propagated over the normalized
bipartite adjacency.

Counterpart of `plotpointe_tpu/models/lightgcn.py::LightGCNModel`: tables
`user_emb [U, D]` and `item_emb [I, D]` drawn N(0, 0.1), K rounds of
D^-1/2 A D^-1/2 propagation and the mean over rounds 0..K. The `state_dict`
keys are the JAX checkpoint's key-paths with dots (`['user_emb']` <->
`user_emb`), so checkpoints carry across with `params_from_jax` /
`params_to_jax`.

Propagation runs the static SpMM operator (`ops/spmm_kernel.make_spmm`,
kernel 7 forward and backward) at `xs_dtype` rows: bfloat16 is what the JAX
trainer's Pallas operator computes, float32 the function its XLA path (and
its export) computes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from plotpointe_tpu_torch.graphs.csr import Graph, symmetric_normalized_weights
from plotpointe_tpu_torch.ops.spmm_kernel import SpmmOperator, make_spmm


class LightGCNModel(nn.Module):
    def __init__(self, n_users: int, n_items: int, embed_dim: int = 64, n_prop_layers: int = 3,
                 xs_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_users, self.n_items = n_users, n_items
        self.embed_dim, self.n_prop_layers, self.xs_dtype = embed_dim, n_prop_layers, xs_dtype
        self.user_emb = nn.Parameter(torch.zeros(n_users, embed_dim))
        self.item_emb = nn.Parameter(torch.zeros(n_items, embed_dim))

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Both tables N(0, 0.1), users first; draws on the generator's device."""
        for p in (self.user_emb, self.item_emb):
            p.copy_(0.1 * torch.randn(p.shape, generator=generator, device=generator.device))

    def operator(self, graph: Graph) -> SpmmOperator:
        """The propagation operator of `graph`: its symmetric normalized edge
        values, aligned once, at this model's row type."""
        return make_spmm(graph, symmetric_normalized_weights(graph), self.xs_dtype)

    def forward(self, spmm_op: SpmmOperator) -> torch.Tensor:
        """Node embeddings [n_nodes, D], users first: K propagation rounds,
        mean over rounds 0..K."""
        acc = out = torch.cat([self.user_emb, self.item_emb], dim=0)
        for _ in range(self.n_prop_layers):
            out = spmm_op(out)
            acc = acc + out
        return acc / (self.n_prop_layers + 1)

    def propagate(self, spmm_op: SpmmOperator) -> Tuple[torch.Tensor, torch.Tensor]:
        """(users [U, D], items [I, D]) of `forward`."""
        z = self(spmm_op)
        return z[: self.n_users], z[self.n_users:]

    def config_dict(self) -> Dict[str, Any]:
        return {
            "model_family": "lightgcn",
            "n_users": self.n_users,
            "n_items": self.n_items,
            "embed_dim": self.embed_dim,
            "n_prop_layers": self.n_prop_layers,
        }

    @staticmethod
    def from_config(d: Dict[str, Any]) -> "LightGCNModel":
        return LightGCNModel(
            n_users=int(d["n_users"]),
            n_items=int(d["n_items"]),
            embed_dim=int(d.get("embed_dim", 64)),
            n_prop_layers=int(d.get("n_prop_layers", 3)),
        )
