"""The two models, their loss and their optimizer in plain PyTorch, f32.

GAT (Velickovic et al. 2018, as the recommender applies it): node features
x = [user table; item features W_p + b_p]; per layer h = x W, source rows
rounded to the configuration's row type r = round(h), per edge s -> d the
logit e = LeakyReLU_0.2(r_s . a_src + h_d . a_dst) clamped to +-10, alpha =
exp(e) / (sum over d's in-edges of exp(e) + 1e-9), dropout on alpha by the
stated hash of the edge id and a per-layer uint32 seed, out_d = sum alpha
mask r_s. No max is subtracted (the clamp bounds exp).

LightGCN (He et al. 2020): z0 = [user table; item table], z_{k+1} = A
round(z_k) with A = D^-1/2 A D^-1/2, output the mean of z_0..z_K.

The row rounding is a straight-through round: the value is rounded, the
gradient passes unchanged. Loss: BPR, -log(sigmoid(pos - neg) + 1e-8),
mean. Optimizer: Adam with the L2 term added to the gradient before the
moments (coupled), betas 0.9 / 0.999, eps 1e-8.

Initial weights are drawn from the trainer's init stream as stated: the
user table N(0, 0.1), the projection U(+-1/sqrt(F)), each layer's W,
a_src, a_dst Xavier-uniform, biases zero; LightGCN's tables N(0, 0.1),
users first."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

LEAKY, CLAMP, EPS = 0.2, 10.0, 1e-9
_M32 = 0xFFFFFFFF


def round_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return x
    return x + (x.detach().to(dtype).to(torch.float32) - x.detach())


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_keep(seed: int, n: int, rate: float, device) -> torch.Tensor:
    """The stated dropout multiplier of edge ids 0..n-1: a splitmix32-style
    hash of the id xor the uint32 seed below (1 - rate) 2**32 keeps the edge
    (times 1 / (1 - rate)), else drops it."""
    x = torch.arange(n, device=device, dtype=torch.int64) ^ (int(seed) & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    keep = x < min(int((1.0 - rate) * 4294967296.0), 4294967295)
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


def _uniform(gen, shape, bound: float) -> torch.Tensor:
    return (2.0 * torch.rand(shape, generator=gen, device=gen.device) - 1.0) * bound


def gat_init(gen, n_users: int, feat_dim: int, hidden: int, layers: int) -> Dict[str, torch.Tensor]:
    p = {"user_emb": 0.1 * torch.randn((n_users, hidden), generator=gen, device=gen.device),
         "item_proj.w": _uniform(gen, (feat_dim, hidden), 1.0 / math.sqrt(feat_dim)),
         "item_proj.b": torch.zeros(hidden, device=gen.device)}
    for li in range(layers):
        p[f"layers.{li}.w"] = _uniform(gen, (hidden, 1, hidden), math.sqrt(6.0 / (2 * hidden)))
        p[f"layers.{li}.a_src"] = _uniform(gen, (1, hidden), math.sqrt(6.0 / (1 + hidden)))
        p[f"layers.{li}.a_dst"] = _uniform(gen, (1, hidden), math.sqrt(6.0 / (1 + hidden)))
    return p


def lightgcn_init(gen, n_users: int, n_items: int, dim: int) -> Dict[str, torch.Tensor]:
    return {"user_emb": 0.1 * torch.randn((n_users, dim), generator=gen, device=gen.device),
            "item_emb": 0.1 * torch.randn((n_items, dim), generator=gen, device=gen.device)}


def attention(h, a_src, a_dst, g, rows_dtype, keep: Optional[torch.Tensor]):
    """One single-head layer over graph g (src, dst, n_nodes)."""
    r = round_rows(h, rows_dtype)
    gs, gd = r @ a_src, h @ a_dst
    e = gs[g.src] + gd[g.dst]
    num = torch.exp(torch.clamp(torch.where(e > 0, e, LEAKY * e), -CLAMP, CLAMP))
    den = torch.zeros(g.n_nodes, device=h.device).index_add(0, g.dst, num)
    w = num if keep is None else num * keep
    out = torch.zeros_like(h).index_add(0, g.dst, w[:, None] * r[g.src])
    return out / (den[:, None] + EPS)


def gat_forward(p, feats, g, layers: int, rows_dtype, rate: float = 0.0,
                seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    x = torch.cat([p["user_emb"], feats @ p["item_proj.w"] + p["item_proj.b"]])
    for li in range(layers):
        keep = None if not seeds or rate <= 0 else hash_keep(seeds[li], g.n_edges, rate, x.device)
        x = attention(x @ p[f"layers.{li}.w"][:, 0, :], p[f"layers.{li}.a_src"][0],
                      p[f"layers.{li}.a_dst"][0], g, rows_dtype, keep)
    return x


def lightgcn_forward(p, g, values, rounds: int, rows_dtype) -> torch.Tensor:
    acc = z = torch.cat([p["user_emb"], p["item_emb"]])
    for _ in range(rounds):
        r = round_rows(z, rows_dtype)
        z = torch.zeros_like(r).index_add(0, g.dst, values[:, None] * r[g.src])
        acc = acc + z
    return acc / (rounds + 1)


def bpr(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.sigmoid(pos - neg) + 1e-8).mean()


class Adam:
    """Adam with coupled L2 (the gradient gets l2 p before the moments)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, l2: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.p, self.lr, self.l2, self.b1, self.b2, self.eps = params, lr, l2, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.first_grad: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k] + self.l2 * p
            if self.t == 1:
                self.first_grad[k] = g.clone()
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))
