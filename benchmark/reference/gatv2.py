"""GATv2 in plain PyTorch, f32: the reference the benchmark and the tests
hold the program's GATv2 to.

GATv2 (Brody, Alon and Yahav 2022, arXiv:2105.14491), as the recommender
applies it: node features x = [user table; item features W_p + b_p]; per
layer l and head k, xl = x W_l,k and xr = x W_r,k (separate weights, PyG's
`share_weights=False`), the source rows rounded to the configuration's row
type, rl = round(xl), and per edge j -> i (canonical id e):

    e_ij,k = a_k . LeakyReLU_0.2(rl_j,k + xr_i,k)      clamped to +-10
    alpha  = exp(e) / (sum over i's in-edges of exp(e) + 1e-9)
    out_i  = mean_k sum_j alpha_ij,k m_ij,k rl_j,k       (concat=False)

with m the dropout multiplier of edge id e + k * 2**27 under the stated
hash of the layer's uint32 seed (`models.hash_keep`). The row rounding is
straight through (the value is rounded, the gradient passes unchanged).
Departures from PyG's `GATv2Conv`, which the program shares: the logit is
clamped to +-10 and no maximum is subtracted before exp (the clamp bounds
it); no biases; the dropout is the hash above, drawn on alpha's numerator
only (the denominator sums every edge), not a Bernoulli draw of
`torch.dropout`; the initial bounds below are the GAT's, where GATv2Conv's
glorot spreads W over heads x D (sqrt(6 / (H + heads D))) and a over heads
(sqrt(6 / (heads + D))). Loss, optimizer and protocol are GAT's
(`training.follow`): BPR, Adam with coupled L2.

Initial weights, from the trainer's init stream in this order: the user
table N(0, 0.1), the projection U(+-1/sqrt(F)) and bias zero, then layer
by layer W_l and W_r Xavier-uniform (bound sqrt(6 / (H + D))) and a
Xavier-uniform (bound sqrt(6 / (1 + D))).

The per-edge work runs in blocks of EDGE_BLOCK edges, each block's
products recomputed in the backward (`torch.utils.checkpoint`), so a
forward at the full graph's 2.66 M edges x 2 heads x 128 holds a block's
tensors and not the whole graph's (one [E, 2, 128] f32 tensor is 2.7 GB).
Gradients come from autograd."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.utils.checkpoint

from benchmark.reference import models, sampling
from benchmark.reference import training as ref

EDGE_BLOCK = 1 << 19
HEAD_ID_STRIDE = 1 << 27


def init(gen, n_users: int, feat_dim: int, hidden: int, layers: int, heads: int) -> Dict[str, torch.Tensor]:
    p = {"user_emb": 0.1 * torch.randn((n_users, hidden), generator=gen, device=gen.device),
         "item_proj.w": models._uniform(gen, (feat_dim, hidden), 1.0 / math.sqrt(feat_dim)),
         "item_proj.b": torch.zeros(hidden, device=gen.device)}
    for li in range(layers):
        for w in ("w_l", "w_r"):
            p[f"layers.{li}.{w}"] = models._uniform(gen, (hidden, heads, hidden), math.sqrt(6.0 / (2 * hidden)))
        p[f"layers.{li}.a"] = models._uniform(gen, (heads, hidden), math.sqrt(6.0 / (1 + hidden)))
    return p


def keep(seed: int, n_edges: int, heads: int, rate: float, device) -> torch.Tensor:
    """[E, heads] dropout multipliers: head k hashes edge ids + k * 2**27
    (`models.hash_keep`'s hash)."""
    out = []
    for k in range(heads):
        x = (torch.arange(n_edges, device=device, dtype=torch.int64) + k * HEAD_ID_STRIDE) ^ (int(seed) & models._M32)
        x = models._mul32(x ^ (x >> 16), 0x7FEB352D)
        x = models._mul32(x ^ (x >> 15), 0x846CA68B)
        x = x ^ (x >> 16)
        kept = x < min(int((1.0 - rate) * 4294967296.0), 4294967295)
        out.append(kept.to(torch.float32) * (1.0 / (1.0 - rate)))
    return torch.stack(out, 1)


def _edge_block(rl, xr, a, src, dst):
    """Per edge of the block: the numerator exp(clamp(a . lrelu(rl_j + xr_i)))
    [Eb, heads] and the unweighted source rows [Eb, heads, D]."""
    rows = rl[src]
    z = rows + xr[dst]
    score = (torch.where(z > 0, z, models.LEAKY * z) * a).sum(-1)
    return torch.exp(torch.clamp(score, -models.CLAMP, models.CLAMP)), rows


def _block_sums(rl, xr, a, src, dst, kb, n_nodes: int):
    num, rows = _edge_block(rl, xr, a, src, dst)
    w = num if kb is None else num * kb
    return num, torch.zeros((n_nodes,) + rl.shape[1:], device=rl.device).index_add(0, dst, w[:, :, None] * rows)


def attention(xl, xr, a, g, rows_dtype, kept: Optional[torch.Tensor]):
    """One GATv2 layer over graph g (src, dst, n_nodes): xl, xr [N, heads, D]
    -> [N, heads, D]."""
    rl = models.round_rows(xl, rows_dtype)
    den = torch.zeros(xl.shape[:2], device=xl.device)
    acc = torch.zeros_like(xl)
    for e0 in range(0, g.n_edges, EDGE_BLOCK):
        src, dst = g.src[e0:e0 + EDGE_BLOCK], g.dst[e0:e0 + EDGE_BLOCK]
        kb = None if kept is None else kept[e0:e0 + EDGE_BLOCK]
        if torch.is_grad_enabled():
            num, part = torch.utils.checkpoint.checkpoint(_block_sums, rl, xr, a, src, dst, kb, g.n_nodes,
                                                          use_reentrant=False)
        else:
            num, part = _block_sums(rl, xr, a, src, dst, kb, g.n_nodes)
        den = den.index_add(0, dst, num)
        acc = acc + part
    return acc / (den[:, :, None] + models.EPS)


def forward(p, feats, g, layers: int, rows_dtype, rate: float = 0.0,
            seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    x = torch.cat([p["user_emb"], feats @ p["item_proj.w"] + p["item_proj.b"]])
    for li in range(layers):
        a = p[f"layers.{li}.a"]
        kept = None if not seeds or rate <= 0 else keep(seeds[li], g.n_edges, a.shape[0], rate, x.device)
        xl = torch.einsum("nf,fhd->nhd", x, p[f"layers.{li}.w_l"])
        xr = torch.einsum("nf,fhd->nhd", x, p[f"layers.{li}.w_r"])
        x = attention(xl, xr, a, g, rows_dtype, kept).mean(1)
    return x


def embed(p, prep: ref.Prepared, cfg: dict, rows, seeds=None, train: bool = False) -> torch.Tensor:
    rate = cfg["attn_dropout"] if train else 0.0
    return forward(p, prep.feats, prep.graph, cfg["layers"], rows, rate, seeds)


def init_params(prep: ref.Prepared, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = sampling.reseed(torch.Generator(device=device), seed, sampling.STREAM_INIT, 0)
    return init(gen, prep.splits.n_users, prep.feats.shape[1], cfg["hidden_dim"], cfg["layers"],
                cfg["heads"])


def loss_of(p, prep: ref.Prepared, cfg: dict, rows, u, i, j, seeds) -> torch.Tensor:
    """BPR of the triples' scores from a full-graph forward with dropout."""
    z = embed(p, prep, cfg, rows, seeds, train=True)
    U = prep.splits.n_users
    zu, zi, zj = z[u], z[U + i], z[U + j]
    return models.bpr((zu * zi).sum(-1), (zu * zj).sum(-1))


def follow(prep: ref.Prepared, cfg: dict, seed: int, device, steps: int = 3, rows: str = "bfloat16",
           tf32: bool = False, keep_share: float = 1.0) -> ref.Readings:
    """`training.follow`'s GAT protocol on GATv2: each step's loss, the first
    gradient's and the first three steps' change's leaf norms, the weights
    after `steps` steps."""
    rt = ref.ROW_TYPES[rows]
    p = init_params(prep, cfg, seed, device)
    p0 = {k: v.clone() for k, v in p.items()}
    opt = models.Adam(p, cfg["lr"], cfg["l2"])
    gen = torch.Generator(device=device)
    out = ref.Readings()
    per_epoch = ref.steps_per_epoch(cfg, len(prep.splits.train_u))
    with ref.matmul_precision(tf32):
        for step in range(steps):
            if step % per_epoch == 0:
                sampling.reseed(gen, seed, sampling.STREAM_TRAIN, step // per_epoch + 1)
            for v in p.values():
                v.requires_grad_(True)
            u, i, j = sampling.bpr_triples(gen, prep.train_users, prep.table, prep.deg,
                                           prep.splits.n_items, cfg["samples_per_epoch"])
            seeds = sampling.layer_seeds(gen, cfg["layers"], device) if cfg["attn_dropout"] > 0 else None
            n = max(1, int(round(len(u) * keep_share)))
            loss = loss_of(p, prep, cfg, rt, u[:n], i[:n], j[:n], seeds)
            grads = torch.autograd.grad(loss, list(p.values()))
            out.losses.append(float(loss.detach()))
            for v in p.values():
                v.requires_grad_(False)
            opt.step(dict(zip(p.keys(), grads)))
            del grads, loss
            if step + 1 == ref.CHANGE_STEPS:
                out.change_norms = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in p}
                p0 = None
    out.grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in opt.first_grad.items()}
    out.params = p
    return out
