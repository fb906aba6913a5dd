"""HGT in plain PyTorch, f32: the reference the benchmark and the tests hold
the program's HGT to.

HGT (Hu, Dong, Wang and Sun 2020, arXiv:2003.01332; the layer PyG ships as
`HGTConv`), as the recommender applies it: node features x = [user table;
item features W_p + b_p]; node types user and item; relations rates (user
-> item, a train interaction), rated_by (item -> user, the same
interaction) and similar (item j -> item i for each j among i's k nearest
item features by cosine); per layer, F = heads x D:

    [K | Q | V]_t = x_t W_t + b_t                     per node type t
    K'_e, V'_e    = K_s A_r,h, V_s M_r,h                per head, r = the edge's
                                                        relation, no bias
    a_e,h         = p_r,h (Q_t,h . K'_e,h) / sqrt(D)    edge e = s -> t
    alpha         = softmax of a over all of t's in-edges, every relation
    out_t         = concat_h sum_e alpha_e,h V'_e,h     0 with no in-edges
    x'_t          = sigmoid(skip_t) (GELU(out_t) W'_t + b'_t) + (1 - sigmoid(skip_t)) x_t

K' and V' are rounded to the configuration's row type, straight through
(the value rounded, the gradient passed unchanged). The softmax subtracts
each target's largest logit (taken without gradient: the softmax does not
depend on it). Departures from the paper and from `HGTConv`: no relative
temporal encoding (the data has no time feature; `HGTConv` has none); no
dropout (as `HGTConv`); the inputs are the GAT's (a learned user table, a
projection of the item features) and not typed input projections; the item
kNN relation is this recommender's, not the paper's; BPR, Adam with coupled
L2 1e-4 and the GAT's protocol (`training.follow`) in place of the paper's
AdamW and cosine schedule.

Initial weights, from the trainer's init stream in this order: the user
table N(0, 0.1), the projection U(+-1/sqrt(feat)) and bias zero; then layer
by layer A, M [3, heads, D, D] U(+-1/sqrt(D)), p ones [3, heads], W_t
[F, 3F] and b_t [3F] of users then items U(+-1/sqrt(F)), W'_t [F, F] and
b'_t [F] likewise, skip ones (PyG's `ones`).

The per-edge work runs in blocks of EDGE_BLOCK edges, each block's
products recomputed in the backward (`torch.utils.checkpoint`), so a
forward over ~3.9 M edges x 8 heads x 32 holds a block's tensors and not
the whole graph's. Gradients come from autograd.

`knn_edges` works out the kNN relation from the item features in plain
f32 products (TF32 off); the benchmark hands its (row, col) arrays to both
sides, as it hands them the interactions."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.utils.checkpoint

from benchmark.reference import models, sampling
from benchmark.reference import training as ref

EDGE_BLOCK = 1 << 19
TYPES = ("user", "item")
REL_SOURCE = ("user", "item", "item")  # rates, rated_by, similar


@dataclass
class TypedGraph:
    src: torch.Tensor  # int64 [E] the source's row of the relation's source table
    dst: torch.Tensor  # int64 [E] the target node
    rel: torch.Tensor  # int64 [E]
    n_users: int
    n_items: int

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def knn_edges(feats: torch.Tensor, k: int, min_similarity: float, block: int = 4096):
    """(rows, cols) int64 numpy: each item i and its k most cosine-similar
    other items j (similarity >= min_similarity)."""
    x = feats.float()
    x = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-8)
    n = x.shape[0]
    rows, cols = [], []
    with ref.matmul_precision(False):
        for r0 in range(0, n, block):
            sim = x[r0:r0 + block] @ x.T
            b = sim.shape[0]
            sim[torch.arange(b, device=x.device), torch.arange(r0, r0 + b, device=x.device)] = -math.inf
            val, idx = torch.topk(sim, min(k, n - 1), dim=1)
            keep = val >= min_similarity
            rows.append(torch.arange(r0, r0 + b, device=x.device)[:, None].expand_as(idx)[keep])
            cols.append(idx[keep])
    return torch.cat(rows).cpu().numpy().astype(np.int64), torch.cat(cols).cpu().numpy().astype(np.int64)


def typed_graph(s, rows: np.ndarray, cols: np.ndarray, device) -> TypedGraph:
    """The three relations' edges, ordered by target (ties in input order):
    rates (u -> U + i; source row u of the user table), rated_by (U + i -> u;
    row i of the item table), similar (U + j -> U + i; row j)."""
    u, i = s.train_u.astype(np.int64), s.train_i.astype(np.int64)
    src = np.concatenate([u, i, np.asarray(cols, np.int64)])
    dst = np.concatenate([s.n_users + i, u, s.n_users + np.asarray(rows, np.int64)])
    rel = np.repeat(np.arange(3), [len(u), len(i), len(rows)])
    order = np.argsort(dst, kind="stable")
    t = lambda a: torch.as_tensor(a[order], device=device)  # noqa: E731
    return TypedGraph(t(src), t(dst), t(rel), s.n_users, s.n_items)


def prepare(inter: dict, feats: np.ndarray, rows: np.ndarray, cols: np.ndarray, device) -> ref.Prepared:
    """`training.prepare`'s splits, positives and features, with the typed
    graph in place of the user-item graph."""
    prep = ref.prepare(inter, feats, "gat", device)
    return dataclasses.replace(prep, graph=typed_graph(prep.splits, rows, cols, device))


def protocol(cfg: dict) -> dict:
    """`cfg` as `training.py`'s step protocol reads it: the HGT trains with
    the GAT's (one draw of `samples_per_epoch` triples a step,
    `steps_per_epoch` steps an epoch), which those helpers key on the GAT
    family."""
    return {**cfg, "model_family": "gat"}


def init(gen, n_users: int, feat_dim: int, hidden: int, layers: int, heads: int) -> Dict[str, torch.Tensor]:
    d = hidden // heads
    p = {"user_emb": 0.1 * torch.randn((n_users, hidden), generator=gen, device=gen.device),
         "item_proj.w": models._uniform(gen, (feat_dim, hidden), 1.0 / math.sqrt(feat_dim)),
         "item_proj.b": torch.zeros(hidden, device=gen.device)}
    for li in range(layers):
        pre = f"layers.{li}."
        for w in ("k_rel", "v_rel"):
            p[pre + w] = models._uniform(gen, (3, heads, d, d), 1.0 / math.sqrt(d))
        p[pre + "p_rel"] = torch.ones((3, heads), device=gen.device)
        for lin, width in (("kqv", 3 * hidden), ("out", hidden)):
            for t in TYPES:
                p[f"{pre}{lin}.{t}.w"] = models._uniform(gen, (hidden, width), 1.0 / math.sqrt(hidden))
                p[f"{pre}{lin}.{t}.b"] = models._uniform(gen, (width,), 1.0 / math.sqrt(hidden))
        for t in TYPES:
            p[f"{pre}skip.{t}"] = torch.ones(1, device=gen.device)
    return p


def _logits(q, kp, prior, src, dst, rel, scale: float):
    return (q[dst] * kp[src]).sum(-1) * (prior[rel] * scale)


def _block_sums(q, kp, vp, prior, top, src, dst, rel, scale: float, n_nodes: int):
    num = torch.exp(_logits(q, kp, prior, src, dst, rel, scale) - top[dst])
    den = torch.zeros((n_nodes, q.shape[1]), device=q.device).index_add(0, dst, num)
    acc = torch.zeros((n_nodes,) + q.shape[1:], device=q.device).index_add(0, dst, num[:, :, None] * vp[src])
    return den, acc


def attention(q, kp, vp, prior, g: TypedGraph, scale: float):
    """q [N, heads, D], kp, vp [S, heads, D] (the relation-stacked rows:
    users under rates, items under rated_by, items under similar), prior
    [3, heads] -> [N, heads, D]."""
    offset = torch.tensor([0, g.n_users, g.n_nodes], device=q.device)
    blocks = [(g.src[e0:e0 + EDGE_BLOCK] + offset[g.rel[e0:e0 + EDGE_BLOCK]], g.dst[e0:e0 + EDGE_BLOCK],
               g.rel[e0:e0 + EDGE_BLOCK]) for e0 in range(0, g.n_edges, EDGE_BLOCK)]
    heads = q.shape[1]
    with torch.no_grad():
        top = torch.full((g.n_nodes, heads), -math.inf, device=q.device)
        for src, dst, rel in blocks:
            top = top.scatter_reduce(0, dst[:, None].expand(-1, heads),
                                     _logits(q, kp, prior, src, dst, rel, scale), "amax")
    den = torch.zeros((g.n_nodes, heads), device=q.device)
    acc = torch.zeros_like(q)
    for src, dst, rel in blocks:
        args = (q, kp, vp, prior, top, src, dst, rel, scale, g.n_nodes)
        if torch.is_grad_enabled():
            d, a = torch.utils.checkpoint.checkpoint(_block_sums, *args, use_reentrant=False)
        else:
            d, a = _block_sums(*args)
        den, acc = den + d, acc + a
    return acc / den.clamp_min(1.0)[:, :, None]  # a target with an edge has den >= 1


def forward(p, feats, g: TypedGraph, layers: int, heads: int, rows_dtype) -> torch.Tensor:
    x = torch.cat([p["user_emb"], feats @ p["item_proj.w"] + p["item_proj.b"]])
    hidden = x.shape[1]
    d = hidden // heads
    u = g.n_users
    for li in range(layers):
        pre = f"layers.{li}."
        parts = {"user": x[:u], "item": x[u:]}
        kqv = {t: (parts[t] @ p[f"{pre}kqv.{t}.w"] + p[f"{pre}kqv.{t}.b"]).view(-1, 3, heads, d)
               for t in TYPES}
        q = torch.cat([kqv[t][:, 1] for t in TYPES])
        kp = torch.cat([torch.einsum("nhd,hde->nhe", kqv[t][:, 0], p[pre + "k_rel"][r])
                        for r, t in enumerate(REL_SOURCE)])
        vp = torch.cat([torch.einsum("nhd,hde->nhe", kqv[t][:, 2], p[pre + "v_rel"][r])
                        for r, t in enumerate(REL_SOURCE)])
        out = attention(q, models.round_rows(kp, rows_dtype), models.round_rows(vp, rows_dtype),
                        p[pre + "p_rel"], g, 1.0 / math.sqrt(d))
        new = []
        for t, m in (("user", out[:u]), ("item", out[u:])):
            y = torch.nn.functional.gelu(m.reshape(-1, hidden)) @ p[f"{pre}out.{t}.w"] + p[f"{pre}out.{t}.b"]
            a = torch.sigmoid(p[f"{pre}skip.{t}"])
            new.append(a * y + (1 - a) * parts[t])
        x = torch.cat(new)
    return x


def embed(p, prep: ref.Prepared, cfg: dict, rows, seeds=None, train: bool = False) -> torch.Tensor:
    return forward(p, prep.feats, prep.graph, cfg["layers"], cfg["heads"], rows)


def init_params(prep: ref.Prepared, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = sampling.reseed(torch.Generator(device=device), seed, sampling.STREAM_INIT, 0)
    return init(gen, prep.splits.n_users, prep.feats.shape[1], cfg["hidden_dim"], cfg["layers"],
                cfg["heads"])


def loss_of(p, prep: ref.Prepared, cfg: dict, rows, u, i, j) -> torch.Tensor:
    """BPR of the triples' scores from a full-graph forward."""
    z = embed(p, prep, cfg, rows)
    U = prep.splits.n_users
    zu, zi, zj = z[u], z[U + i], z[U + j]
    return models.bpr((zu * zi).sum(-1), (zu * zj).sum(-1))


def follow(prep: ref.Prepared, cfg: dict, seed: int, device, steps: int = 3, rows: str = "bfloat16",
           tf32: bool = False, keep_share: float = 1.0) -> ref.Readings:
    """`training.follow`'s GAT protocol on HGT (no dropout seeds are drawn):
    each step's loss, the first gradient's and the first three steps'
    change's leaf norms, the weights after `steps` steps."""
    rt = ref.ROW_TYPES[rows]
    p = init_params(prep, cfg, seed, device)
    p0 = {k: v.clone() for k, v in p.items()}
    opt = models.Adam(p, cfg["lr"], cfg["l2"])
    gen = torch.Generator(device=device)
    out = ref.Readings()
    per_epoch = ref.steps_per_epoch(protocol(cfg), len(prep.splits.train_u))
    with ref.matmul_precision(tf32):
        for step in range(steps):
            if step % per_epoch == 0:
                sampling.reseed(gen, seed, sampling.STREAM_TRAIN, step // per_epoch + 1)
            for v in p.values():
                v.requires_grad_(True)
            u, i, j = sampling.bpr_triples(gen, prep.train_users, prep.table, prep.deg,
                                           prep.splits.n_items, cfg["samples_per_epoch"])
            n = max(1, int(round(len(u) * keep_share)))
            loss = loss_of(p, prep, cfg, rt, u[:n], i[:n], j[:n])
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
