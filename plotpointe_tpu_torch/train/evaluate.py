"""Sampled-negative Recall@K / NDCG@K evaluation.

Counterpart of `plotpointe_tpu/train/evaluate.py`: per eval user, one
positive and `neg_k` negatives drawn uniformly over items outside the user's
train positives and the positive itself; rank = 1 + (number of negatives
scoring strictly higher); recall@K = 1[rank <= K]; ndcg@K = 1/log2(rank + 1)
on a hit; macro mean. A non-finite positive score counts as unranked (a
diverged model would otherwise rank first everywhere), and `tie_fraction`
reports the share of negatives exactly tying the positive.

Users go in chunks of `chunk`. Each chunk's ranks and ties come from one
launch of `ops/eval_kernel.eval_rank`, which scores just the positive and the
negatives of each user, each as one f32 FMA chain (f32 throughout, as the JAX
package asks for HIGH precision: a rank comparison is sensitive to rounding);
on the CPU its plain version scores all items with one f32 matrix product and
gathers the candidates. Rows whose width is not a multiple of 4 (the anchor's
one-column baselines) are padded with zero columns first, which leaves every
score as it was.

On a CUDA device a chunk's ~55 launches are replayed from two CUDA graphs
(`_ChunkGraphs`), so the host no longer paces the eval: `G_neg` draws the
chunk's negatives (`sample_eval_negatives`) and `G_scores` runs
`eval_from_negatives` and adds the chunk's sums into static sums. The graphs
read static buffers: the chunk's users, positives and `valid` (copied from the
split, staged on the device once, by one copy a chunk) and U and I (copied
once an eval). One set of graphs serves every eval with the same key (device,
chunk, shapes, neg_k, ks, the tables' storage, the generator); it is captured
at the key's second chunk, after its first ran eagerly, and replayed from then
on; the last `MAX_GRAPH_SETS` keys used keep their sets. The generator is
registered with `G_neg`, so a replay draws what the eager call draws from the
same seed and offset and advances the generator as far. The sums start from
zero and take the chunks in order, as the eager loop's do, so the metrics
equal the eager loop's to the bit. On the CPU the chunks run eagerly.

Spans (`utils/tracing.py`): per chunk `eval.negatives` and `eval.scores` (the
ranks and the sums, with its device interval), then `eval.read` (the totals'
read). Counters (`ops/eval_kernel.py`): `EVAL_GRAPH_CAPTURES` (one a key),
`EVAL_GRAPH_REPLAYS` (two a graphed chunk); `EVAL_RANK_LAUNCHES` counts one a
chunk, eager or replayed.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch.ops.eval_kernel import (
    EVAL_GRAPH_CAPTURES, EVAL_GRAPH_REPLAYS, EVAL_RANK_LAUNCHES, eval_rank)
from plotpointe_tpu_torch.train.sampling import sample_eval_negatives
from plotpointe_tpu_torch.utils import tracing

MAX_GRAPH_SETS = 4  # keys kept at once (a set holds U and I, ~131 MB for the GAT's)


def eval_from_negatives(U: torch.Tensor, I: torch.Tensor, users: torch.Tensor, pos: torch.Tensor,
                        negs: torch.Tensor, valid: torch.Tensor,
                        ks: Sequence[int] = (10, 20)) -> Dict[str, torch.Tensor]:
    """Sums over one chunk (`_eval_chunk`'s outputs): `tie_frac_sum`,
    `recall@k_sum`, `ndcg@k_sum`, `count`. users/pos [C], negs [C, neg_k],
    valid [C] float {0, 1}."""
    rank, ties = eval_rank(U, I, users, pos, negs)
    ties = ties.to(torch.float32) / negs.shape[1]
    out = {"tie_frac_sum": (ties * valid).sum()}
    rank_f = rank.to(torch.float32)
    for k in ks:
        hit = rank <= k
        out[f"recall@{k}_sum"] = (hit.to(torch.float32) * valid).sum()
        ndcg = torch.where(hit, 1.0 / torch.log2(rank_f + 1.0), torch.zeros_like(rank_f))
        out[f"ndcg@{k}_sum"] = (ndcg * valid).sum()
    out["count"] = valid.sum()
    return out


def _eager_totals(U, I, eval_users, eval_pos, user_pos_padded, user_deg, generator, neg_k, ks,
                  chunk) -> Dict[str, float]:
    """The sums over every chunk, launched chunk by chunk (the CPU's path)."""
    n = len(eval_users)
    n_pad = ((n + chunk - 1) // chunk) * chunk
    dev = U.device
    users = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    pos = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    users[:n] = torch.as_tensor(np.asarray(eval_users, np.int32), device=dev)
    pos[:n] = torch.as_tensor(np.asarray(eval_pos, np.int32), device=dev)
    valid[:n] = 1.0
    if U.shape[1] % 4:  # the rank kernel reads rows in 16-byte loads; zero columns add exact zeros
        U, I = (torch.nn.functional.pad(x, (0, -U.shape[1] % 4)) for x in (U, I))

    sums: Dict[str, torch.Tensor] = {}
    for c in range(0, n_pad, chunk):
        sl = slice(c, c + chunk)
        with tracing.span("eval.negatives"):
            negs = sample_eval_negatives(generator, users[sl], pos[sl], user_pos_padded,
                                         user_deg, I.shape[0], neg_k)
        with tracing.span("eval.scores", device=dev):
            part = eval_from_negatives(U, I, users[sl], pos[sl], negs, valid[sl], ks)
            for k, v in part.items():
                sums[k] = sums[k] + v if k in sums else v
    with tracing.span("eval.read"):
        return {k: float(v) for k, v in sums.items()}


class _ChunkGraphs:
    """The static buffers and the two graphs of one key (see the module's
    docstring). `totals` runs one eval; the caller holds `_graphs_lock`."""

    def __init__(self, U: torch.Tensor, I: torch.Tensor, generator: torch.Generator, chunk: int,
                 ks: Sequence[int]):
        dev, dp = U.device, U.shape[1] + (-U.shape[1] % 4)  # zero columns pad D to a multiple of 4
        self.generator = generator  # held, so no other generator takes its id (the key's)
        self.U = torch.zeros(U.shape[0], dp, dtype=U.dtype, device=dev)
        self.I = torch.zeros(I.shape[0], dp, dtype=I.dtype, device=dev)
        self.inputs = torch.zeros(3, chunk, dtype=torch.int32, device=dev)  # users, pos, valid's f32 bits
        self.names = ["tie_frac_sum", *(f"{m}@{k}_sum" for k in ks for m in ("recall", "ndcg")), "count"]
        self.sums = torch.zeros(len(self.names), dtype=torch.float32, device=dev)
        self.splits: List[Tuple[np.ndarray, np.ndarray, torch.Tensor]] = []
        self.warm = False  # a chunk has run eagerly: every lazy set-up is done
        self.graphs = None  # (G_neg, G_scores) once captured
        self.negs = None  # G_neg's output, G_scores' input

    def _staged(self, eval_users, eval_pos) -> torch.Tensor:
        """The split's chunks as [n_chunks, 3, chunk] int32 on the device, built
        once per split: users, positives and valid (1.0 or 0.0, as f32 bits)."""
        for u, p, staged in self.splits:
            if np.array_equal(u, eval_users) and np.array_equal(p, eval_pos):
                return staged
        n, chunk = len(eval_users), self.inputs.shape[1]
        n_chunks = -(-n // chunk)
        host = np.zeros((3, n_chunks * chunk), np.int32)
        host[0, :n], host[1, :n] = eval_users, eval_pos
        host[2, :n] = np.float32(1.0).view(np.int32)
        staged = torch.as_tensor(host.reshape(3, n_chunks, chunk).transpose(1, 0, 2).copy(),
                                 device=self.inputs.device)
        self.splits = self.splits[-3:] + [(np.array(eval_users, np.int32), np.array(eval_pos, np.int32),
                                           staged)]
        return staged

    def _negatives(self, table, deg, generator, n_items, neg_k) -> torch.Tensor:
        return sample_eval_negatives(generator, self.inputs[0], self.inputs[1], table, deg, n_items, neg_k)

    def _add_sums(self, negs, ks) -> None:
        part = eval_from_negatives(self.U, self.I, self.inputs[0], self.inputs[1], negs,
                                   self.inputs[2].view(torch.float32), ks)
        self.sums.add_(torch.stack([part[k] for k in self.names]))

    def _capture(self, table, deg, generator, n_items, neg_k, ks) -> None:
        dev = self.U.device
        g_neg, g_scores = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        g_neg.register_generator_state(generator)
        stream = torch.cuda.Stream(dev)  # a capture needs a stream other than the default
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            g_neg.capture_begin(capture_error_mode="thread_local")
            try:
                negs = self._negatives(table, deg, generator, n_items, neg_k)
            finally:
                g_neg.capture_end()
            g_scores.capture_begin(pool=g_neg.pool(), capture_error_mode="thread_local")
            try:
                self._add_sums(negs, ks)
            finally:
                g_scores.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graphs, self.negs = (g_neg, g_scores), negs
        EVAL_GRAPH_CAPTURES.bump()

    def totals(self, U, I, eval_users, eval_pos, table, deg, generator, neg_k, ks) -> Dict[str, float]:
        staged = self._staged(eval_users, eval_pos)
        d, dev = U.shape[1], U.device
        self.U[:, :d].copy_(U)
        self.I[:, :d].copy_(I)
        self.sums.zero_()
        for c in range(staged.shape[0]):
            if self.graphs is None and self.warm:
                self._capture(table, deg, generator, I.shape[0], neg_k, ks)
            if self.graphs is None:  # the key's first chunk, eager: it does every lazy set-up
                with tracing.span("eval.negatives"):
                    self.inputs.copy_(staged[c])
                    negs = self._negatives(table, deg, generator, I.shape[0], neg_k)
                with tracing.span("eval.scores", device=dev):
                    self._add_sums(negs, ks)
                self.warm = True
                continue
            g_neg, g_scores = self.graphs
            with tracing.span("eval.negatives"):
                self.inputs.copy_(staged[c])
                g_neg.replay()
            with tracing.span("eval.scores", device=dev):
                g_scores.replay()
            EVAL_RANK_LAUNCHES.bump()  # the replay's launch (a capture counts none)
            EVAL_GRAPH_REPLAYS.bump()
            EVAL_GRAPH_REPLAYS.bump()
        with tracing.span("eval.read"):
            return dict(zip(self.names, self.sums.tolist()))


_graph_sets: "collections.OrderedDict[tuple, _ChunkGraphs]" = collections.OrderedDict()
_graphs_lock = threading.Lock()  # one graphed eval at a time: the sets' buffers are shared


def _graphed_totals(U, I, eval_users, eval_pos, user_pos_padded, user_deg, generator, neg_k, ks,
                    chunk) -> Dict[str, float]:
    """`_eager_totals` replayed from the key's graphs (a CUDA device)."""
    key = (U.device, chunk, tuple(U.shape), tuple(I.shape), U.dtype, I.dtype, neg_k, tuple(ks),
           tuple(user_pos_padded.shape), user_pos_padded.dtype, user_pos_padded.data_ptr(),
           tuple(user_deg.shape), user_deg.dtype, user_deg.data_ptr(), id(generator))
    with _graphs_lock:
        graphs = _graph_sets.get(key)
        if graphs is None:
            graphs = _graph_sets[key] = _ChunkGraphs(U, I, generator, chunk, ks)
            while len(_graph_sets) > MAX_GRAPH_SETS:  # the least recently used goes
                _graph_sets.popitem(last=False)
        _graph_sets.move_to_end(key)
        with torch.cuda.device(U.device):
            return graphs.totals(U, I, eval_users, eval_pos, user_pos_padded, user_deg, generator,
                                 neg_k, ks)


def sampled_eval(U: torch.Tensor, I: torch.Tensor, eval_users: np.ndarray, eval_pos: np.ndarray,
                 user_pos_padded: torch.Tensor, user_deg: torch.Tensor,
                 generator: torch.Generator, neg_k: int = 1000, ks: Tuple[int, ...] = (10, 20),
                 chunk: int = 512) -> Dict[str, float]:
    """Macro-averaged sampled metrics over (eval_users, eval_pos)."""
    n = len(eval_users)
    if n == 0:
        return {f"{m}@{k}": 0.0 for k in ks for m in ("recall", "ndcg")}
    chunk = min(chunk, ((n + 127) // 128) * 128)  # don't pad tiny evals to a full chunk
    run = _graphed_totals if U.is_cuda else _eager_totals
    totals = run(U, I, eval_users, eval_pos, user_pos_padded, user_deg, generator, neg_k, ks, chunk)
    count = max(totals["count"], 1.0)
    metrics = {}
    for k in ks:
        metrics[f"recall@{k}"] = totals[f"recall@{k}_sum"] / count
        metrics[f"ndcg@{k}"] = totals[f"ndcg@{k}_sum"] / count
    metrics["tie_fraction"] = totals["tie_frac_sum"] / count
    return metrics
