"""Training harness for the GAT and LightGCN: sampled BPR/BCE steps,
sampled evaluation, best-by-val checkpointing, resume.

Counterpart of `plotpointe_tpu/train/trainer.py` (`make_optimizer`,
`Trainer`). Per epoch, then the val eval:
  GAT       `steps_per_epoch` steps, each sampling `samples_per_epoch` exact
            (u, i, j) triples on the device, one full-graph forward with
            attention dropout, the loss, the backward (B1 and B2 in the
            attention layers) and an optimizer step;
  LightGCN  the mini-batch protocol: a permutation of the train
            interactions, t // batch_size steps of `batch_size` (u, i)
            positives with `neg_per_pos` exact negatives each, a full
            propagation (kernel 7 forward and backward through the static
            operator, built once), the loss of each positive against its
            negatives and an optimizer step; the losses are summed on the
            device and read once per epoch.
The best val NDCG@20 keeps its parameters, which give the final test eval
and are written as a checkpoint in the JAX npz format.

Randomness: one `torch.Generator` on the device, re-seeded from `cfg.seed`
at each use (init, each epoch's steps, each eval), so a resumed run draws
what an uninterrupted one would. Its draws are not the JAX package's.
The loss gathers node rows with `gather_rows`, whose backward is a sorted
segment sum, and no kernel uses float atomics, so a run on the card is
repeatable bit for bit.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from plotpointe_tpu_torch import resolve_device
from plotpointe_tpu_torch.config import TrainConfig
from plotpointe_tpu_torch.data.splits import Splits, padded_positives
from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops.gat_fused import MAX_PACKED_HEADS
from plotpointe_tpu_torch.ops.segment import gather_rows
from plotpointe_tpu_torch.train.checkpoint import (
    load_resume_state, params_to_jax, save_checkpoint, save_resume_state)
from plotpointe_tpu_torch.train.evaluate import sampled_eval
from plotpointe_tpu_torch.train.losses import LOSSES
from plotpointe_tpu_torch.train.sampling import rank_to_item, sample_bpr_triples, uniform_ranks
from plotpointe_tpu_torch.utils.logging import log_event
from plotpointe_tpu_torch.utils.prng import stream_seed

STREAM_INIT, STREAM_TRAIN, STREAM_EVAL = 0, 1, 2
TEST_EVAL_INDEX = 10_000  # the JAX trainer's fold_in index of the test eval


def make_optimizer(params, lr: float, l2: float, optimizer: str = "adam",
                   warmup_steps: int = 0) -> Tuple[torch.optim.Optimizer, Optional[Any]]:
    """(optimizer, warmup scheduler or None).

    `adam` is `torch.optim.Adam(weight_decay=l2)`: L2 added to the gradient
    before the moments, the JAX package's `add_decayed_weights` ->
    `scale_by_adam` (reference parity). `adamw` decouples the decay
    (`torch.optim.AdamW`), which avoids the long-schedule collapse of coupled
    L2. `warmup_steps > 0` scales the step's learning rate by
    min(1, (step + 1) / warmup_steps)."""
    params = list(params)
    if optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=l2)
    elif optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=l2)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r} (expected adam|adamw)")
    sched = None
    if warmup_steps > 0:
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: min(1.0, (step + 1) / warmup_steps))
    return opt, sched


def _clone_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class Trainer:
    """Drives a GATModel or a LightGCNModel through the reference protocol on
    one device."""

    def __init__(self, model, cfg: TrainConfig, graph: Graph, splits: Splits,
                 item_feats: Optional[np.ndarray] = None, max_pos_degree: int = 512, device=None):
        family = model.config_dict().get("model_family")
        if family not in ("gat", "lightgcn"):
            raise ValueError(f"unknown model_family {family}")
        self.device = dev = resolve_device(device)
        self.model = model.to(dev)
        self.cfg = cfg
        self.graph = graph.to(dev)
        self.splits = splits
        self.n_users, self.n_items = splits.n_users, splits.n_items
        feats = item_feats if item_feats is not None else np.zeros((self.n_items, 1), np.float32)
        self.item_feats = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
        pos_table, deg = padded_positives(splits, max_degree=max_pos_degree)
        self.user_pos_padded = torch.as_tensor(pos_table, device=dev)
        self.user_deg = torch.as_tensor(deg, device=dev)
        self.train_users = torch.as_tensor(np.flatnonzero(deg > 0).astype(np.int32), device=dev)
        self._spmm_op = None  # LightGCN's propagation operator: edge values aligned once
        if family == "lightgcn":
            self._spmm_op = model.operator(self.graph)
            self.train_u = torch.as_tensor(splits.train_u, device=dev)
            self.train_i = torch.as_tensor(splits.train_i, device=dev)
        self.generator = torch.Generator(device=dev)
        self.optimizer: Optional[torch.optim.Optimizer] = None  # fit() builds both
        self.scheduler: Optional[Any] = None

    def _reseed(self, stream: int, index: int) -> torch.Generator:
        return self.generator.manual_seed(stream_seed(self.cfg.seed, stream, index))

    # -- one step, in phases (chip_smoke.py times each) ------------------------

    def _sample(self):
        """(u, i, j) triples and the uint32 dropout seeds: one per layer, or
        [layers][heads] above 8 heads (one attention pass per head)."""
        u, i, j = sample_bpr_triples(self.generator, self.train_users, self.user_pos_padded,
                                     self.user_deg, self.n_items, self.cfg.samples_per_epoch)
        seeds = None
        if self.model.attn_dropout > 0:
            m = self.model
            shape = (m.n_layers, m.heads) if m.heads > MAX_PACKED_HEADS else (m.n_layers,)
            seeds = torch.randint(0, 1 << 32, shape, generator=self.generator,
                                  device=self.device, dtype=torch.int64).tolist()
        return u, i, j, seeds

    def _loss(self, u, i, j, seeds) -> torch.Tensor:
        """The loss of the JAX step: scores U[u].I[i] and U[u].I[j] from a
        full-graph forward with dropout."""
        z = self.model(self.item_feats, self.graph, train=True, seeds=seeds)
        rows = gather_rows(z, torch.cat([u, i + self.n_users, j + self.n_users]))
        zu, zi, zj = rows.split(u.shape[0])
        return LOSSES[self.cfg.loss]((zu * zi).sum(-1), (zu * zj).sum(-1))

    def _opt_step(self) -> None:
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def _train_step(self) -> float:
        u, i, j, seeds = self._sample()
        loss = self._loss(u, i, j, seeds)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._opt_step()
        return float(loss.detach())

    def _epoch(self, epoch: int) -> float:
        self._reseed(STREAM_TRAIN, epoch)
        if self._spmm_op is not None:
            return self._lightgcn_epoch()
        steps = max(1, self.cfg.steps_per_epoch)
        return sum(self._train_step() for _ in range(steps)) / steps

    # -- LightGCN mini-batch step, in phases -------------------------------------

    def _lightgcn_perm(self) -> Tuple[torch.Tensor, int]:
        """The epoch's order of the train interactions and its step count: a
        permutation, wrapped around to one full batch when there are fewer
        interactions than `batch_size`."""
        t, bs = self.splits.n_train, self.cfg.batch_size
        perm = torch.randperm(t, generator=self.generator, device=self.device)
        if t < bs:
            return perm.repeat(-(-bs // t))[:bs], 1
        return perm, t // bs

    def _lightgcn_sample(self, perm: torch.Tensor, step: int):
        """Batch `step` of `perm`: positives (u, i) [bs] and `neg_per_pos`
        exact negatives j [bs, npp] per positive."""
        bs, npp = self.cfg.batch_size, self.cfg.neg_per_pos
        idx = perm[step * bs:(step + 1) * bs]
        u, i = self.train_u[idx], self.train_i[idx]
        bound = (self.n_items - self.user_deg[u])[:, None].expand(bs, npp)
        j = rank_to_item(uniform_ranks(self.generator, (bs, npp), bound), self.user_pos_padded[u])
        return u, i, j

    def _lightgcn_loss(self, u, i, j) -> torch.Tensor:
        """The loss of each positive score U[u].I[i], repeated, against its
        negatives' U[u].I[j], from a full propagation."""
        z = self.model(self._spmm_op)
        bs, npp = j.shape
        rows = gather_rows(z, torch.cat([u, i + self.n_users, j.reshape(-1) + self.n_users]))
        zu, zi, zj = rows.split([bs, bs, bs * npp])
        pos = (zu * zi).sum(-1)
        neg = (zu[:, None, :] * zj.view(bs, npp, -1)).sum(-1)
        return LOSSES[self.cfg.loss](pos[:, None].expand(bs, npp).reshape(-1), neg.reshape(-1))

    def _lightgcn_epoch(self) -> float:
        perm, n_steps = self._lightgcn_perm()
        total = torch.zeros((), device=self.device)
        for step in range(n_steps):
            loss = self._lightgcn_loss(*self._lightgcn_sample(perm, step))
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self._opt_step()
            total += loss.detach()
        return float(total) / n_steps  # the losses are read once per epoch

    # -- evaluation ------------------------------------------------------------

    @torch.no_grad()
    def _forward_eval(self):
        if self._spmm_op is not None:
            z = self.model(self._spmm_op)
        else:
            z = self.model(self.item_feats, self.graph)
        return z[: self.n_users], z[self.n_users:]

    def evaluate(self, eval_u: np.ndarray, eval_i: np.ndarray, index: int) -> Dict[str, float]:
        """Sampled metrics of the model's current parameters; `index` picks
        the negatives' random stream."""
        U, I = self._forward_eval()
        return sampled_eval(U, I, eval_u, eval_i, self.user_pos_padded, self.user_deg,
                            self._reseed(STREAM_EVAL, index), neg_k=self.cfg.eval_neg_k,
                            chunk=self.cfg.eval_chunk)

    # -- fit -------------------------------------------------------------------

    def _opt_state(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": None if self.scheduler is None else self.scheduler.state_dict()}

    def fit(self, checkpoint_path: Optional[str] = None,
            resume_path: Optional[str] = None) -> Dict[str, Any]:
        """Train `cfg.epochs` epochs (from the resume state when
        `resume_path` exists; it is rewritten after every epoch). Afterwards
        the model holds the best parameters."""
        cfg = self.cfg
        self.model.init_params(self._reseed(STREAM_INIT, 0))
        self.optimizer, self.scheduler = make_optimizer(self.model.parameters(), cfg.lr, cfg.l2,
                                                        cfg.optimizer, cfg.warmup_steps)
        best_val, best_state, start_epoch = -1.0, _clone_state(self.model), 1
        if resume_path is not None and Path(resume_path).exists():
            params, opt_state, best_state, meta = load_resume_state(resume_path, self.device)
            self.model.load_state_dict(params)
            self.optimizer.load_state_dict(opt_state["optimizer"])
            if self.scheduler is not None:
                self.scheduler.load_state_dict(opt_state["scheduler"])
            start_epoch = int(meta["epoch"]) + 1
            best_val = float(meta["best_val_ndcg20"])

        run_id = cfg.run_id or f"{cfg.model_family}_d{cfg.hidden_dim}_{int(time.time())}"
        if cfg.structured_logs:
            log_event("run_start", run_id=run_id, model_family=cfg.model_family, config=cfg.to_dict(),
                      resumed_from_epoch=start_epoch - 1 if start_epoch > 1 else None)
        history = []
        val_metrics: Dict[str, float] = {}
        t_start = time.perf_counter()
        for epoch in range(start_epoch, cfg.epochs + 1):
            t0 = time.perf_counter()
            loss = self._epoch(epoch)
            step_time = time.perf_counter() - t0
            t1 = time.perf_counter()
            val_metrics = (self.evaluate(self.splits.val_u, self.splits.val_i, epoch)
                           if len(self.splits.val_u) else {})
            eval_time = time.perf_counter() - t1
            history.append({"epoch": epoch, "loss": loss, "step_time_s": step_time,
                            "eval_time_s": eval_time,
                            **{f"val_{k}": v for k, v in val_metrics.items()}})
            if cfg.structured_logs:
                log_event("epoch_end", run_id=run_id, epoch=epoch, loss=loss, val=val_metrics)
            ndcg20 = val_metrics.get("ndcg@20", 0.0)
            if ndcg20 > best_val:
                best_val, best_state = ndcg20, _clone_state(self.model)
                if checkpoint_path:
                    save_checkpoint(checkpoint_path, params_to_jax(best_state),
                                    self.model.config_dict() | {"train_config": cfg.to_dict()})
            if resume_path is not None:
                save_resume_state(resume_path, self.model.state_dict(), self._opt_state(), best_state,
                                  {"epoch": epoch, "best_val_ndcg20": float(best_val)})

        if best_val < 0:  # no val split and no epoch run: best = last
            best_state = _clone_state(self.model)
        self.model.load_state_dict(best_state)
        test_metrics = self.evaluate(self.splits.test_u, self.splits.test_i, TEST_EVAL_INDEX)
        wall = time.perf_counter() - t_start
        results = {
            "best_val_ndcg@20": float(best_val),
            "val": val_metrics,
            "test": test_metrics,
            "config": cfg.to_dict() | self.model.config_dict(),
            "history": history,
            "wall_time_s": wall,
            "run_id": run_id,
            "notes": f"one-backward-per-epoch, {cfg.samples_per_epoch} sampled triples, loss={cfg.loss}",
        }
        if cfg.structured_logs:
            log_event("run_complete", run_id=run_id, best_val_ndcg20=results["best_val_ndcg@20"],
                      test=test_metrics)
        return results

    def export_item_embeddings(self) -> np.ndarray:
        """Item-side embeddings [n_items, hidden] from a full forward of the
        model's current parameters."""
        _, I = self._forward_eval()
        return I.cpu().numpy().astype(np.float32)
