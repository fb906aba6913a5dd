"""Faults planted in the timed path of a mesh cell, for the tests and for
`tools/control.py`: each `plant(trainer)` runs on every rank, after the
sharded trainer is built and before its first fit, and returns a callable
that takes the fault out again (or None). `drivers/train_fit_mesh.run`
takes one as `plant`.

  grad_exchange_left_out  the all-reduce of the replicated parameters'
                          gradients left out: each rank steps on its own
                          partial gradient (leaving it out on one rank only
                          would stall the others' collective)
  overlay_stale           the last rank's block of each layer's overlay is,
                          on every rank, the one of the previous training
                          step (its gradient dropped with it)
  half_batch              each rank's block of the batch halved, the mean
                          taken over the rest
  state_unchanged         a step that leaves the parameters as they were"""
from __future__ import annotations

import torch


def _partial_grads(ctx, *gs):
    return (None, *gs)


def grad_exchange_left_out(trainer):
    from plotpointe_tpu_torch.parallel import collectives

    cls = collectives._AllReduceGrad
    backward = cls.__dict__["backward"]
    cls.backward = staticmethod(_partial_grads)

    def undo():
        cls.backward = backward
    return undo


def overlay_stale(trainer):
    step = trainer.step
    combine, held, calls = step.combine, {}, [0]
    counts, k = step.layout.counts, trainer.mesh.n_shards - 1
    lo = sum(counts[:k])
    hi = lo + counts[k]

    def stale(owned: torch.Tensor) -> torch.Tensor:
        out = combine(owned)
        if not torch.is_grad_enabled():  # an eval's forward
            return out
        layer = calls[0] % step.n_layers
        calls[0] += 1
        before, held[layer] = held.get(layer), out[lo:hi].detach().clone()
        return out if before is None else torch.cat([out[:lo], before, out[hi:]])

    step.combine = stale
    return None


def half_batch(trainer):
    step = trainer.step
    loss_fn = step.loss_fn
    step.loss_fn = lambda pos, neg: loss_fn(pos[: len(pos) // 2], neg[: len(neg) // 2])
    return None


def state_unchanged(trainer):
    trainer._opt_step = lambda: None
    return None


FAULTS = {f.__name__: f for f in (grad_exchange_left_out, overlay_stale, half_batch, state_unchanged)}
