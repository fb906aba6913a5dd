"""Training; exports the names `plotpointe_tpu/train/__init__.py` exports,
but `TrainState` (an optax pytree there; the port's `Trainer` holds torch
modules and their optimizer)."""
from plotpointe_tpu_torch.train.evaluate import sampled_eval
from plotpointe_tpu_torch.train.losses import bce_loss, bpr_loss
from plotpointe_tpu_torch.train.trainer import Trainer

__all__ = ["bpr_loss", "bce_loss", "sampled_eval", "Trainer"]
