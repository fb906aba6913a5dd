"""Utilities; exports the names `plotpointe_tpu/utils/__init__.py` exports."""
from plotpointe_tpu_torch.utils.logging import log_event
from plotpointe_tpu_torch.utils.prng import key_seq, set_seeds

__all__ = ["log_event", "set_seeds", "key_seq"]
