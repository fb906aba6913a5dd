"""The models; exports the names `plotpointe_tpu/models/__init__.py` exports."""
from plotpointe_tpu_torch.models.fusion import FusionModel
from plotpointe_tpu_torch.models.gat import GATModel
from plotpointe_tpu_torch.models.lightgcn import LightGCNModel

__all__ = ["GATModel", "LightGCNModel", "FusionModel"]
