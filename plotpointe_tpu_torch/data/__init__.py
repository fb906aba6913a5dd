"""The data stage; exports the names `plotpointe_tpu/data/__init__.py` exports."""
from plotpointe_tpu_torch.data.splits import Splits, build_node_maps, build_splits
from plotpointe_tpu_torch.data.synthetic import synthetic_catalog, synthetic_interactions

__all__ = [
    "Splits",
    "build_splits",
    "build_node_maps",
    "synthetic_interactions",
    "synthetic_catalog",
]
