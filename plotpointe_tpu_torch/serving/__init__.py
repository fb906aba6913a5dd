"""The serving plane; exports the names `plotpointe_tpu/serving/__init__.py` exports."""
from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig

__all__ = ["RecommenderRuntime", "ServingConfig"]
