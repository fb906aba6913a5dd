from plotpointe_tpu_torch.graphs.csr import Graph, build_bipartite_graph
from plotpointe_tpu_torch.graphs.ui_graph import build_ui_artifacts, ui_stats
from plotpointe_tpu_torch.graphs.knn import cosine_knn_graph

__all__ = [
    "Graph",
    "build_bipartite_graph",
    "build_ui_artifacts",
    "ui_stats",
    "cosine_knn_graph",
]
