"""The plain reference the benchmark holds the program to: plain PyTorch and
NumPy, written from the models' published equations and the trainer's
stated protocol. It imports neither `jax` nor the JAX package nor anything
of `plotpointe_tpu_torch`, and works out again whatever the program derives
from the inputs the benchmark hands to both sides (splits, graph, positive
tables, edge values, initial weights, sampled triples, dropout masks,
negatives)."""
