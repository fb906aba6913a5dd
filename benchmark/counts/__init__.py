"""Frozen counts of the yardstick: the card's published peaks, the
compulsory bytes and the operations of the kernels the per-layer metrics
hold to a roofline, and the model FLOPs of a training step. Counted from
the operations' shapes, never from what an implementation reads."""
