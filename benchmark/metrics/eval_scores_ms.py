"""eval_scores_ms: the device intervals of the program's `eval.scores` spans
(each chunk's f32 score products and ranks, `train/evaluate.py`) in the
traced fit, summed per `eval` span, in ms."""
from benchmark.program_spans import device_ms_per


def read(obs):
    return device_ms_per(obs, "eval.scores", "eval")
