"""The readers of the program's own spans (`benchmark/program_spans.py` and
the nine metrics on it) on hand-made records: each reads its span inside the
traced region; each returns None with no records, and with no span recorder
in the program (a checkout that predates it)."""
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import core
from benchmark.core import Observation
from benchmark.tracing import DeviceTrace, Spans

READERS = ("sample_ms", "forward_ms", "backward_ms", "optimizer_ms", "step_idle_ms",
           "eval_scores_ms", "queue_wait_ms", "handler_self_ms", "history_mean_ms")
MODULE = "plotpointe_tpu_torch.utils.tracing"


def rec(name, t0, t1, d=None, id=0, parent=None, **meta):
    d0, d1 = d if d is not None else (None, None)
    return SimpleNamespace(name=name, t0=t0, t1=t1, d0=d0, d1=d1, id=id, parent=parent,
                           meta=meta)


def obs_of(ops=((("k", 0.0, 0.5), ("k", 2.2, 0.2)))):
    return Observation({}, {}, Spans(torch.device("cpu")),
                       trace=DeviceTrace(list(ops), -1.0, 100.0))


@pytest.fixture
def recorded(monkeypatch):
    """Replace the recorder's records with the given list, kept to the window
    asked for, as `tracing.records` keeps them."""
    from plotpointe_tpu_torch.utils import tracing

    def put(recs):
        monkeypatch.setattr(tracing, "records",
                            lambda t0=float("-inf"), t1=float("inf"):
                            [r for r in recs if t0 <= r.t0 and r.t1 <= t1])
    return put


def read(name, obs):
    return core.load_reader(name)(obs)


TRAIN = [rec("train.step", 0.0, 1.0, (0.0, 1.0)), rec("train.step", 2.0, 3.0, (2.0, 3.0)),
         rec("train.sample", 0.0, 0.1, (0.01, 0.11)), rec("train.sample", 2.0, 2.1, (2.0, 2.3)),
         rec("train.forward", 0.1, 0.2, (0.1, 0.2)), rec("train.forward", 2.1, 2.2, (2.3, 2.4)),
         rec("train.backward", 0.2, 0.3, (0.2, 0.5)), rec("train.backward", 2.2, 2.3, (2.4, 2.5)),
         rec("train.optimizer", 0.3, 0.4, (0.5, 0.55)),
         rec("train.optimizer", 2.3, 2.4, (2.5, 2.55)),
         rec("train.sample", 200.0, 201.0, (200.0, 201.0))]  # outside the traced region
EVAL = [rec("eval", 0.0, 1.0), rec("eval", 2.0, 3.0),
        rec("eval.scores", 0.1, 0.2, (0.1, 0.15)), rec("eval.scores", 0.2, 0.3, (0.2, 0.25)),
        rec("eval.scores", 2.1, 2.2, (2.1, 2.2)), rec("eval.negatives", 0.0, 0.1, (0.0, 0.5))]
SERVE = [rec("http.request", 0.0, 0.010, id=1, route="/recommend", status=200),
         rec("serve.recommend", 0.002, 0.007, id=2, parent=1),
         rec("http.request", 0.020, 0.026, id=3, route="/recommend", status=200),
         rec("serve.recommend", 0.021, 0.025, id=4, parent=3),
         rec("http.request", 0.030, 0.090, id=5, route="/startup", status=200),
         rec("batch.queue", 0.003, 0.004, id=6, parent=2),
         rec("batch.queue", 0.021, 0.024, id=7, parent=4),
         rec("serve.queries", 0.004, 0.0045), rec("serve.queries", 0.024, 0.0255)]


def test_training_phases_read_device_intervals_per_step(recorded):
    recorded(TRAIN)
    obs = obs_of()
    assert read("sample_ms", obs) == pytest.approx(200.0)
    assert read("forward_ms", obs) == pytest.approx(100.0)
    assert read("backward_ms", obs) == pytest.approx(200.0)
    assert read("optimizer_ms", obs) == pytest.approx(50.0)
    # idle inside the steps' host intervals: 1 - 0.5 and 1 - 0.2 of busy time
    assert read("step_idle_ms", obs) == pytest.approx(650.0)


def test_the_measured_window_without_a_trace(recorded):
    recorded([rec("train.step", 0.0, 1.0), rec("train.sample", 0.0, 0.5, (0.0, 0.5)),
              rec("train.step", 5.0, 6.0), rec("train.sample", 5.0, 5.5, (5.0, 5.1))])
    obs = Observation({}, {}, Spans(torch.device("cpu")), window=(4.0, 7.0))
    assert read("sample_ms", obs) == pytest.approx(100.0)
    assert read("step_idle_ms", obs) is None  # no device trace to read idle from


def test_eval_scores_sum_per_eval(recorded):
    recorded(EVAL)
    assert read("eval_scores_ms", obs_of()) == pytest.approx(100.0)


def test_serving_readers(recorded):
    recorded(SERVE)
    obs = obs_of()
    assert read("handler_self_ms", obs) == pytest.approx(3.5)  # (10 - 5 + 6 - 4) / 2
    assert read("queue_wait_ms", obs) == pytest.approx(2.0)
    assert read("history_mean_ms", obs) == pytest.approx(1.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_records(recorded, name):
    recorded([])
    assert read(name, obs_of()) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_span_recorder(recorded, monkeypatch, name):
    import plotpointe_tpu_torch.utils

    recorded(TRAIN + EVAL + SERVE)
    assert read(name, obs_of()) is not None
    monkeypatch.delattr(plotpointe_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, MODULE, None)  # its import raises ImportError
    with pytest.raises(ImportError):
        from plotpointe_tpu_torch.utils import tracing  # noqa: F401
    assert read(name, obs_of()) is None


def test_every_reader_is_declared():
    declared = {m["name"]: m for m in core.load_benchmark()["per_layer"]}
    for name in READERS:
        assert declared[name]["unit"] == "ms" and declared[name]["better"] == "lower"
