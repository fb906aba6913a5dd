"""The harness driven with the timed path broken underneath reads `correct`
false: a step that returns its state unchanged; half of the batch left out,
the mean taken over the rest; the sampler replaying epoch 1 in later
epochs; an answer altered where it is produced. (The cells run on one chip:
there is no exchange between chips to leave out.)"""
import numpy as np
import pytest
import torch

from benchmark.tests.conftest import run_tiny


@pytest.mark.parametrize("cell", ["tiny.gat.train", "tiny.lightgcn.train"])
def test_step_that_leaves_the_state_unchanged(tiny_bench, cell, monkeypatch):
    from plotpointe_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_opt_step", lambda self: None)
    r = run_tiny(tiny_bench, cell)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["tiny.gat.train", "tiny.lightgcn.train"])
def test_half_the_batch_left_out(tiny_bench, cell, monkeypatch):
    from plotpointe_tpu_torch.train import trainer

    bpr = trainer.LOSSES["bpr"]
    monkeypatch.setitem(trainer.LOSSES, "bpr", lambda pos, neg: bpr(pos[: len(pos) // 2],
                                                                     neg[: len(neg) // 2]))
    r = run_tiny(tiny_bench, cell)
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] > r["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.gat.train", "tiny.lightgcn.train"])
def test_sampler_replays_the_first_epoch(tiny_bench, cell, monkeypatch):
    from plotpointe_tpu_torch.train import trainer

    reseed = trainer.Trainer._reseed
    monkeypatch.setattr(trainer.Trainer, "_reseed", lambda self, stream, index: reseed(
        self, stream, 1 if stream == trainer.STREAM_TRAIN else index))
    r = run_tiny(tiny_bench, cell)
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.gat.train", "tiny.lightgcn.train"])
def test_eval_metrics_altered(tiny_bench, cell, monkeypatch):
    from plotpointe_tpu_torch.train import trainer

    sampled_eval = trainer.sampled_eval

    def altered(*args, **kwargs):
        out = sampled_eval(*args, **kwargs)
        return {**out, "ndcg@20": out["ndcg@20"] * 1.01}

    monkeypatch.setattr(trainer, "sampled_eval", altered)
    r = run_tiny(tiny_bench, cell)
    assert not r["correct"]
    assert r["checks"]["eval_gap"]["value"] > r["checks"]["eval_gap"]["limit"]


def test_served_answer_altered(tiny_bench, monkeypatch):
    from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime

    served = RecommenderRuntime.top_k_for_batch

    def altered(self, histories, ks, max_batch=64):
        out = served(self, histories, ks, max_batch=max_batch)
        idx, sc = out[0]
        out[0] = (idx, np.asarray(sc, np.float32) * np.float32(1.001))
        return out

    monkeypatch.setattr(RecommenderRuntime, "top_k_for_batch", altered)
    r = run_tiny(tiny_bench, "tiny.gat.serve")
    assert not r["correct"]


def test_eval_forward_altered(tiny_bench, monkeypatch):
    from plotpointe_tpu_torch.train.trainer import Trainer

    forward = Trainer._forward_eval

    def altered(self):
        u, i = forward(self)
        return u, i * (1.0 + 1e-2 * torch.sign(i))

    monkeypatch.setattr(Trainer, "_forward_eval", altered)
    r = run_tiny(tiny_bench, "tiny.gat.train")
    assert not r["correct"]
    assert r["checks"]["embed_gap"]["value"] > r["checks"]["embed_gap"]["limit"]
