"""The port's span recorder (`utils/tracing.py`) and the spans placed at the
layer boundaries of training, evaluation and serving, on the CPU: off by
default and a shared no-op when off, on between enable() and disable() and
while a torch.profiler records, records with parents, threads, request ids
and meta, the bounded buffer, the Chrome export, device intervals resolved
through one anchor a recording period (on a stand-in for CUDA's events),
the spans of tiny GAT and LightGCN fits (losses and metrics bit-equal with
tracing on and off), of a micro-batched stdlib server, and `cli train
--trace`.

One card test (`-m cuda`): in a fit profiled as the benchmark's
`benchmark/tracing.Profile` profiles (its marker kernel warmed first), the
Adam kernels' device time lies inside the `train.optimizer` device
intervals, and the four phases cover the busy device time inside the
`train.step` intervals. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -m cuda
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.config import TrainConfig
from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
from plotpointe_tpu_torch.data.synthetic import synthetic_features, synthetic_interactions
from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
from plotpointe_tpu_torch.pipeline import make_model
from plotpointe_tpu_torch.serving.httpd import serve
from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig
from plotpointe_tpu_torch.train.trainer import Trainer
from plotpointe_tpu_torch.utils import tracing

PHASES = ("train.sample", "train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _by_id(recs):
    return {r.id: r for r in recs}


def _children(recs, parent, name):
    return [r for r in recs if r.parent == parent.id and r.name == name]


# -- the recorder -------------------------------------------------------------


def test_off_by_default_returns_the_shared_noop():
    assert tracing.span("a") is tracing.NOOP
    assert tracing.span("a", device=True, k=1) is tracing.NOOP
    assert tracing.begin("q") is tracing.NOOP and tracing.request_id() is None
    with tracing.span("a") as s:
        s.note(x=1)
    tracing.begin("q").end()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_enable_records_names_times_parents_threads_rids_and_meta():
    tracing.enable()
    with tracing.span("outer", rid=7, k=3) as outer:
        with tracing.span("inner") as inner:
            inner.note(status=200)
        opened = tracing.begin("wait")
    done = []

    def other():
        opened.end()  # a span opened on one thread, closed on another
        with tracing.span("elsewhere"):
            done.append(tracing.request_id())

    t = threading.Thread(target=other, name="worker")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    recs = tracing.records()
    by = {r.name: r for r in recs}
    assert set(by) == {"outer", "inner", "wait", "elsewhere"}
    for r in recs:
        assert r.t0 <= r.t1 and r.d0 is None and r.d1 is None
    assert by["inner"].parent == by["wait"].parent == outer.id and by["outer"].parent is None
    assert by["inner"].rid == by["wait"].rid == 7 and by["outer"].meta == {"k": 3}
    assert by["inner"].meta == {"status": 200} and by["inner"].t1 <= by["outer"].t1
    assert by["wait"].thread == by["outer"].thread == threading.current_thread().name
    assert by["elsewhere"].thread == "worker" and by["elsewhere"].parent is None
    assert done[0] is not None and done[0] != 7  # a new request id on a thread with none open
    assert by["wait"].t1 >= by["outer"].t1  # ended after its opener's block
    tracing.disable()
    assert tracing.span("after") is tracing.NOOP


def test_on_while_a_profiler_records_and_off_after():
    # the flag the recorder reads: a torch upgrade that renames it fails here
    assert torch.autograd.profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        with tracing.span("profiled") as s:
            assert s is not tracing.NOOP
    assert tracing.span("later") is tracing.NOOP
    assert [r.name for r in tracing.records()] == ["profiled"]


def test_buffer_is_bounded_and_counts_what_it_drops():
    tracing.clear(max_records=3)
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    assert [r.name for r in tracing.records()] == ["s2", "s3", "s4"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_records_keeps_what_lies_inside_the_window():
    tracing.enable()
    with tracing.span("early"):
        pass
    t0 = time.perf_counter()
    with tracing.span("inside"):
        pass
    t1 = time.perf_counter()
    with tracing.span("late"):
        pass
    assert [r.name for r in tracing.records(t0, t1)] == ["inside"]
    assert len(tracing.records()) == 3


def test_chrome_export_holds_every_record(tmp_path):
    tracing.enable()
    with tracing.span("outer", rid=1):
        with tracing.span("inner", k=2):
            pass
    def side():
        with tracing.span("side"):
            pass

    t = threading.Thread(target=side, name="side-thread")
    t.start()
    t.join(timeout=10)
    path = tmp_path / "trace.json"
    assert tracing.write_chrome_trace(str(path)) == 3
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["name"] for e in spans) == ["inner", "outer", "side"]
    assert all(e["pid"] == 1 and e["dur"] >= 0 and e["ts"] >= 0 for e in spans)
    inner = next(e for e in spans if e["name"] == "inner")
    outer = next(e for e in spans if e["name"] == "outer")
    assert inner["args"]["parent"] == outer["args"]["id"] and inner["args"]["k"] == 2
    assert inner["args"]["rid"] == 1 and inner["tid"] == outer["tid"]
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"host", "device", "side-thread"} <= names
    assert doc["otherData"]["dropped"] == 0


class _FakeEvent:
    """A CUDA timing event on a device clock 100 s ahead of the host's."""
    synced = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter() + 100.0

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_device_intervals_resolve_through_one_anchor_a_period(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(tracing, "_cuda_index", lambda device: 0 if device else None)
    tracing.enable()
    for _ in range(4):
        with tracing.span("step", device=True):
            with tracing.span("phase", device=True):
                time.sleep(0.002)
            with tracing.span("host"):
                pass
    assert syncs == [0]  # one synchronise: the period's anchor
    tracing.disable()
    with tracing.span("off", device=True):  # a span that finds tracing off ends the period
        pass
    tracing.enable()
    with tracing.span("again", device=True):
        pass
    assert syncs == [0, 0]
    recs = tracing.records()
    for r in recs:
        if r.name == "host":
            assert r.d0 is None and r.d1 is None
            continue
        # the device clock mapped onto the host's: inside the host interval here
        assert r.t0 <= r.d0 <= r.d1 <= r.t1 + 1e-3, (r.name, r.t0, r.d0, r.d1, r.t1)
    steps = [r for r in recs if r.name == "step"]
    phases = [r for r in recs if r.name == "phase"]
    assert all(s.d0 <= p.d0 and p.d1 <= s.d1 for s, p in zip(steps, phases))
    assert all(p.d1 - p.d0 >= 0.0015 for p in phases)


# -- the program's spans ------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    df, (_, i_fac) = synthetic_interactions(n_users=160, n_items=90, n_interactions=2500, seed=5,
                                           return_factors=True)
    u2i, i2i = build_node_maps(df)
    s = build_splits(df, u2i, i2i)
    idx_of_item = np.empty(s.n_items, dtype=np.int64)
    for asin, idx in i2i.items():
        idx_of_item[idx] = int(asin[1:])
    feats = synthetic_features(i_fac.shape[0], 16, seed=5, factors=i_fac)[idx_of_item]
    return df, s, feats.astype(np.float32)


def _trainer(data, family):
    _, s, feats = data
    cfg = TrainConfig(model_family=family, epochs=2, samples_per_epoch=600, steps_per_epoch=2,
                      eval_neg_k=20, eval_chunk=128, hidden_dim=16, embed_dim=16,
                      batch_size=256, neg_per_pos=2, seed=3)
    feats = feats if family == "gat" else None
    model = make_model(cfg, s.n_users, s.n_items, 0 if feats is None else feats.shape[1],
                       device="cpu")
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    return Trainer(model, cfg, graph, s, item_feats=feats, device="cpu")


@pytest.mark.parametrize("family", ["gat", "lightgcn"])
def test_a_fit_has_one_of_each_phase_a_step_and_chunk_spans(data, family):
    tr = _trainer(data, family)
    tracing.enable()
    res = tr.fit()
    tracing.disable()
    recs = tracing.records()
    names = [r.name for r in recs]
    (fit,) = [r for r in recs if r.name == "train.fit"]
    epochs = [r for r in recs if r.name == "train.epoch"]
    assert len(epochs) == 2 and all(e.parent == fit.id for e in epochs)
    steps = [r for r in recs if r.name == "train.step"]
    n_steps = 2 if family == "gat" else tr.splits.n_train // 256
    assert len(steps) == 2 * n_steps
    by = _by_id(recs)
    for st in steps:
        assert by[st.parent].name == "train.epoch"
        for phase in PHASES:
            (p,) = _children(recs, st, phase)
            assert st.t0 <= p.t0 <= p.t1 <= st.t1
        kids = [r.name for r in recs if r.parent == st.id]
        assert kids == list(PHASES) + (["train.read"] if family == "gat" else [])
    reads = [r for r in recs if r.name == "train.read"]
    assert len(reads) == (len(steps) if family == "gat" else len(epochs))
    evals = [r for r in recs if r.name == "eval"]
    assert len(evals) == 3 and all(e.parent == fit.id for e in evals)  # 2 val, 1 test
    for ev in evals:
        assert len(_children(recs, ev, "eval.forward")) == 1
        assert len(_children(recs, ev, "eval.read")) == 1
        neg, sco = _children(recs, ev, "eval.negatives"), _children(recs, ev, "eval.scores")
        assert len(neg) == len(sco) >= 1
    n_val = len(tr.splits.val_u)
    chunks = -(-n_val // min(128, -(-n_val // 128) * 128))
    assert names.count("eval.scores") == 2 * chunks + -(-len(tr.splits.test_u) // 128)
    assert names.count("train.best_state") >= 1
    assert res["history"][-1]["epoch"] == 2


@pytest.mark.parametrize("family", ["gat", "lightgcn"])
def test_fit_is_bit_equal_with_tracing_on_and_off(data, family):
    tr = _trainer(data, family)
    off = tr.fit()
    tracing.enable()
    on = tr.fit()
    tracing.disable()
    assert tracing.records()
    for a, b in zip(off["history"], on["history"]):
        assert {k: v for k, v in a.items() if not k.endswith("_time_s")} == \
            {k: v for k, v in b.items() if not k.endswith("_time_s")}
    assert off["test"] == on["test"] and off["val"] == on["val"]
    assert off["best_val_ndcg@20"] == on["best_val_ndcg@20"]


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_microbatched_server_spans_follow_each_request(tmp_path):
    path = tmp_path / "emb.npy"
    np.save(path, np.random.default_rng(0).normal(size=(300, 16)).astype(np.float32))
    rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=str(path), device="cpu",
                                          use_kernel_topk=True))
    rt.startup()
    server, _ = serve("127.0.0.1", 0, runtime=rt, block=False, micro_batch=True,
                      micro_batch_max=8, micro_batch_wait_ms=100.0)
    url = f"http://127.0.0.1:{server.server_address[1]}/recommend"
    n = 6
    replies = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        replies[i] = _post(url, {"item_ids": [i, i + 10, i + 20], "k": 5})

    tracing.enable()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        deadline = time.time() + 10
        while time.time() < deadline and sum(r.name == "http.request"
                                              for r in tracing.records()) < n:
            time.sleep(0.01)
    finally:
        tracing.disable()
        server.shutdown()
        server.server_close()
        server.state.close()
    assert all(code == 200 for code, _ in replies)
    recs = tracing.records()
    requests = [r for r in recs if r.name == "http.request"]
    assert len(requests) == n and len({r.rid for r in requests}) == n
    runs = [r for r in recs if r.name == "batch.run"]
    assert sum(r.meta["batch"] for r in runs) == n
    for req in requests:
        assert req.meta == {"route": "/recommend", "status": 200}
        kids = [r for r in recs if r.parent == req.id]
        assert [k.name for k in kids] == ["http.parse", "serve.recommend", "http.reply"]
        assert all(req.t0 <= k.t0 <= k.t1 <= req.t1 for k in kids)
        rec = kids[1]
        assert rec.rid == req.rid
        (queued,) = [r for r in recs if r.name == "batch.queue" and r.rid == req.rid]
        assert queued.parent == rec.id and rec.t0 <= queued.t0 <= queued.t1 <= rec.t1
        (run,) = [r for r in runs if req.rid in r.meta["rids"]]
        assert queued.t1 <= run.t0 and run.meta["bucket"] >= run.meta["batch"]
    for run in runs:
        kids = [r.name for r in recs if r.parent == run.id]
        assert kids == ["serve.queries", "serve.topk", "serve.fetch", "serve.filter"]


def test_cli_train_trace_writes_nested_spans(data, tmp_path, capsys):
    df, _, feats = data
    staging, emb = tmp_path / "staging", tmp_path / "emb"
    staging.mkdir()
    emb.mkdir()
    np.savez(staging / "interactions.npz",
             **{c: df[c] for c in ("user_id", "asin", "ts", "rating")})
    np.save(emb / "txt_interacted.npy", feats)
    path = tmp_path / "train_trace.json"
    cli.main(["train", "--staging-prefix", str(staging), "--embeddings-prefix", str(emb),
              "--models-prefix", str(tmp_path / "models"), "--item-features", "txt",
              "--device", "cpu", "--epochs", "2", "--samples-per-epoch", "500",
              "--eval-neg-k", "20", "--hidden-dim", "16", "--trace", str(path)])
    out = capsys.readouterr()
    assert "ndcg@20" in json.loads(out.out)["test"]
    assert json.loads(out.err.strip().splitlines()[-1])["trace"] == str(path)
    assert tracing.span("after") is tracing.NOOP  # the flag is turned off again
    spans = [e for e in json.loads(path.read_text())["traceEvents"] if e["ph"] == "X"]
    by = {e["args"]["id"]: e for e in spans}
    for child, want in (("train.step", "train.epoch"), ("train.epoch", "train.fit"),
                        ("train.sample", "train.step"), ("train.optimizer", "train.step"),
                        ("eval.scores", "eval"), ("eval", "train.fit")):
        assert {by[e["args"]["parent"]]["name"] for e in spans if e["name"] == child} == {want}


# -- on the card -------------------------------------------------------------


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, within):
    """The parts of `intervals` (start, end) inside the union of `within`."""
    w = _union(within)
    return [(max(a, s0), min(b, s1)) for a, b in intervals for s0, s1 in w
            if min(b, s1) > max(a, s0)]


def _length(intervals):
    return sum(b - a for a, b in _union(intervals))


@pytest.mark.cuda
def test_adam_kernels_lie_inside_the_optimizer_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from benchmark.tracing import Profile

    dev = torch.device("cuda")
    df = synthetic_interactions(n_users=60_000, n_items=20_000, n_interactions=300_000, seed=1)
    u2i, i2i = build_node_maps(df)
    s = build_splits(df, u2i, i2i)
    cfg = TrainConfig(model_family="lightgcn", epochs=1, eval_neg_k=50, batch_size=32_768,
                      neg_per_pos=2, seed=1)
    model = make_model(cfg, s.n_users, s.n_items, 0, device=dev)
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    tr = Trainer(model, cfg, graph, s, device=dev)
    tr.fit()  # builds and warms every kernel
    # Profile places the trace on the host clock by its marker kernel's start; that kernel's
    # first launch in a process loads its module (~0.4 ms late on an H100), so it is warmed here
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    with Profile(dev) as prof:
        tr.fit()
    assert prof.trace is not None
    recs = tracing.records(prof.trace.t0, prof.trace.t1)
    steps = [(r.d0, r.d1) for r in recs if r.name == "train.step"]
    opt = [(r.d0, r.d1) for r in recs if r.name == "train.optimizer"]
    phases = [(r.d0, r.d1) for r in recs if r.name in PHASES]
    assert steps and len(opt) == len(steps) and all(a is not None for a, _ in phases)
    adam = [(s, s + d) for n, s, d in prof.trace.ops if "multi_tensor_apply" in n]
    assert adam and _length(_clip(adam, opt)) >= 0.95 * _length(adam)
    busy_in_steps = _clip([(s, s + d) for _, s, d in prof.trace.ops], steps)
    assert _length(_clip(busy_in_steps, phases)) >= 0.95 * _length(busy_in_steps)
