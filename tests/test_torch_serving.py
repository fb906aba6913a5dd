"""The port's serving slice on the CPU: export parity with the JAX export,
runtime paths against the JAX runtime, micro-batching, the stdlib HTTP
surface and the CLI. Mirrors tests/test_serving.py and tests/test_batching.py."""
import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import jax

from plotpointe_tpu.models.gat import GATModel as JaxGAT
from plotpointe_tpu.serving.runtime import RecommenderRuntime as JaxRuntime
from plotpointe_tpu.serving.runtime import ServingConfig as JaxConfig
from plotpointe_tpu.tools.export import export_item_embeddings as jax_export
from plotpointe_tpu.train.checkpoint import save_checkpoint as jax_save
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.serving.batching import MicroBatcher, bucket_size
from plotpointe_tpu_torch.serving.httpd import serve
from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig
from plotpointe_tpu_torch.tools.export import export_item_embeddings

COLUMNS = ("user_id", "asin", "ts", "rating")


@pytest.fixture(scope="module")
def exported(tiny_dataset, tmp_path_factory):
    """A JAX checkpoint for tiny_dataset, its features, and the JAX export."""
    d = tmp_path_factory.mktemp("export")
    n_users, n_items = tiny_dataset["user_id"].nunique(), tiny_dataset["asin"].nunique()
    model = JaxGAT(n_users, n_items, feat_dim=24, hidden_dim=32, n_layers=2)
    ckpt = jax_save(d / "gat.npz", model.init(jax.random.key(1)), model.config_dict())
    feats = np.random.default_rng(3).normal(size=(n_items, 24)).astype(np.float32)
    want = jax_export(ckpt, tiny_dataset, feats, str(d / "jax_items.npy"), attn_impl="xla")
    return d, ckpt, feats, want


def test_export_matches_jax(tiny_dataset, exported, tmp_path):
    _, ckpt, feats, want = exported
    got = export_item_embeddings(ckpt, tiny_dataset, feats, str(tmp_path / "a.npy"), device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), got)
    cols = {c: tiny_dataset[c].to_numpy() for c in COLUMNS}
    got2 = export_item_embeddings(ckpt, cols, feats, str(tmp_path / "b.npy"), device="cpu")
    np.testing.assert_array_equal(got2, got)


def test_export_rejects_lightgcn_and_mismatch(tiny_dataset, exported, tmp_path):
    """A LightGCN checkpoint, once refused, now exports the JAX export's
    values (f32 rows, no features); a checkpoint trained on other
    interactions is still refused."""
    from plotpointe_tpu.models.lightgcn import LightGCNModel as JaxLightGCN
    from plotpointe_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    _, ckpt, feats, _ = exported
    n_users, n_items = tiny_dataset["user_id"].nunique(), tiny_dataset["asin"].nunique()
    jm = JaxLightGCN(n_users, n_items, embed_dim=64, n_prop_layers=3)
    lg = jax_save(tmp_path / "lg.npz", jm.init(jax.random.key(2)), jm.config_dict())
    want = jax_export(lg, tiny_dataset, None, str(tmp_path / "jax_lg.npy"))
    got = export_item_embeddings(lg, tiny_dataset, None, str(tmp_path / "lg.npy"), device="cpu")
    assert got.shape == want.shape == (n_items, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    flat, config = load_checkpoint(ckpt)
    bad = save_checkpoint(tmp_path / "bad.npz", flat, {**config, "n_users": 1})
    with pytest.raises(ValueError, match="n_users"):
        export_item_embeddings(bad, tiny_dataset, feats, str(tmp_path / "x.npy"), device="cpu")


def test_cli_export_from_npz_columns(tiny_dataset, exported, tmp_path, capsys):
    _, ckpt, feats, want = exported
    # string ids as fixed-width unicode: an npz holds no object arrays
    np.savez(tmp_path / "interactions.npz", **{c: np.asarray(tiny_dataset[c].tolist()) for c in COLUMNS})
    np.save(tmp_path / "feats.npy", feats)
    cli.main(["export", "--checkpoint", str(ckpt), "--staging-prefix", str(tmp_path),
              "--features", str(tmp_path / "feats.npy"), "--out", str(tmp_path / "o.npy"),
              "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["shape"] == list(want.shape)
    np.testing.assert_allclose(np.load(tmp_path / "o.npy"), want, rtol=1e-4, atol=1e-5)


def _runtimes(tmp_path, emb, **kw):
    path = tmp_path / "emb.npy"
    np.save(path, emb)
    rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=str(path), **kw))
    rt.startup()
    return rt, str(path)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_runtime_paths_match_jax_runtime(tmp_path, rng, table_dtype):
    emb = rng.normal(size=(700, 16)).astype(np.float32)
    path = str(tmp_path / "emb.npy")
    np.save(path, emb)
    jrt = JaxRuntime(JaxConfig(item_embeddings_uri=path, use_pallas_topk=True, table_dtype=table_dtype))
    jrt.startup()
    port = {}
    for kernel in (True, False):
        port[kernel] = RecommenderRuntime(ServingConfig(
            item_embeddings_uri=path, device="cpu", use_kernel_topk=kernel, table_dtype=table_dtype))
        port[kernel].startup()
    # the batched paths of both packages round the query to the table dtype
    # and score in f32: only the summation order differs
    tight = dict(rtol=1e-4, atol=1e-5)
    # the JAX per-request kernel path keeps an f32 query against a bf16
    # table, the port rounds it to bf16 (2**-9 relative) in every path
    single = tight if table_dtype == "float32" else dict(rtol=5e-3, atol=1e-2)
    hists = ([5], [3, 9, 200], list(range(40)))
    _, js = jrt.top_k_for_user_items(hists[1], k=10)  # one shape: each kk compiles anew
    for rt in port.values():
        i, s = rt.top_k_for_user_items(hists[1], k=10)
        assert len(i) == 10 and not np.isin(i, hists[1]).any()
        np.testing.assert_allclose(np.sort(s), np.sort(js), **single)
    jb = jrt.top_k_for_batch([np.asarray(h) for h in hists], [10, 4, 7])
    for rt in port.values():
        for (i, s), (_, js) in zip(rt.top_k_for_batch([np.asarray(h) for h in hists], [10, 4, 7]), jb):
            np.testing.assert_allclose(s, js, **tight)


def test_numpy_path_matches_jax_numpy_path(tmp_path, rng):
    emb = rng.normal(size=(64, 8)).astype(np.float32)
    rt, path = _runtimes(tmp_path, emb, use_device=False)
    jrt = JaxRuntime(JaxConfig(item_embeddings_uri=path, use_device=False))
    jrt.startup()
    for hist in ([3], [5, 9, 11], list(range(30))):
        i, s = rt.top_k_for_user_items(hist, k=5)
        ji, js = jrt.top_k_for_user_items(hist, k=5)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(s, js)


def test_history_excluded_and_sorted(tmp_path):
    rt, _ = _runtimes(tmp_path, np.eye(8, dtype=np.float32), topk=3, use_device=False)
    idx, scores = rt.top_k_for_user_items([0, 1], k=3)
    assert 0 not in idx and 1 not in idx
    assert list(scores) == sorted(scores, reverse=True)


def test_device_path_default_needs_cuda_or_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        _runtimes(tmp_path, np.eye(8, dtype=np.float32))


def test_artifact_store_formats_read_by_jax_store(tmp_path):
    from plotpointe_tpu.utils.artifacts import ArtifactStore as JaxStore
    from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

    store, jstore = ArtifactStore(), JaxStore()
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    npy = store.save_npy(arr, f"file://{tmp_path}/a/emb.npy")  # parent dirs are made
    js = store.save_json({"B00X": 0, "B00Y": 1}, str(tmp_path / "map.json"))
    npz = store.save_npz({"user_id": np.array([1, 2]), "ts": np.array([5, 6])}, str(tmp_path / "i.npz"))
    np.testing.assert_array_equal(store.load_npy(npy), jstore.load_npy(npy))
    assert store.load_json(js) == jstore.load_json(js) == {"B00X": 0, "B00Y": 1}
    got, want = store.load_npz(npz), jstore.load_npz(npz)
    assert sorted(got) == sorted(want) == ["ts", "user_id"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert store.exists(npy) and not store.exists(str(tmp_path / "none.npy"))
    with pytest.raises(FileNotFoundError):
        store.load_npy(str(tmp_path / "none.npy"))
    # gs:// goes through the storage client (a stub here: no network) into the cache
    blobs = {}

    class _Bucket:
        def __init__(self, name):
            self.name = name

        def blob(self, path):
            blob = types.SimpleNamespace(
                download_to_filename=lambda local: blobs.setdefault((self.name, path), local),
                exists=lambda: (self.name, path) in blobs)
            return blob

    gs = ArtifactStore(cache_dir=str(tmp_path / "cache"))
    gs._gcs_client = types.SimpleNamespace(bucket=_Bucket)
    (tmp_path / "cache" / "bucket").mkdir(parents=True)
    np.save(tmp_path / "cache" / "bucket" / "emb.npy", arr)  # what the stub's download leaves
    np.testing.assert_array_equal(gs.load_npy("gs://bucket/emb.npy"), arr)
    assert blobs == {("bucket", "emb.npy"): str(tmp_path / "cache" / "bucket" / "emb.npy")}


def test_bucket_size():
    assert [bucket_size(n, 64) for n in (1, 2, 3, 5, 9, 64)] == [1, 2, 4, 8, 16, 64]
    assert bucket_size(100, 64) == 100


@pytest.mark.parametrize("kernel", [True, False])
def test_batch_parity_with_single(tmp_path, kernel):
    rt, _ = _runtimes(tmp_path, np.random.default_rng(0).normal(size=(500, 32)).astype(np.float32),
                      device="cpu", use_kernel_topk=kernel)
    rng = np.random.default_rng(1)
    histories = [rng.choice(500, size=n, replace=False).astype(np.int32) for n in (1, 3, 7, 12)]
    ks = [5, 10, 3, 20]
    for h, k, (idx, sc) in zip(histories, ks, rt.top_k_for_batch(histories, ks)):
        s_idx, s_sc = rt.top_k_for_user_items([int(x) for x in h], k=k)
        np.testing.assert_array_equal(idx, s_idx)
        np.testing.assert_allclose(sc, s_sc, rtol=1e-5)
        assert not np.isin(idx, h).any()


def test_microbatcher_coalesces_and_isolates_errors(tmp_path):
    rt, _ = _runtimes(tmp_path, np.random.default_rng(0).normal(size=(500, 32)).astype(np.float32),
                      device="cpu", use_kernel_topk=True)
    # a wait far above the time 32 released threads take to submit, so the
    # coalescing asserted below holds on a loaded machine too
    mb = MicroBatcher(rt, max_batch=64, max_wait_ms=200.0)
    rng = np.random.default_rng(2)
    histories = [rng.choice(500, size=5, replace=False).tolist() for _ in range(32)]
    singles = [rt.top_k_for_user_items(h, k=10) for h in histories]
    results = [None] * 32
    barrier = threading.Barrier(32)

    def worker(i):
        barrier.wait()
        results[i] = mb.submit(histories[i], 10)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for (idx, _), (s_idx, _) in zip(results, singles):
        np.testing.assert_array_equal(idx, s_idx)
    assert mb.stats.n_requests == 32 and mb.stats.n_batches <= 8, mb.stats
    with pytest.raises(IndexError):
        rt.validate_history(np.array([10_000]))
    idx, _ = mb.submit([1, 2, 3], 5)
    assert len(idx) == 5
    mb.close()


def _batcher(tmp_path, max_wait_ms):
    rt, _ = _runtimes(tmp_path, np.random.default_rng(0).normal(size=(500, 32)).astype(np.float32),
                      device="cpu", use_kernel_topk=True)
    return rt, MicroBatcher(rt, max_batch=64, max_wait_ms=max_wait_ms)


def test_microbatcher_dispatches_a_lone_request_at_once(tmp_path):
    """An idle batcher pays no straggler wait: a 2 s window would show."""
    rt, mb = _batcher(tmp_path, max_wait_ms=2000.0)
    try:
        t0 = time.perf_counter()
        idx, _ = mb.submit([1, 2, 3], 5)
        assert time.perf_counter() - t0 < 1.0
        np.testing.assert_array_equal(idx, rt.top_k_for_user_items([1, 2, 3], k=5)[0])
        assert (mb.stats.n_batches, mb.stats.n_immediate) == (1, 1), mb.stats
    finally:
        mb.close()


def test_microbatcher_sparse_arrivals_never_wait(tmp_path):
    """Arrivals further apart than the window are each a batch of one,
    dispatched at once; each `batch.run` span says it did not wait."""
    from plotpointe_tpu_torch.utils import tracing

    _, mb = _batcher(tmp_path, max_wait_ms=50.0)
    tracing.clear()
    tracing.enable()
    try:
        for i in range(3):
            if i:
                time.sleep(0.2)
            assert len(mb.submit([i, i + 10], 4)[0]) == 4
        # a batch's span closes just after its waiter is woken
        deadline = time.time() + 10
        while time.time() < deadline and sum(r.name == "batch.run" for r in tracing.records()) < 3:
            time.sleep(0.01)
    finally:
        tracing.disable()
        mb.close()
    st = mb.stats
    assert (st.n_requests, st.n_batches, st.n_immediate) == (3, 3, 3), st
    runs = [r for r in tracing.records() if r.name == "batch.run"]
    assert [(r.meta["batch"], r.meta["waited"]) for r in runs] == [(1, False)] * 3
    tracing.clear()


def test_microbatcher_burst_after_quiet_spell_coalesces(tmp_path):
    """Only the first request of a burst can find the batcher idle; the
    rest arrive within the window of one another and coalesce."""
    rt, mb = _batcher(tmp_path, max_wait_ms=200.0)
    rng = np.random.default_rng(4)
    histories = [rng.choice(500, size=5, replace=False).tolist() for _ in range(16)]
    results = [None] * 16
    barrier = threading.Barrier(16)

    def worker(i):
        barrier.wait()
        results[i] = mb.submit(histories[i], 10)

    try:
        time.sleep(0.2)
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for h, (idx, _) in zip(histories, results):
            np.testing.assert_array_equal(idx, rt.top_k_for_user_items(h, k=10)[0])
        st = mb.stats
        assert st.n_requests == 16 and st.n_batches <= 3 and st.n_immediate <= 1, st
    finally:
        mb.close()


def _req(url, data=None):
    r = urllib.request.Request(url, data=None if data is None else json.dumps(data).encode())
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_stdlib_http_surface(tmp_path):
    path = tmp_path / "item_embeddings.npy"
    np.save(path, np.eye(8, dtype=np.float32))
    httpd, _ = serve("127.0.0.1", 0, runtime=None, block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _req(f"{base}/healthz")[0] == 200
        assert _req(f"{base}/nope")[0] == 404
        assert _req(f"{base}/recommend", {"item_ids": [1]})[0] == 503
        assert _req(f"{base}/startup", {})[0] == 400
        assert _req(f"{base}/startup", {"item_embeddings_uri": str(tmp_path / "missing.npy"),
                                        "use_device": False})[0] == 400
        assert _req(f"{base}/startup", {"item_embeddings_uri": str(path), "use_device": False})[0] == 200
        code, body = _req(f"{base}/recommend", {"item_ids": [0, 1], "k": 3})
        assert code == 200 and len(body["indices"]) == 3
        assert 0 not in body["indices"] and 1 not in body["indices"]
        assert _req(f"{base}/recommend", {"item_ids": []})[0] == 400
        assert _req(f"{base}/recommend", {"item_ids": [999]})[0] == 400
        r = urllib.request.Request(f"{base}/recommend", data=b"not json")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(r, timeout=10)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.state.close()


def test_http_concurrent_microbatched(tmp_path):
    rt, _ = _runtimes(tmp_path, np.random.default_rng(0).normal(size=(500, 32)).astype(np.float32),
                      device="cpu", use_kernel_topk=True)
    server, _ = serve("127.0.0.1", 0, runtime=rt, block=False, micro_batch=True,
                      micro_batch_max=32, micro_batch_wait_ms=200.0)  # see the batcher test
    url = f"http://127.0.0.1:{server.server_address[1]}/recommend"
    try:
        rng = np.random.default_rng(3)
        histories = [rng.choice(500, size=4, replace=False).tolist() for _ in range(48)]
        replies = [None] * 48
        barrier = threading.Barrier(48)

        def client(i):
            barrier.wait()
            replies[i] = _req(url, {"item_ids": histories[i], "k": 7})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert all(c == 200 for c, _ in replies), [c for c, _ in replies]
        for h, (_, b) in zip(histories, replies):
            assert len(b["indices"]) == 7 and not set(b["indices"]) & set(h)
            want_i, want_s = rt.top_k_for_user_items(h, k=7)
            np.testing.assert_allclose(b["scores"], want_s, rtol=1e-5)
        st = server.state.batcher.stats
        assert st.n_requests == 48 and st.mean_batch >= 4.0, st
        code, body = _req(url, {"item_ids": [999_999], "k": 3})
        assert code == 400 and "bad item_ids" in body["detail"]
        assert _req(url, {"item_ids": histories[0], "k": 3})[0] == 200
    finally:
        server.shutdown()
        server.server_close()
        server.state.close()


@pytest.mark.parametrize("flag", [["--stdlib"], []])
def test_cli_serve_reads_the_environment_like_jax(tmp_path, monkeypatch, flag):
    """JAX's `_cmd_serve` (plotpointe_tpu/cli.py:218, :223) takes the stdlib
    server when PLOTPOINTE_STDLIB_HTTP is set and loads ITEM_EMBEDDINGS_URI
    when --item-embeddings is absent: the port answers /recommend with 200
    on an environment-configured server, with --stdlib or without it."""
    from plotpointe_tpu_torch.serving import httpd

    path = tmp_path / "emb.npy"
    np.save(path, np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32))
    monkeypatch.setenv("ITEM_EMBEDDINGS_URI", str(path))
    if not flag:
        monkeypatch.setenv("PLOTPOINTE_STDLIB_HTTP", "1")
    started = []

    def serve_in_background(*args, **kw):  # the command blocks; the test needs it back
        started.append(serve(*args, **(kw | {"block": False}))[0])
        return started[-1], None

    monkeypatch.setattr(httpd, "serve", serve_in_background)
    cli.main(["serve", *flag, "--host", "127.0.0.1", "--port", "0", "--device", "cpu", "--topk", "5"])
    srv = started[0]
    try:
        code, body = _req(f"http://127.0.0.1:{srv.server_address[1]}/recommend", {"item_ids": [1, 2]})
        assert code == 200 and len(body["indices"]) == 5
        assert not {1, 2} & set(body["indices"])
    finally:
        srv.shutdown()
        srv.server_close()
        srv.state.close()


def test_cli_serve_without_stdlib_exits(monkeypatch):
    """Without --stdlib, `serve` takes the FastAPI app as JAX's does
    (plotpointe_tpu/cli.py:240-244); without fastapi it fails with an
    ImportError that names the package's `serving` extra."""
    import sys

    monkeypatch.delenv("PLOTPOINTE_STDLIB_HTTP", raising=False)
    monkeypatch.setitem(sys.modules, "fastapi", None)  # absent, whatever is installed
    with pytest.raises(ImportError, match="`serving` extra"):
        cli.main(["serve", "--port", "0"])


def test_history_quirks_of_jax_pinned_to_the_numpy_answer(tmp_path):
    """The JAX package's serving paths disagree on which history items they
    drop, and the port keeps the answer of its numpy path, the one that
    states the contract (history masked):
    - quirk 1: the XLA per-request path `_topk_scores` pads the history with
      item 0 and masks with `.at[history].set`, so the pad slots write item
      0's score back and item 0 can return when it is in the history (its
      answer depends on the scatter's order over duplicate indices, so it is
      named here and not asserted);
    - quirk 2: the Pallas per-request branch drops history with
      `np.isin(idx, ids)`, without the `% n` of its batch path, so the item a
      negative id wraps to comes back (asserted below).
    Every port path answers history [0] and history [-1] as JAX's numpy
    path does."""
    n = 60
    emb = np.random.default_rng(4).normal(size=(n, 8)).astype(np.float32)
    path = str(tmp_path / "emb.npy")
    np.save(path, emb)
    jnp_rt = JaxRuntime(JaxConfig(item_embeddings_uri=path, use_device=False))
    jnp_rt.startup()
    jpl_rt = JaxRuntime(JaxConfig(item_embeddings_uri=path, use_pallas_topk=True))
    jpl_rt.startup()
    ports = [RecommenderRuntime(ServingConfig(item_embeddings_uri=path, use_device=False))]
    ports += [RecommenderRuntime(ServingConfig(item_embeddings_uri=path, device="cpu",
                                               use_kernel_topk=kernel)) for kernel in (True, False)]
    for rt in ports:
        rt.startup()
    for hist, dropped in (([0], 0), ([-1], n - 1)):
        want_i, want_s = jnp_rt.top_k_for_user_items(hist, k=6)
        assert dropped not in want_i
        for rt in ports:
            got_i, got_s = rt.top_k_for_user_items(hist, k=6)
            np.testing.assert_array_equal(got_i, want_i)
            np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
            (bi, bs), = rt.top_k_for_batch([np.asarray(hist)], [6])
            np.testing.assert_array_equal(bi, want_i)
    # quirk 2: JAX's Pallas branch keeps the row that id -1 wraps to
    pallas_i, _ = jpl_rt.top_k_for_user_items([-1], k=6)
    assert n - 1 in pallas_i


def test_serve_bench_modes_on_the_cpu():
    """`tools/serve_bench.main` at a tiny shape on the CPU (the kernels' plain
    versions): every mode serves requests and reports JAX's keys."""
    from plotpointe_tpu_torch.tools import serve_bench

    out = serve_bench.main(["--items", "200", "--d", "16", "--clients", "4", "--seconds", "0.3",
                            "--device", "cpu", "--pallas", "--json"])
    assert out["device"] == "cpu" and out["items"] == 200 and out["speedup"] > 0
    for mode in ("single", "micro_batch", "loopback"):
        r = out[mode]
        assert r["mode"] == mode and r["n_requests"] > 0 and r["served_qps"] > 0
        assert 0 < r["latency_p50_ms"] <= r["latency_p95_ms"]
    assert out["micro_batch"]["mean_batch"] >= 1 and out["loopback"]["mean_batch"] >= 1
    assert out["loopback"]["dispatch_ms"] is not None
