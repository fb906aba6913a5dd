"""The rest of serving in the port against the JAX package: telemetry records
and drift, the reply codes and bodies of /recommend and /feedback, the
environment's startup payload, `cli drift`, the gs:// half of the artifact
store (a stub client: no network), the FastAPI app's gated import and the
environment-configured entry point. Small shapes, numpy serving paths."""
import json
import os
import socket
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from plotpointe_tpu import cli as jax_cli
from plotpointe_tpu.serving.endpoints import ServingState as JaxState
from plotpointe_tpu.serving.telemetry import ServingTelemetry as JaxTelemetry
from plotpointe_tpu.utils.artifacts import ArtifactStore as JaxStore
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.serving.endpoints import ServingState
from plotpointe_tpu_torch.serving.httpd import serve
from plotpointe_tpu_torch.serving.runtime import RecommenderRuntime, ServingConfig
from plotpointe_tpu_torch.serving.telemetry import ServingTelemetry
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

ROOT = Path(__file__).resolve().parents[1]
HOUR = 3600.0
T0 = 1_700_000_000.0 - 1_700_000_000.0 % HOUR  # the start of an hour


@pytest.fixture(autouse=True)
def _nosync(monkeypatch):
    monkeypatch.setenv("PLOTPOINTE_QUEUE_NOSYNC", "1")


@pytest.fixture()
def clock(monkeypatch):
    """time.time pinned to a settable value, so hour buckets are chosen."""
    now = types.SimpleNamespace(t=T0 + 10.0)
    monkeypatch.setattr("time.time", lambda: now.t)
    return now


def test_telemetry_schemas_and_drift(tmp_path, clock):
    tel = ServingTelemetry(root=str(tmp_path), experiment="e1", model_version="v1")
    rid = tel.log_request([1, 2, 3], [0.9, 0.8, 0.7], latency_ms=12.5, user_key="u1")
    tel.log_feedback(rid, item_id=2, event_type="click")
    reqs = tel.requests.read_all()
    assert len(reqs) == 1
    assert set(reqs[0]) == {"request_id", "ts", "user_key", "item_ids", "scores", "latency_ms",
                            "experiment", "model_version"}
    fb = tel.feedback.read_all()
    assert fb[0]["request_id"] == rid and fb[0]["event_type"] == "click"
    assert set(fb[0]) == {"request_id", "ts", "user_key", "item_id", "event_type", "value"}
    tel.log_request([4], [0.5], latency_ms=20.0)
    drift = tel.aggregate_drift()
    assert len(drift) == 1 and drift[-1]["n_requests"] == 2
    assert drift[-1]["latency_p95_ms"] >= drift[-1]["latency_p50_ms"]


@pytest.mark.parametrize("durable", [False, True])
def test_drift_equals_jax_over_the_same_directory(tmp_path, clock, durable):
    """Records over three hours, written by the port (JSONL file or durable
    queue): JAX's aggregate_drift of the directory equals the port's, and
    `cli drift` prints the same text in both packages."""
    rng = np.random.default_rng(0)
    tel = ServingTelemetry(root=str(tmp_path), durable=durable)
    for i in range(30):
        clock.t = T0 + [10.0, HOUR + 5.0, 3 * HOUR + 1.0][i % 3] + i
        tel.log_request(rng.integers(0, 100, 5).tolist(), rng.normal(size=5).tolist(),
                        latency_ms=float(rng.gamma(2.0, 3.0)), user_key=f"u{i}")
        tel.log_feedback(f"r{i}", item_id=i, event_type="click")
    got = ServingTelemetry(root=str(tmp_path)).aggregate_drift()
    want = JaxTelemetry(root=str(tmp_path)).aggregate_drift()
    assert len(got) == 3 and [r["n_requests"] for r in got] == [10, 10, 10]
    assert got == want
    assert ServingTelemetry(root=str(tmp_path)).durable is durable


def test_cli_drift_prints_what_jax_prints(tmp_path, clock, capsys):
    tel = ServingTelemetry(root=str(tmp_path), durable=True)
    for i in range(5):
        clock.t = T0 + i * 1000.0
        tel.log_request([i], [0.1 * i], latency_ms=float(i))
    cli.main(["drift", "--telemetry-dir", str(tmp_path)])
    got = capsys.readouterr().out
    jax_cli.main(["drift", "--telemetry-dir", str(tmp_path)])
    assert got == capsys.readouterr().out
    assert [r["n_requests"] for r in json.loads(got)] == [4, 1]


def _states(tmp_path, micro_batch: bool, with_telemetry: bool = True):
    """The port's ServingState and JAX's on the same 8 x 4 table, numpy path."""
    path = tmp_path / "emb.npy"
    np.save(path, np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32))
    out = {}
    for name, state_cls, tel_cls in (("port", ServingState, ServingTelemetry),
                                     ("jax", JaxState, JaxTelemetry)):
        tel = tel_cls(root=str(tmp_path / name)) if with_telemetry else None
        st = state_cls(telemetry=tel, micro_batch=micro_batch, micro_batch_wait_ms=1.0)
        out[name] = st
        assert st.recommend({"item_ids": [1]})[0] == 503
        assert st.startup({"item_embeddings_uri": str(path), "use_device": False}) == (200, {"status": "ok"})
    return out


PAYLOADS = {
    "good": ("recommend", {"item_ids": [0, 1], "k": 3, "user_key": "u7"}),
    "empty": ("recommend", {"item_ids": []}),
    "missing": ("recommend", {"k": 3}),
    "out_of_range": ("recommend", {"item_ids": [999]}),
    "negative_out_of_range": ("recommend", {"item_ids": [-9]}),
    "non_int": ("recommend", {"item_ids": ["a", 1]}),
    "feedback": ("feedback", {"request_id": "r1", "item_id": 3, "event_type": "view", "value": 2}),
    "feedback_default_event": ("feedback", {"request_id": "r1", "item_id": "4"}),
    "feedback_no_request_id": ("feedback", {"item_id": 3}),
    "feedback_bad_item": ("feedback", {"request_id": "r1", "item_id": "x"}),
    "feedback_bad_value": ("feedback", {"request_id": "r1", "item_id": 1, "value": [1]}),
}


@pytest.mark.parametrize("micro_batch", [False, True])
def test_replies_and_logs_equal_jax(tmp_path, clock, micro_batch):
    states = _states(tmp_path, micro_batch)
    try:
        replies = {name: {case: getattr(st, route)(dict(p)) for case, (route, p) in PAYLOADS.items()}
                   for name, st in states.items()}
        for case in PAYLOADS:
            (pc, pb), (jc, jb) = replies["port"][case], replies["jax"][case]
            assert pc == jc and {k: v for k, v in pb.items() if k != "request_id"} == \
                {k: v for k, v in jb.items() if k != "request_id"}, case
            assert ("request_id" in pb) == ("request_id" in jb) == (case == "good"), case
        assert [replies["port"][c][0] for c in PAYLOADS] == [200, 400, 400, 400, 400, 400, 200, 200, 400,
                                                             400, 400]
        logs = {}
        for name, st in states.items():
            tel = st.telemetry
            logs[name] = [[{k: v for k, v in r.items() if k not in ("ts", "request_id", "latency_ms")}
                           for r in sink.read_all()] for sink in (tel.requests, tel.feedback, tel.rejects)]
        assert logs["port"] == logs["jax"]
        reqs, fbs, rejects = logs["port"]
        assert len(reqs) == 1 and reqs[0]["user_key"] == "u7" and len(fbs) == 2 and len(rejects) == 6
        assert states["port"].telemetry.requests.read_all()[0]["request_id"] == \
            replies["port"]["good"][1]["request_id"]
    finally:
        for st in states.values():
            if st.batcher is not None:
                st.batcher.close()


def test_feedback_without_telemetry_equals_jax(tmp_path):
    states = _states(tmp_path, micro_batch=False, with_telemetry=False)
    p = {"request_id": "r1", "item_id": 3}
    assert states["port"].feedback(p) == states["jax"].feedback(p) == (503, {"detail": "telemetry not enabled"})
    assert states["port"].recommend({"item_ids": [1], "k": 2})[1].keys() == {"indices", "scores"}


def test_latency_includes_the_batchers_wait(tmp_path):
    path = tmp_path / "emb.npy"
    np.save(path, np.eye(8, dtype=np.float32))
    st = ServingState(telemetry=ServingTelemetry(root=str(tmp_path / "tel")), micro_batch=True,
                      micro_batch_wait_ms=500.0)
    try:
        assert st.startup({"item_embeddings_uri": str(path), "use_device": False})[0] == 200
        # the first request finds the batcher idle and is scored at once; the
        # second follows it within the window, so it waits out the 500 ms for stragglers
        assert st.recommend({"item_ids": [1], "k": 2})[0] == 200
        code, body = st.recommend({"item_ids": [0], "k": 2})
        assert code == 200
        assert (st.batcher.stats.n_batches, st.batcher.stats.n_immediate) == (2, 1), st.batcher.stats
        (rec,) = [r for r in st.telemetry.requests.read_all() if r["request_id"] == body["request_id"]]
        assert rec["latency_ms"] >= 495.0
    finally:
        st.batcher.close()


ENVS = {
    "uri_only": {"ITEM_EMBEDDINGS_URI": "gs://b/emb.npy"},
    "all": {"ITEM_EMBEDDINGS_URI": "/x/emb.npy", "ITEM_INDEX_MAP_URI": "/x/map.json", "TOPK": "7",
            "PROJECT_ID": "p1", "GOOGLE_CLOUD_PROJECT": "p2"},
    "cloud_project": {"ITEM_EMBEDDINGS_URI": "/x/emb.npy", "GOOGLE_CLOUD_PROJECT": "p2"},
    "none": {"TOPK": "9"},
}


@pytest.mark.parametrize("env", ENVS)
def test_startup_from_env_builds_jax_payload(monkeypatch, env):
    for k in ("ITEM_EMBEDDINGS_URI", "ITEM_INDEX_MAP_URI", "TOPK", "PROJECT_ID", "GOOGLE_CLOUD_PROJECT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    seen, loaded = {}, {}
    for name, cls in (("port", ServingState), ("jax", JaxState)):
        def capture(payload, name=name):
            seen[name] = payload
            return 200, {"status": "ok"}

        st = cls()
        st.startup = capture
        loaded[name] = st.startup_from_env()
    assert seen.get("port") == seen.get("jax")
    assert loaded["port"] is loaded["jax"] is (env != "none")


class _StubStorage:
    """A google.cloud.storage.Client stand-in: blobs live in a dict; every
    call is recorded with paths relative to the store's cache dir."""

    def __init__(self, cache: Path):
        self.cache, self.blobs, self.calls = cache, {}, []

    def bucket(self, bucket):
        stub = self

        class _Blob:
            def __init__(self, name):
                self.key = (bucket, name)

            def download_to_filename(self, local):
                stub.calls.append(("download", *self.key, Path(local).relative_to(stub.cache).as_posix()))
                Path(local).write_bytes(stub.blobs[self.key])

            def upload_from_filename(self, local):
                stub.calls.append(("upload", *self.key, Path(local).relative_to(stub.cache).as_posix()))
                stub.blobs[self.key] = Path(local).read_bytes()

            def exists(self):
                stub.calls.append(("exists", *self.key))
                return self.key in stub.blobs

        return types.SimpleNamespace(blob=_Blob)


def test_gs_artifacts_use_jax_cache_paths_and_blob_names(tmp_path):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    seen = {}
    for name, cls in (("port", ArtifactStore), ("jax", JaxStore)):
        store = cls(cache_dir=str(tmp_path / name), project_id="p1")
        stub = store._gcs_client = _StubStorage(tmp_path / name)
        assert store.save_npy(arr, "gs://bkt/exports/item_embeddings.npy") == \
            "gs://bkt/exports/item_embeddings.npy"
        store.save_json({"a": 1}, "gs://bkt/maps/node_maps.json")
        assert store.exists("gs://bkt/maps/node_maps.json") and not store.exists("gs://bkt/none")
        np.testing.assert_array_equal(store.load_npy("gs://bkt/exports/item_embeddings.npy"), arr)
        assert store.load_json("gs://bkt/maps/node_maps.json") == {"a": 1}
        store.publish(tmp_path / name / "bkt" / "maps" / "node_maps.json", "gs://other/copy.json")
        seen[name] = stub.calls
    assert seen["port"] == seen["jax"]
    assert ("download", "bkt", "exports/item_embeddings.npy", "bkt/exports/item_embeddings.npy") in seen["port"]


def test_gs_without_google_cloud_storage_raises_jax_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)  # absent: no client is ever made
    errors = []
    for cls in (ArtifactStore, JaxStore):
        with pytest.raises(ImportError) as e:
            cls(cache_dir=str(tmp_path)).load_npy("gs://bkt/emb.npy")
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "gs:// URIs require google-cloud-storage; use local paths instead"


def test_serving_config_project_reaches_the_store():
    rt = RecommenderRuntime(ServingConfig(item_embeddings_uri="x.npy", project_id="p9"))
    assert rt.store.project_id == "p9"
    assert RecommenderRuntime(ServingConfig(item_embeddings_uri="x.npy")).store.project_id is None


def test_create_app_without_fastapi_names_the_extra(monkeypatch):
    from plotpointe_tpu_torch.serving.app import create_app

    monkeypatch.setitem(sys.modules, "fastapi", None)
    with pytest.raises(ImportError, match="`serving` extra"):
        create_app()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.mark.parametrize("durable", [False, True])
def test_telemetry_wired_into_http(tmp_path, durable):
    path = tmp_path / "emb.npy"
    np.save(path, np.eye(8, dtype=np.float32))
    rt = RecommenderRuntime(ServingConfig(item_embeddings_uri=str(path), use_device=False))
    rt.startup()
    tel = ServingTelemetry(root=str(tmp_path / "tel"), durable=durable)
    httpd, _ = serve("127.0.0.1", 0, runtime=rt, telemetry=tel, block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, body = _post(f"{base}/recommend", {"item_ids": [0, 1], "k": 3})
        assert code == 200 and "request_id" in body
        assert _post(f"{base}/feedback", {"request_id": body["request_id"],
                                          "item_id": body["indices"][0]}) == (200, {"status": "ok"})
        assert _post(f"{base}/feedback", {"item_id": 1})[0] == 400
        assert [r["request_id"] for r in tel.requests.read_all()] == [body["request_id"]]
        assert len(tel.feedback.read_all()) == 1 and len(tel.rejects.read_all()) == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.state.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("use_device", ["0", None])
def test_env_entry_point(tmp_path, use_device):
    """`python -m plotpointe_tpu_torch.serving`: SERVING_USE_DEVICE=0 serves
    the numpy path and logs to TELEMETRY_DIR; unset, it takes the card and,
    without one, exits with the CUDA error instead of serving on the CPU."""
    path = tmp_path / "emb.npy"
    np.save(path, np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "SERVING_USE_DEVICE"}
    env.update(ITEM_EMBEDDINGS_URI=str(path), TOPK="5", TELEMETRY_DIR=str(tmp_path / "tel"),
               HOST="127.0.0.1", PORT=str(port), CUDA_VISIBLE_DEVICES="")
    if use_device is not None:
        env["SERVING_USE_DEVICE"] = use_device
    proc = subprocess.Popen([sys.executable, "-m", "plotpointe_tpu_torch.serving"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        if use_device is None:
            _, err = proc.communicate(timeout=120)
            assert proc.returncode != 0 and "CUDA is not available" in err
            return
        line = proc.stdout.readline()
        assert line.strip() == f"serving on 127.0.0.1:{port} loaded=True telemetry=True"
        deadline = time.time() + 30
        while True:
            try:
                code, body = _post(f"http://127.0.0.1:{port}/recommend", {"item_ids": [1, 2]})
                break
            except urllib.error.URLError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        assert code == 200 and len(body["indices"]) == 5 and not {1, 2} & set(body["indices"])
        recs = [json.loads(x) for x in (tmp_path / "tel" / "requests.jsonl").read_text().splitlines()]
        assert [r["request_id"] for r in recs] == [body["request_id"]]
    finally:
        proc.kill()
        proc.communicate(timeout=30)
