"""The port's durable event queue (plotpointe_tpu_torch/serving/eventqueue.py)
against the JAX package's: the cases of tests/test_eventqueue.py on the
port's queue, the same files on disk for the same operations, and each
package pulling, acking and compacting a queue directory the other wrote."""
import shutil

import pytest

from plotpointe_tpu.serving import eventqueue as jax_eq
from plotpointe_tpu_torch.serving.eventqueue import Deliverer, DurableQueue
from plotpointe_tpu_torch.serving.telemetry import ServingTelemetry

QUEUES = {"jax": jax_eq.DurableQueue, "port": DurableQueue}


@pytest.fixture(autouse=True)
def _nosync(monkeypatch):
    # fsync per event is the production default; a crash is simulated by reopening
    monkeypatch.setenv("PLOTPOINTE_QUEUE_NOSYNC", "1")


def test_publish_pull_ack_roundtrip(tmp_path):
    q = DurableQueue(tmp_path / "q")
    offs = [q.publish({"i": i}) for i in range(10)]
    assert offs == list(range(10))
    batch = q.pull(100)
    assert [d["i"] for _, d in batch] == list(range(10))
    q.ack([o for o, _ in batch])
    assert q.backlog() == 0
    assert q.pull(100) == []
    q.close()


def test_lease_blocks_double_delivery_until_expiry(tmp_path):
    q = DurableQueue(tmp_path / "q", lease_s=1000.0)
    q.publish({"x": 1})
    assert len(q.pull(10)) == 1
    assert q.pull(10) == []  # leased, not redelivered
    q.close()
    q = DurableQueue(tmp_path / "q", lease_s=0.0)
    assert len(q.pull(10)) == 1 and len(q.pull(10)) == 1  # an expired lease redelivers
    q.close()


def test_crash_mid_delivery_loses_nothing(tmp_path):
    root = tmp_path / "q"
    q = DurableQueue(root)
    for i in range(50):
        q.publish({"i": i})
    assert len(q.pull(20)) == 20
    q.close()  # crashes before acking any
    q2 = DurableQueue(root)  # leases were in memory only
    redelivered = q2.pull(100)
    assert sorted(d["i"] for _, d in redelivered) == list(range(50))
    q2.ack([o for o, _ in redelivered])
    q2.close()
    q3 = DurableQueue(root)  # acks are durable
    assert q3.backlog() == 0
    q3.close()


def test_crash_mid_publish_torn_tail_recovers(tmp_path):
    root = tmp_path / "q"
    q = DurableQueue(root)
    q.publish({"i": 0})
    q.publish({"i": 1})
    q.close()
    seg = next(root.glob("segment-*.jsonl"))
    with open(seg, "a") as f:
        f.write('{"o": 2, "d": {"i": 2')  # torn partial line, no newline
    q2 = DurableQueue(root)
    assert [d["i"] for _, d in q2.pull(10)] == [0, 1]
    assert q2.publish({"i": "next"}) == 2  # the torn record was never durable
    q2.close()


def test_dlq_after_max_attempts(tmp_path):
    q = DurableQueue(tmp_path / "q", max_attempts=5, lease_s=0.0)
    for i in range(5):
        q.publish({"i": i})

    def deliver(rec):
        if rec["i"] == 3:
            raise RuntimeError("downstream 500")

    stats = Deliverer(q, deliver).drain()
    assert stats["delivered"] == 4 and stats["dead_lettered"] == 1
    dead = q.dead_letters()
    assert len(dead) == 1 and dead[0]["d"]["i"] == 3 and dead[0]["attempts"] == 5
    assert "downstream 500" in dead[0]["reason"]
    assert q.backlog() == 0
    q.close()


def test_attempt_counts_survive_restart(tmp_path):
    root = tmp_path / "q"
    q = DurableQueue(root, max_attempts=3, lease_s=0.0)
    off = q.publish({"i": 0})
    assert q.nack(off, {"i": 0}, "fail1") is False
    assert q.nack(off, {"i": 0}, "fail2") is False
    q.close()
    q2 = DurableQueue(root, max_attempts=3, lease_s=0.0)
    assert q2.nack(off, {"i": 0}, "fail3") is True  # the 3rd attempt dead-letters
    assert len(q2.dead_letters()) == 1
    q2.close()


def test_segment_rotation_and_compaction(tmp_path):
    q = DurableQueue(tmp_path / "q", segment_bytes=200)
    for i in range(30):
        q.publish({"i": i, "pad": "x" * 40})
    segs = list((tmp_path / "q").glob("segment-*.jsonl"))
    assert len(segs) > 2
    batch = q.pull(1000)
    assert len(batch) == 30
    q.ack([o for o, _ in batch])
    assert q.compact() >= len(segs) - 1  # all but the active segment
    assert q.backlog() == 0
    q.close()


@pytest.mark.parametrize("how", ["ack", "nack"])
def test_restart_after_compact_does_not_reuse_offsets(tmp_path, how):
    """With every segment compacted away, the offset counter recovers from
    the ack log, or from the attempts log of a record dead-lettered at its
    first nack; otherwise new publishes would reuse settled offsets and never
    be delivered."""
    root = tmp_path / "q"
    q = DurableQueue(root, segment_bytes=100, max_attempts=1, lease_s=0.0)
    for i in range(10):
        q.publish({"i": i, "pad": "x" * 40})
    for off, rec in q.pull(100):
        if how == "ack":
            q.ack([off])
        else:
            assert q.nack(off, rec, "fail") is True
    q.close()  # closed first, so even the active segment is removable
    q = DurableQueue(root)
    q.compact()
    assert list(root.glob("segment-*.jsonl")) == []
    q.close()
    q2 = DurableQueue(root)
    assert q2.publish({"i": "fresh"}) == 10
    assert [d["i"] for _, d in q2.pull(100)] == ["fresh"]
    assert q2.backlog() == 1
    q2.close()


def test_telemetry_durable_sink_and_drift(tmp_path, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.0)  # one hour bucket
    tel = ServingTelemetry(root=str(tmp_path / "tel"), durable=True)
    rid = tel.log_request([1, 2, 3], [0.9, 0.8, 0.7], latency_ms=4.2)
    tel.log_feedback(request_id=rid, item_id=2, event_type="click")
    drift = tel.aggregate_drift()
    assert len(drift) == 1 and drift[0]["n_requests"] == 1
    tel2 = ServingTelemetry(root=str(tmp_path / "tel"))  # `cli drift` finds the durable layout
    assert tel2.durable is True and tel2.aggregate_drift() == drift
    delivered = []
    stats = Deliverer(tel.requests.queue, delivered.append).drain()
    assert stats["delivered"] == 1 and delivered[0]["request_id"] == rid


def _script(q, root):
    """One run of every operation that writes a file: publishes over several
    segments, a pull, acks, nacks up to the DLQ and a compaction."""
    for i in range(12):
        q.publish({"i": i, "pad": "y" * 30})
    batch = q.pull(100)
    q.ack([o for o, d in batch if d["i"] % 3 == 0])
    for o, d in batch:
        if d["i"] == 4:
            for _ in range(2):
                q.nack(o, d, "downstream 500")
    q.compact()
    q.close()
    return {p.relative_to(root).as_posix(): p.read_text() for p in sorted(root.rglob("*"))}


def test_same_files_on_disk_for_the_same_operations(tmp_path):
    files = {name: _script(cls(tmp_path / name, max_attempts=2, segment_bytes=150, lease_s=0.0),
                           tmp_path / name) for name, cls in QUEUES.items()}
    assert "dlq.jsonl" in files["port"] and len(files["port"]) > 3
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_queue_written_by_one_package_is_consumed_by_the_other(tmp_path, writer, reader):
    root = tmp_path / "q"
    q = QUEUES[writer](root, max_attempts=2, segment_bytes=150, lease_s=0.0)
    for i in range(20):
        q.publish({"i": i, "pad": "z" * 30})
    first = q.pull(5)
    q.ack([o for o, _ in first])
    q.nack(7, None, "fail")  # one attempt of two, recorded by the writer
    q.close()

    got = {}
    for name in (reader, writer):  # the reader acts; the writer's own run is the expectation
        copy = tmp_path / f"{name}_copy"
        shutil.copytree(root, copy)
        r = QUEUES[name](copy, max_attempts=2, segment_bytes=150, lease_s=0.0)
        pulled = r.pull(100)
        dead = [r.nack(o, d, "fail again") for o, d in pulled if d["i"] == 7]
        r.ack([o for o, d in pulled if d["i"] != 7])
        removed = r.compact()
        got[name] = {"pulled": [o for o, _ in pulled], "dead": dead, "removed": removed,
                     "dlq": r.dead_letters(), "backlog": r.backlog(),
                     "next": r.publish({"i": "new"}),
                     "segments": sorted(p.name for p in copy.glob("segment-*.jsonl"))}
        r.close()
    assert got[reader]["pulled"] == list(range(5, 20))
    assert got[reader]["dead"] == [True] and got[reader]["backlog"] == 0
    assert [d["o"] for d in got[reader]["dlq"]] == [7] and got[reader]["next"] == 20
    assert got[reader] == got[writer]
