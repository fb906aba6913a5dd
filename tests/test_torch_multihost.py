"""Multi-process runs of the port: 2 processes, one gloo CPU rank each,
collectives crossing the process boundary; mirrors tests/test_multihost.py.
Each process runs `plotpointe_tpu_torch.tools.multihost_smoke`, the same
per-process entry a launcher would run. Both processes must see the group
of 2, print IDENTICAL losses, and finish a whole `ShardedTrainer.fit()`
(GAT and LightGCN). The four launches run in one module fixture, one
group after another (two processes at a time keep the `-n 6` run's load
low); each test holds its own."""
import json
import os
import subprocess
import sys

import pytest

from plotpointe_tpu_torch.parallel.multihost import free_port
from plotpointe_tpu_torch.tools import multihost_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"step": [], "fit": ["--fit"], "lightgcn_fit": ["--fit", "--family", "lightgcn"]}


def _start(extra, n=2):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    return [subprocess.Popen(
        [sys.executable, "-m", "plotpointe_tpu_torch.tools.multihost_smoke", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id", str(pid), "--device", "cpu",
         *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(n)]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for mode, (extra, n) in {**{m: (e, 2) for m, e in MODES.items()}, "step_1_process": ([], 1)}.items():
        procs = _start(extra, n)
        try:
            out[mode] = []
            for p in procs:
                stdout, stderr = p.communicate(timeout=300)
                assert p.returncode == 0, f"{mode} process failed:\n{stderr[-3000:]}"
                out[mode].append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return out


@pytest.mark.multihost
def test_two_process_sharded_step(runs):
    r0, r1 = runs["step"]
    assert r0["n_processes"] == r1["n_processes"] == 2
    assert r0["n_devices"] == r1["n_devices"] == 2
    assert r0["backend"] == r1["backend"] == "gloo" and not r0["staged"]
    # the collectives agreed: the loss is identical in both processes
    assert r0["loss"] == r1["loss"]
    # each process holds another block of the user table -> other gradients
    assert r0["grad_user_norm"] != r1["grad_user_norm"]
    # one process alone gives the same global batch's loss
    (alone,) = runs["step_1_process"]
    assert abs(alone["loss"] - r0["loss"]) <= 5e-4 * abs(alone["loss"])


@pytest.mark.multihost
def test_two_process_full_fit(runs):
    r0, r1 = runs["fit"]
    assert r0["loss"] == r1["loss"]
    assert r0["best_val_ndcg20"] == r1["best_val_ndcg20"] > 0.0
    assert r0["test_ndcg20"] == r1["test_ndcg20"] > 0.0


@pytest.mark.multihost
def test_two_process_lightgcn_fit(runs):
    r0, r1 = runs["lightgcn_fit"]
    assert r0["loss"] == r1["loss"]
    assert r0["test_ndcg20"] == r1["test_ndcg20"] > 0.0


def test_devices_per_process_must_be_one():
    with pytest.raises(SystemExit):
        multihost_smoke.main(["--coordinator", "127.0.0.1:1", "--num-processes", "1",
                              "--process-id", "0", "--devices-per-process", "4"])
