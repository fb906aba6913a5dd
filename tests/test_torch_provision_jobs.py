"""The port's deployment tools against the JAX package's on the CPU:
`tools/provision.py` (plan / apply / destroy, the state file, the local
driver, the gcloud lines) and `tools/jobs.py` (the `${VAR:-default}`
rules, restarts, the capacity race), with their CLI commands and the specs
and container files under `deploy_torch/` and `docker_torch/`.

Mirrors the nine tests of `tests/test_provision_jobs.py` on the port's
specs, then holds the port to JAX on JAX's own specs: the same gcloud
strings, plans, state and materialised files (byte-equal), queues that
open in either package, the same rendered job commands, and the same exit
codes (`cli jobs run` drops the job's code in both packages; the tools'
`main` returns it). Every comparison is exact: strings, bools and bytes.
Children are short `sh` commands; one `cli --help` subprocess.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from plotpointe_tpu import cli as jax_cli
from plotpointe_tpu.serving.eventqueue import DurableQueue as JaxQueue
from plotpointe_tpu.tools import jobs as jax_jobs
from plotpointe_tpu.tools import provision as jax_prov
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.serving.eventqueue import DurableQueue
from plotpointe_tpu_torch.tools import jobs, provision
from plotpointe_tpu_torch.tools.jobs import load_job, race_job, render_command, substitute
from plotpointe_tpu_torch.tools.provision import LocalDriver, State, apply, gcloud_command, load_spec, plan

REPO = Path(__file__).resolve().parent.parent
SPEC = REPO / "deploy_torch" / "infra.yaml"
JOBS = REPO / "deploy_torch" / "jobs"
JAX_SPEC = REPO / "deploy" / "infra.yaml"
OVERRIDES = {"CHECKPOINT": "ckpt.npz", "ARTIFACTS": "tmp/a"}


def _spec():
    return load_spec(SPEC)


def _job_specs():
    return sorted(JOBS.glob("*.yaml"))


# -- the nine tests of tests/test_provision_jobs.py, on the port's specs ----------


def test_plan_apply_idempotent(tmp_path):
    spec = _spec()
    state = State(tmp_path / "state.json")
    actions = plan(spec, state)
    assert all(a["op"] == "create" for a in actions)
    counts = apply(spec, state, LocalDriver(tmp_path), actions)
    assert counts["create"] == len(spec["resources"])

    state2 = State(tmp_path / "state.json")
    assert all(a["op"] == "noop" for a in plan(spec, state2))
    assert (tmp_path / "plotpointe-artifacts" / ".store.json").exists()
    assert (tmp_path / "telemetry" / "recsys_logs" / "requests" / "schema.json").exists()
    assert (tmp_path / "queues" / "recsys-requests" / "queue.json").exists()
    vm = state2.resources["gpu_vm.plotpointe-h100"]
    assert vm["external"] is True
    assert vm["command"].startswith("gcloud compute instances create plotpointe-h100 ")
    assert "--accelerator=type=nvidia-h100-80gb,count=1" in vm["command"]
    assert vm["command"].endswith(" --provisioning-model=SPOT")


def test_spec_change_replaces_and_removal_deletes(tmp_path):
    spec = _spec()
    state = State(tmp_path / "state.json")
    driver = LocalDriver(tmp_path)
    apply(spec, state, driver, plan(spec, state))

    spec["resources"][0]["retention_days"] = 60
    removed = spec["resources"].pop()
    state = State(tmp_path / "state.json")
    ops = {a["id"]: a["op"] for a in plan(spec, state)}
    assert ops["artifact_store.plotpointe-artifacts"] == "replace"
    assert ops[f"event_queue.{removed['name']}"] == "delete"
    counts = apply(spec, state, driver, plan(spec, state))
    assert counts["replace"] == 1 and counts["delete"] == 1
    assert not (tmp_path / "queues" / removed["name"]).exists()


def test_gcloud_render_covers_every_kind():
    spec = _spec()
    assert {r["kind"] for r in spec["resources"]} == {
        "artifact_store", "gpu_vm", "service_account", "telemetry_dataset", "event_queue"}
    for res in spec["resources"]:
        assert res["name"] in gcloud_command(res, "proj")
    q = [r for r in spec["resources"] if r["kind"] == "event_queue"][0]
    cmd = gcloud_command(q, "proj")
    assert "--dead-letter-topic" in cmd and "--max-delivery-attempts=5" in cmd
    vm = [r for r in spec["resources"] if r["kind"] == "gpu_vm"][0]
    assert gcloud_command(vm, "proj") == (
        "gcloud compute instances create plotpointe-h100 --zone=us-central1-a "
        "--machine-type=a3-highgpu-1g --accelerator=type=nvidia-h100-80gb,count=1 "
        "--maintenance-policy=TERMINATE --image-family=common-cu128-ubuntu-2204-nvidia-570 "
        "--image-project=deeplearning-platform-release --boot-disk-size=200GB --project=proj "
        "--provisioning-model=SPOT")
    assert "--provisioning-model" not in gcloud_command(dict(vm, spot=False), "proj")


def test_job_substitution_pattern():
    assert substitute("x ${A} ${B:-def}", {"A": "1"}) == "x 1 def"
    assert substitute("${A:-d}", {"A": "v"}) == "v"
    with pytest.raises(KeyError):
        substitute("${MISSING}", {})
    for text, env in (("x ${A} ${B:-def}", {"A": "1"}), ("${A:-}y", {}), ("$A ${A:-d}", {"A": ""})):
        assert substitute(text, env) == jax_jobs.substitute(text, env)


def test_every_job_spec_loads_and_renders():
    specs = _job_specs()
    assert len(specs) == len(list((REPO / "deploy" / "jobs").glob("*.yaml"))) == 8
    for f in specs:
        spec = load_job(f)
        cmd = render_command(spec, OVERRIDES)
        assert cmd.startswith("python -m plotpointe_tpu_torch.cli "), f
        assert "${" not in cmd, f"unresolved vars in {f}: {cmd}"
        assert spec["accelerator"] == "nvidia-h100-80gb", f


def test_job_spec_cli_subcommands_exist():
    help_text = subprocess.run(
        [sys.executable, "-m", "plotpointe_tpu_torch.cli", "--help"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    ).stdout
    parser = cli.build_parser()
    for f in _job_specs():
        cmd = render_command(load_job(f), {"CHECKPOINT": "c", "ARTIFACTS": "a"})
        for part in cmd.split("&&"):
            argv = part.split()[3:]  # after "python -m plotpointe_tpu_torch.cli"
            assert argv[0] in help_text, f"{f}: unknown subcommand {argv[0]}"
            parser.parse_args(argv)  # every flag exists (a parse error exits 2)
    for sub in ("provision", "jobs"):
        assert sub in help_text


def test_job_dry_run_end_to_end(capsys):
    assert jobs.main(["run", str(JOBS / "train_gat_h100.yaml"), "--set", "EPOCHS=3", "--dry-run"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert "--epochs 3" in meta["command"]
    assert meta["restart_on_preemption"] is True
    assert meta["accelerator"] == "nvidia-h100-80gb"


def test_job_race_first_capacity_wins(tmp_path, capsys):
    """One winner past the grace window; workers denied capacity drop out;
    losers are killed. The winner writes its marker to a temp file and
    renames it, so a loser killed mid-write cannot leave it empty."""
    marker = tmp_path / "winner.txt"
    spec_p = tmp_path / "race.yaml"
    spec_p.write_text(
        "name: race-test\n"
        "command: |\n"
        f"  sh -c 'if [ \"${{WORKER}}\" = \"local\" ]; then sleep 0.2 && echo ${{WORKER}} > {marker}.$$ "
        f"&& mv {marker}.$$ {marker}; else exit 1; fi'\n"
    )
    rc = race_job(load_job(spec_p), {}, ["local", "local", "local"], grace_s=5.0, timeout_s=30.0)
    assert rc == 0
    assert marker.read_text().strip() == "local"
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()
             if line.startswith("{")]
    assert any("winner" in line for line in lines)


def test_job_race_all_denied(tmp_path):
    spec_p = tmp_path / "race.yaml"
    spec_p.write_text("name: race-denied\ncommand: \"sh -c 'exit 7'\"\n")
    assert race_job(load_job(spec_p), {}, ["local", "local"], grace_s=2.0, timeout_s=10.0) == 1


# -- the port against JAX, on JAX's specs ---------------------------------------------


def test_gcloud_lines_equal_jax_on_every_jax_resource():
    spec = jax_prov.load_spec(JAX_SPEC)
    assert load_spec(JAX_SPEC) == spec
    for res in spec["resources"]:
        for project in ("proj", "<project>"):
            assert gcloud_command(res, project) == jax_prov.gcloud_command(res, project)
    with pytest.raises(ValueError, match="unknown resource kind: nope"):
        gcloud_command({"kind": "nope", "name": "x"}, "p")


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): (p.read_bytes() if p.is_file() else None)
            for p in sorted(root.rglob("*")) if p.name != "state.json"}


def test_plan_apply_state_and_files_equal_jax(tmp_path):
    spec = jax_prov.load_spec(JAX_SPEC)
    roots = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    acts, states = {}, {}
    for name, mod in (("port", provision), ("jax", jax_prov)):
        state = mod.State(roots[name] / "state.json")
        acts[name] = mod.plan(spec, state)
        mod.apply(spec, state, mod.LocalDriver(roots[name]), acts[name])
        states[name] = mod.State(roots[name] / "state.json").resources
    assert acts["port"] == acts["jax"]
    assert list(states["port"]) == list(states["jax"])
    for rid, cur in states["jax"].items():
        got = states["port"][rid]
        assert got["spec"] == cur["spec"]
        assert {k for k in got if k != "path"} == {k for k in cur if k != "path"}
        assert got.get("command") == cur.get("command") and got.get("external") == cur.get("external")
        if "path" in cur:
            assert Path(got["path"]).relative_to(roots["port"]) == Path(cur["path"]).relative_to(roots["jax"])
    tree = _tree(roots["port"])
    assert tree == _tree(roots["jax"])
    for rel in ("plotpointe-artifacts/.store.json", "telemetry/recsys_logs/requests/schema.json",
                "telemetry/recsys_logs/drift_hourly/table.json", "queues/recsys-feedback/queue.json"):
        assert tree[rel]
    # re-apply is all noops in both; destroy deletes in the same order
    for name, mod in (("port", provision), ("jax", jax_prov)):
        state = mod.State(roots[name] / "state.json")
        assert all(a["op"] == "noop" for a in mod.plan(spec, state))
        acts[name] = mod.plan({"resources": []}, state)
        mod.apply({"resources": []}, state, mod.LocalDriver(roots[name]), acts[name])
        assert mod.State(roots[name] / "state.json").resources == {}
    assert acts["port"] == acts["jax"]
    assert _tree(roots["port"]) == _tree(roots["jax"])


@pytest.mark.parametrize("made_by", ["port", "jax"])
def test_provisioned_queue_opens_in_the_other_package(tmp_path, monkeypatch, made_by):
    monkeypatch.setenv("PLOTPOINTE_QUEUE_NOSYNC", "1")
    mod = provision if made_by == "port" else jax_prov
    res = {"kind": "event_queue", "name": "q", "max_delivery_attempts": 3, "dlq": True}
    path = Path(mod.LocalDriver(tmp_path).create(res)["path"])
    other = JaxQueue if made_by == "port" else DurableQueue
    q = other(path, max_attempts=3)
    q.publish({"request_id": "r1", "item_ids": [1, 2]})
    ((off, rec),) = q.pull()
    q.ack([off])
    q.close()
    assert rec == {"request_id": "r1", "item_ids": [1, 2]}
    mine = DurableQueue if made_by == "port" else JaxQueue
    q = mine(path, max_attempts=3)
    assert q.backlog() == 0 and q.read_all() == [rec]
    q.close()


def test_rendered_commands_equal_jax_on_every_jax_spec(monkeypatch):
    monkeypatch.setenv("ARTIFACTS", "/from/env")  # the process environment takes part in both
    for f in sorted((REPO / "deploy" / "jobs").glob("*.yaml")):
        spec = jax_jobs.load_job(f)
        assert load_job(f) == spec
        for over in (OVERRIDES, {"CHECKPOINT": "c", "EPOCHS": "2", "WORKER": "w1"}):
            assert render_command(spec, over) == jax_jobs.render_command(spec, over), f


def test_remote_lines_use_gcloud_compute_ssh(capsys):
    spec = load_job(JOBS / "train_gat_h100.yaml")
    assert jobs.run_job(spec, {}, remote="plotpointe-h100", dry_run=True) == 0
    assert race_job(spec, {}, ["vm1:europe-west4-b", "vm2"], dry_run=True) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["command"].startswith(
        "gcloud compute ssh plotpointe-h100 --zone=us-central1-a --command='python -m plotpointe_tpu_torch.cli train")
    assert lines[1]["command"].startswith("gcloud compute ssh vm1 --zone=europe-west4-b --command=")
    assert lines[2]["command"].startswith(f"gcloud compute ssh vm2 --zone={jobs.ZONE} --command=")


def test_restarts_and_exit_codes_equal_jax(tmp_path, capsys):
    """Two restarts after a failure with restart_on_preemption, in both
    packages. The quirk, matched: `cli jobs run` returns without raising
    (so `python -m ... cli jobs run` exits 0) though the job exited 3,
    while each package's `tools.jobs.main` returns 3."""
    for name, mod in (("port", jobs), ("jax", jax_jobs)):
        count = tmp_path / f"attempts_{name}"
        spec = {"name": "flaky", "restart_on_preemption": True,
                "command": f"sh -c 'echo x >> {count}; exit 5'"}
        assert mod.run_job(spec, {}) == 5
        assert count.read_text().count("x") == 3
    spec_p = tmp_path / "exit3.yaml"
    spec_p.write_text("name: exit3\ncommand: \"sh -c 'exit 3'\"\n")
    for main in (cli.main, jax_cli.main):
        assert main(["jobs", "run", str(spec_p)]) is None
    for mod in (jobs, jax_jobs):
        assert mod.main(["run", str(spec_p)]) == 3
    rcs = [json.loads(line)["rc"] for line in capsys.readouterr().out.splitlines()
           if line.startswith('{"job": "exit3", "rc"')]
    assert rcs == [3, 3, 3, 3]


def test_cli_provision_and_jobs_list(tmp_path, capsys):
    cli.main(["provision", "apply", "--spec", str(SPEC), "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["apply"]["create"] == len(_spec()["resources"])
    cli.main(["provision", "render", "--spec", str(SPEC)])
    assert "gcloud compute instances create plotpointe-h100" in capsys.readouterr().out
    cli.main(["provision", "destroy", "--spec", str(SPEC), "--root", str(tmp_path)])
    capsys.readouterr()
    assert State(tmp_path / "state.json").resources == {}
    assert not (tmp_path / "plotpointe-artifacts").exists()
    cli.main(["jobs", "list", "--dir", str(JOBS)])
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 8 and {r["accelerator"] for r in rows} == {"nvidia-h100-80gb"}


def test_launch_log_appends_one_line_a_process(tmp_path):
    """`PLOTPOINTE_LAUNCH_LOG`: each process that loaded the kernels' module
    appends its counts as one JSON line at exit; the smoke's job runs read
    what their children launched from it."""
    from plotpointe_tpu_torch.ops import cuda_build

    log = tmp_path / "launches.jsonl"
    cuda_build.reset_counters()
    cuda_build.COUNTERS["knn_topk"].bump()
    cuda_build._log_launches(str(log))
    cuda_build._log_launches(str(log))
    cuda_build.reset_counters()
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(lines) == 2 and lines[0]["launches"] == lines[1]["launches"]
    assert set(lines[0]["launches"]) == set(cuda_build.COUNTERS)
    assert {k for k, v in lines[0]["launches"].items() if v} == {"knn_topk"}


# -- the deployment files ----------------------------------------------------------------

DEPLOY_FILES = sorted(p for d in ("deploy_torch", "docker_torch") for p in (REPO / d).rglob("*")
                      if p.is_file())


def test_compose_parses_and_reserves_a_gpu_for_serving():
    compose = yaml.safe_load((REPO / "deploy_torch" / "docker-compose.yml").read_text())
    assert set(compose["services"]) == {"serving", "drift"}
    serving = compose["services"]["serving"]
    (dev,) = serving["deploy"]["resources"]["reservations"]["devices"]
    assert dev["driver"] == "nvidia" and dev["capabilities"] == ["gpu"]
    for svc in compose["services"].values():
        assert (REPO / "deploy_torch" / svc["build"]["context"] / svc["build"]["dockerfile"]).is_file()


def test_every_port_command_in_the_deploy_files_exists():
    import importlib.util

    subs = set(cli.build_parser()._subparsers._group_actions[0].choices)
    named = []
    for p in DEPLOY_FILES:
        text = p.read_text()
        # `python -m MOD [SUB]`, and the exec form `"python3", "-m", "MOD"`
        named += re.findall(r"python3? -m (plotpointe_tpu_torch[\w.]*)(?: ([\w-]+))?", text)
        named += [(m, "") for m in re.findall(r'"-m", "(plotpointe_tpu_torch[\w.]*)"', text)]
    mods = {m for m, _ in named}
    assert {"plotpointe_tpu_torch.cli", "plotpointe_tpu_torch.serving"} <= mods
    for mod, sub in named:
        assert importlib.util.find_spec(mod) is not None, mod
        if mod in ("plotpointe_tpu_torch.cli", "plotpointe_tpu_torch") and sub:
            assert sub in subs, f"unknown subcommand {sub}"


def test_dockerfile_copy_sources_exist():
    n = 0
    for p in (REPO / "docker_torch").glob("*Dockerfile"):
        for line in p.read_text().splitlines():
            if line.startswith("COPY "):
                *srcs, _dst = line.split()[1:]
                for s in srcs:
                    assert (REPO / s).exists(), f"{p.name}: {s}"
                    n += 1
    assert n >= 4


def test_deploy_files_name_neither_jax_nor_the_jax_package():
    assert len(DEPLOY_FILES) >= 14
    for p in DEPLOY_FILES:
        text = p.read_text()
        assert "plotpointe_tpu." not in text and "jax" not in text.lower(), p
