"""Per-stage job specs and their runner.

Counterpart of `plotpointe_tpu/tools/jobs.py`. A spec (`deploy_torch/jobs/
*.yaml`) names a stage, its accelerator, its container image, `env`
defaults and the CLI command, with `${VAR}` / `${VAR:-default}`
substitution. The runner executes the command on this machine (one GPU
VM), or renders it as `gcloud compute ssh NAME --zone=Z --command=...` for
a remote GPU VM; `race` submits one spec to several workers and keeps the
first that gets capacity.

    python -m plotpointe_tpu_torch.tools.jobs list [--dir deploy_torch/jobs]
    python -m plotpointe_tpu_torch.tools.jobs run deploy_torch/jobs/train_gat_h100.yaml \
        --set EPOCHS=5 --set ARTIFACTS=/tmp/artifacts
    python -m plotpointe_tpu_torch.tools.jobs run ... --remote plotpointe-h100 --dry-run
    python -m plotpointe_tpu_torch.tools.jobs race SPEC --worker local --worker NAME:ZONE

This module exits with the job's return code. `cli jobs` (as the JAX
package's) runs the same `main` and drops its return code: it exits 0.
Specs are YAML, read with pyyaml (the package's `deploy` extra).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shlex
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

ZONE = "us-central1-a"  # a zone that offers a3-highgpu (H100) machines
_SUB_RE = re.compile(r"\$\{(\w+)(?::-([^}]*))?\}")


def substitute(text: str, env: Dict[str, str]) -> str:
    """`${VAR}` / `${VAR:-default}` substitution; KeyError for an unset
    variable with no default."""

    def repl(m):
        var, default = m.group(1), m.group(2)
        val = env.get(var, default)
        if val is None:
            raise KeyError(f"undefined variable ${{{var}}} with no default")
        return val

    return _SUB_RE.sub(repl, text)


def load_job(path: str | Path) -> Dict:
    import yaml

    spec = yaml.safe_load(Path(path).read_text())
    for field in ("name", "command"):
        if field not in spec:
            raise ValueError(f"{path}: job spec missing '{field}'")
    return spec


def render_command(spec: Dict, overrides: Dict[str, str]) -> str:
    """The command on one line: the spec's `env`, then the process
    environment (every variable when the command substitutes any, as the
    JAX runner reads it), then `overrides`."""
    env = dict(spec.get("env", {}))
    env.update({k: v for k, v in os.environ.items() if k in env or _SUB_RE.search(spec["command"] or "")})
    env.update(overrides)
    return substitute(" ".join(spec["command"].split()), env)


def ssh_command(name: str, zone: str, cmd: str) -> str:
    return f"gcloud compute ssh {name} --zone={zone} --command={shlex.quote(cmd)}"


def run_job(spec: Dict, overrides: Dict[str, str], remote: str | None = None,
            dry_run: bool = False, zone: str = ZONE) -> int:
    """Run (or with `dry_run` only print) the rendered command; with
    `restart_on_preemption`, up to two restarts after a failure. Returns the
    last attempt's exit code."""
    cmd = render_command(spec, overrides)
    if remote:
        cmd = ssh_command(remote, zone, cmd)
    meta = {"job": spec["name"], "accelerator": spec.get("accelerator", "none"),
            "restart_on_preemption": spec.get("restart_on_preemption", False),
            "command": cmd}
    print(json.dumps(meta), flush=True)
    if dry_run:
        return 0
    t0 = time.time()
    attempts = 1 + (2 if spec.get("restart_on_preemption") else 0)
    rc = 1
    for i in range(attempts):
        rc = subprocess.call(cmd, shell=True)
        if rc == 0:
            break
        if i + 1 < attempts:
            print(json.dumps({"job": spec["name"], "attempt": i + 1, "rc": rc, "action": "restart"}),
                  file=sys.stderr)
    print(json.dumps({"job": spec["name"], "rc": rc, "wall_s": round(time.time() - t0, 1)}), flush=True)
    return rc


def _stop(pr: subprocess.Popen, sig) -> None:
    """Signal the worker's whole process group (its shell and what it runs)."""
    try:
        os.killpg(os.getpgid(pr.pid), sig)
    except (ProcessLookupError, PermissionError):
        pr.send_signal(sig)


def race_job(spec: Dict, overrides: Dict[str, str], workers: List[str],
             grace_s: float = 3.0, timeout_s: float = 3600.0,
             dry_run: bool = False) -> int:
    """First capacity wins: launch the command on every worker ("local" on
    this machine, "NAME:ZONE" on a GPU VM over gcloud ssh), each in its own
    process group. A worker that exits non-zero (capacity denied) drops
    out; the first still running after `grace_s`, or already done with exit
    0, wins, and the others' groups are killed and reaped. Returns the
    winner's exit code, or 1 when no worker accepted the job."""
    cmds = []
    for w in workers:
        if w == "local":
            cmd = render_command(spec, dict(overrides, WORKER="local"))
        else:
            name, _, zone = w.partition(":")
            cmd = ssh_command(name, zone or ZONE, render_command(spec, dict(overrides, WORKER=name)))
        cmds.append((w, cmd))
        print(json.dumps({"race": spec["name"], "worker": w, "command": cmd}))
    if dry_run:
        return 0

    procs = [(w, subprocess.Popen(cmd, shell=True, start_new_session=True), time.time())
             for w, cmd in cmds]
    winner = None
    t0 = time.time()
    try:
        while winner is None and time.time() - t0 < timeout_s:
            alive = []
            for w, pr, ts in procs:
                rc = pr.poll()
                if rc == 0 or (rc is None and time.time() - ts >= grace_s):
                    winner = (w, pr)
                    break
                if rc is not None:
                    print(json.dumps({"race": spec["name"], "worker": w, "rc": rc, "action": "dropped"}),
                          file=sys.stderr)
                    continue
                alive.append((w, pr, ts))
            if winner is not None:
                break
            procs = alive
            if not procs:
                print(json.dumps({"race": spec["name"], "error": "no worker accepted the job"}))
                return 1
            time.sleep(0.1)
    finally:
        for w, pr, _ in procs:
            if winner is not None and pr is winner[1]:
                continue
            if pr.poll() is None:
                _stop(pr, signal.SIGTERM)
                print(json.dumps({"race": spec["name"], "worker": w, "action": "cancelled (lost the race)"}),
                      file=sys.stderr)
            try:
                pr.wait(timeout=10)
            except subprocess.TimeoutExpired:
                _stop(pr, signal.SIGKILL)
                pr.wait(timeout=5)
    if winner is None:
        return 1
    w, pr = winner
    print(json.dumps({"race": spec["name"], "winner": w}))
    rc = pr.wait()
    print(json.dumps({"job": spec["name"], "worker": w, "rc": rc, "wall_s": round(time.time() - t0, 1)}))
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="list job specs")
    p.add_argument("--dir", default="deploy_torch/jobs")
    p = sub.add_parser("run", help="run one job spec")
    p.add_argument("spec")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--remote", default=None, help="GPU VM name (render gcloud compute ssh)")
    p.add_argument("--zone", default=ZONE)
    p.add_argument("--dry-run", action="store_true")
    p = sub.add_parser("race", help="submit one job to several workers; first "
                                    "with capacity wins, the rest are cancelled")
    p.add_argument("spec")
    p.add_argument("--worker", action="append", required=True, metavar="NAME:ZONE",
                   help="repeatable; 'local' runs the command on this machine")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--grace", type=float, default=3.0)
    p.add_argument("--timeout", type=float, default=3600.0)
    p.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    if args.cmd == "list":
        rows = []
        for f in sorted(Path(args.dir).glob("*.yaml")):
            s = load_job(f)
            rows.append({"file": str(f), "name": s["name"], "accelerator": s.get("accelerator", "none")})
        print(json.dumps(rows, indent=2))
        return 0

    overrides = dict(kv.partition("=")[::2] for kv in args.set)
    if args.cmd == "race":
        return race_job(load_job(args.spec), overrides, args.worker, grace_s=args.grace,
                        timeout_s=args.timeout, dry_run=args.dry_run)
    return run_job(load_job(args.spec), overrides, remote=args.remote, dry_run=args.dry_run,
                   zone=args.zone)


if __name__ == "__main__":
    raise SystemExit(main())
