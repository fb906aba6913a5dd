"""Declarative provisioning: plan / apply / destroy over an infra spec
(default `deploy_torch/infra.yaml`) with a terraform-style state file.

Counterpart of `plotpointe_tpu/tools/provision.py`; the same spec format,
plans, state file and local driver, so it also applies and renders the JAX
package's `deploy/infra.yaml`:

  * `plan`    — diff the spec against the recorded state; print
                create / replace / delete (noops are counted, not printed).
  * `apply`   — run the plan through the local driver and save the state.
                Re-applying an unchanged spec is all noops.
  * `destroy` — delete everything in the state.
  * `render`  — print the gcloud / bq / gsutil line of every resource.

The local driver materialises what one GPU VM runs itself: artifact-store
prefixes with their `.store.json`, telemetry table schemas (`schema.json`,
`table.json`) and durable event queues (the port's `DurableQueue`, whose
files are the JAX queue's, plus `queue.json`). External resources
(`gpu_vm`, the H100 counterpart of `tpu_vm`; `tpu_vm`; `service_account`)
are recorded in the state with the command that creates them.

    python -m plotpointe_tpu_torch.tools.provision {plan,apply,destroy,render} \
        [--spec deploy_torch/infra.yaml] [--root tmp/infra] [--project ID]

Specs are YAML, read with pyyaml (the package's `deploy` extra), which is
imported when a spec is loaded.
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List

# the telemetry tables' columns, flattened to the fields the serving
# telemetry logs (serving/telemetry.py)
TABLE_SCHEMAS = {
    "requests": [
        {"name": "request_id", "type": "STRING", "mode": "REQUIRED"},
        {"name": "ts", "type": "TIMESTAMP", "mode": "REQUIRED"},
        {"name": "user_key", "type": "STRING", "mode": "NULLABLE"},
        {"name": "item_ids", "type": "INTEGER", "mode": "REPEATED"},
        {"name": "scores", "type": "FLOAT", "mode": "REPEATED"},
        {"name": "latency_ms", "type": "FLOAT", "mode": "NULLABLE"},
        {"name": "experiment", "type": "STRING", "mode": "NULLABLE"},
        {"name": "model_version", "type": "STRING", "mode": "NULLABLE"},
    ],
    "feedback": [
        {"name": "request_id", "type": "STRING", "mode": "REQUIRED"},
        {"name": "ts", "type": "TIMESTAMP", "mode": "REQUIRED"},
        {"name": "user_key", "type": "STRING", "mode": "NULLABLE"},
        {"name": "item_id", "type": "INTEGER", "mode": "REQUIRED"},
        {"name": "event_type", "type": "STRING", "mode": "REQUIRED"},
        {"name": "value", "type": "FLOAT", "mode": "NULLABLE"},
    ],
    "drift_hourly": [
        {"name": "hour", "type": "TIMESTAMP", "mode": "REQUIRED"},
        {"name": "n_requests", "type": "INTEGER", "mode": "REQUIRED"},
        {"name": "score_mean", "type": "FLOAT", "mode": "NULLABLE"},
        {"name": "score_std", "type": "FLOAT", "mode": "NULLABLE"},
        {"name": "latency_p50_ms", "type": "FLOAT", "mode": "NULLABLE"},
        {"name": "latency_p95_ms", "type": "FLOAT", "mode": "NULLABLE"},
    ],
}
EXTERNAL_KINDS = ("gpu_vm", "tpu_vm", "service_account")


def _rid(res: Dict[str, Any]) -> str:
    return f"{res['kind']}.{res['name']}"


def load_spec(path: str | Path) -> Dict[str, Any]:
    import yaml

    spec = yaml.safe_load(Path(path).read_text())
    seen = set()
    for res in spec.get("resources", []):
        if "kind" not in res or "name" not in res:
            raise ValueError(f"resource missing kind/name: {res}")
        if _rid(res) in seen:
            raise ValueError(f"duplicate resource id {_rid(res)}")
        seen.add(_rid(res))
    return spec


class State:
    def __init__(self, path: Path):
        self.path = path
        self.resources: Dict[str, Dict] = {}
        if path.exists():
            self.resources = json.loads(path.read_text()).get("resources", {})

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(
            {"version": 1, "updated": time.time(), "resources": self.resources}, indent=2))


def plan(spec: Dict, state: State) -> List[Dict]:
    """Ordered actions: create for a new resource, replace for a changed one,
    noop for an unchanged one, then delete for each one gone from the spec."""
    actions = []
    desired = {_rid(r): r for r in spec.get("resources", [])}
    for rid, res in desired.items():
        cur = state.resources.get(rid)
        if cur is None:
            actions.append({"op": "create", "id": rid, "res": res})
        elif cur.get("spec") != res:
            actions.append({"op": "replace", "id": rid, "res": res})
        else:
            actions.append({"op": "noop", "id": rid, "res": res})
    for rid, cur in state.resources.items():
        if rid not in desired:
            actions.append({"op": "delete", "id": rid, "res": cur["spec"]})
    return actions


class LocalDriver:
    """Materialises the resources one VM runs itself under `root`; external
    ones are recorded with their creation command."""

    def __init__(self, root: Path):
        self.root = Path(root)

    def create(self, res: Dict) -> Dict:
        kind = res["kind"]
        out: Dict[str, Any] = {"spec": res, "created": time.time()}
        if kind == "artifact_store":
            base = self.root / res["name"]
            for p in res.get("prefixes", []):
                (base / p).mkdir(parents=True, exist_ok=True)
            (base / ".store.json").write_text(json.dumps(
                {"versioning": res.get("versioning", False),
                 "retention_days": res.get("retention_days")}, indent=2))
            out["path"] = str(base)
        elif kind == "telemetry_dataset":
            base = self.root / "telemetry" / res["name"]
            for t in res.get("tables", []):
                tdir = base / t["name"]
                tdir.mkdir(parents=True, exist_ok=True)
                (tdir / "schema.json").write_text(json.dumps(TABLE_SCHEMAS.get(t["name"], []), indent=2))
                (tdir / "table.json").write_text(json.dumps(t, indent=2))
            out["path"] = str(base)
        elif kind == "event_queue":
            from plotpointe_tpu_torch.serving.eventqueue import DurableQueue

            qdir = self.root / "queues" / res["name"]
            DurableQueue(qdir, max_attempts=int(res.get("max_delivery_attempts", 5))).close()
            (qdir / "queue.json").write_text(json.dumps(
                {"max_delivery_attempts": res.get("max_delivery_attempts", 5),
                 "dlq": res.get("dlq", True)}, indent=2))
            out["path"] = str(qdir)
        elif kind in EXTERNAL_KINDS:
            out["external"] = True
            out["command"] = gcloud_command(res, project="<project>")
        else:
            raise ValueError(f"unknown resource kind: {kind}")
        return out

    def delete(self, rid: str, cur: Dict) -> None:
        p = cur.get("path")
        if p and Path(p).exists() and Path(p).is_relative_to(self.root):
            shutil.rmtree(p)


def gcloud_command(res: Dict, project: str) -> str:
    """The command that creates the resource on GCP; on the JAX package's
    kinds, the JAX tool's string."""
    k = res["kind"]
    if k == "gpu_vm":
        cmd = (f"gcloud compute instances create {res['name']} --zone={res['zone']} "
               f"--machine-type={res['machine_type']} "
               f"--accelerator=type={res['accelerator']},count={res.get('count', 1)} "
               f"--maintenance-policy=TERMINATE")
        if res.get("image_family"):
            cmd += f" --image-family={res['image_family']} --image-project={res['image_project']}"
        if res.get("boot_disk_gb"):
            cmd += f" --boot-disk-size={res['boot_disk_gb']}GB"
        cmd += f" --project={project}"
        if res.get("spot"):
            cmd += " --provisioning-model=SPOT"
        return cmd
    if k == "tpu_vm":
        cmd = (f"gcloud compute tpus tpu-vm create {res['name']} --zone={res['zone']} "
               f"--accelerator-type={res['accelerator']} --version={res['runtime_version']} "
               f"--project={project}")
        if res.get("spot"):
            cmd += " --spot"
        return cmd
    if k == "service_account":
        return (f"gcloud iam service-accounts create {res['name']} --project={project}"
                + "".join(f" && gcloud projects add-iam-policy-binding {project} "
                          f"--member=serviceAccount:{res['name']}@{project}.iam.gserviceaccount.com "
                          f"--role=roles/{r}" for r in res.get("roles", [])))
    if k == "artifact_store":
        cmd = f"gsutil mb -p {project} gs://{res['name']}"
        if res.get("versioning"):
            cmd += f" && gsutil versioning set on gs://{res['name']}"
        return cmd
    if k == "telemetry_dataset":
        parts = [f"bq mk --dataset {project}:{res['name']}"]
        for t in res.get("tables", []):
            flags = f"--time_partitioning_type={'HOUR' if t.get('partition') == 'hour' else 'DAY'}"
            if t.get("ttl_days"):
                flags += f" --time_partitioning_expiration={t['ttl_days'] * 86400}"
            if t.get("cluster"):
                flags += f" --clustering_fields={','.join(t['cluster'])}"
            parts.append(f"bq mk --table {flags} {project}:{res['name']}.{t['name']}")
        return " && ".join(parts)
    if k == "event_queue":
        n = res["name"]
        return (f"gcloud pubsub topics create {n} --project={project} && "
                f"gcloud pubsub topics create {n}-dlq --project={project} && "
                f"gcloud pubsub subscriptions create {n}-sub --topic={n} "
                f"--dead-letter-topic={n}-dlq "
                f"--max-delivery-attempts={res.get('max_delivery_attempts', 5)} --project={project}")
    raise ValueError(f"unknown resource kind: {k}")


def apply(spec: Dict, state: State, driver: LocalDriver, actions: List[Dict]) -> Dict[str, int]:
    counts = {"create": 0, "replace": 0, "delete": 0, "noop": 0}
    for a in actions:
        if a["op"] in ("create", "replace"):
            if a["op"] == "replace":
                driver.delete(a["id"], state.resources[a["id"]])
            state.resources[a["id"]] = driver.create(a["res"])
        elif a["op"] == "delete":
            driver.delete(a["id"], state.resources[a["id"]])
            del state.resources[a["id"]]
        counts[a["op"]] += 1
    state.save()
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cmd", choices=["plan", "apply", "destroy", "render"])
    ap.add_argument("--spec", default="deploy_torch/infra.yaml")
    ap.add_argument("--root", default="tmp/infra", help="local driver root")
    ap.add_argument("--state", default=None, help="state file (default <root>/state.json)")
    ap.add_argument("--project", default="plotpointe", help="project id for render")
    args = ap.parse_args(argv)

    spec = load_spec(args.spec)
    state = State(Path(args.state) if args.state else Path(args.root) / "state.json")
    if args.cmd == "render":
        for res in spec["resources"]:
            print(f"# {_rid(res)}")
            print(gcloud_command(res, args.project))
        return 0
    if args.cmd == "destroy":
        spec = {"resources": []}
    actions = plan(spec, state)
    for a in actions:
        if a["op"] != "noop":
            print(f"{a['op']:8s} {a['id']}")
    if args.cmd == "plan":
        n = sum(1 for a in actions if a["op"] != "noop")
        print(json.dumps({"plan": {"changes": n, "total": len(actions)}}))
        return 0
    counts = apply(spec, state, LocalDriver(Path(args.root)), actions)
    print(json.dumps({"apply": counts, "state": str(state.path)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
