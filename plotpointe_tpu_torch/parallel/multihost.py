"""Starting the ranks, and placing host arrays on them.

Counterpart of `plotpointe_tpu/parallel/multihost.py`
(`maybe_initialize_distributed`, `is_multiprocess`, `put_sharded`,
`put_replicated`, `process_slice`, `host_gather`), plus `spawn`, the
launcher JAX does not need.

The port runs one process per rank and one rank per device (`mesh.py`).
A process joins its group from the arguments or the environment, the
same on every host, as in JAX:

    PLOTPOINTE_COORDINATOR=host0:12345   # the rendezvous address
    PLOTPOINTE_NUM_PROCESSES=2
    PLOTPOINTE_PROCESS_ID=0              # unique per process

or from torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT. The
backend is NCCL for CUDA devices and gloo for the CPU unless the caller
names one; nothing falls back from one to the other. `spawn` starts N
ranks of a function on this host (rank r on `cuda:r`; more ranks than
visible GPUs raise, as JAX's `make_mesh` does), each with one thread, a
timeout on the rendezvous and on the whole run, and returns what each
rank returned. The spawned function must live in an importable module:
a spawned rank imports only that module's imports.
"""
from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from plotpointe_tpu_torch.parallel.mesh import DATA, Mesh, default_backend, rank_device

TIMEOUT_S = 600.0  # a rendezvous or collective that waits longer fails


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None, backend: Optional[str] = None,
                                 device=None) -> bool:
    """Join the process group from the arguments, the PLOTPOINTE_* variables
    or torchrun's. `num_processes=1` without a coordinator starts a group of
    one on a free localhost port. Returns True when the group has more than
    one rank. Idempotent; without arguments or environment it starts nothing
    and returns False."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator = coordinator or env.get("PLOTPOINTE_COORDINATOR")
    if coordinator is None and num_processes == 1:
        coordinator = f"127.0.0.1:{free_port()}"
    if coordinator is not None:
        num_processes = int(num_processes or env.get("PLOTPOINTE_NUM_PROCESSES", "1"))
        process_id = int(process_id if process_id is not None
                         else env.get("PLOTPOINTE_PROCESS_ID", "0"))
        init = f"tcp://{coordinator}"
    elif "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        init = "env://"
    else:
        return False
    dev = rank_device(int(env.get("LOCAL_RANK", process_id)), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev), init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return num_processes > 1


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_slice(n_rows: int, mesh: Mesh, spec: Sequence[str]) -> tuple:
    """(offset, length) of this rank's contiguous dim-0 rows under `spec`
    (`mesh.row_sharded`: split over the data axis; `()`: every row)."""
    if not spec:
        return 0, n_rows
    n_shards = 1
    for a in spec:
        n_shards *= mesh.size(a)
    if n_rows % n_shards:
        raise ValueError(f"rows ({n_rows}) must divide shards ({n_shards})")
    if tuple(spec) != (DATA,):
        raise NotImplementedError(f"process_slice splits dim 0 over the data axis; got {spec}")
    per_shard = n_rows // n_shards
    return mesh.shard * per_shard, per_shard


def put_sharded(data: np.ndarray, mesh: Mesh, spec: Sequence[str]) -> torch.Tensor:
    """This rank's block of a GLOBAL host array under `spec`, on the mesh's
    device (every process holds the array; each keeps only its rows)."""
    lo, n = process_slice(data.shape[0], mesh, spec)
    return torch.as_tensor(np.ascontiguousarray(data[lo:lo + n]), device=mesh.device)


def put_replicated(data, mesh: Mesh) -> torch.Tensor:
    return put_sharded(np.asarray(data), mesh, ())


def host_gather(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """A row-sharded tensor (this rank's block of equal-sized blocks) to
    EVERY rank as numpy: an all_gather over the data axis."""
    from plotpointe_tpu_torch.parallel.collectives import all_gather_rows

    with torch.no_grad():
        return all_gather_rows(x, mesh).cpu().numpy()


def _rank_main(fn, rank: int, n: int, port: int, backend: Optional[str], device,
               args: tuple, results) -> None:
    """One spawned rank: join the group, run `fn(*args)`, send back
    (rank, ok, value or traceback)."""
    torch.set_num_threads(1)
    try:
        maybe_initialize_distributed(f"127.0.0.1:{port}", n, rank, backend, device)
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], n_ranks: int, args: tuple = (), device=None,
          backend: Optional[str] = None, timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run `fn(*args)` on `n_ranks` new processes joined in one group (rank
    r on `cuda:r`, or on the CPU with device="cpu") and return each rank's
    value, rank 0 first. Raises if a rank raises, dies or outlasts
    `timeout_s`; every process is stopped before it returns."""
    import multiprocessing as mp

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if dev.index is None and n_ranks > have:
            raise ValueError(f"mesh shape {{'data': {n_ranks}}} needs {n_ranks} devices, have {have}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n_ranks, port, backend, device, args, results),
                         daemon=True) for r in range(n_ranks)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(got) < n_ranks:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[i].exitcode for i in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} spawned ranks outlasted {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{value}")
            got[r] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [got[r] for r in range(n_ranks)]
