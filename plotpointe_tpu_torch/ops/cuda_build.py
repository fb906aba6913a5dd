"""Build, load and count the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled on its own by nvcc for sm_90a into a shared
library with a plain C interface and loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries go to `build/plotpointe_tpu_torch/` at
the repository root, named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused. `build_all` starts one nvcc
per source at once and waits for all of them.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` calls one on the tensor's device and current
stream and raises on a non-zero code. Every wrapper counts its launches on a
`LaunchCounter`: one per source, plus one for each TPU kernel that a source
serves in another mode (`SHARED`).

The launch path is on every wrapper's hot path (LightGCN calls kernel 7 six
times a step), so once a library is loaded `launch` takes no lock, enters
`torch.cuda.device` only for a tensor off the current device, and reads the
stream as a raw pointer without building a `torch.cuda.Stream`.
"""
from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plotpointe_tpu_torch"
KERNELS = ("gat_fwd", "gat_bwd_dst", "gat_bwd_src", "gather_fence", "topk_chunkmax", "topk_rescore",
           "spmm_csr", "gat_fwd_mh", "gat_bwd_dst_mh", "knn_topk", "knn_topk_fast", "stream_probe",
           "smoke_affine")
# TPU kernels that a source above computes in another mode, each with a
# counter of its own: the legacy attention contracts' reduces (v1's weighted
# one and the unweighted one) are spmm_csr over pre-gathered rows; v2's
# fused layer is gat_fwd with an explicit mask.
SHARED = ("fused_segment_reduce", "onehot_reduce", "fused_layer")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
P = ctypes.c_void_p
I = ctypes.c_int
# C entry point and argument types of each library
SIGNATURES = {
    "gat_fwd": ("ppt_gat_fwd", [P] * 11 + [I, I, P]),
    "gat_bwd_dst": ("ppt_gat_bwd_dst", [P, I] + [P] * 11 + [I, I, I, P, P]),
    "gat_bwd_src": ("ppt_gat_bwd_src", [P, P, I] + [P] * 10 + [I, I, I, P, P]),
    "gather_fence": ("ppt_gather_fence", [P, I, I, I, P, P]),
    "topk_chunkmax": ("ppt_topk_chunkmax", [P, P, P, I, I, I, I, P]),
    "topk_rescore": ("ppt_topk_rescore", [P, P, P, P, I, I, I, I, I, P]),
    "spmm_csr": ("ppt_spmm_csr", [P, I] + [P] * 9 + [I, I, I, I, P]),
    "gat_fwd_mh": ("ppt_gat_fwd_mh", [P] * 11 + [I, I, I, I, P]),
    "gat_bwd_dst_mh": ("ppt_gat_bwd_dst_mh", [P, I] + [P] * 11 + [I, I, I, I, I, P]),
    "knn_topk": ("ppt_knn_topk", [P, P, P, P, I, I, I, P]),
    "knn_topk_fast": ("ppt_knn_topk_fast", [P, P, P, I, I, I, P]),
    "stream_probe": ("ppt_stream_probe", [P, ctypes.c_float, P, I, I, I, P]),
    "smoke_affine": ("ppt_smoke_affine", [P, P, ctypes.c_longlong, P]),
}
MAX_SMEM = 232_448 - 1024  # a block's shared memory on sm_90, less static use

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Callable[..., int]] = {}  # filled once per library, read without the lock


class LaunchCounter:
    """Number of kernel launches a wrapper made; thread-safe. A bump is one
    `next()` of an `itertools.count` (atomic, and cheaper than a lock on
    every launch); reading the count takes one tick more, which `count`
    subtracts."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def bump(self) -> None:
        next(self._ticks)

    @property
    def count(self) -> int:
        with self._lock:
            n = next(self._ticks) - self._reads  # ticks so far = bumps + earlier reads
            self._reads += 1
            return n

    def reset(self) -> None:
        with self._lock:
            self._ticks, self._reads = itertools.count(), 0


COUNTERS = {name: LaunchCounter() for name in KERNELS + SHARED}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library, one nvcc process per source, all at
    once. Returns {name: seconds} for what was built (0.0 if it was there);
    ptxas' register/shared-memory report goes to `<lib>.log`."""
    with _lock:
        return _build_locked(list(names))


def _build_locked(names) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    took = {name: 0.0 for name in names}
    errors = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.ppt_error_string.argtypes = [I]
            lib.ppt_error_string.restype = ctypes.c_char_p
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, I
            if hasattr(lib, symbol + "_smem"):
                sm = getattr(lib, symbol + "_smem")
                sm.argtypes, sm.restype = [I], ctypes.c_size_t
            _libs[name] = lib
        return lib


def entry(name: str) -> Callable[..., int]:
    """The C entry point of `csrc/<name>.cu`, building the library if missing."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries.setdefault(name, getattr(_load(name), SIGNATURES[name][0]))
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Call `csrc/<name>.cu`'s entry point with `args` and the current
    stream of `device` (a CUDA device with an index, as a tensor's is), and
    raise if it returns a CUDA error."""
    fn = _entries.get(name) or entry(name)
    index = device.index
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        check(rc, name)


def require_smem(name: str, size: int, what: str = "D") -> None:
    """Raise ValueError if the kernel's shared memory for `size` (the row
    width D, or what `what` names) exceeds a block's."""
    need = getattr(_load(name), SIGNATURES[name][0] + "_smem")(size)
    if need > MAX_SMEM:
        raise ValueError(f"{name}: {what}={size} needs {need} bytes of shared memory; "
                         f"a block has {MAX_SMEM}")


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = _load(name).ppt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {rc})")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous with a 16-byte aligned start (a fresh copy if it is not),
    for kernels that read rows in 16-byte loads."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()

