"""ctypes bindings for the native graphcore host runtime (csrc/graphcore.cpp).

Counterpart of `plotpointe_tpu/native.py`, with the same entry points and
the same numpy fallbacks. g++ builds the library on first use into
`build/plotpointe_tpu_torch/libgraphcore-<hash>.so`, named by a hash of the
source and flags as the CUDA libraries are (`ops/cuda_build.py`), so an
edited source is rebuilt. Without g++, or with PLOTPOINTE_NO_NATIVE set,
every entry point runs its numpy version; `backend()` says which is active.
This is host code: it runs on the CPU whatever the device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from plotpointe_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "graphcore.cpp"
# no -march=native: the library must run on any x86-64 host the build directory reaches
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgraphcore-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PLOTPOINTE_NO_NATIVE"):
            return None
        try:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            if lib.ppt_abi_version() != 1:
                return None
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            lib.ppt_build_csr.argtypes = [
                i64p, i64p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                i32p, i32p, f32p, i32p,
            ]
            lib.ppt_build_csr.restype = None
            lib.ppt_leave_last2.argtypes = [i32p, i64p, ctypes.c_int64, ctypes.c_int32, i8p]
            lib.ppt_leave_last2.restype = None
            lib.ppt_padded_positives.argtypes = [
                i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
            ]
            lib.ppt_padded_positives.restype = None
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def backend() -> str:
    return "native" if _load() is not None else "numpy"


def _check_ids(what: str, ids: np.ndarray, n: int) -> None:
    """The library indexes its count arrays with these ids: refuse any
    outside [0, n) before a pointer is passed."""
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise ValueError(f"{what} ids must lie in [0, {n})")


def build_csr(
    src: np.ndarray, dst: np.ndarray, weight: Optional[np.ndarray], n_nodes: int, e_pad: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(dst,src)-sorted padded edge arrays + CSR row_ptr [n_nodes + 2] (the
    last row is the padding). Native counting sort (O(E)) with numpy lexsort
    fallback; both are stable, so duplicate edges keep their input order."""
    e = len(src)
    if e_pad < e:
        raise ValueError(f"e_pad {e_pad} < {e} edges")
    lib = _load()
    if lib is not None:
        src64 = np.ascontiguousarray(src, np.int64)
        dst64 = np.ascontiguousarray(dst, np.int64)
        _check_ids("src", src64, n_nodes)
        _check_ids("dst", dst64, n_nodes)
        out_src = np.empty(e_pad, np.int32)
        out_dst = np.empty(e_pad, np.int32)
        out_w = np.empty(e_pad, np.float32)
        row_ptr = np.empty(n_nodes + 2, np.int32)
        w = np.ascontiguousarray(weight, np.float32) if weight is not None else None
        if w is not None and len(w) != e:
            raise ValueError(f"{len(w)} weights for {e} edges")
        lib.ppt_build_csr(
            src64, dst64,
            None if w is None else w.ctypes.data_as(ctypes.c_void_p),
            e, n_nodes, e_pad,
            out_src, out_dst, out_w, row_ptr,
        )
        return out_src, out_dst, out_w, row_ptr
    return build_csr_numpy(src, dst, weight, n_nodes, e_pad)


def build_csr_numpy(
    src: np.ndarray, dst: np.ndarray, weight: Optional[np.ndarray], n_nodes: int, e_pad: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """`build_csr`'s numpy version (the fallback): a stable lexsort."""
    e = len(src)
    w = np.ones(e, np.float32) if weight is None else np.asarray(weight, np.float32)
    order = np.lexsort((src, dst))
    s, d, w = np.asarray(src)[order], np.asarray(dst)[order], w[order]
    pad = e_pad - e
    out_src = np.concatenate([s, np.full(pad, n_nodes)]).astype(np.int32)
    out_dst = np.concatenate([d, np.full(pad, n_nodes)]).astype(np.int32)
    out_w = np.concatenate([w, np.zeros(pad, np.float32)])
    counts = np.bincount(d, minlength=n_nodes + 1)
    row_ptr = np.zeros(n_nodes + 2, np.int32)
    np.cumsum(counts, out=row_ptr[1 : n_nodes + 2][: len(counts)])
    row_ptr[n_nodes + 1] = e_pad
    return out_src, out_dst, out_w, row_ptr


def leave_last2_roles(u: np.ndarray, ts: np.ndarray, n_users: int) -> np.ndarray:
    """Role per interaction row: 0 train, 1 val, 2 test, 3 dropped."""
    n = len(u)
    lib = _load()
    if lib is not None:
        u32 = np.ascontiguousarray(u, np.int32)
        _check_ids("user", u32, n_users)
        role = np.empty(n, np.int8)
        lib.ppt_leave_last2(u32, np.ascontiguousarray(ts, np.int64), n, n_users, role)
        return role
    order = np.lexsort((ts, u))
    su = np.asarray(u)[order]
    boundary = np.flatnonzero(np.r_[True, su[1:] != su[:-1]])
    counts = np.diff(np.r_[boundary, n])
    pos = np.arange(n) - np.repeat(boundary, counts)
    cnt = np.repeat(counts, counts)
    role_sorted = np.full(n, 0, np.int8)
    role_sorted[cnt < 2] = 3
    role_sorted[(cnt >= 3) & (pos == cnt - 2)] = 1
    role_sorted[(cnt >= 2) & (pos == cnt - 1)] = 2
    role = np.empty(n, np.int8)
    role[order] = role_sorted
    return role


def padded_positives_native(
    train_u: np.ndarray, train_i: np.ndarray, n_users: int, n_items: int, p: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native sorted/deduped positive table; None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    u32 = np.ascontiguousarray(train_u, np.int32)
    _check_ids("user", u32, n_users)
    table = np.empty((n_users, p), np.int32)
    deg = np.empty(n_users, np.int32)
    lib.ppt_padded_positives(
        u32, np.ascontiguousarray(train_i, np.int32),
        len(train_u), n_users, n_items, p, table, deg,
    )
    return table, deg
