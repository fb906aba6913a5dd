"""spmm_roofline: kernel 7 (csrc/spmm_csr.cu) over the traced fit: its
launches times one launch's bound (`counts/spmm.py`, from the shapes, rows
at the configuration's type) over the device time of the kernels below,
in %."""
from benchmark.counts import spmm

KERNELS = ("spmm_units", "spmm_combine")


def read(obs):
    if obs.trace is None:
        return None
    device_s = obs.trace.time_of(KERNELS)
    launches = obs.counters.get("spmm_csr", 0)
    if device_s <= 0 or not launches:
        return None
    sh = obs.shapes
    isz = 2 if sh["rows"] == "bfloat16" else 4
    return 100.0 * launches * spmm.spmm_bound_s(sh["n_nodes"], sh["n_edges"], sh["embed_dim"], isz) / device_s
