#!/usr/bin/env python3
"""Time kernels 2 (B1) and 9 of `csrc/gat_bwd_dst.cu` against variants of
that source on one card, at the main graph of `chip_smoke.py`.

    python3 docs/scripts/b1_variants.py [--out DIR] [--variants kept,no_cs,...]

Each variant is a copy of `plotpointe_tpu_torch/csrc/` under DIR (default
`tmp/b1_variants`, which .gitignore lists) with `gat_bwd_dst.cu` patched:

  kept      the source as it stands
  no_cs     g and out read with the read-only path (`__ldg`), not streamed
  no_pf     no L2 prefetch of the next row's g and out at a piece's start
  no_div    de's quotient by an IEEE division per entry, not x * r
            corrected by one FMA
  base      none of the three (the walk alone)
  node      godot from a node pass before the walk (one warp a node),
            not formed at each piece's start
  lb4       registers capped for 4 blocks of 256 threads an SM, not 3
  ilp2      twice the source rows in flight a lane

Every variant is built at once (one nvcc each), then kernel 2 (D 128, head
0's rows, the 0.1 mask) and kernel 9 (2 x 128; the mask with bf16 rows) are
timed with bf16 and f32 rows, in turns (the list, then reversed), each
variant's outputs against the kept source's: `same_bits` true where every
output has the same bits. One JSON line per turn; the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _sub(s: str, old: str, new: str) -> str:
    if old not in s:
        raise AssertionError(f"variant patch no longer applies: {old[:60]!r}")
    return s.replace(old, new)


def no_cs(s):
    s = _sub(s, "load_f32_once<VEC>(a.g + row", "load_f32<VEC>(a.g + row")
    return _sub(s, "load_f32_once<VEC>(a.out + row", "load_f32<VEC>(a.out + row")


def no_pf(s):
    return _sub(s, """          if (row + 1 < a.n) {
            prefetch_l2(a.g + (row + 1) * a.ld + ch * VEC);
            prefetch_l2(a.out + (row + 1) * a.ld + ch * VEC);
          }
""", "")


def no_div(s):
    return _sub(s, """              const float x = m * pq[q][c] - go[c];
              const float q0 = x * rdn[c];  // x / dn, then one FMA correction
              const float de = fmaf(fmaf(-q0, dn[c], x), rdn[c], q0) * s_deriv[k * st + i];""",
                """              const float de = ((m * pq[q][c] - go[c]) / dn[c]) * s_deriv[k * st + i];""")


NODE_KERNEL = """// godot[n, H] = g . out per head, one warp per node
__global__ void node_godot(const float* __restrict__ g, const float* __restrict__ out,
                           float* __restrict__ godot, int n, int heads, int d) {
  const int node = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= n) return;
  for (int k = 0; k < heads; ++k) {
    const long long off = (static_cast<long long>(node) * heads + k) * d;
    float s = 0.f;
    for (int f = lane; f < d; f += 32) s += g[off + f] * out[off + f];
    s = warp_sum(s);
    if (lane == 0) godot[static_cast<long long>(node) * heads + k] = s;
  }
}

template <typename T, bool GIVEN>
cudaError_t launch_walk("""


def node(s):
    s = _sub(s, """      if constexpr (GIVEN) {
        const float go_row = a.godot_in[row];
#pragma unroll
        for (int c = 0; c < C; ++c) go[c] = go_row;
      } else {
        head_sums(t, head, gmask, a.red, merge);
#pragma unroll
        for (int c = 0; c < C; ++c) go[c] = t[0][c];
      }""", """#pragma unroll
      for (int c = 0; c < C; ++c) go[c] = a.godot_in[row * H + head[c]];""")
    s = _sub(s, """          if constexpr (!GIVEN) {
            float ov[VEC];
            load_f32_once<VEC>(a.out + row * a.ld + ch * VEC, ov);
#pragma unroll
            for (int k = 0; k < VEC; ++k) t[0][c] += gv[c][k] * ov[k];
          }""", "")
    s = _sub(s, "template <typename T, bool GIVEN>\ncudaError_t launch_walk(", NODE_KERNEL)
    s = _sub(s, "  const int strip = strips ? STRIP : width;", """  if (!strips) {
    const dim3 block(32 * WARPS_PER_BLOCK);
    const dim3 grid((f.n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
    node_godot<<<grid, block, 0, st>>>(f.g, f.out, f.godot, f.n, f.heads, f.d);
    err = cudaGetLastError();
  }
  const int strip = strips ? STRIP : width;""")
    s = _sub(s, "strips ? f.ghs : nullptr, strips ? f.godot : nullptr,", "strips ? f.ghs : nullptr, f.godot,")
    s = _sub(s, "c0 == 0 ? f.de_sum : nullptr, strips ? nullptr : f.godot, f.partial + c0,",
             "c0 == 0 ? f.de_sum : nullptr, nullptr, f.partial + c0,")
    return _sub(s, "f.split_ptr, f.de_sum, strips ? nullptr : f.godot, f.n_split,",
                "f.split_ptr, f.de_sum, nullptr, f.n_split,")


def lb4(s):
    return _sub(s, "__launch_bounds__(32 * WALK_UNITS, WALK_MIN_BLOCKS) bwd_dst_walk",
                "__launch_bounds__(32 * WALK_UNITS, 4) bwd_dst_walk")


def ilp2(s):
    return _sub(s, "constexpr int FIT = 32 / (C * VEC);", "constexpr int FIT = 64 / (C * VEC);")


VARIANTS = {"kept": [], "no_cs": [no_cs], "no_pf": [no_pf], "no_div": [no_div],
            "base": [no_cs, no_pf, no_div], "node": [node], "lb4": [lb4], "ilp2": [ilp2]}


def make(out: Path, names) -> None:
    src = ROOT / "plotpointe_tpu_torch" / "csrc"
    for name in names:
        d = out / name / "csrc"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src, d)
        s = (d / "gat_bwd_dst.cu").read_text()
        for patch in VARIANTS[name]:
            s = patch(s)
        (d / "gat_bwd_dst.cu").write_text(s)


def use(out: Path, name: str) -> None:
    from plotpointe_tpu_torch.ops import cuda_build

    cuda_build.CSRC = (out / name / "csrc").resolve()
    cuda_build.BUILD_DIR = (out / name / "build").resolve()
    cuda_build._libs.clear()
    cuda_build._entries.clear()


def build(out: Path, names) -> float:
    """Every variant's library at once, one process (and nvcc) each."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", (
        "import sys; from pathlib import Path; sys.path.insert(0, %r); "
        "from plotpointe_tpu_torch.ops import cuda_build as cb; "
        "cb.CSRC = Path(%r); cb.BUILD_DIR = Path(%r); cb.build_all(['gat_bwd_dst'])") % (
            str(ROOT), str((out / n / "csrc").resolve()), str((out / n / "build").resolve()))])
        for n in names]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a variant failed to build")
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tmp" / "b1_variants"))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b1_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst, attention_bwd_dst_mh, dropout_mask_mh, hash_mask)

    names = args.variants.split(",")
    if names[0] != "kept":
        names = ["kept"] + [n for n in names if n != "kept"]
    out = Path(args.out)
    cs.phase_device()
    make(out, names)
    print(json.dumps({"built_s": build(out, names)}), flush=True)
    inter = cs.amazon_shaped_interactions(0)
    s = build_splits(inter, *build_node_maps(inter))
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w).to("cuda")
    n, e, d = graph.n_nodes, graph.n_edges, 128
    gen = torch.Generator(device="cuda").manual_seed(13)

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    h, ct, out2 = t(n, 2, d), t(n, 2, d), t(n, 2, d, scale=0.1)
    gs, gd = t(n, 2, scale=0.5), t(n, 2, scale=0.5)
    den = torch.rand((n, 2), generator=gen, device="cuda") * 4 + 1
    m1 = hash_mask(7, torch.arange(e, device="cuda"), 0.1)
    mask = dropout_mask_mh(graph, 0.1, 7, 2, "cuda")
    cases = {}
    for dt in (torch.bfloat16, torch.float32):
        rows, dname = h.to(dt), str(dt)[6:]
        a1 = [x[:, 0].contiguous() for x in (rows, gs, gd, ct, out2, den)]
        cases[f"kernel 2 H=1 D=128 rows={dname} mask=0.1"] = lambda a1=a1: attention_bwd_dst(*a1, graph, m1)
        mk = mask if dt == torch.bfloat16 else None
        cases[f"kernel 9 H=2 D=128 rows={dname} mask={0.1 if mk is not None else 0}"] = \
            lambda rows=rows, mk=mk: attention_bwd_dst_mh(rows, gs, gd, ct, out2, den, graph, mk)
    kept = None
    for name in names + names[::-1]:
        use(out, name)
        got = {k: f() for k, f in cases.items()}
        kept = kept or got
        print(json.dumps({"variant": name, "ms": {k: cs.time_ms(f) for k, f in cases.items()},
                          "same_bits": {k: all(torch.equal(a, b) for a, b in zip(got[k], kept[k]))
                                        for k in got}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
