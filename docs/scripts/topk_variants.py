#!/usr/bin/env python3
"""Time the top-K rescore (kernel 5, `csrc/topk_rescore.cu`) and the select
kernel (`csrc/topk_select.cu`) against variants of those sources on one
card, at the served catalog of `chip_smoke.py` (498,196 x 128).

    python3 docs/scripts/topk_variants.py [--out DIR] [--parent DIR] [--variants kept,div,...]

Each variant is a copy of `plotpointe_tpu_torch/csrc/` under DIR (default
`tmp/topk_variants`, which .gitignore lists), patched:

  kept       the sources as they stand
  div        the rescore's copy loop finds each 16-byte slot's row by an
             integer division, not by stepping
  unroll4    the rescore's dot loop unrolled by 4 (loads ahead of the FMAs;
             the same order of sums)
  wide       the rescore stages 256 bytes of a row at a time at every grid
  narrow     the rescore stages 128 bytes of a row at a time at every grid
  sel256     the select kernel at 256 threads a row, not 512
  sel1024    the select kernel at 1,024 threads a row
  parent     kernel 5 of the checkout `--parent` (an earlier commit; the
             same C entry), where given

Every variant is built at once (one nvcc each). Then, at B 1, 8 and 64 in
f32 and bf16, for the 40 chunks of largest plain maxima a query (ascending,
as the first selection lists them): kernel 5's device time, and the select
kernel's on the [B, 3,893] maxima (r 40) and on the [B, 5,120] scores (k
32), from torch.profiler (`chip_smoke.device_ms`), in turns (the list, then
reversed), each variant's outputs against the kept sources': `same_bits`
true where every output has the same bits. One JSON line per variant, turn
and shape; the card's name and power limit first.
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


def div(s):
    s = _sub(s, """    const int drr = rows / nv, dv = rows - drr * nv;
    int rr = t / nv, v = t - rr * nv;
    for (int i = t; i < live * nv; i += rows) {""", """    for (int i = t; i < live * nv; i += rows) {
      const int rr = i / nv, v = i - rr * nv;""")
    return _sub(s, """      rr += drr;
      v += dv;
      if (v >= nv) {
        v -= nv;
        ++rr;
      }
""", "")


def unroll4(s):
    return _sub(s, "      for (int v = 0; v < nv; ++v) {", "#pragma unroll 4\n      for (int v = 0; v < nv; ++v) {")


def wide(s):
    return _sub(s, "blocks > 3LL * sms ? NARROW_PIECE : WIDE_PIECE", "WIDE_PIECE")


def narrow(s):
    return _sub(s, "blocks > 3LL * sms ? NARROW_PIECE : WIDE_PIECE", "NARROW_PIECE")


def threads(n):
    def patch(s):
        return _sub(s, "constexpr int THREADS = 512;", f"constexpr int THREADS = {n};")
    return patch


# variant: (file patched, patches)
VARIANTS = {"kept": ("topk_rescore.cu", []), "div": ("topk_rescore.cu", [div]),
            "unroll4": ("topk_rescore.cu", [unroll4]), "wide": ("topk_rescore.cu", [wide]),
            "narrow": ("topk_rescore.cu", [narrow]), "sel256": ("topk_select.cu", [threads(256)]),
            "sel1024": ("topk_select.cu", [threads(1024)]), "parent": ("topk_rescore.cu", [])}


def make(out: Path, names, parent: Path | None) -> None:
    src = ROOT / "plotpointe_tpu_torch" / "csrc"
    for name in names:
        d = out / name / "csrc"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src, d)
        fname, patches = VARIANTS[name]
        if name == "parent":
            shutil.copy(parent / "plotpointe_tpu_torch" / "csrc" / fname, d / fname)
            continue
        s = (d / fname).read_text()
        for patch in patches:
            s = patch(s)
        (d / fname).write_text(s)


def use(out: Path, name: str) -> None:
    from plotpointe_tpu_torch.ops import cuda_build

    cuda_build.CSRC = (out / name / "csrc").resolve()
    cuda_build.BUILD_DIR = (out / name / "build").resolve()
    cuda_build._libs.clear()
    cuda_build._entries.clear()


def build(out: Path, names) -> float:
    """Every variant's libraries at once, one process (and nvcc each) a variant."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", (
        "import sys; from pathlib import Path; sys.path.insert(0, %r); "
        "from plotpointe_tpu_torch.ops import cuda_build as cb; "
        "cb.CSRC = Path(%r); cb.BUILD_DIR = Path(%r); cb.build_all(['topk_rescore', 'topk_select'])") % (
            str(ROOT), str((out / n / "csrc").resolve()), str((out / n / "build").resolve()))])
        for n in names]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a variant failed to build")
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tmp" / "topk_variants"))
    ap.add_argument("--parent", default=None, help="a checkout whose kernel 5 is timed as `parent`")
    ap.add_argument("--variants", default=",".join(n for n in VARIANTS if n != "parent"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("topk_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from plotpointe_tpu_torch.ops import topk_kernel as tk

    names = [n for n in args.variants.split(",") if n != "kept"]
    names = ["kept"] + names + (["parent"] if args.parent and "parent" not in names else [])
    out = Path(args.out)
    cs.phase_device()
    make(out, names, Path(args.parent).resolve() if args.parent else None)
    print(json.dumps({"built_s": build(out, names)}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(17)
    catalog = torch.randn((cs.CATALOG, 128), generator=gen, device="cuda")
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        x = catalog.to(dt)
        for b in (1, 8, 64):
            q = torch.randn((b, 128), generator=gen, device="cuda").to(dt)
            cm = tk.chunk_max_plain(x, q)
            cid = torch.sort(torch.topk(cm, 40, dim=1)[1].to(torch.int32), dim=1)[0]
            cases.append((f"B={b} {str(dt)[6:]}", x, q, cm, cid))
    want = {}
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            use(out, name)
            for shape, x, q, cm, cid in cases:
                got = [tk.rescore(x, q, cid)]
                line = {"variant": name, "turn": turn, "shape": shape,
                        "rescore_ms": cs.device_ms(lambda: tk.rescore(x, q, cid), ("rescore",))}
                if name != "parent":  # an earlier tree has no select kernel
                    sc = got[0].flatten(1)
                    got += [tk.select_chunks(cm, 40, cs.CATALOG), *tk.select_items(sc, cid, 32)]
                    line["select_first_ms"] = cs.device_ms(lambda: tk.select_chunks(cm, 40, cs.CATALOG),
                                                           cs.SELECT_KERNELS)
                    line["select_final_ms"] = cs.device_ms(lambda: tk.select_items(sc, cid, 32),
                                                           cs.SELECT_KERNELS)
                ref = want.setdefault(shape, got)
                line["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, ref))
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
