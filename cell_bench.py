#!/usr/bin/env python3
"""Time the sweep engine's ``cell_update`` kernel of one or more source trees
on one CUDA card, each tree in its own process, in the order given.

    python3 cell_bench.py --src A --src B --src B --src A   # turns: A B B A
    python3 cell_bench.py --src A --profile                 # + warp waits
    python3 cell_bench.py --src A --sass out.sass           # + the SASS

For every tree (a directory holding ``repro_torch``, of this design or an
earlier one) the child process builds the kernels from that tree and
prints one JSON line:

  * ``fig2_ms``: one ``cell_update`` call at the fig2 sweep's first chunk
    (C=1440, N=20, T=4096, k_max=2, 15 service families, no sketch);
  * ``pct_ms`` / ``pct_nosketch_ms``: the 1M-arrival percentile run's first
    chunk (C=12, T=4096, 2048 bins) with and without the sketch, every
    launch of the sketch included.

Kernel times are CUDA-event means with the host queued ahead of the card
(``chip_smoke.cuda_ms``). ``chip_smoke.py`` prints the change's own
times and the sweeps' walls and idle shares (phases 3-4); this script
sets trees side by side in one call, a variant of a tree being a copy of
its package with an edit of ``cell_update.cu``. ``--profile`` also times
a copy of the first tree's kernel with ``PROFILE`` applied: each warp of
block 0 counts the clocks it spends waiting on the mbarriers and in all,
and prints them once a launch (the edits match the warp-specialised
design). A warp that hardly waits is the one that bounds the block.
``--sass PATH`` writes the first tree's ``cell_update`` library as
``cuobjdump -sass`` prints it to PATH and prints the card's SM clocks
(``nvidia-smi``), for reckoning the clocks of a step's dependent chain.
Needs CUDA; imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHUNK = 4096

# clocks each warp of block 0 spends waiting on mbarriers, and in all
PROFILE = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
    ("extern __shared__ __align__(16) unsigned char smem[];\n",
     "extern __shared__ __align__(16) unsigned char smem[];\n"
     "__shared__ unsigned long long prof_wait[32];\n"),
    ("  uint32_t done = 0;\n  while (!done) {",
     "  const long long t0 = clock64();\n  uint32_t done = 0;\n"
     "  while (!done) {"),
    ("        : \"r\"(smem_addr(bar)), \"r\"(parity)\n        : \"memory\");\n"
     "  }\n}",
     "        : \"r\"(smem_addr(bar)), \"r\"(parity)\n        : \"memory\");\n"
     "  }\n  if ((threadIdx.x & 31) == 0) prof_wait[threadIdx.x / 32] += "
     "clock64() - t0;\n}"),
    ("  __syncthreads();\n\n  if (warp == 0)\n",
     "  if (lane == 0) prof_wait[warp] = 0;\n  __syncthreads();\n"
     "  const long long p0 = clock64();\n  if (warp == 0)\n"),
    ("    hist_warp(a, b, lane);\n  __syncthreads();\n",
     "    hist_warp(a, b, lane);\n  if (blockIdx.x == 0 && lane == 0)\n"
     "    printf(\"prof T=%d G=%d TS=%d Q=%d bins=%d warp %d: %lld clocks, "
     "%llu waiting\\n\", a.T, L.G, L.TS, L.Q, a.n_bins, warp, "
     "clock64() - p0, prof_wait[warp]);\n  __syncthreads();\n"),
]


def measure(src: Path) -> dict:
    import torch

    sys.path.insert(0, str(src))
    from chip_smoke import cuda_ms
    from repro_torch.core import distributions as dists
    from repro_torch.core import queueing, threshold
    from repro_torch.core.scenario import Scenario
    from repro_torch.kernels import build
    from repro_torch.kernels.cell_update import ops as cell_ops
    from repro_torch.kernels.hist_sketch import ops as hist_ops

    build.build_all()
    dev = torch.device("cuda")
    fams = ([dists.pareto(a) for a in (6.0, 3.0, 2.5, 2.2, 2.05)]
            + [dists.weibull(k) for k in (2.0, 1.0, 0.7, 0.5, 0.4)]
            + [dists.two_point(p) for p in (0.1, 0.5, 0.8, 0.95, 0.99)])
    fig2_cfg = queueing.SimConfig(n_servers=20, n_arrivals=50_000)
    fig2_scn = Scenario.paper_default(tuple(fams), ks=(1, 2))
    p_rhos = (0.2, 0.3, 0.4)
    p_cfg = queueing.SimConfig(n_servers=20, n_arrivals=1_000_000)
    p_scn = Scenario.paper_default(dists.exponential(), ks=(1, 2))

    def chunk_call(seed, dist, n_rows, rhos, cfg, scn, n_bins, warmup):
        grid = queueing._engine_grid(n_rows, rhos, cfg, scn.variants(), dev)
        gaps, servers, services = queueing.make_sampler(
            seed, dist, cfg, 2, 2, device=dev)(0, CHUNK)
        cum, warm, valid, services = queueing._chunk_inputs(
            gaps, services, 0, CHUNK, warmup)
        carry = queueing._init_cell_state(grid.plan, cfg, n_bins,
                                          n_bins > 0)
        args = (*carry, cum, warm, valid, servers, services,
                *grid.cell_args())
        return lambda: cell_ops.cell_update(*args, n_bins=n_bins, block=512,
                                            kernel="on", **grid.flags())

    fig2 = chunk_call(1, fams, len(fams) * 2, threshold.default_rhos(),
                      fig2_cfg, fig2_scn, 0, int(0.1 * fig2_cfg.n_arrivals))
    pct = chunk_call(100, [dists.exponential()], 2, p_rhos, p_cfg, p_scn,
                     hist_ops.DEFAULT_BINS, 0)
    pct0 = chunk_call(100, [dists.exponential()], 2, p_rhos, p_cfg, p_scn,
                      0, 0)
    out = {"src": str(src)}
    for _ in range(2):  # warm-up, then the turns kept
        out.update(fig2_ms=cuda_ms(fig2, 5, "fig2 chunk"),
                   pct_ms=cuda_ms(pct, 5, "percentile chunk"),
                   pct_nosketch_ms=cuda_ms(pct0, 5, "percentile chunk, "
                                           "no sketch"))
    return out


def variant_tree(src: Path, name: str, edits) -> Path:
    """A copy of ``src``'s package with ``edits`` applied to its
    ``cell_update.cu``, under the git-ignored build directory, with the
    other sources' libraries copied over; raises where an edit's text is
    not found once."""
    tree = ROOT / "src" / "repro_torch" / "build" / "variants" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(src / "repro_torch", tree / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    built = src / "repro_torch" / "build"
    if built.is_dir():
        shutil.copytree(built, tree / "repro_torch" / "build",
                        ignore=shutil.ignore_patterns("variants", "faults"))
    cu = tree / "repro_torch" / "csrc" / "cell_update.cu"
    text = cu.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not found once in {cu}")
        text = text.replace(old, new)
    cu.write_text(text)
    return tree


def child(src: Path, profile: bool = False) -> dict:
    """One tree's record, from its own process; its other lines are
    printed (with ``profile``, the first of each warp and shape)."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--one", str(src)],
        capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{src}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    seen = set()
    for ln in lines[:-1]:
        key = ln.split(":")[0] if profile and ln.startswith("prof") else ln
        if key not in seen:
            seen.add(key)
            print(f"    {ln}", flush=True)
    return json.loads(lines[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="a directory holding repro_torch (repeatable; the "
                         "trees run in the order given)")
    ap.add_argument("--profile", action="store_true",
                    help="also the first tree's PROFILE variant")
    ap.add_argument("--sass", metavar="PATH",
                    help="also write the first tree's cell_update SASS to "
                         "PATH and print the card's SM clocks")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cell_bench: CUDA is not available", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(measure(Path(args.one).resolve())), flush=True)
        return 0
    from chip_smoke import gpu_line
    print(gpu_line(), flush=True)
    srcs = [Path(s).resolve() for s in args.src] or [ROOT / "src"]
    results = []
    for src in srcs:
        rec = child(src)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if args.profile:
        tree = variant_tree(srcs[0], "profile", PROFILE)
        rec = dict(child(tree, profile=True), variant="profile")
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if args.sass:
        sys.path.insert(0, str(srcs[0]))
        from repro_torch.kernels import build
        cuobjdump = Path(build.nvcc_path()).resolve().parent / "cuobjdump"
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(build.library_path("cell_update"))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        out = Path(args.sass)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(sass)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(f"SASS: {out} ({len(sass.splitlines())} lines); SM clocks "
              f"now, max: {clocks}", flush=True)
    print(json.dumps({"cell_bench": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
