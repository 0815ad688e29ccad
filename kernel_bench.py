#!/usr/bin/env python3
"""Time the hand-written kernels of one or more source trees on one CUDA
card, each tree in its own process, in the order given.

    python3 kernel_bench.py --src A --src B --src B --src A   # turns: A B B A
    python3 kernel_bench.py --kernel rglru_scan --src A --src B
    python3 kernel_bench.py --kernel hist_accum --src A --src B --src B --src A
    python3 kernel_bench.py --kernel cell_update --src A --profile
    python3 kernel_bench.py --kernel cell_update --src A --sass DIR

For every tree (a directory holding ``repro_torch``, of this design or an
earlier one; a variant of a tree is a copy of its package with a kernel
source edited) the child process builds the kernels it launches from that
tree and prints one JSON line. Per kernel (``--kernel``, repeatable; all
four by default) and shape:

  * ``cell_update``: ``fig2``, one call at the fig2 sweep's first chunk
    (C=1440, N=20, T=4096, k_max=2, 15 service families, no sketch);
    ``pct`` / ``pct_nosketch``, the 1M-arrival percentile run's first
    chunk (C=12, T=4096, 2048 bins) with and without the sketch, every
    launch of the sketch included;
  * ``hist_accum``: ``pct`` and ``wide``, binned responses at the
    percentile chunk (T=4096, C=12, 2048 bins) and at (4096, 1440), added
    into a histogram allocated ahead, and ``_one_bin``, every entry in one
    bin (the most contended input); beside each, ``_empty`` (an empty
    kernel on the same plan's grid, clusters and shared memory, where the
    tree has one: the launch's floor), ``_index_put`` (the plain version's
    one ``index_put_(..., accumulate=True)`` on indices prepared ahead)
    and ``_bincount`` (``torch.bincount``, which waits on the host);
  * ``ssd_scan``: ``16_chunks``, mamba2-370m's prefill of 4096 tokens (16
    chunks of Q=256, H=32, P=64, N=128, inputs as the model makes them);
    ``1_chunk``, one padded chunk of 16 valid rows (a served prompt);
  * ``rglru_scan``: ``L4096``, ``L16``, ``L64``, ``L2560``, at (1, L, 4096):
    ``chip_smoke.py``'s table shape, a served prompt, one time tile and
    recurrentgemma-9b's prefill in phase 12.

Each shape gives ``ms``, the CUDA-event mean with the host queued ahead of
the card (``chip_smoke.cuda_ms``): the card's time per call, the gaps
between launches included; and ``kernel_ms``, the device's busy time per
call in a ``torch.profiler`` trace of the same calls (``chip_smoke.traced``):
the kernels' own run time. ``ms - kernel_ms`` is what a launch costs the
card between kernels.

``--profile`` also times a copy of the first tree's ``cell_update`` with
``PROFILE`` planted (``chip_smoke.planted_tree``): each warp of block 0
counts the clocks it spends waiting on the mbarriers and in all, and
prints them once a launch (the edits match the warp-specialised design).
A warp that hardly waits is the one that bounds the block.
``--sass DIR`` writes the first tree's library of each kernel as
``cuobjdump -sass`` prints it to ``DIR/<kernel>.sass`` and prints the
card's SM clocks (``nvidia-smi``), for reckoning a step's dependent chain.
``chip_smoke.py`` prints the change's own times, gates and bounds; this
script sets trees side by side in one call. Needs CUDA; imports nothing of
JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = ("cell_update", "hist_accum", "ssd_scan", "rglru_scan")

# clocks each warp of cell_update's block 0 spends waiting on mbarriers,
# and in all
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


def cell_update_calls(dev) -> dict:
    from chip_smoke import CHUNK
    from repro_torch.core import distributions as dists
    from repro_torch.core import queueing, threshold
    from repro_torch.core.scenario import Scenario
    from repro_torch.kernels.cell_update import ops as cell_ops
    from repro_torch.kernels.hist_sketch import ops as hist_ops

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

    return {
        "fig2": (chunk_call(1, fams, len(fams) * 2, threshold.default_rhos(),
                            fig2_cfg, fig2_scn, 0,
                            int(0.1 * fig2_cfg.n_arrivals)), 5),
        "pct": (chunk_call(100, [dists.exponential()], 2, p_rhos, p_cfg,
                           p_scn, hist_ops.DEFAULT_BINS, 0), 5),
        "pct_nosketch": (chunk_call(100, [dists.exponential()], 2, p_rhos,
                                    p_cfg, p_scn, 0, 0), 5)}


def hist_accum_calls(dev) -> dict:
    import numpy as np
    import torch

    from chip_smoke import CHUNK, hist_responses
    from repro_torch.kernels.hist_sketch import kernel as hist_kernel
    from repro_torch.kernels.hist_sketch import ops as hist_ops

    nb = hist_ops.DEFAULT_BINS
    rng = np.random.default_rng(7)
    calls = {}
    for name, c in (("pct", 12), ("wide", 1440)):
        idx = hist_responses(dev, CHUNK, c, nb, rng)
        out = torch.zeros((c, nb), dtype=torch.float32, device=dev)
        calls[name] = (lambda idx=idx, out=out: hist_kernel.hist_accum_cuda(
            idx, out), 50)
        same = torch.full_like(idx, nb // 3)  # every entry in one bin
        calls[f"{name}_one_bin"] = (
            lambda idx=same, out=out.clone(): hist_kernel.hist_accum_cuda(
                idx, out), 50)
        if hasattr(hist_kernel, "empty_launch"):
            calls[f"{name}_empty"] = (
                lambda idx=idx: hist_kernel.empty_launch(idx, nb), 50)
        live = idx >= 0
        cols = torch.arange(c, device=dev).expand(CHUNK, c)
        safe = idx.clamp(0, nb - 1).to(torch.int64)
        ones = live.to(torch.float32)
        lib_out = torch.zeros_like(out)
        calls[f"{name}_index_put"] = (
            lambda o=lib_out, i=(cols, safe), v=ones: o.index_put_(
                i, v, accumulate=True), 50)
        flat = (torch.arange(c, device=dev)[None, :] * nb
                + idx.clamp(max=nb - 1))[live]
        calls[f"{name}_bincount"] = (
            lambda flat=flat, n=c * nb: torch.bincount(flat, minlength=n),
            50)
    return calls


def ssd_scan_calls(dev) -> dict:
    from chip_smoke import ssd_inputs
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    calls = {}
    for name, n_chunks, valid in (("16_chunks", 16, None),
                                  ("1_chunk", 1, 16)):
        args = ssd_inputs(dev, n_chunks, True, valid, 99)
        calls[name] = (lambda args=args: ssd_ops.ssd_intra_chunk(
            *args, kernel="on"), 50)
    return calls


def rglru_scan_calls(dev) -> dict:
    import torch

    from chip_smoke import SCAN_W
    from repro_torch.kernels.rglru_scan import ops as scan_ops

    g = torch.Generator(dev).manual_seed(1)
    calls = {}
    for length in (4096, 16, 64, 2560):
        a = torch.rand((1, length, SCAN_W), generator=g, device=dev)
        b = torch.randn((1, length, SCAN_W), generator=g, device=dev)
        calls[f"L{length}"] = (lambda a=a, b=b: scan_ops.linear_scan(
            a, b, kernel="on"), 50)
    return calls


def measure(src: Path, kernels: list[str]) -> dict:
    import torch

    sys.path.insert(0, str(src))
    from chip_smoke import cuda_ms, traced

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    makers = {"cell_update": cell_update_calls,
              "hist_accum": hist_accum_calls, "ssd_scan": ssd_scan_calls,
              "rglru_scan": rglru_scan_calls}
    calls = {kernel: makers[kernel](dev) for kernel in kernels}
    out = {"src": str(src)}
    for _ in range(2):  # warm-up (and the builds), then the turn kept
        for kernel in kernels:
            out[kernel] = {name: {"ms": cuda_ms(fn, reps, f"{kernel} {name}")}
                           for name, (fn, reps) in calls[kernel].items()}
    # the traces last, so that no time above is taken under the profiler
    for kernel in kernels:
        for name, (fn, reps) in calls[kernel].items():
            def many(fn=fn, reps=reps):
                for _ in range(reps):
                    fn()
            busy = traced(many)["busy_s"]
            out[kernel][name]["kernel_ms"] = (None if busy is None
                                              else 1e3 * busy / reps)
    return out


def child(src: Path, kernels: list[str], profile: bool = False) -> dict:
    """One tree's record, from its own process; its other lines are
    printed (with ``profile``, the first of each warp and shape)."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--one", str(src),
         *(a for k in kernels for a in ("--kernel", k))],
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


def write_sass(src: Path, kernels: list[str], out_dir: Path) -> None:
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).resolve().parent / "cuobjdump"
    out_dir.mkdir(parents=True, exist_ok=True)
    for kernel in kernels:
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(build.library_path(kernel))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        out = out_dir / f"{kernel}.sass"
        out.write_text(sass)
        print(f"SASS: {out} ({len(sass.splitlines())} lines)", flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"SM clocks now, max: {clocks}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="a directory holding repro_torch (repeatable; the "
                         "trees run in the order given)")
    ap.add_argument("--kernel", action="append", choices=KERNELS,
                    help="a kernel to time (repeatable; default all)")
    ap.add_argument("--profile", action="store_true",
                    help="also the first tree's cell_update with PROFILE")
    ap.add_argument("--sass", metavar="DIR",
                    help="also write the first tree's libraries' SASS to "
                         "DIR and print the card's SM clocks")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kernels = args.kernel or list(KERNELS)
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: CUDA is not available", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(measure(Path(args.one).resolve(), kernels)),
              flush=True)
        return 0
    from chip_smoke import gpu_line, planted_tree
    print(gpu_line(), flush=True)
    srcs = [Path(s).resolve() for s in args.src] or [ROOT / "src"]
    results = []
    for src in srcs:
        rec = child(src, kernels)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if args.profile:
        tree = planted_tree("profile", "cell_update", PROFILE, srcs[0])
        rec = dict(child(tree, ["cell_update"], profile=True),
                   variant="profile")
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if args.sass:
        write_sass(srcs[0], kernels, Path(args.sass))
    print(json.dumps({"kernel_bench": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
