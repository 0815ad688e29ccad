#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
nonzero:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, started together) and print the card;
  2. hold the ``hist_accum`` kernel against its plain version: counts
     must be exactly equal;
  3. hold the ``cell_update`` kernel against its plain version on
     identical injected inputs, for every policy x service model, a
     degraded grid, the timed policies, a heterogeneous (``has_dists``)
     grid and ragged padded chunks, with and without the sketch:
     ``free``/``ssum``/``comp``/``cnt`` bit-equal, histograms exactly
     equal; then time both at the main path's chunk shape;
  4. the main path through the kernels: the Figure 2 threshold sweep
     (15 families, N=20, 24 loads, k in {1,2}, 2 seeds = 1,440 cells,
     50k arrivals, chunks of 4096) and a 1M-arrival percentile run of
     the paper's exponential model, checked against the closed forms,
     with the kernels' launch counts read around exactly that run; both
     runs again with the sampling pipeline on and off (summaries must be
     bit-equal; wall times printed) and once under ``torch.profiler``
     for the device's idle share; plus a small mixed grid run with the
     kernels and with the plain version, whose summaries must be
     bit-equal;
  5. hold the ``flash_attention`` kernel against its plain version at
     gemma2-2b's head shape (B=1, H=8, KV=4, hd=256, bf16, softcap 50) at
     S = 16, 300, 1000 and 4608, without a window and with windows of 16,
     128 and 4096, some with queries scaled so that the softmax is peaked
     and the outputs are of order 1: in every row (query position and
     head) the error is at most 2^-6 of the row's largest value, and with
     standard-normal inputs at most 2e-2 anywhere; time kernel, plain
     version and ``scaled_dot_product_attention`` (which has no softcap)
     at S = 4608;
  6. the same for ``decode_attention``: the served path's dense cache,
     a dense cache with a window and positions past ``pos``, a ring
     before and after it wraps, a dense cache of 4672 slots and a ring of
     4096 at pos = 5000; the device time of its two passes from a trace;
  7. gemma2-2b at full width and depth (26 layers, random weights from the
     port's own init on the card): a 4608-token prompt, longer than the
     window, then 16 teacher-forced decode steps. Once with every
     attention kernel call also run through its plain version on the same
     inputs (the row gate of phases 5-6 at every layer and step), then
     timed with the kernels, with their plain versions and with the plain
     versions in float32: the kernels' logits within twice the float32
     path's distance from the plain path (the model's bf16 noise floor)
     at every step; prefill and per-token decode times, the device's idle
     share during decode; the engine's greedy tokens equal
     repeated-prefill argmax;
  8. the LM main path through its user entry point:
     ``repro_torch.launch.serve.main`` serves 8 requests of gemma2-2b on
     2 hedged replicas (``--max-k 2``), with the attention kernels' launch
     counts read around exactly that run.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs CUDA and the repository's
``src/`` beside this script; imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): device memory rate, the
# float32 rate outside the tensor cores and the dense bf16 tensor-core
# rate, for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

ATTN_TOL = 2e-2    # bf16 tolerance of tests/test_kernels.py, anywhere
ATTN_REL = 2**-6   # per row, of the row's largest |value|: two bf16 ulps
ATTN_ATOL = 1e-6
PROMPT = 4608      # prefill past gemma2-2b's window of 4096
DECODE_STEPS = 16
MAX_LEN = 4672     # dense (global-layer) cache: prompt + steps, rounded up

FIG2_LOADS = 24
CHUNK = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_SLEEP_CYCLES_PER_MS: list[float] = []


def cuda_ms(fn, reps: int, label: str) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls. A sleep
    kernel holds the card while the host queues the calls behind it, so
    the CUDA events around them time the card's work, not the host's pace
    of launching. Where the host could not queue all of them before the
    sleep ended (the start event had fired), the time is the host's pace
    and a line says so."""
    import torch
    if not _SLEEP_CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10**7)
        b.record()
        b.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / a.elapsed_time(b))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_ms + 1, 200) * _SLEEP_CYCLES_PER_MS[0]))
    start.record()
    for _ in range(reps):
        fn()
    host_ahead = not start.query()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    if not host_ahead:
        log(f"    ({label}: the host could not queue {reps} calls ahead of "
            f"the card; {ms} ms is the host's pace)")
    return ms


def traced(fn) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and read the device's
    share of the host window: the union of the device's kernel, copy and
    set intervals over the window from the call to the end of its
    synchronize. ``busy_s``/``idle_share`` are None when the profiler
    recorded no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    window = "chip_smoke.window"
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(window):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    win = next(e for e in events if e.name == window
               and e.device_type == DeviceType.CPU)
    w0, w1 = win.time_range.start, win.time_range.end
    # the window's own annotation is mirrored on the device's timeline
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.name != window]
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev_events)
    busy, end = 0.0, w0
    for a, b in spans:
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for e in dev_events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    wall = (w1 - w0) * 1e-6
    return {"wall_s": wall, "busy_s": busy * 1e-6 if spans else None,
            "idle_share": 1.0 - busy / (w1 - w0) if spans else None,
            "top_device_ms": {n[:60]: t * 1e-3 for n, t in top}}



def check_imports() -> None:
    if any(m in ("jax", "repro") or m.startswith(("jax.", "repro."))
           for m in sys.modules):
        raise RuntimeError("the port imported JAX or the JAX package")


def row_err(got, want) -> tuple[float, float]:
    """(max abs error, largest ratio of a row's max abs error to its
    allowance ``ATTN_REL * max|want row| + ATTN_ATOL``) of an attention
    output (..., hd) against its plain version; a row is one query
    position and head."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    allow = ATTN_REL * w.abs().amax(-1) + ATTN_ATOL
    return float(err.max()), float((err / allow).max())


def check_attention(name: str, got, want, absolute: bool) -> float:
    """Raise unless ``got`` meets the row gate and, where ``absolute``
    (standard-normal inputs, as in tests/test_kernels.py), ``ATTN_TOL``
    anywhere; returns the max abs error. Peaked inputs give outputs up to
    ~4.5, where one bf16 ulp is 0.03125, so they take the row gate only."""
    err, ratio = row_err(got, want)
    if not ((err <= ATTN_TOL or not absolute) and ratio <= 1.0):
        raise AssertionError(f"{name} differs from its plain version: max "
                             f"abs err {err} (gate "
                             f"{ATTN_TOL if absolute else None}), worst row "
                             f"at {ratio} of 2^-6 of its largest value")
    return err


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(ms, "bytes" | "operations"): the least time for the work."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_kernels(dev) -> dict:
    """Phases 5 and 6: both attention kernels against their plain
    versions at gemma2-2b's head shape; times at the main path's shapes.
    Returns the kernels' records (without launches)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, h, kv, hd, cap, window = 1, 8, 4, 256, 50.0, 4096
    rng = np.random.default_rng(13)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    # ---------------------------------------------------------------- 5
    # (S, window, query scale, timed): a query scale of 8 makes the
    # softmax peaked, so the outputs are of order 1
    fa_err, fa = 0.0, {}
    for s, w, qs, timed in ((16, None, 1, False), (300, 16, 1, False),
                            (300, 16, 8, False), (1000, 128, 1, False),
                            (1000, 128, 8, False), (1000, None, 1, False),
                            (PROMPT, None, 1, True),
                            (PROMPT, window, 1, True),
                            (PROMPT, window, 8, False)):
        q, k, v = qs * bf16(b, s, h, hd), bf16(b, s, kv, hd), \
            bf16(b, s, kv, hd)
        got = fa_ops.flash_attention(q, k, v, window=w, softcap=cap,
                                     kernel="on")
        want = fa_ops.flash_attention(q, k, v, window=w, softcap=cap,
                                      kernel="off")
        err = check_attention(f"flash_attention S={s} window={w}", got,
                              want, absolute=qs == 1)
        if qs == 1:  # the record's error: the 2e-2-gated cases
            fa_err = max(fa_err, err)
        log(f"[5] flash_attention S={s} window={w} softcap={cap} query "
            f"scale {qs}: max abs err vs plain {err} (largest |out| "
            f"{float(want.float().abs().max())}, worst row at "
            f"{row_err(got, want)[1]} of its allowance)")
        if not timed:
            continue
        i = torch.arange(s, device=dev)
        live = i[None, :] <= i[:, None]
        if w is not None:
            live &= i[None, :] > i[:, None] - w
        pairs = int(live.sum())
        ms = cuda_ms(lambda: fa_ops.flash_attention(
            q, k, v, window=w, softcap=cap, kernel="on"), 10,
            "flash_attention")
        plain = cuda_ms(lambda: fa_ops.flash_attention(
            q, k, v, window=w, softcap=cap, kernel="off"), 3,
            "flash_attention plain")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = (dict(is_causal=True) if w is None
                else dict(attn_mask=live))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa), 10, "sdpa")
        n_bytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
        bms, by = bound(n_bytes, 4 * hd * h * b * pairs, BF16_OPS_PER_S)
        fa[w] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                     bound_by=by)
        log(f"[5] flash_attention S={s} window={w}: kernel {ms} ms, plain "
            f"{plain} ms, scaled_dot_product_attention (no softcap) {lib} "
            f"ms, bound {bms} ms ({by}; {pairs} live pairs)")

    # ---------------------------------------------------------------- 6
    da_err, da = 0.0, {}
    last = PROMPT + DECODE_STEPS - 1
    # (case, cache length, pos, window, query scale, timed): the served
    # path's dense cache (max_len 128, a 16-token prompt and 8 new
    # tokens); a dense cache holding positions past ``pos`` under a
    # window; a ring before and after it wraps; the long run's dense
    # cache and its wrapped ring
    for case, length, pos, w, qs, timed in (
            ("dense", 128, 23, None, 1, False),
            ("filled", 512, 300, 64, 1, False),
            ("ring", 64, 40, 64, 1, False),
            ("ring", 64, 1000, 64, 1, False),
            ("dense", MAX_LEN, last, None, 1, True),
            ("dense", MAX_LEN, last, None, 8, False),
            ("ring", window, 5000, window, 1, True)):
        q, k, v = qs * bf16(b, 1, h, hd), bf16(b, length, kv, hd), \
            bf16(b, length, kv, hd)
        s = np.arange(length)
        slots = {"dense": np.where(s <= pos, s, -1), "filled": s,
                 "ring": pos - (pos - s) % length}[case]
        slots = torch.from_numpy(slots.astype(np.int32)).to(dev)
        got = da_ops.decode_attention(q, k, v, slots, pos, window=w,
                                      softcap=cap, kernel="on")
        want = da_ops.decode_attention(q, k, v, slots, pos, window=w,
                                       softcap=cap, kernel="off")
        err = check_attention(f"decode_attention {case} L={length} "
                              f"pos={pos}", got, want, absolute=qs == 1)
        if qs == 1:  # the record's error: the 2e-2-gated cases
            da_err = max(da_err, err)
        valid = (slots >= 0) & (slots <= pos)
        if w is not None:
            valid &= slots > pos - w
        n_live = int(valid.sum())
        log(f"[6] decode_attention {case} L={length} pos={pos} window={w} "
            f"query scale {qs} ({n_live} live slots): max abs err vs plain "
            f"{err} (largest |out| {float(want.float().abs().max())}, "
            f"worst row at {row_err(got, want)[1]} of its allowance)")
        if not timed:
            continue

        def call(kernel):
            return da_ops.decode_attention(q, k, v, slots, pos, window=w,
                                           softcap=cap, kernel=kernel)

        ms = cuda_ms(lambda: call("on"), 50, "decode_attention")
        plain = cuda_ms(lambda: call("off"), 20, "decode_attention plain")
        mask = valid[None, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 50, "sdpa")
        n_bytes = 2 * 2 * n_live * b * kv * hd
        bms, by = bound(n_bytes, 4 * hd * h * b * n_live, BF16_OPS_PER_S)
        da[case] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                        bound_by=by)
        tr = traced(lambda: [call("on") for _ in range(50)])
        per_call = {n: t / 50 for n, t in tr["top_device_ms"].items()}
        log(f"[6] decode_attention {case} L={length} pos={pos}: kernel {ms} "
            f"ms, plain {plain} ms, scaled_dot_product_attention (no "
            f"softcap) {lib} ms, bound {bms} ms ({by}); device ms per call "
            f"by kernel (trace of 50 calls) {json.dumps(per_call)}")
    return {"flash_attention": dict(fa[None], max_abs_err=fa_err),
            "decode_attention": dict(da["dense"], max_abs_err=da_err)}


@contextlib.contextmanager
def float32_attention():
    """The attention ops' plain versions run in float32 (bf16 inputs
    widened, the output rounded back to bf16): the same function with the
    probabilities kept in float32, as the TPU kernels keep them. Its
    distance from the bf16 plain path is the model's own bf16 noise floor,
    the yardstick of phase 7's gate."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fa_ref, da_ref = fa_ops.flash_attention_ref, da_ops.decode_attention_ref

    def fa32(q, k, v, **kw):
        return fa_ref(q.float(), k.float(), v.float(), **kw).to(q.dtype)

    def da32(q, k, v, slot_pos, pos, **kw):
        return da_ref(q.float(), k.float(), v.float(), slot_pos, pos,
                      **kw).to(q.dtype)

    fa_ops.flash_attention_ref, da_ops.decode_attention_ref = fa32, da32
    try:
        yield
    finally:
        fa_ops.flash_attention_ref, da_ops.decode_attention_ref = fa_ref, \
            da_ref


@contextlib.contextmanager
def checked_against_plain(worst: dict):
    """Every attention op called with ``kernel="on"`` inside also runs
    its plain version on the same inputs; ``worst[name]`` collects
    (calls, max abs error, worst row's share of its allowance) for
    ``check_attention``'s gates. The kernel's output is what the model
    gets."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fa, da = fa_ops.flash_attention, da_ops.decode_attention

    def wrap(name, op):
        def call(*args, kernel="auto", **kw):
            out = op(*args, kernel=kernel, **kw)
            if kernel == "on":
                err, ratio = row_err(out, op(*args, kernel="off", **kw))
                n, e0, r0 = worst.get(name, (0, 0.0, 0.0))
                worst[name] = (n + 1, max(e0, err), max(r0, ratio))
            return out
        return call

    fa_ops.flash_attention = wrap("flash_attention", fa)
    da_ops.decode_attention = wrap("decode_attention", da)
    try:
        yield
    finally:
        fa_ops.flash_attention, da_ops.decode_attention = fa, da


def lm_full(dev) -> None:
    """Phase 7: gemma2-2b at full width and depth, kernels vs plain. Runs
    every check before it raises, listing each that failed."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode, lm
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    model = lm.init(torch.Generator(dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[7] gemma2-2b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {n_params} parameters "
        f"(param_count {cfg.param_count}), init {time.perf_counter() - t0}s")
    rng = np.random.default_rng(17)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, PROMPT + DECODE_STEPS))).to(dev)
    runs, worst, failed = {}, {}, []
    for mode in ("checked", "on", "off", "off32", "on"):
        kernel = "off" if mode.startswith("off") else "on"

        def ctx():
            return {"off32": float32_attention(),
                    "checked": checked_against_plain(worst)}.get(
                        mode, contextlib.nullcontext())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx():
            logits, cache = decode.prefill(model, toks[:, :PROMPT], MAX_LEN,
                                           kernel=kernel)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        steps = [logits]
        t0 = time.perf_counter()
        with ctx():
            for i in range(DECODE_STEPS):
                logits, cache = decode.decode_step(
                    model, cache, toks[:, PROMPT + i:PROMPT + i + 1],
                    PROMPT + i, kernel=kernel)
                steps.append(logits)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / DECODE_STEPS
        runs[mode] = torch.stack(steps)[:, 0]
        log(f"[7] {mode}: prefill of {PROMPT} tokens {t_pre * 1e3} "
            f"ms, decode {t_dec * 1e3} ms per token ({DECODE_STEPS} steps)")
    for name in ("flash_attention", "decode_attention"):
        n, err, ratio = worst.get(name, (0, 0.0, 0.0))
        log(f"[7] {name} at every layer and step of the kernel run ({n} "
            f"calls), against its plain version on the same inputs: max abs "
            f"err {err}, worst row at {ratio} of its allowance")
        if n == 0 or not ratio <= 1.0:
            failed.append(f"{name} over the model: {n} calls, worst row at "
                          f"{ratio} of 2^-6 of its largest value")
    on, off, off32 = runs["on"], runs["off"], runs["off32"]
    if tuple(on.shape) != (DECODE_STEPS + 1, cfg.vocab_size) or \
            not all(bool(torch.isfinite(x).all()) for x in runs.values()):
        raise AssertionError(f"logits of shape {tuple(on.shape)} or not "
                             f"finite")
    diffs = (on - off).abs().amax(dim=-1).tolist()
    floor = (off32 - off).abs().amax(dim=-1).tolist()
    # the kernels may differ from the plain path by no more than twice the
    # plain path's own bf16 noise floor (the rule of tests/test_torch_lm.py)
    bound_ = 2 * max(floor)
    log(f"[7] max abs logit difference, prefill then each decode step: "
        f"kernels vs plain {json.dumps(diffs)}; plain in float32 vs plain "
        f"{json.dumps(floor)}; bound 2 x {max(floor)} = {bound_}; largest "
        f"|logit| {float(on.abs().max())}, final softcap "
        f"{cfg.final_softcap}; kernels vs plain in float32 "
        f"{json.dumps((on - off32).abs().amax(dim=-1).tolist())}")
    if max(diffs) > bound_:
        failed.append(f"kernels' and plain path's logits differ by "
                      f"{max(diffs)} > {bound_}")
    for name, x in (("kernels", on), ("float32 plain", off32)):
        agree = float((x.argmax(-1) == off.argmax(-1)).float().mean())
        log(f"[7] greedy tokens of the {name} path agree with the plain "
            f"path's at {agree} of the {DECODE_STEPS + 1} positions")

    _, cache = decode.prefill(model, toks[:, :PROMPT], MAX_LEN)

    def decode_run():
        c = cache
        for i in range(DECODE_STEPS):
            _, c = decode.decode_step(
                model, c, toks[:, PROMPT + i:PROMPT + i + 1], PROMPT + i)

    tr = traced(decode_run)
    log(f"[7] trace of {DECODE_STEPS} decode steps (kernels): "
        f"{json.dumps(tr)}")

    eng = InferenceEngine(cfg, model, max_len=128, name="check", device=dev)
    prompt = rng.integers(0, cfg.vocab_size, 16)
    out = eng.generate(prompt, max_new_tokens=4)
    cur = list(prompt)
    for i in range(4):
        logits, _ = decode.prefill(model, torch.tensor([cur], device=dev),
                                   128)
        nxt = int(logits.argmax(-1)[0])
        if nxt != int(out[i]):
            failed.append(f"engine token {i} is {out[i]}, repeated "
                          f"prefill gives {nxt}")
            break
        cur.append(nxt)
    log(f"[7] engine greedy tokens {out.tolist()}, repeated-prefill argmax "
        f"{cur[len(prompt):]}")
    if failed:
        raise AssertionError("phase 7: " + "; ".join(failed))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from repro_torch import interop
    from repro_torch.core import analytic, queueing, threshold
    from repro_torch.core import distributions as dists
    from repro_torch.core.scenario import (CANCEL_ON_COMPLETE, Degradation,
                                           HEDGE_AFTER_DELAY,
                                           REPLICATE_TO_IDLE,
                                           SERVER_DEPENDENT, TIMEOUT_RETRY,
                                           Scenario)
    from repro_torch.kernels import build
    from repro_torch.kernels.cell_update import kernel as cell_kernel
    from repro_torch.kernels.cell_update import ops as cell_ops
    from repro_torch.kernels.hist_sketch import kernel as hist_kernel
    from repro_torch.kernels.hist_sketch import ops as hist_ops

    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import serve

    check_imports()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind}")
    t_all = time.perf_counter()

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[1] build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}"
        f" wall {time.perf_counter() - t0:.2f}s (nvcc flags: "
        f"{' '.join(build.NVCC_FLAGS)})")
    for name in build.SOURCES:
        if build.build_log(name).exists():
            for ln in build.build_log(name).read_text().splitlines():
                if "registers" in ln or "bytes stack" in ln:
                    log(f"[1] ptxas {name}: {ln.strip()}")
    card = gpu_line()
    log(f"[1] gpu: {card}")

    # ---------------------------------------------------------------- 2
    errs = {"cell_update": 0.0, "hist_accum": 0.0}
    rng = np.random.default_rng(7)
    for n_bins in (100, 256, 2048):
        for t, c in ((4096, 16), (4096, 1440), (777, 37)):
            idx = torch.from_numpy(rng.integers(
                -1, n_bins, (t, c)).astype(np.int32)).to(dev)
            got = hist_ops.hist_accum(idx, n_bins=n_bins, kernel="on")
            want = hist_ops.hist_accum(idx, n_bins=n_bins, kernel="off")
            err = float((got - want).abs().max())
            errs["hist_accum"] = max(errs["hist_accum"], err)
            if err != 0.0:
                raise AssertionError(f"hist_accum differs: n_bins={n_bins} "
                                     f"T={t} C={c} max|diff|={err}")
    log(f"[2] hist_accum kernel == plain (exact counts) for n_bins "
        f"100/256/2048 at (T,C) (4096,16) (4096,1440) (777,37)")

    # ---------------------------------------------------------------- 3
    def on_card(args):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in args.items()}

    def call(args, static, kernel):
        return cell_ops.cell_update(
            *(args[k] for k in interop.CELL_UPDATE_ARGS), block=512,
            kernel=kernel, **static)

    arms = dict(interop.CELL_UPDATE_ARMS, generic_mix=dict(
        k_max=3, policies=(0, 1, 2, 3, 4), models=(0, 1), mix=0.6,
        delay=0.7))
    for name, kw in arms.items():
        args, static = interop.synthetic_chunk(
            11, n_cells=160, n_seeds=4, n_servers=20, steps=2048, **kw)
        args = on_card(args)
        got = call(args, static, "on")
        want = call(args, static, "off")
        torch.cuda.synchronize()
        flips = 0
        for field, g, w in zip(("free", "ssum", "comp", "cnt", "hist"),
                               got, want):
            err = float((g - w).abs().max()) if g.numel() else 0.0
            errs["cell_update"] = max(errs["cell_update"], err)
            if field == "hist":
                flips = int((g != w).sum())
                if flips:
                    raise AssertionError(f"{name}: {flips} histogram bins "
                                         f"differ (bound 0)")
            elif not torch.equal(g, w):
                raise AssertionError(f"{name}: {field} not bit-equal "
                                     f"(max|diff|={err})")
        log(f"[3] cell_update kernel == plain bit for bit: {name} "
            f"({json.dumps(kw)}), histogram flips {flips}")

    # timing at the main path's chunk shapes: the fig2 sweep's first
    # chunk, sampled and laid out by the engine itself
    fams = ([dists.pareto(a) for a in (6.0, 3.0, 2.5, 2.2, 2.05)]
            + [dists.weibull(k) for k in (2.0, 1.0, 0.7, 0.5, 0.4)]
            + [dists.two_point(p) for p in (0.1, 0.5, 0.8, 0.95, 0.99)])
    fig2_cfg = queueing.SimConfig(n_servers=20, n_arrivals=50_000)
    fig2_scn = Scenario.paper_default(tuple(fams), ks=(1, 2))
    n_rows = len(fams) * 2
    grid = queueing._engine_grid(n_rows, threshold.default_rhos(), fig2_cfg,
                                 fig2_scn.variants(), dev)
    sampler = queueing.make_sampler(1, fams, fig2_cfg, 2, 2, device=dev)
    gaps, servers, services = sampler(0, CHUNK)
    cum, warm, valid, services = queueing._chunk_inputs(
        gaps, services, 0, CHUNK, int(0.1 * fig2_cfg.n_arrivals))
    carry = queueing._init_cell_state(grid.plan, fig2_cfg, 0, False)
    fig2_args = (*carry, cum, warm, valid, servers, services,
                 *grid.cell_args())

    def fig2_chunk(kernel):
        return cell_ops.cell_update(*fig2_args, n_bins=0, block=512,
                                    kernel=kernel, **grid.flags())

    ms_cell = cuda_ms(lambda: fig2_chunk("on"), 5, "cell_update")
    plain_cell = cuda_ms(lambda: fig2_chunk("off"), 1,
                         "cell_update plain")
    got, want = fig2_chunk("on"), fig2_chunk("off")
    for field, g, w in zip(("free", "ssum", "comp", "cnt"), got, want):
        errs["cell_update"] = max(errs["cell_update"],
                                  float((g - w).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"fig2 chunk: {field} not bit-equal")
    C, T, k = grid.plan.n_padded, CHUNK, 2
    S = n_rows
    # bytes: carry in and out, 12 per-cell parameters, cum / warm / valid,
    # servers and services, each read once; operations: the division,
    # four per copy (max, add, min, select), Kahan and count (8 in all)
    cell_bytes = 4 * (2 * C * 20 + 6 * C + 12 * C + S * T + 2 * T
                      + S * T * k + S * T * k)
    cell_ops_n = C * T * (8 + 4 * k)
    cell_bound = 1e3 * max(cell_bytes / HBM_BYTES_PER_S,
                           cell_ops_n / F32_OPS_PER_S)
    cell_by = ("bytes" if cell_bytes / HBM_BYTES_PER_S
               >= cell_ops_n / F32_OPS_PER_S else "operations")
    log(f"[3] cell_update at the fig2 chunk (C={C}, N=20, T={T}, k_max=2, "
        f"no sketch; kernel == plain bit for bit): kernel {ms_cell:.4f} ms, "
        f"plain {plain_cell:.1f} ms, bound {cell_bound:.5f} ms ({cell_by})")

    # the percentile run's chunk: 12 cells, with the sketch
    p_rhos = (0.2, 0.3, 0.4)
    p_cfg = queueing.SimConfig(n_servers=20, n_arrivals=1_000_000)
    p_scn = Scenario.paper_default(dists.exponential(), ks=(1, 2))
    nb = hist_ops.DEFAULT_BINS
    pgrid = queueing._engine_grid(2, p_rhos, p_cfg, p_scn.variants(), dev)
    gaps, servers, services = queueing.make_sampler(
        100, [dists.exponential()], p_cfg, 2, 2, device=dev)(0, CHUNK)
    cum, warm, valid, services = queueing._chunk_inputs(
        gaps, services, 0, CHUNK, 0)
    pcarry = queueing._init_cell_state(pgrid.plan, p_cfg, nb, True)
    p_args = (*pcarry, cum, warm, valid, servers, services,
              *pgrid.cell_args())

    def p_chunk(kernel):
        return cell_ops.cell_update(*p_args, n_bins=nb, block=512,
                                    kernel=kernel, **pgrid.flags())

    ms_pcell = cuda_ms(lambda: p_chunk("on"), 5, "cell_update + hist")
    for field, g, w in zip(("free", "ssum", "comp", "cnt", "hist"),
                           p_chunk("on"), p_chunk("off")):
        if not torch.equal(g, w):
            raise AssertionError(f"percentile chunk: {field} not bit-equal")
    log(f"[3] cell_update + hist_accum at the percentile run's chunk "
        f"(C=12, N=20, T={CHUNK}, 2048 bins; kernel == plain bit for bit): "
        f"{ms_pcell:.4f} ms")
    hc = pgrid.plan.n_padded
    # bin indices of M/M/1-like responses (mean 2), a tenth skipped
    resp = torch.from_numpy(rng.exponential(2.0, (CHUNK, hc)).astype(
        np.float32)).to(dev)
    keep = torch.from_numpy((rng.random((CHUNK, hc)) > 0.1).astype(
        np.float32)).to(dev)
    idx = hist_ops.bin_indices(resp, keep, n_bins=nb)
    ms_hist = cuda_ms(lambda: hist_ops.hist_accum(idx, n_bins=nb,
                                                  kernel="on"), 20,
                      "hist_accum")
    plain_hist = cuda_ms(lambda: hist_ops.hist_accum(idx, n_bins=nb,
                                                     kernel="off"), 20,
                         "hist_accum plain")
    live = idx >= 0
    flat = (torch.arange(hc, device=dev)[None, :] * nb + idx)[live]
    lib_hist = cuda_ms(lambda: torch.bincount(flat, minlength=hc * nb), 20,
                       "bincount")
    hist_bytes = 4 * (CHUNK * hc + 2 * hc * nb)
    hist_ops_n = int(live.sum())
    hist_bound = 1e3 * max(hist_bytes / HBM_BYTES_PER_S,
                           hist_ops_n / F32_OPS_PER_S)
    hist_by = ("bytes" if hist_bytes / HBM_BYTES_PER_S
               >= hist_ops_n / F32_OPS_PER_S else "operations")
    log(f"[3] hist_accum at the percentile run's chunk (T={CHUNK}, C={hc}, "
        f"n_bins={nb}): kernel {ms_hist:.4f} ms, plain {plain_hist:.4f} ms, "
        f"torch.bincount {lib_hist:.4f} ms, bound {hist_bound:.5f} ms "
        f"({hist_by})")

    # ---------------------------------------------------------------- 4
    cell_kernel.cell_update_cuda.launches = 0
    hist_kernel.hist_accum_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ths = threshold.threshold_grid_batch(1, fams, fig2_cfg, n_seeds=2,
                                         chunk_size=CHUNK, device="cuda")
    th_exp = threshold.threshold_grid(2, dists.exponential(), fig2_cfg,
                                      n_seeds=2, chunk_size=CHUNK,
                                      device="cuda")
    torch.cuda.synchronize()
    t_fig2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = queueing.run(100, Scenario.paper_default(dists.exponential()),
                       p_rhos, p_cfg, n_seeds=2,
                       percentiles=(50.0, 99.0, 99.9), chunk_size=CHUNK,
                       device="cuda")
    torch.cuda.synchronize()
    t_pct = time.perf_counter() - t0
    launches = {"cell_update": cell_kernel.cell_update_cuda.launches,
                "hist_accum": hist_kernel.hist_accum_cuda.launches}
    log(f"[4] fig2 sweep (1440 cells x 50k arrivals) + exponential sweep "
        f"(96 cells): {t_fig2}s wall; "
        f"1M-arrival percentile run (12 cells): {t_pct}s wall; kernel "
        f"launches {json.dumps(launches)}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    names = ([f"pareto(a={a:g})" for a in (6.0, 3.0, 2.5, 2.2, 2.05)]
             + [f"weibull(k={k:g})" for k in (2.0, 1.0, 0.7, 0.5, 0.4)]
             + [f"two_point(p={p:g})" for p in (0.1, 0.5, 0.8, 0.95, 0.99)])
    log("[4] fig2 thresholds: " + json.dumps(
        {n: round(t, 4) for n, t in zip(names, ths)}))
    if not all(math.isfinite(t) and 0.0 < t <= 0.5 for t in ths):
        raise AssertionError(f"threshold outside (0, 0.5]: {ths}")
    # Theorem 1: 1/3 for exponential service — the exponential sweep
    # (96 cells, same shape) and fig2's weibull(k=1), the same law
    th_w1 = ths[names.index("weibull(k=1)")]
    log(f"[4] exponential threshold {th_exp:.4f}, weibull(k=1) {th_w1:.4f} "
        f"(Theorem 1: {analytic.exponential_threshold():.4f})")
    for th in (th_exp, th_w1):
        if abs(th - analytic.exponential_threshold()) > 0.03:
            raise AssertionError(f"exponential threshold {th} is not within "
                                 f"0.03 of 1/3")
    for key in ("mean", "p50", "p99", "p99.9"):
        v = out[key]
        if tuple(v.shape) != (2, len(p_rhos), 2) or \
                not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{key}: shape {tuple(v.shape)} or "
                                 f"non-finite values")
    mean1 = out["mean"][:, :, 0].mean(0).cpu().numpy()
    p99_1 = out["p99"][:, :, 0].mean(0).cpu().numpy()
    mean2 = out["mean"][:, :, 1].mean(0).cpu().numpy()
    for i, rho in enumerate(p_rhos):
        mm1, q99 = float(analytic.mm1_mean(rho)), math.log(100) / (1 - rho)
        two = float(analytic.mm1_replicated_mean(rho, 2))
        log(f"[4] rho={rho}: k=1 mean {mean1[i]:.4f} (M/M/1 {mm1:.4f}), "
            f"k=1 p99 {p99_1[i]:.4f} (M/M/1 {q99:.4f}), k=2 mean "
            f"{mean2[i]:.4f} (min-of-two M/M/1 {two:.4f})")
        if abs(mean1[i] / mm1 - 1) > 0.02:
            raise AssertionError(f"k=1 mean off M/M/1 by more than 2%")
        if abs(p99_1[i] / q99 - 1) > 0.05:
            raise AssertionError(f"k=1 p99 off M/M/1 by more than 5%")
    if not bool((out["p50"] < out["p99"]).all() & (out["p99"]
                                                   <= out["p99.9"]).all()):
        raise AssertionError("percentiles out of order")

    # the same two runs with the sampling pipeline on and off, in the
    # order on, off, off, on; summaries bit-equal, wall times per mode
    fig2_run = dict(n_seeds=2, percentiles=(), chunk_size=CHUNK,
                    device="cuda")

    def fig2_sweep(pipeline):
        return queueing.run(1, fig2_scn, threshold.default_rhos(), fig2_cfg,
                            pipeline=pipeline, **fig2_run)

    def pct_run(pipeline):
        return queueing.run(100, p_scn, p_rhos, p_cfg, n_seeds=2,
                            percentiles=(50.0, 99.0, 99.9), chunk_size=CHUNK,
                            pipeline=pipeline, device="cuda")

    for label, fn in (("fig2 sweep (1440 cells)", fig2_sweep),
                      ("1M-arrival run (12 cells)", pct_run)):
        walls: dict[str, list[float]] = {"on": [], "off": []}
        outs = {}
        for mode in ("on", "off", "off", "on"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[mode] = fn(mode)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
        for key, v in outs["on"].items():
            if isinstance(v, torch.Tensor) and \
                    not torch.equal(v, outs["off"][key]):
                raise AssertionError(f"{label}: pipeline on/off differ in "
                                     f"{key}")
        log(f"[4] pipeline {label}: on {json.dumps(walls['on'])} s, off "
            f"{json.dumps(walls['off'])} s (order on, off, off, on; "
            f"summaries bit-equal)")
        for mode in ("on", "off"):
            tr = traced(lambda: fn(mode))
            log(f"[4] trace {label}, pipeline {mode}: {json.dumps(tr)}")

    # a small mixed grid end to end: kernels vs plain version, bit-equal
    mixed = (Scenario.paper_default(dists.pareto(2.2), ks=(1, 2)),
             Scenario(dists=dists.pareto(2.2), policy=CANCEL_ON_COMPLETE,
                      ks=(2,)),
             Scenario(dists=dists.pareto(2.2), policy=REPLICATE_TO_IDLE,
                      service_model=SERVER_DEPENDENT, mix=0.4, ks=(3,)),
             Scenario(dists=dists.pareto(2.2), policy=HEDGE_AFTER_DELAY,
                      delay=0.5, ks=(2,),
                      degradation=Degradation(p_slow=0.05, slow_factor=5.0,
                                              p_fail=0.02)),
             Scenario(dists=dists.weibull(0.5), policy=TIMEOUT_RETRY,
                      delay=1.5, ks=(3,)))
    small = queueing.SimConfig(n_servers=20, n_arrivals=9_000)
    kw = dict(n_seeds=2, percentiles=(50.0, 99.0), chunk_size=CHUNK,
              device="cuda")
    a = queueing.run(5, mixed, (0.1, 0.3), small, kernel="on", **kw)
    b = queueing.run(5, mixed, (0.1, 0.3), small, kernel="off", **kw)
    for key in ("mean", "completed", "p50", "p99"):
        if not torch.equal(a[key], b[key]):
            raise AssertionError(f"mixed grid: {key} differs between the "
                                 f"kernels and the plain version")
    log("[4] mixed grid (5 policies, SD, degraded, 2 dists, 9k arrivals): "
        "kernels == plain version bit for bit in mean/completed/p50/p99")

    # ------------------------------------------------------------- 5, 6
    attn = attention_kernels(dev)

    # ---------------------------------------------------------------- 7
    lm_full(dev)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 8
    fa_kernel.flash_attention_cuda.launches = 0
    da_kernel.decode_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = serve.main(["--arch", "gemma2-2b", "--replicas", "2",
                         "--max-k", "2", "--requests", "8"])
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches.update(flash_attention=fa_kernel.flash_attention_cuda.launches,
                    decode_attention=da_kernel.decode_attention_cuda.launches)
    lat = served["latency_s"]
    log(f"[8] serve gemma2-2b, 2 replicas, max-k 2, 8 requests of 16 "
        f"prompt tokens and 8 new tokens: {t_serve}s wall (model init "
        f"included); latency mean {float(lat.mean()) * 1e3} ms, p50 "
        f"{float(np.percentile(lat, 50)) * 1e3} ms, p99 "
        f"{float(np.percentile(lat, 99)) * 1e3} ms; stats "
        f"{json.dumps(served['stats'])}; kernel launches "
        f"{json.dumps({k: launches[k] for k in attn})}")
    if lat.shape != (8,) or not np.all(np.isfinite(lat)) or \
            served["stats"]["total"] != 8:
        raise AssertionError(f"serve answered {lat.shape} requests, stats "
                             f"{served['stats']}")
    if min(launches[k] for k in attn) <= 0:
        raise AssertionError(f"an attention kernel of the served path never "
                             f"launched: {launches}")
    check_imports()

    # ----------------------------------------------------------- output
    log(f"total {time.perf_counter() - t_all:.1f}s")
    log(card)
    record = {"kernels": [
        {"name": "cell_update", "route": "cuda",
         "source": "src/repro_torch/csrc/cell_update.cu",
         "replaces": "src/repro/kernels/cell_update/kernel.py:378",
         "launches": launches["cell_update"],
         "max_abs_err": errs["cell_update"], "ms": ms_cell,
         "plain_ms": plain_cell, "bound_ms": cell_bound,
         "bound_by": cell_by, "library_ms": None},
        {"name": "hist_accum", "route": "cuda",
         "source": "src/repro_torch/csrc/hist_sketch.cu",
         "replaces": "src/repro/kernels/hist_sketch/kernel.py:81",
         "launches": launches["hist_accum"],
         "max_abs_err": errs["hist_accum"], "ms": ms_hist,
         "plain_ms": plain_hist, "bound_ms": hist_bound,
         "bound_by": hist_by, "library_ms": lib_hist}]}
    sources = {"flash_attention": ("flash_attention", 109),
               "decode_attention": ("decode_attention", 88)}
    for name, (pkg, line) in sources.items():
        a = attn[name]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{pkg}/kernel.py:{line}",
            "launches": launches[name], "max_abs_err": a["max_abs_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": a["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(no softcap)"})
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
