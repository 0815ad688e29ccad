#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py              # every phase; needs one card
    python3 chip_smoke.py --gates      # phases 1-3, 5-7, gates recorded
    python3 chip_smoke.py --faults     # --gates on planted faults F9-F14
    python3 chip_smoke.py --faults F12 F13 F14   # only those (+ control)

Phases, each printing its own lines; any failure raises and exits
nonzero:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, started together; each library's flags and build
     seconds), print the attention and cell_update libraries' SASS
     instruction counts (wgmma, TMA, mbarrier, cp.async) and the card;
  2. hold the ``hist_accum`` kernel against its plain version: counts
     must be exactly equal;
  3. hold the ``cell_update`` kernel against its plain version on
     identical injected inputs, for every policy x service model, a
     degraded grid, the timed policies, a heterogeneous (``has_dists``)
     grid and ragged padded chunks, with and without the sketch, and at
     every edge of its protocol (``interop.CELL_UPDATE_EDGES``: T of 1,
     63, 777 and 4097, every K template up to 16 copies, N at
     ``MAX_SERVERS``, 1,440 cells over 30 service rows, 100/256/2048 bins
     with skipped steps, a chunk past the counters' flush interval):
     ``free``/``ssum``/``comp``/``cnt`` bit-equal, histograms exactly
     equal; then time both at the main path's chunk shapes (the fig2
     chunk, and the percentile run's chunk with the sketch, one launch);
  4. the main path through the kernels: the Figure 2 threshold sweep
     (15 families, N=20, 24 loads, k in {1,2}, 2 seeds = 1,440 cells,
     50k arrivals, chunks of 4096) and a 1M-arrival percentile run of
     the paper's exponential model, checked against the closed forms,
     with the kernels' launch counts read around exactly that run (one
     ``cell_update`` a chunk, and no ``hist_accum``: the sketch is binned
     inside ``cell_update``, as on the TPU); both
     runs again with the sampling pipeline on and off (summaries must be
     bit-equal; wall times printed) and once under ``torch.profiler``
     for the device's idle share; plus a small mixed grid run with the
     kernels and with the plain version, whose summaries must be
     bit-equal;
  5. hold the ``flash_attention`` kernel against its plain version at
     gemma2-2b's head shape (B=1, H=8, KV=4, hd=256, bf16, softcap 50) at
     S = 16, 300, 1000 and 4608, without a window and with windows of 16,
     128 and 4096, and at recurrentgemma-9b's (H=16 over one KV head,
     hd=256, window 2048, no softcap) at S = 16 and 2560, some with
     queries scaled so that the softmax is peaked and the outputs are of
     order 1: in every row (query position and head) the error is at most
     2^-6 of the row's largest value, and with standard-normal inputs at
     most 2e-2 anywhere; time kernel, plain version and the library calls
     at S = 4608 (gemma2-2b's global and local layers) and 2560
     (recurrentgemma-9b's local layer): where there is no softcap, masked
     ``scaled_dot_product_attention`` computes the same function; with
     gemma2-2b's softcap, ``flex_attention`` compiled with the softcap as
     its ``score_mod`` and the mask as its block mask does (its compile
     seconds printed), and SDPA without the softcap stands beside it;
  6. the same for ``decode_attention``: the served path's dense cache,
     a dense cache with a window and positions past ``pos``, a ring
     before and after it wraps, a dense cache of 4672 slots and a ring of
     4096 at pos = 5000 (timed, with ``flex_attention`` and SDPA), and
     recurrentgemma-9b's MQA ring of 2048 at pos 23 and 2575 (timed,
     with masked SDPA); the device's kernels per call from a trace;
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
     counts read around exactly that run;
  9. hold the ``ssd_scan`` kernel against its plain version at
     mamba2-370m's shape (Q=256, H=32, P=64, N=128), 1 and 16 chunks,
     standard-normal inputs and inputs as the model makes them, and a
     padded chunk (a 16-token prompt): every element within 5e-3 + 5e-3
     |plain| (tests/test_kernels.py); time both and the bound at 16 chunks;
 10. mamba2-370m at full width and depth (48 layers): a 4096-token prompt
     (16 chunks) and 16 decode steps, as phase 7 (every ``ssd_scan`` call
     also checked against its plain version; logits with the kernel within
     twice the plain path's float32-vs-bf16 distance, the float32 path
     being the whole model widened with ``.float()``); then serve 8
     requests on 2 hedged replicas through ``launch.serve.main`` with the
     launch counts read around exactly that run;
 11. hold the ``rglru_scan`` kernel against its plain version bit for bit
     at (1, 4096, 4096) and ragged lengths; time both and the bound;
 12. recurrentgemma-9b at full width and depth (38 layers, 8.5B
     parameters): a 2560-token prompt (past the window of 2048) and 16
     decode steps, as phase 10 with ``rglru_scan``, ``flash_attention`` and
     ``decode_attention`` checked per call; then serve 8 requests. Each
     model is freed before the next is made.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. A kernel's ``launches`` there are those
of its main path's run (phase 4, 8, 10 or 12); ``hist_accum``, which no
main path launches, reads 0 and gives its launches in phase 2 as
``check_launches``. Needs CUDA and the repository's
``src/`` beside this script (or ``--src``); imports nothing of JAX or of
``repro``. ``--gates`` records every gate of phases 2, 3 and 5-7 (the
worst multiple of its allowance; a bit gate as 0 or inf) instead of
stopping at the first that fails, and prints them as its last line;
``--faults`` runs it on a copy of the package for each planted fault of
``FAULTS`` over the phases that hold its kernel, the unedited package
first.
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


def traced(fn, top: int = 4) -> dict:
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
    busiest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    wall = (w1 - w0) * 1e-6
    return {"wall_s": wall, "busy_s": busy * 1e-6 if spans else None,
            "idle_share": 1.0 - busy / (w1 - w0) if spans else None,
            "top_device_ms": {n[:60]: t * 1e-3 for n, t in busiest}}



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


# The worst multiple of its allowance that each gate saw in this run (inf
# where an output was not finite); ``--gates`` prints it.
GATES: dict[str, float] = {}


def record_gate(gate: str, ratio: float) -> None:
    GATES[gate] = max(GATES.get(gate, 0.0),
                      math.inf if math.isnan(ratio) else ratio)


def check_attention(name: str, got, want, absolute: bool, gate: str,
                    raise_on_fail: bool) -> float:
    """Check that ``got`` meets the row gate and, where ``absolute``
    (standard-normal inputs, as in tests/test_kernels.py), ``ATTN_TOL``
    anywhere; returns the max abs error. Peaked inputs give outputs up to
    ~4.5, where one bf16 ulp is 0.03125, so they take the row gate only.
    ``gate`` names the gate in ``GATES``; a failure raises where
    ``raise_on_fail``, and is only printed otherwise (``--gates``)."""
    err, ratio = row_err(got, want)
    record_gate(f"{gate} row", ratio)
    if absolute:
        record_gate(f"{gate} 2e-2", err / ATTN_TOL)
    if not ((err <= ATTN_TOL or not absolute) and ratio <= 1.0):
        msg = (f"{name} differs from its plain version: max abs err {err} "
               f"(gate {ATTN_TOL if absolute else None}), worst row at "
               f"{ratio} of 2^-6 of its largest value")
        if raise_on_fail:
            raise AssertionError(msg)
        log(f"    gate failed: {msg}")
    return err


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(ms, "bytes" | "operations"): the least time for the work."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flex_attention_call(q, k, v, mask_mod, cap):
    """``torch.nn.attention.flex_attention``, compiled, computing the
    attention kernels' function on (B, Sq, H, hd) queries over (B, Skv,
    KV, hd) keys and values: hd^-0.5 scale, the softcap as its
    ``score_mod``, the causal, window or slot mask as its block mask.
    Returns (call, seconds to build the mask and compile); the call returns
    (B, Sq, H, hd). A yardstick only: the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def softcap(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    # a fresh compile: the mask functions share their code and differ only
    # in what they capture
    torch._dynamo.reset()
    t0 = time.perf_counter()
    block_mask = create_block_mask(mask_mod, None, None, q.shape[1],
                                   k.shape[1], device=q.device)
    fx = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return fx(qt, kt, vt, score_mod=softcap if cap else None,
                  block_mask=block_mask, enable_gqa=True).transpose(1, 2)

    call()
    torch.cuda.synchronize()
    return call, time.perf_counter() - t0


def causal_mask_mod(window):
    """flex_attention's mask: causal, and within ``window`` if given."""
    def mask_mod(b, h, q_idx, kv_idx):
        live = kv_idx <= q_idx
        return live if window is None else live & (kv_idx > q_idx - window)
    return mask_mod


def slot_mask_mod(valid):
    """flex_attention's mask over a cache: the slots ``valid`` marks."""
    def mask_mod(b, h, q_idx, kv_idx):
        return valid[kv_idx]
    return mask_mod


def flex_yardstick(label: str, q, k, v, mask_mod, cap, want, reps: int):
    """ms of ``flex_attention_call``, printed with its compile seconds and
    its distance from the plain version. It computes the kernels' function,
    so a failure to compile or run it fails the run."""
    call, compile_s = flex_attention_call(q, k, v, mask_mod, cap)
    _, ratio = row_err(call(), want)
    ms = cuda_ms(call, reps, f"flex_attention {label}")
    log(f"    flex_attention {label}: {ms} ms, compiled in {compile_s} s, "
        f"worst row at {ratio} of the row allowance against the plain "
        f"version (the same function)")
    return ms


def attention_kernels(dev, timed: bool = True,
                      raise_on_fail: bool = True) -> dict:
    """Phases 5 and 6: both attention kernels against their plain
    versions at gemma2-2b's and recurrentgemma-9b's head shapes; with
    ``timed``, their times at the main path's shapes beside their bounds
    and the library calls that compute the same function. A failed gate
    raises where ``raise_on_fail`` (see ``check_attention``). Returns the
    kernels' records (without launches)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    b, h, kv, hd, cap, window = 1, 8, 4, 256, 50.0, 4096
    mq_h, mq_w = 16, 2048  # recurrentgemma-9b's local layers: MQA, window
    rng = np.random.default_rng(13)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    # ---------------------------------------------------------------- 5
    # (heads, KV heads, S, window, softcap, query scale, timed): a query
    # scale of 8 makes the softmax peaked, so the outputs are of order 1
    fa_err, fa = 0.0, {}
    g2 = (h, kv)
    for (nh, nkv), s, w, c, qs, time_it in (
            (g2, 16, None, cap, 1, False), (g2, 300, 16, cap, 1, False),
            (g2, 300, 16, cap, 8, False), (g2, 1000, 128, cap, 1, False),
            (g2, 1000, 128, cap, 8, False), (g2, 1000, None, cap, 1, False),
            (g2, PROMPT, None, cap, 1, True),
            (g2, PROMPT, window, cap, 1, True),
            (g2, PROMPT, window, cap, 8, False),
            ((mq_h, 1), 16, mq_w, None, 1, False),
            ((mq_h, 1), RG_PROMPT, mq_w, None, 1, True),
            ((mq_h, 1), RG_PROMPT, mq_w, None, 8, False)):
        q, k, v = qs * bf16(b, s, nh, hd), bf16(b, s, nkv, hd), \
            bf16(b, s, nkv, hd)
        got = fa_ops.flash_attention(q, k, v, window=w, softcap=c,
                                     kernel="on")
        want = fa_ops.flash_attention(q, k, v, window=w, softcap=c,
                                      kernel="off")
        shape = f"H={nh} KV={nkv} S={s} window={w} softcap={c}"
        err = check_attention(f"flash_attention {shape}", got, want,
                              absolute=qs == 1, gate="phase 5",
                              raise_on_fail=raise_on_fail)
        if qs == 1:  # the record's error: the 2e-2-gated cases
            fa_err = max(fa_err, err)
        log(f"[5] flash_attention {shape} query scale {qs}: max abs err vs "
            f"plain {err} (largest |out| {float(want.float().abs().max())}, "
            f"worst row at {row_err(got, want)[1]} of its allowance)")
        if not (timed and time_it):
            continue
        i = torch.arange(s, device=dev)
        live = i[None, :] <= i[:, None]
        if w is not None:
            live &= i[None, :] > i[:, None] - w
        pairs = int(live.sum())
        ms = cuda_ms(lambda: fa_ops.flash_attention(
            q, k, v, window=w, softcap=c, kernel="on"), 10,
            "flash_attention")
        plain = cuda_ms(lambda: fa_ops.flash_attention(
            q, k, v, window=w, softcap=c, kernel="off"), 3,
            "flash_attention plain")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_kw = (dict(is_causal=True) if w is None
                   else dict(attn_mask=live))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_kw), 10, "sdpa")
        n_bytes = 2 * (2 * b * s * nh * hd + 2 * b * s * nkv * hd)
        bms, by = bound(n_bytes, 4 * hd * nh * b * pairs, BF16_OPS_PER_S)
        rec = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        if c is None:
            # no softcap: masked SDPA computes exactly the kernel's function
            rec.update(library_ms=sdpa, library="torch.nn.functional."
                       "scaled_dot_product_attention (boolean mask)")
            log(f"[5] flash_attention {shape}: kernel {ms} ms, plain {plain} "
                f"ms, scaled_dot_product_attention (the same function) "
                f"{sdpa} ms, bound {bms} ms ({by}; {pairs} live pairs)")
        else:
            flex = flex_yardstick(shape, q, k, v, causal_mask_mod(w), c,
                                  want, 10)
            rec.update(library_ms=flex, library="torch.nn.attention."
                       "flex_attention, compiled (softcap score_mod, block "
                       "mask: the same function)", sdpa_no_softcap_ms=sdpa)
            log(f"[5] flash_attention {shape}: kernel {ms} ms, plain {plain} "
                f"ms, flex_attention (the same function) {flex} ms, "
                f"scaled_dot_product_attention (no softcap) {sdpa} ms, bound "
                f"{bms} ms ({by}; {pairs} live pairs)")
        fa[(nh, w)] = rec

    # ---------------------------------------------------------------- 6
    da_err, da = 0.0, {}
    last = PROMPT + DECODE_STEPS - 1
    # (case, heads, KV heads, cache length, pos, window, softcap, query
    # scale, timed): the served path's dense cache (max_len 128, a 16-token
    # prompt and 8 new tokens); a dense cache holding positions past
    # ``pos`` under a window; a ring before and after it wraps; the long
    # run's dense cache and its wrapped ring; recurrentgemma-9b's MQA ring
    # of 2048 before it fills and past it
    for case, (nh, nkv), length, pos, w, c, qs, time_it in (
            ("dense", g2, 128, 23, None, cap, 1, False),
            ("filled", g2, 512, 300, 64, cap, 1, False),
            ("ring", g2, 64, 40, 64, cap, 1, False),
            ("ring", g2, 64, 1000, 64, cap, 1, False),
            ("dense", g2, MAX_LEN, last, None, cap, 1, True),
            ("dense", g2, MAX_LEN, last, None, cap, 8, False),
            ("ring", g2, window, 5000, window, cap, 1, True),
            ("ring", (mq_h, 1), mq_w, 23, mq_w, None, 1, False),
            ("ring", (mq_h, 1), mq_w, RG_PROMPT + 15, mq_w, None, 1, True),
            ("ring", (mq_h, 1), mq_w, RG_PROMPT + 15, mq_w, None, 8, False)):
        q, k, v = qs * bf16(b, 1, nh, hd), bf16(b, length, nkv, hd), \
            bf16(b, length, nkv, hd)
        s = np.arange(length)
        slots = {"dense": np.where(s <= pos, s, -1), "filled": s,
                 "ring": np.where(s <= pos, pos - (pos - s) % length,
                                  -1)}[case]
        slots = torch.from_numpy(slots.astype(np.int32)).to(dev)

        def call(kernel):
            return da_ops.decode_attention(q, k, v, slots, pos, window=w,
                                           softcap=c, kernel=kernel)

        got, want = call("on"), call("off")
        shape = (f"{case} H={nh} KV={nkv} L={length} pos={pos} window={w} "
                 f"softcap={c}")
        err = check_attention(f"decode_attention {shape}", got, want,
                              absolute=qs == 1, gate="phase 6",
                              raise_on_fail=raise_on_fail)
        if qs == 1:  # the record's error: the 2e-2-gated cases
            da_err = max(da_err, err)
        valid = (slots >= 0) & (slots <= pos)
        if w is not None:
            valid &= slots > pos - w
        n_live = int(valid.sum())
        log(f"[6] decode_attention {shape} query scale {qs} ({n_live} live "
            f"slots): max abs err vs plain {err} (largest |out| "
            f"{float(want.float().abs().max())}, worst row at "
            f"{row_err(got, want)[1]} of its allowance)")
        if not (timed and time_it):
            continue
        ms = cuda_ms(lambda: call("on"), 50, "decode_attention")
        plain = cuda_ms(lambda: call("off"), 20, "decode_attention plain")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = valid[None, None, None, :]
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 50, "sdpa")
        n_bytes = 2 * 2 * n_live * b * nkv * hd
        bms, by = bound(n_bytes, 4 * hd * nh * b * n_live, BF16_OPS_PER_S)
        rec = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        if c is None:
            rec.update(library_ms=sdpa, library="torch.nn.functional."
                       "scaled_dot_product_attention (boolean mask)")
            lib_note = f"scaled_dot_product_attention (the same function) " \
                       f"{sdpa} ms"
        else:
            flex = flex_yardstick(shape, q, k, v, slot_mask_mod(valid), c,
                                  want, 50)
            rec.update(library_ms=flex, library="torch.nn.attention."
                       "flex_attention, compiled (softcap score_mod, block "
                       "mask: the same function)", sdpa_no_softcap_ms=sdpa)
            lib_note = (f"flex_attention (the same function) {flex} ms, "
                        f"scaled_dot_product_attention (no softcap) {sdpa} ms")
        da[(nh, case)] = rec
        tr = traced(lambda: [call("on") for _ in range(50)])
        per_call = {n: t / 50 for n, t in tr["top_device_ms"].items()}
        # what the time is made of: the same launch with no live slot (no
        # copies, no products: the scan, barriers and combine), and one
        # library call reading the same K and V bytes
        none_live = torch.full_like(slots, -1)
        ms_empty = cuda_ms(lambda: da_ops.decode_attention(
            q, k, v, none_live, pos, window=w, softcap=c, kernel="on"), 50,
            "decode_attention, no live slot")
        kv_rows = torch.stack((k, v))
        ms_read = cuda_ms(lambda: kv_rows.sum(dtype=torch.float32), 50,
                          "torch.sum")
        log(f"[6] decode_attention {shape}: kernel {ms} ms, plain {plain} "
            f"ms, {lib_note}, bound {bms} ms ({by}); the kernel with no "
            f"live slot {ms_empty} ms, torch.sum over the same K and V "
            f"{ms_read} ms; device ms per call by kernel (trace of 50 "
            f"calls) {json.dumps(per_call)}")
    if not timed:
        return {}
    for key, rec in (("flash_attention recurrentgemma-9b local layer",
                      fa[(mq_h, mq_w)]),
                     ("decode_attention recurrentgemma-9b ring",
                      da[(mq_h, "ring")]),
                     ("flash_attention gemma2-2b local layer",
                      fa[(h, window)]),
                     ("decode_attention gemma2-2b ring", da[(h, "ring")])):
        log(f"[6] {key}: {json.dumps(rec)}")
    return {"flash_attention": dict(fa[(h, None)], max_abs_err=fa_err),
            "decode_attention": dict(da[(h, "dense")], max_abs_err=da_err)}


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


def _checked_ops() -> dict:
    """Per kernel: the ops module and function the model calls, and the
    gate function that compares its output with the plain version's."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": (fa_ops, "flash_attention", row_err),
            "decode_attention": (da_ops, "decode_attention", row_err),
            "ssd_scan": (ssd_ops, "ssd_intra_chunk", ssd_err),
            "rglru_scan": (scan_ops, "linear_scan", scan_err)}


@contextlib.contextmanager
def checked_against_plain(worst: dict,
                          names=("flash_attention", "decode_attention")):
    """Every op of ``names`` called with ``kernel="on"`` inside also runs
    its plain version on the same inputs; ``worst[name]`` collects
    (calls, max abs error, worst share of the allowance) of the op's gate
    (``row_err``, ``ssd_err``, ``scan_err``). The kernel's output is what
    the model gets."""
    every = _checked_ops()
    ops = {name: every[name] for name in names}

    def wrap(name, op, gate):
        def call(*args, kernel="auto", **kw):
            out = op(*args, kernel=kernel, **kw)
            if kernel == "on":
                err, ratio = gate(out, op(*args, kernel="off", **kw))
                # a NaN (an output not written, say) fails, not vanishes
                err, ratio = (math.inf if math.isnan(x) else x
                              for x in (err, ratio))
                n, e0, r0 = worst.get(name, (0, 0.0, 0.0))
                worst[name] = (n + 1, max(e0, err), max(r0, ratio))
            return out
        return call

    saved = {name: getattr(mod, attr) for name, (mod, attr, _) in ops.items()}
    for name, (mod, attr, gate) in ops.items():
        setattr(mod, attr, wrap(name, saved[name], gate))
    try:
        yield
    finally:
        for name, (mod, attr, _) in ops.items():
            setattr(mod, attr, saved[name])


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
        record_gate(f"phase 7 per-call {name}", ratio if n else math.inf)
        if n == 0 or not ratio <= 1.0:
            failed.append(f"{name} over the model: {n} calls, worst row at "
                          f"{ratio} of 2^-6 of its largest value")
    on, off, off32 = runs["on"], runs["off"], runs["off32"]
    if tuple(on.shape) != (DECODE_STEPS + 1, cfg.vocab_size) or \
            not all(bool(torch.isfinite(x).all()) for x in runs.values()):
        record_gate("phase 7 logits", math.inf)
        raise AssertionError(f"logits of shape {tuple(on.shape)} or not "
                             f"finite; " + "; ".join(failed))
    diffs = (on - off).abs().amax(dim=-1).tolist()
    floor = (off32 - off).abs().amax(dim=-1).tolist()
    # the kernels may differ from the plain path by no more than twice the
    # plain path's own bf16 noise floor (the rule of tests/test_torch_lm.py)
    bound_ = 2 * max(floor)
    record_gate("phase 7 logits", max(diffs) / bound_)
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


SSD_TOL = 5e-3      # tests/test_kernels.py: |err| <= 5e-3 + 5e-3 |plain|
SSD_SHAPE = (256, 32, 64, 128)  # mamba2-370m: chunk Q, heads H, P, d_state N
MAMBA_PROMPT = 4096  # 16 chunks of 256
RG_PROMPT = 2560     # past recurrentgemma-9b's window of 2048
SCAN_W = 4096        # recurrentgemma-9b's lru_width


def ssd_err(got, want) -> tuple[float, float]:
    """(max abs error, largest ratio of an element's error to its
    allowance ``SSD_TOL + SSD_TOL * |plain|``) over both outputs of
    ``ssd_intra_chunk``."""
    err, ratio = 0.0, 0.0
    for g, w in zip(got, want):
        e = (g - w).abs()
        err = max(err, float(e.max()))
        ratio = max(ratio, float((e / (SSD_TOL + SSD_TOL * w.abs())).max()))
    return err, ratio


def scan_err(got, want) -> tuple[float, float]:
    """(max abs error, 0 if bit-equal else inf) of ``linear_scan``."""
    import torch
    return float((got - want).abs().max()), (0.0 if torch.equal(got, want)
                                             else math.inf)


def ssd_inputs(dev, n_chunks: int, model_like: bool, valid: int | None,
               seed: int):
    """Inputs of ``ssd_intra_chunk`` at mamba2-370m's shape. Standard
    normal x, B, C and dt = softplus(z), a = -exp(0.2 z); or as the model
    makes them: x, B, C = silu(z), dt = softplus(z), a = -exp(a_log) with
    the init's a_log = 0. ``valid``: rows of a prompt in one padded chunk
    (dt = 0 and x, B, C = 0 past them, as ``ssd_chunked`` pads)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(seed)
    q, h, p, n = SSD_SHAPE

    def z(*shape):
        return torch.randn(shape, generator=g, device=dev)

    xc, bc, cc = z(1, n_chunks, q, h, p), z(1, n_chunks, q, n), \
        z(1, n_chunks, q, n)
    if model_like:
        xc, bc, cc = F.silu(xc), F.silu(bc), F.silu(cc)
        a = -torch.ones(h, device=dev)
    else:
        a = -torch.exp(0.2 * z(h))
    dtc = F.softplus(z(1, n_chunks, q, h))
    if valid is not None:
        for x in (xc, bc, cc, dtc):
            x[:, :, valid:] = 0
    cum = torch.cumsum(dtc * a, dim=2)
    return xc, bc, cc, dtc, cum


def ssd_kernel(dev) -> dict:
    """Phase 9: ``ssd_scan`` against its plain version at mamba2-370m's
    shape; times and bound at the 4096-token prefill's 16 chunks."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    worst = 0.0
    for n_chunks, model_like, valid in ((1, False, None), (16, False, None),
                                        (1, True, None), (16, True, None),
                                        (1, True, 16)):
        args = ssd_inputs(dev, n_chunks, model_like, valid, 9 + n_chunks)
        got = ssd_ops.ssd_intra_chunk(*args, kernel="on")
        want = ssd_ops.ssd_intra_chunk(*args, kernel="off")
        err, ratio = ssd_err(got, want)
        log(f"[9] ssd_scan {n_chunks} chunk(s) of Q={SSD_SHAPE[0]}, H="
            f"{SSD_SHAPE[1]}, P={SSD_SHAPE[2]}, N={SSD_SHAPE[3]}, inputs "
            f"{'as the model makes them' if model_like else 'standard normal'}"
            f"{f', {valid} valid rows (padded chunk)' if valid else ''}: max "
            f"abs err vs plain {err}, worst element at {ratio} of its "
            f"allowance {SSD_TOL} + {SSD_TOL}|plain| (largest |y| "
            f"{float(want[0].abs().max())}, |state| "
            f"{float(want[1].abs().max())})")
        if not ratio <= 1.0:
            raise AssertionError(f"ssd_scan differs from its plain version: "
                                 f"worst element at {ratio} of its allowance")
        worst = max(worst, err)
        if n_chunks == 1 and valid is None:
            # both against the plain version in float64: the kernel's own
            # rounding, whether or not it matches the plain version's bits
            exact = ssd_ops.ssd_intra_chunk_ref(*(t.double() for t in args))

            def dist(outs):
                return [float((o - e).abs().max()) for o, e in zip(outs, exact)]

            log(f"[9]   against the plain version in float64: kernel "
                f"{dist(got)}, plain {dist(want)} (y, states); kernel "
                f"bit-equal to plain "
                f"{all(bool((g == w).all()) for g, w in zip(got, want))}")
    args = ssd_inputs(dev, 16, True, None, 99)
    ms = cuda_ms(lambda: ssd_ops.ssd_intra_chunk(*args, kernel="on"), 20,
                 "ssd_scan")
    plain = cuda_ms(lambda: ssd_ops.ssd_intra_chunk(*args, kernel="off"), 5,
                    "ssd_scan plain")
    bc_n, (q, h, p, n) = 16, SSD_SHAPE
    pairs = q * (q + 1) // 2
    # C B^T once per chunk over the causal half; per head the weights (a
    # subtraction, exp and two products a pair), W X and the state product
    n_ops = (bc_n * pairs * n * 2 + bc_n * h * pairs * (p * 2 + 4)
             + bc_n * h * q * p * n * 2)
    n_bytes = 4 * (2 * bc_n * q * h * p + 2 * bc_n * q * n + 2 * bc_n * q * h
                   + bc_n * h * p * n)
    bms, by = bound(n_bytes, n_ops, F32_OPS_PER_S)
    log(f"[9] ssd_scan at 16 chunks: kernel {ms} ms, plain {plain} ms, bound "
        f"{bms} ms ({by}; {n_ops} operations, {n_bytes} bytes); no single "
        f"PyTorch call computes it")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=None, max_abs_err=worst)


def scan_kernel(dev) -> dict:
    """Phase 11: ``rglru_scan`` against its plain version, bit for bit, at
    recurrentgemma-9b's width; times and bound at (1, 4096, 4096)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rglru_scan import ops as scan_ops

    g = torch.Generator(dev).manual_seed(11)
    for shape in ((1, 4096, SCAN_W), (1, 2573, SCAN_W), (2, 77, SCAN_W)):
        # a = exp(-8 softplus(2) sigmoid(z)) and b ~ sqrt(1 - a^2) z, as the
        # gates make them
        a = torch.exp(-8.0 * F.softplus(torch.tensor(2.0)) * torch.sigmoid(
            torch.randn(shape, generator=g, device=dev)))
        b = torch.sqrt(1 - a * a) * torch.randn(shape, generator=g, device=dev)
        got = scan_ops.linear_scan(a, b, kernel="on")
        want = scan_ops.linear_scan(a, b, kernel="off")
        err, ratio = scan_err(got, want)
        log(f"[11] rglru_scan {shape}: bit-equal to its plain version "
            f"{ratio == 0.0} (max abs diff {err}; largest |h| "
            f"{float(want.abs().max())})")
        if ratio != 0.0:
            raise AssertionError(f"rglru_scan {shape} is not bit-equal to its "
                                 f"plain version (max abs diff {err})")
        if shape[1] == 4096:
            ms = cuda_ms(lambda: scan_ops.linear_scan(a, b, kernel="on"), 20,
                         "rglru_scan")
            plain = cuda_ms(lambda: scan_ops.linear_scan(a, b, kernel="off"),
                            2, "rglru_scan plain")
            n = a.numel()
            bms, by = bound(3 * 4 * n, 2 * n, F32_OPS_PER_S)
            log(f"[11] rglru_scan {shape}: kernel {ms} ms, plain {plain} ms, "
                f"bound {bms} ms ({by}); no single PyTorch call computes it")
            rec = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       library_ms=None, max_abs_err=0.0)
    return rec


def recurrent_full(dev, arch: str, phase: int, prompt: int,
                   kernels: tuple[str, ...]) -> None:
    """Phases 10 and 12: ``arch`` at full width and depth (random weights
    from the port's own init on the card), a ``prompt``-token prefill and
    16 teacher-forced decode steps. Once with every call of ``kernels``
    also run through its plain version on the same inputs (the gates of
    phases 5, 6, 9 and 11), then with the kernels and their plain
    versions, and last with the plain versions on the model widened to
    float32: the kernels' logits within twice the float32 path's distance
    from the plain path at every step. Prefill and per-token decode
    times, the device's idle share during decode, the engine's greedy
    tokens against repeated prefill (before the widening). Runs every
    check before it raises."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode, lm

    tag = f"[{phase}]"
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = lm.init(torch.Generator(dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{tag} {arch}: {cfg.n_layers} layers {cfg.layer_kinds[:3]}..., "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {n_params} "
        f"parameters (param_count {cfg.param_count}), init "
        f"{time.perf_counter() - t0}s, "
        f"{torch.cuda.memory_allocated() / 2**30} GiB allocated")
    rng = np.random.default_rng(phase)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, prompt + DECODE_STEPS))).to(dev)
    max_len = prompt + DECODE_STEPS
    runs, worst, failed = {}, {}, []

    def run(mode: str) -> None:
        kernel = "off" if mode.startswith("off") else "on"

        def ctx():
            return (checked_against_plain(worst, kernels)
                    if mode == "checked" else contextlib.nullcontext())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx():
            logits, cache = decode.prefill(model, toks[:, :prompt], max_len,
                                           kernel=kernel)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        steps = [logits]
        t0 = time.perf_counter()
        with ctx():
            for i in range(DECODE_STEPS):
                logits, cache = decode.decode_step(
                    model, cache, toks[:, prompt + i:prompt + i + 1],
                    prompt + i, kernel=kernel)
                steps.append(logits)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / DECODE_STEPS
        runs[mode] = torch.stack(steps)[:, 0]
        log(f"{tag} {mode}: prefill of {prompt} tokens {t_pre * 1e3} ms, "
            f"decode {t_dec * 1e3} ms per token ({DECODE_STEPS} steps)")

    for mode in ("checked", "on", "off", "on", "off"):
        run(mode)
    _, cache = decode.prefill(model, toks[:, :prompt], max_len, kernel="on")

    def decode_run(c=cache):
        for i in range(DECODE_STEPS):
            _, c = decode.decode_step(model, c,
                                      toks[:, prompt + i:prompt + i + 1],
                                      prompt + i, kernel="on")

    log(f"{tag} trace of the prefill (kernels): " + json.dumps(traced(
        lambda: decode.prefill(model, toks[:, :prompt], max_len,
                               kernel="on"), top=8)))
    log(f"{tag} trace of {DECODE_STEPS} decode steps (kernels): "
        f"{json.dumps(traced(decode_run))}")
    engine_check(model, cfg, dev, rng, failed, tag)
    model.float()  # in place, last: the plain path in float32
    run("off32")
    for name in kernels:
        n, err, ratio = worst.get(name, (0, 0.0, 0.0))
        log(f"{tag} {name} at every layer and step of the kernel run ({n} "
            f"calls), against its plain version on the same inputs: max abs "
            f"err {err}, worst at {ratio} of its allowance")
        if n == 0 or not ratio <= 1.0:
            failed.append(f"{name} over the model: {n} calls, worst at "
                          f"{ratio} of its allowance")
    on, off, off32 = runs["on"], runs["off"], runs["off32"]
    if tuple(on.shape) != (DECODE_STEPS + 1, cfg.vocab_size) or \
            not all(bool(torch.isfinite(runs[m]).all())
                    for m in ("checked", "on", "off", "off32")):
        raise AssertionError(f"{arch}: logits of shape {tuple(on.shape)} or "
                             f"not finite")
    diffs = (on - off).abs().amax(dim=-1).tolist()
    floor = (off32 - off).abs().amax(dim=-1).tolist()
    bound_ = 2 * max(floor)
    log(f"{tag} max abs logit difference, prefill then each decode step: "
        f"kernels vs plain {json.dumps(diffs)}; plain in float32 vs plain "
        f"{json.dumps(floor)}; bound 2 x {max(floor)} = {bound_}; largest "
        f"|logit| {float(on.abs().max())}")
    if max(diffs) > bound_:
        failed.append(f"{arch}: kernels' and plain path's logits differ by "
                      f"{max(diffs)} > {bound_}")
    for name, x in (("kernels", on), ("float32 plain", off32)):
        agree = float((x.argmax(-1) == off.argmax(-1)).float().mean())
        log(f"{tag} greedy tokens of the {name} path agree with the plain "
            f"path's at {agree} of the {DECODE_STEPS + 1} positions")
    del model, cache, runs
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase {phase}: " + "; ".join(failed))


def engine_check(model, cfg, dev, rng, failed: list, tag: str) -> None:
    """The engine's greedy tokens (prefill, then decode from its cache)
    equal repeated-prefill argmax."""
    import torch

    from repro_torch.models import decode
    from repro_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(cfg, model, max_len=128, name="check", device=dev)
    prompt_ids = rng.integers(0, cfg.vocab_size, 16)
    out = eng.generate(prompt_ids, max_new_tokens=4)
    cur = list(prompt_ids)
    for i in range(4):
        logits, _ = decode.prefill(model, torch.tensor([cur], device=dev),
                                   128)
        nxt = int(logits.argmax(-1)[0])
        if nxt != int(out[i]):
            failed.append(f"{cfg.name}: engine token {i} is {out[i]}, "
                          f"repeated prefill gives {nxt}")
            break
        cur.append(nxt)
    log(f"{tag} engine greedy tokens {out.tolist()}, repeated-prefill argmax "
        f"{cur[len(prompt_ids):]}")


def serve_path(arch: str, phase: int, counters: dict) -> dict:
    """The served path of ``arch`` through its user entry point:
    ``launch.serve.main`` answers 8 requests on 2 hedged replicas, with
    every kernel's launch count set to 0 just before and read just after.
    Returns the counts."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = serve.main(["--arch", arch, "--replicas", "2", "--max-k", "2",
                         "--requests", "8"])
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    lat = served["latency_s"]
    log(f"[{phase}] serve {arch}, 2 replicas, max-k 2, 8 requests of 16 "
        f"prompt tokens and 8 new tokens: {t_serve}s wall (model init "
        f"included); latency mean {float(lat.mean()) * 1e3} ms, p50 "
        f"{float(np.percentile(lat, 50)) * 1e3} ms, p99 "
        f"{float(np.percentile(lat, 99)) * 1e3} ms; stats "
        f"{json.dumps(served['stats'])}; kernel launches "
        f"{json.dumps(launches)}")
    if lat.shape != (8,) or not np.all(np.isfinite(lat)) or \
            served["stats"]["total"] != 8:
        raise AssertionError(f"serve {arch} answered {lat.shape} requests, "
                             f"stats {served['stats']}")
    torch.cuda.empty_cache()
    return launches


def bit_gate(gate: str, equal: bool, msg: str, raise_on_fail: bool) -> None:
    """Record a bit gate as 0 (equal) or inf; a failure raises where
    ``raise_on_fail``, and is only printed otherwise (``--gates``)."""
    record_gate(gate, 0.0 if equal else math.inf)
    if not equal:
        if raise_on_fail:
            raise AssertionError(msg)
        log(f"    gate failed: {msg}")


def hist_accum_check(dev, raise_on_fail: bool = True) -> float:
    """Phase 2: ``hist_accum`` against its plain version, exact counts;
    returns the max abs difference."""
    import numpy as np
    import torch

    from repro_torch.kernels.hist_sketch import ops as hist_ops

    worst = 0.0
    rng = np.random.default_rng(7)
    for n_bins in (100, 256, 2048):
        for t, c in ((4096, 16), (4096, 1440), (777, 37)):
            idx = torch.from_numpy(rng.integers(
                -1, n_bins, (t, c)).astype(np.int32)).to(dev)
            got = hist_ops.hist_accum(idx, n_bins=n_bins, kernel="on")
            want = hist_ops.hist_accum(idx, n_bins=n_bins, kernel="off")
            err = float((got - want).abs().max())
            worst = max(worst, err)
            bit_gate("phase 2 hist_accum", err == 0.0,
                     f"hist_accum differs: n_bins={n_bins} T={t} C={c} "
                     f"max|diff|={err}", raise_on_fail)
    log(f"[2] hist_accum kernel == plain (exact counts) for n_bins "
        f"100/256/2048 at (T,C) (4096,16) (4096,1440) (777,37)")
    return worst


def cell_kernel_check(dev, raise_on_fail: bool = True) -> float:
    """Phase 3's bit gates: ``cell_update`` against its plain version on
    identical injected inputs, on every arm of ``interop.CELL_UPDATE_ARMS``
    (and a five-policy mix) and every edge of its protocol
    (``interop.CELL_UPDATE_EDGES``); ``free``/``ssum``/``comp``/``cnt``
    bit-equal and the histograms exactly equal. Returns the max abs
    difference."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.kernels.cell_update import ops as cell_ops

    cases = {name: dict(kw, n_cells=160, n_seeds=4, n_servers=20,
                        steps=2048)
             for name, kw in interop.CELL_UPDATE_ARMS.items()}
    cases["generic_mix"] = dict(k_max=3, policies=(0, 1, 2, 3, 4),
                                models=(0, 1), mix=0.6, delay=0.7,
                                n_cells=160, n_seeds=4, n_servers=20,
                                steps=2048)
    cases.update({f"edge {name}": dict({"n_servers": 20}, **kw)
                  for name, kw in interop.CELL_UPDATE_EDGES.items()})
    worst = 0.0
    for name, kw in cases.items():
        kw = dict(kw)
        steps = kw.pop("steps")
        args, static = interop.synthetic_chunk(11, steps=steps, **kw)
        args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in args.items()}
        outs = [cell_ops.cell_update(
            *(args[k] for k in interop.CELL_UPDATE_ARGS), block=steps,
            kernel=mode, **static) for mode in ("on", "off")]
        torch.cuda.synchronize()
        bad = []
        for field, g, w in zip(("free", "ssum", "comp", "cnt", "hist"),
                               *outs):
            if g.numel():
                worst = max(worst, float((g - w).abs().max()))
            if not torch.equal(g, w):
                bad.append(f"{field} ({int((g != w).sum())} differ)")
        bit_gate(f"phase 3 {name}", not bad,
                 f"cell_update {name}: not bit-equal in {', '.join(bad)}",
                 raise_on_fail)
        if not bad:
            log(f"[3] cell_update kernel == plain bit for bit: {name} "
                f"({json.dumps(kw)}, T={steps})")
    return worst


# Planted faults (``--faults``): each edits one kernel source of a copy of
# the package, as (source, text found once, its replacement, what it does).
FAULTS = {
    "F9": ("flash_attention",
           "      mbar_wait(kfull, parity);\n      const uint32_t k_tile",
           "      if (n < kStages) mbar_wait(kfull, parity);\n"
           "      const uint32_t k_tile",
           "a consumer waits for K only on each stage's first use, so a "
           "later tile may read the stage's stale K"),
    "F10": ("flash_attention",
            "  const int h = blockIdx.x;\n",
            "  if (tile == n_tiles - 1) return;\n  const int h = blockIdx.x;\n",
            "the tile scheduler drops the last (heaviest) query tile of "
            "every head"),
    "F11": ("decode_attention",
            "is_last = done == n_clusters - 1;",
            "is_last = done == n_clusters - 2;",
            "the combine runs when all but one cluster have published their "
            "partials"),
    # stronger forms of F9 and F11, for races that the timing may hide
    "F9b": ("flash_attention",
            "      mbar_wait(kfull, parity);\n      const uint32_t k_tile",
            "      const uint32_t k_tile",
            "a consumer never waits for K: every tile may read a K stage "
            "before its copy lands"),
    "F11b": ("decode_attention",
             "is_last = done == n_clusters - 1;",
             "is_last = done == 0;",
             "the combine runs when the first cluster has published"),
    # the cell_update protocol
    "F12": ("cell_update",
            "  mbar_wait(b.full + (tile & b.qmask), (tile >> b.qshift) & 1);\n",
            "",
            "the consumer never waits for a stage's full barrier, so it "
            "reads each slot as soon as it gets there, before it is written"),
    "F13": ("cell_update",
            "const int n_live = min(TS, T - tile * TS);",
            "const int n_live = T - tile * TS < TS ? 0 : TS;",
            "the histogram warp skips the last tile where it is partial"),
    "F14": ("cell_update",
            "sts(o_t + 4 * e * G, __fdiv_rn(cum_e, rate));",
            "sts(o_t + 4 * e * G, __fmul_rn(cum_e, __frcp_rn(rate)));",
            "the producer computes t as cum * (1 / rate)"),
}
# phases of --gates that hold each source's kernel
FAULT_PHASES = {"cell_update": [2, 3]}
GATE_PHASES = [2, 3, 5, 6, 7]


def sass_counts(lib_path) -> dict:
    """Counts of the instructions that show the kernels' designs in a
    library's SASS (``cuobjdump -sass``): wgmma (HGMMA), TMA and bulk
    copies (UTMALDG, UBLKCP), mbarrier operations (SYNCS), cp.async
    (LDGSTS), mma.sync (HMMA), ldmatrix (LDSM)."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).resolve().parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    ops = []  # "/*1a40*/  @!P0 SYNCS.EXCH.64 ... ;  /* 0x... */"
    for ln in sass.splitlines():
        head = ln.strip()
        if head.startswith("/*") and head[2:].split("*/", 1)[0].isalnum():
            words = head.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                ops.append(words[0].split(".")[0])
    return {op: ops.count(op)
            for op in ("HGMMA", "UTMALDG", "UBLKCP", "SYNCS", "LDGSTS",
                       "HMMA", "LDSM")}


def run_faults(names: list[str]) -> int:
    """Plant each fault of ``FAULTS`` (or of ``names``) in a copy of the
    package (under the git-ignored build directory, with the built
    libraries of the sources it leaves alone), run this script on the copy
    with ``--gates`` over the phases that hold its kernel
    (``FAULT_PHASES``; 5-7 for the attention kernels), and print which
    gates rejected it: the worst multiple of each gate's allowance (> 1
    rejects; a bit gate reads 0 or inf). The unedited package runs first,
    as the control, over the phases of every fault named."""
    import shutil

    from repro_torch.kernels import build

    unknown = sorted(set(names) - set(FAULTS))
    if unknown:
        raise SystemExit(f"unknown faults {unknown}; FAULTS has "
                         f"{sorted(FAULTS)}")
    names = names or list(FAULTS)

    def phases(fault):
        return FAULT_PHASES.get(FAULTS[fault][0], [5, 6, 7])

    build.build_all()
    results = {}
    for name in ("control", *names):
        tree = ROOT / "src"
        gate_phases = (sorted({p for f in names for p in phases(f)})
                       if name == "control" else phases(name))
        if name != "control":
            source, old, new, what = FAULTS[name]
            tree = build.BUILD_DIR / "faults" / name
            shutil.rmtree(tree, ignore_errors=True)
            shutil.copytree(ROOT / "src" / "repro_torch", tree / "repro_torch",
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            shutil.copytree(build.BUILD_DIR, tree / "repro_torch" / "build",
                            ignore=shutil.ignore_patterns("faults"))
            cu = tree / "repro_torch" / "csrc" / f"{source}.cu"
            text = cu.read_text()
            if text.count(old) != 1:
                raise AssertionError(f"{name}: its text is not found once in "
                                     f"{source}.cu")
            cu.write_text(text.replace(old, new))
            log(f"[faults] {name}: {what} ({source}.cu)")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--gates",
             *map(str, gate_phases), "--src", str(tree)],
            capture_output=True, text=True, timeout=1500)
        lines = proc.stdout.strip().splitlines()
        for ln in lines[:-1]:
            if "gate failed" in ln or "[7]" in ln or "build" in ln:
                log(f"[faults] {name} | {ln.strip()[:400]}")
        try:
            gates = json.loads(lines[-1])["gates"]
        except (IndexError, ValueError, KeyError):
            log(f"[faults] {name}: no gate record (exit {proc.returncode});"
                f" stderr: {proc.stderr[-2000:]}")
            gates = None
        results[name] = gates
        log(f"[faults] {name}: {time.perf_counter() - t0:.1f}s, gates "
            f"(worst multiple of the allowance; > 1 rejects) "
            f"{json.dumps(gates)}")
    print(json.dumps({"faults": results}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one "
                                 "CUDA card (see the module's docstring).")
    ap.add_argument("--gates", nargs="*", type=int, metavar="PHASE",
                    help="run phase 1 and the gates of phases 2, 3, 5, 6 "
                         "and 7 (or of the phases named), recording every "
                         "gate instead of stopping at the first that "
                         "fails; the last line is the gates' worst "
                         "multiples")
    ap.add_argument("--faults", nargs="*", metavar="FAULT",
                    help="run --gates on copies of the package with each "
                         "planted fault of FAULTS (or of those named)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding repro_torch (default: "
                         "src/ beside this script)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.faults is not None:
        return run_faults(args.faults)
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
    from repro_torch.kernels.rglru_scan import kernel as scan_kernel_mod
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel_mod
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
        f" seconds each (started together), wall "
        f"{time.perf_counter() - t0:.2f}s")
    for name in build.SOURCES:
        log(f"[1] {name} nvcc flags: {' '.join(build.nvcc_flags(name))}")
        if build.build_log(name).exists():
            for ln in build.build_log(name).read_text().splitlines():
                if any(w in ln for w in ("registers", "bytes stack",
                                         "arning")):
                    log(f"[1] ptxas {name}: {ln.strip()}")
    for name in ("flash_attention", "decode_attention", "cell_update"):
        log(f"[1] SASS of {name}: "
            f"{json.dumps(sass_counts(build.library_path(name)))}")
    card = gpu_line()
    log(f"[1] gpu: {card}")
    if args.gates is not None:
        phases = set(args.gates or GATE_PHASES)
        if 2 in phases:
            hist_accum_check(dev, raise_on_fail=False)
        if 3 in phases:
            try:
                cell_kernel_check(dev, raise_on_fail=False)
            except RuntimeError as exc:  # a launch that died
                record_gate("phase 3 launch", math.inf)
                log(f"    gate failed: {exc}")
        if phases & {5, 6}:
            attention_kernels(dev, timed=False, raise_on_fail=False)
        if 7 in phases:
            try:
                lm_full(dev)
            except AssertionError as exc:
                log(f"    gate failed: {exc}")
        print(json.dumps({"gates": GATES}), flush=True)
        return 0

    # ---------------------------------------------------------------- 2
    hist_kernel.hist_accum_cuda.launches = 0
    errs = {"hist_accum": hist_accum_check(dev)}
    # hist_accum's launches in this check, its only caller here: the main
    # path bins inside cell_update, and phase 4 checks it launches none
    hist_check_launches = hist_kernel.hist_accum_cuda.launches
    rng = np.random.default_rng(7)

    # ---------------------------------------------------------------- 3
    errs["cell_update"] = cell_kernel_check(dev)

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

    ms_pcell = cuda_ms(lambda: p_chunk("on"), 5, "cell_update, sketch on")
    for field, g, w in zip(("free", "ssum", "comp", "cnt", "hist"),
                           p_chunk("on"), p_chunk("off")):
        if not torch.equal(g, w):
            raise AssertionError(f"percentile chunk: {field} not bit-equal")
    log(f"[3] cell_update with the sketch at the percentile run's chunk "
        f"(C=12, N=20, T={CHUNK}, 2048 bins, one launch; kernel == plain "
        f"bit for bit): {ms_pcell:.4f} ms")
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
    fig2_launches = cell_kernel.cell_update_cuda.launches
    t0 = time.perf_counter()
    out = queueing.run(100, Scenario.paper_default(dists.exponential()),
                       p_rhos, p_cfg, n_seeds=2,
                       percentiles=(50.0, 99.0, 99.9), chunk_size=CHUNK,
                       device="cuda")
    torch.cuda.synchronize()
    t_pct = time.perf_counter() - t0
    launches = {"cell_update": cell_kernel.cell_update_cuda.launches,
                "hist_accum": hist_kernel.hist_accum_cuda.launches}
    pct_launches = launches["cell_update"] - fig2_launches
    log(f"[4] fig2 sweep (1440 cells x 50k arrivals) + exponential sweep "
        f"(96 cells): {t_fig2}s wall; "
        f"1M-arrival percentile run (12 cells): {t_pct}s wall; kernel "
        f"launches {json.dumps(launches)}, {pct_launches} of cell_update "
        f"in the percentile run")
    if launches["cell_update"] <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    # the sketch is binned inside cell_update: one launch a chunk
    if launches["hist_accum"] != 0 or \
            pct_launches != math.ceil(p_cfg.n_arrivals / CHUNK):
        raise AssertionError(f"the main path launched hist_accum, or not "
                             f"one cell_update a chunk: {launches}, "
                             f"{pct_launches} in the percentile run")
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

    # ------------------------------------------------------------ 9, 10
    counters = {"flash_attention": fa_kernel.flash_attention_cuda,
                "decode_attention": da_kernel.decode_attention_cuda,
                "ssd_scan": ssd_kernel_mod.ssd_intra_chunk_cuda,
                "rglru_scan": scan_kernel_mod.linear_scan_cuda}
    recs = {"ssd_scan": ssd_kernel(dev)}
    recurrent_full(dev, "mamba2-370m", 10, MAMBA_PROMPT, ("ssd_scan",))
    served = serve_path("mamba2-370m", 10, counters)
    if served["ssd_scan"] <= 0:
        raise AssertionError(f"ssd_scan never launched on mamba2-370m's "
                             f"served path: {served}")
    launches["ssd_scan"] = served["ssd_scan"]

    # ----------------------------------------------------------- 11, 12
    recs["rglru_scan"] = scan_kernel(dev)
    recurrent_full(dev, "recurrentgemma-9b", 12, RG_PROMPT,
                   ("rglru_scan", "flash_attention", "decode_attention"))
    served = serve_path("recurrentgemma-9b", 12, counters)
    if min(served[k] for k in ("rglru_scan", "flash_attention",
                               "decode_attention")) <= 0:
        raise AssertionError(f"a kernel of recurrentgemma-9b's served path "
                             f"never launched: {served}")
    launches["rglru_scan"] = served["rglru_scan"]
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
         "check_launches": hist_check_launches,
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
            "launches": launches[name], **a})
    for name, line in (("ssd_scan", 62), ("rglru_scan", 46)):
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}/kernel.py:{line}",
            "launches": launches[name], **recs[name]})
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
