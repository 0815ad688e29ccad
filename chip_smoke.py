#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py              # every phase; needs one card
    python3 chip_smoke.py --gates      # phases 1-3, 5-7, 9, 11, 15, gates recorded
    python3 chip_smoke.py --gates 16   # phase 16 alone (the seven models)
    python3 chip_smoke.py --gates 17   # phase 17 alone (training)
    python3 chip_smoke.py --gates 18   # phases 18 and 20 (model parallel)
    python3 chip_smoke.py --gates 19   # phase 19 alone (sharded serving)
    python3 chip_smoke.py --gates 21   # phase 21 alone (the dry run)
    python3 chip_smoke.py --faults     # --gates on planted faults F9-F22
    python3 chip_smoke.py --faults F12 F13 F14   # only those (+ control)

Phases, each printing its own lines; any failure raises and exits
nonzero:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, started together; each library's flags and build
     seconds), print the attention, cell_update and recurrent libraries'
     SASS instruction counts (wgmma, TMA, mbarrier, cp.async, mma.sync)
     and the card;
  2. hold the ``hist_accum`` kernel against its plain version: counts
     must be exactly equal, on uniform indices and on every input of
     ``interop.HIST_ACCUM_CASES`` (binned responses, all in one bin, all
     skipped, ragged T and C, several clusters along T, 1-8 cells a CTA,
     100 bins to ``MAX_BINS``, a running histogram, unaligned indices);
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
     chunk, and the percentile run's chunk with the sketch, one launch),
     and ``hist_accum`` on binned responses at the percentile chunk
     (T=4096, C=12) and at (4096, 1440), beside an empty launch of its
     plan, its plain version, ``index_put_`` and ``torch.bincount``;
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
     with masked SDPA); the device's kernels per call from a trace. Then
     both kernels, untimed, at the head shapes of phase 16's models, dense
     and causal (``ZOO_HEADS``: hd 128 at groups of 6, 7 and 8, hd 64 at
     groups of 1 and 3; S = 1000, a dense cache of 1100 slots at pos 1000;
     query scales 1 and 8), under the same gates, and both timed at
     command-r-35b's layer (S = 2048, a dense cache of 2056 slots) beside
     their plain versions, the bound and masked SDPA (no softcap: the same
     function). Then sharded serving's calls, gated and timed beside the
     whole call: ``flash_attention`` on rows 2,304-4,607 of gemma2-2b's
     4,608 at ``q_offset`` 2,304 over their causal prefix, global and
     windowed (also against the whole call's rows, bit for bit), and
     ``decode_attention`` with ``return_lse`` (its float32 output and
     log-sum-exp, the latter within 2^-6 of max(1, |lse|)) on the dense
     cache of 4,624 slots, one rank's block of 1,156, a block with no
     live slot (0 and -inf) and the wrapped ring;
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
     |plain| (tests/test_kernels.py); time both and the bound (split TF32
     on the tensor cores, beside the float32 CUDA-core bound) at 16 chunks
     and at one padded chunk;
 10. mamba2-370m at full width and depth (48 layers): a 4096-token prompt
     (16 chunks) and 16 decode steps, as phase 7 (every ``ssd_scan`` call
     also checked against its plain version; logits with the kernel within
     twice the plain path's float32-vs-bf16 distance, the float32 path
     being the whole model widened with ``.float()``); then serve 8
     requests on 2 hedged replicas through ``launch.serve.main`` with the
     launch counts read around exactly that run;
 11. hold the ``rglru_scan`` kernel against its plain version bit for bit
     at (1, 4096, 4096), ragged lengths and the served prompt's 16 steps;
     time both and the bound at (1, 4096, 4096), (1, 16, 4096) and
     (1, 2560, 4096);
 12. recurrentgemma-9b at full width and depth (38 layers, 8.5B
     parameters): a 2560-token prompt (past the window of 2048) and 16
     decode steps, as phase 10 with ``rglru_scan``, ``flash_attention`` and
     ``decode_attention`` checked per call; then serve 8 requests. Each
     model is freed before the next is made;
 13. the paper's figures through their user entry point,
     ``repro_torch.bench.run.main``, at full size (fig1-5, 12, 14, 15,
     the cross-system figure and the TCP table; one call a figure), each
     with its wall time and ``cell_update``/``hist_accum`` launches read
     around it, held to the paper's claims and the JAX package's test
     assertions (``figure_gates``: Theorem 1 in fig2 and fig4, the
     storage thresholds, memcached's loss, DNS tail and cost, the TCP
     savings, fig14's short-flow gain with the elephants unmoved, the
     cross-system order and its kernel-parity row); fig5 under
     ``torch.profiler``; every engine figure again with the plain
     version, bit-equal to the kernels (six at full size, fig3 and fig4
     at their smoke size: ``FULL_SIZE_PARITY``); and fig14's headline
     packet simulation on the card and on the CPU, delivery slots equal.
     The same phase runs the benchmarks beside the figures
     (``BENCH_MODULES``: sweep_engine at its smoke size, serving_hedge
     with 100k virtual requests, fig_policy_space, fig_fault_masking and
     roofline at full size), held to
     the JAX package's test assertions (``bench_gates``: the policy-space
     crossover, the fault-masking completed fractions and chaos booleans,
     the adaptive controller no worse and strictly better, the old and
     fused thresholds equal, chunked within a grid step, roofline
     fractions at most 1), and holds fig_policy_space and
     fig_fault_masking bit for bit against the plain version at their
     smoke size;
 14. the adaptive serving stack at full width, as the port's
     ``examples/serve_hedged`` drives it: ``threshold.policy_table`` with
     serving_hedge's full-size arguments (``cell_update`` launches read
     around exactly that call), then ``BatchedHedgedService`` over 4
     replicas of gemma2-2b (full width, cut to ``SERVE_STACK_DEPTH`` = 6
     layers for the script's budget; one shared model) replaying 32
     Poisson requests through ``replay_live`` with an
     ``AdaptiveController`` on that table, and 32 more at static k=2
     with replica r0 crashed a third of the way in: every request
     completes, its tokens equal a lone engine's, and both attention
     kernels launch in each run; the adaptive run once more under
     ``torch.profiler`` for the device's idle share;
 15. the sharded sweep executor (``repro_torch.distributed.sweep_shard``)
     on phase 4's runs: (a) the fig2 sweep through
     ``sweep_dists_sharded`` on 4 shards of the card and the 1M-arrival
     run on 5 (12 cells padded to 15); (b) ``threshold_grid_batch`` under
     ``use_sweep_mesh``; (c) two processes spawned by
     ``multihost.spawn``, each adding two slots on cuda:0 through
     ``multihost.initialize`` (gloo, a file store in a temporary
     directory), running the fig2 sweep as a plain ``queueing.run`` —
     each prints the rows it sampled against the whole block; (d)
     sweep_engine's sharded part at its smoke size. Each equals phase 4's
     unsharded kernel run bit for bit (mean, completed, every
     percentile; the thresholds; ``bit_identical=True``), with
     ``cell_update`` launched shards x chunks times in each; the walls of
     (a) and (c) are printed beside phase 4's;
 16. the other seven architectures of the JAX package at full width, one
     at a time, each freed before the next (``ZOO_RUNS``, ``lm_full``):
     gemma3-12b, nemotron-4-15b, command-r-35b and granite-moe-3b-a800m
     over 2048-token prompts (gemma3's ring of 1024 wraps), musicgen-large
     over 1024 frames of 4 codebooks, llava-next-34b over its 2,880 patches
     and 16 text tokens, deepseek-v3-671b at a depth of 3 (one dense MLA
     layer, two MLA-MoE layers: 50.9 GB) over 1024 tokens, each then 8
     teacher-forced decode steps: the parameters ``param_count`` counts,
     init seconds and peak memory, every attention kernel call checked
     against its plain version (the row gate of phases 5-6), the kernels'
     logits within twice the model's bf16 floor (the attention ops in
     float32) at every step, MoE models replaying the plain run's expert
     choices (``moe_routes``), prefill and decode times, the engine's
     greedy tokens against repeated prefill for the token-prompt models;
     then ``launch.serve.main`` serves 8 requests of command-r-35b and of
     granite-moe-3b-a800m on 2 hedged replicas, both attention kernels
     launching in each;
 17. training (``TRAIN_RUNS``; seed 0, Markov batches from the port's
     ``data.pipeline``): (a) gemma2-2b at full width and depth, its
     evaluation loss over 4608 tokens under ``torch.no_grad()`` with the
     kernels (``flash_attention`` launched once a layer, 26), with their
     plain versions and with the attention ops in float32: the kernels'
     loss within twice the plain path's float32 distance, at least
     ``EVAL_LOSS_RTOL`` of the loss; (b) 4 training steps of it through
     ``repro_torch.launch.train.main`` (AdamW, lr 1e-3, no checkpoint):
     losses and grad norms finite, no kernel launched (the gradient takes
     the plain versions), after the first step every parameter's
     gradient finite and not all zero and every float32 master moved by
     at most lr (1 + wd |p|) plus rounding; step times, tokens/s, peak
     memory, model FLOPs utilisation and one traced step's idle share;
     (c) mamba2-370m (48 layers) over 2 x 1024 tokens likewise,
     ``ssd_scan`` launched 48 times, the float32 yardstick the model
     widened; (d) the port's ``train_100m`` example (105M, 8 x 256
     tokens, hedged loader k=2) for 60 steps under deterministic
     algorithms, checkpoints every 20: the loss falls by at least 0.3;
     a second run fails at step 30 by the injected hook and resumes from
     step 20, its parameters and optimizer state equal to the first
     run's bit for bit; 12 steps with the deterministic algorithms off,
     for what they cost a step; (e) the example's trainable model refuses
     the kernels: ``loss_fn(kernel="auto")`` under grad raises, nothing
     launched;
 18. the model-parallel layer (``repro_torch.distributed``): four ranks
     spawned on cuda:0, joined over gloo through a file store, form a
     (data 2, model 2) mesh (``make_test_mesh``) and print which
     collectives gloo takes on CUDA tensors (the others are staged
     through pinned host buffers). (a) granite-moe-3b-a800m at full width
     and a depth of ``MP_DEPTH`` under its fsdp recipe (the batch over
     (data, model), experts over model, tokens gathered over model),
     AdamW, ``MP_STEPS`` steps of 8 x 1024 tokens through
     ``make_train_step(ctx=)`` on a ``ShardedModel`` drawn shard by shard
     from seed 0, the capacity raised so no token drops, replaying the
     expert choices of the same steps run unsharded first in this process
     on the same function (each EP group's rows, capacity and aux loss):
     each step's loss and grad norm within ``MP_LOSS_RTOL`` /
     ``MP_NORM_RTOL`` of the unsharded run's, every parameter after the
     last step within twice its distance in the unsharded run's float32
     copy, all finite;
     step times, peak memory per rank, collective bytes a step, the
     routing agreement without replay; (b) the sharded evaluation loss
     under ``torch.no_grad()`` with the kernels (``flash_attention``
     once a layer on each rank), their plain versions and the attention
     ops in float32, gated as 17(a); (c) the final state gathered, written
     by rank 0 and restored through ``elastic.reshard_state`` onto the
     (1, 2) mesh of ``plan_for(2, model_degree=2)`` and onto one device,
     bit-equal; (d) ``hierarchical_grad_reduce`` on (pod 2, data 2) and a
     2-stage ``pipeline_apply`` on the card at the JAX tests' tolerances;
 19. sharded serving (``repro_torch.models.decode`` under a ``ShardCtx``):
     four ranks on cuda:0 as phase 18's (data 2, model 2) mesh serve
     gemma2-2b at full width and a depth of ``SERVE_MP_DEPTH``, weights
     drawn shard by shard from seed 0 under the prefill layout's training
     specs, then moved one parameter at a time to the decode layout's
     inference blocks, read in place. (a) B = 2: a 4,608-token prompt
     with the sequence over ``model`` (2,304 rows a rank, K and V gathered,
     ``flash_attention`` at ``q_offset``), a cache of 4,624 slots, then 8
     teacher-forced decode steps with the KV slots over ``model``
     (``decode_attention`` with ``return_lse`` on each rank's block, the
     ranks' partial softmaxes combined); (b) B = 1: 4 steps with the KV
     slots over (data, model) on the cache of an unsharded 512-token
     prefill, every live slot on rank 0. Every attention call of every
     rank also run through its plain version (the row gate of phases 5-6,
     output and log-sum-exp); the logits of the prefill and of every step
     within twice the model's bf16 floor (phase 7's measure) of the same
     model unsharded in this process with the kernels, on the same
     weights (``lm.init`` from seed 0); both kernels launched on every
     rank; prefill and decode-step times, collective bytes and
     collectives a step, peak memory per rank;
 20. training under the sequence-sharded layout, inside phase 18's
     world: its four ranks form a (pod 2, data 1, model 2) mesh under
     ``make_layout(cfg, "train", multi_pod=True)`` (the sequence over
     pod, K and V gathered with gradients) and take SEQ_STEPS AdamW steps
     of phase 18's granite-moe-3b-a800m (aux weight 0) on 2 x 2,048
     tokens, the unsharded run's expert choices replayed; each step's
     loss and grad norm and step 0's gathered gradients against the
     unsharded run at phase 18's allowances, the sharded evaluation loss
     with ``flash_attention`` (one launch a layer a rank, the second pod
     rank's at ``q_offset``) gated as 18(b); bytes a rank a step;
 21. the dry run (``repro_torch.launch.dryrun``, subprocesses in
     parallel on the host): gemma2-2b ``train_4k`` on the multi-pod
     mesh (512 fake ranks, the sequence over pod) and mamba2-370m
     ``decode_32k`` on the single mesh, each record ok with FLOPs, their
     roofline rows on the H100's peaks; ungated, the dry run's temp
     bytes of phase 17's one-device gemma2-2b step beside the peak
     phase 17 measured.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. A kernel's ``launches`` there are those
of its main path's run (phase 4, 8, 10 or 12; the attention kernels'
``model_launches`` those of each phase-16 model's timed run and
``model_served_launches`` its served runs), ``cell_update``'s
``figure_launches`` those of phase 13's modules, ``serving_launches``
(``cell_update`` and the attention kernels) phase 14's, and
``cell_update``'s ``sharded_launches`` phase 15's (the spawned
processes' included), ``training_eval_launches`` (the attention
kernels, ``ssd_scan`` and ``rglru_scan``) phase 17's evaluation losses
and ``flash_attention``'s ``sharded_eval_launches`` phase 18's (its four
ranks') and ``sharded_seq_eval_launches`` phase 20's, the attention
kernels' ``sharded_serve_launches`` phase 19's (its four ranks');
``hist_accum``,
which no main path launches, reads 0 and gives its launches in phase 2 as
``check_launches``; its times are at the percentile chunk (its
``library_ms`` the ``index_put_`` call, ``bincount_ms`` and ``empty_ms``
beside it) and under ``wide`` at (4096, 1440). Needs CUDA and the repository's
``src/`` beside this script (or ``--src``); imports nothing of JAX or of
``repro``. ``--gates`` records every gate of phases 2, 3, 5-7, 9, 11 and
15, and of 16-21 where they are named (20 runs inside 18) (the worst multiple of its
allowance; a bit gate as 0 or inf; phase 15 runs its own unsharded
references; phase 16 skips its serving) instead of
stopping at the first that fails, and prints them as its last line;
``--faults`` runs it on a copy of the package for each planted fault of
``FAULTS`` over the phases that hold its kernel, the unedited package
first.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The H100's published peaks for the kernels' bounds: memory rate, the
# float32 rate outside the tensor cores, the bf16 and TF32 tensor-core
# rates. They live in ``repro_torch.device`` (with the roofline's); ``main``
# reads them once the package is on the path (``load_peaks``).
HBM_BYTES_PER_S = F32_OPS_PER_S = BF16_OPS_PER_S = TF32_OPS_PER_S = None

ATTN_TOL = 2e-2    # bf16 tolerance of tests/test_kernels.py, anywhere
ATTN_REL = 2**-6   # per row, of the row's largest |value|: two bf16 ulps
ATTN_ATOL = 1e-6
PROMPT = 4608      # prefill past gemma2-2b's window of 4096
DECODE_STEPS = 16
MAX_LEN = 4672     # dense (global-layer) cache: prompt + steps, rounded up
# phases 5-6: the head shapes of phase 16's models (arch, query heads, KV
# heads, head dim): groups of 6, 7 and 8 at hd 128, of 1 and 3 at hd 64
ZOO_HEADS = (("nemotron-4-15b", 48, 8, 128), ("llava-next-34b", 56, 8, 128),
             ("command-r-35b", 64, 8, 128), ("musicgen-large", 32, 32, 64),
             ("granite-moe-3b-a800m", 24, 8, 64))
ZOO_S = 1000       # flash_attention's sequence: a partial last tile
ZOO_L, ZOO_POS = 1100, 1000  # decode_attention's dense cache and position
CR_PROMPT = 2048   # command-r-35b's prompt in phase 16, timed in 5-6

FIG2_LOADS = 24
CHUNK = 4096


def load_peaks() -> None:
    """Read the card's peaks from ``repro_torch.device``."""
    global HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S, TF32_OPS_PER_S
    from repro_torch import device
    HBM_BYTES_PER_S, F32_OPS_PER_S = device.HBM_BYTES_PER_S, \
        device.F32_OPS_PER_S
    BF16_OPS_PER_S, TF32_OPS_PER_S = device.BF16_OPS_PER_S, \
        device.TF32_OPS_PER_S


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
    # --------------------------------------- 5, 6: sharded serving's calls
    # flash_attention with q_offset: the second half of a 4608-token
    # prompt (a rank's block of rows in a sequence-sharded prefill) over
    # its causal prefix, global and windowed; decode_attention with
    # return_lse: the dense cache of 4,624 slots whole, one rank's block
    # of it (1,156 slots), a block with no live slot, and the wrapped
    # ring; each timed beside the whole call
    half, off_rec = PROMPT // 2, {}
    for w in (None, window):
        q, k, v = bf16(b, PROMPT, h, hd), bf16(b, PROMPT, kv, hd), \
            bf16(b, PROMPT, kv, hd)
        qh = q[:, half:].contiguous()

        def offset_call(kernel, qh=qh, k=k, v=v, w=w):
            return fa_ops.flash_attention(qh, k, v, window=w, softcap=cap,
                                          q_offset=half, kernel=kernel)

        got, want = offset_call("on"), offset_call("off")
        shape = (f"H={h} KV={kv} rows {half}..{PROMPT - 1} of {PROMPT} "
                 f"(q_offset={half}) window={w} softcap={cap}")
        err = check_attention(f"flash_attention {shape}", got, want,
                              absolute=True, gate="phase 5",
                              raise_on_fail=raise_on_fail)
        fa_err = max(fa_err, err)
        whole = fa_ops.flash_attention(q, k, v, window=w, softcap=cap,
                                       kernel="on")
        log(f"[5] flash_attention {shape}: max abs err vs plain {err}, "
            f"worst row at {row_err(got, want)[1]} of its allowance; equal "
            f"to the whole call's rows bit for bit: "
            f"{bool(torch.equal(got, whole[:, half:]))}")
        if timed:
            off_rec[w] = dict(
                ms=cuda_ms(lambda: offset_call("on"), 10,
                           "flash_attention q_offset"),
                whole_ms=cuda_ms(lambda: fa_ops.flash_attention(
                    q, k, v, window=w, softcap=cap, kernel="on"), 10,
                    "flash_attention whole"))
            log(f"[5] flash_attention {shape}: {off_rec[w]['ms']} ms "
                f"against {off_rec[w]['whole_ms']} ms for the whole "
                f"{PROMPT} rows")
    length, pos = PROMPT + 16, PROMPT + 7
    blk = length // 4
    q, k, v = bf16(b, 1, h, hd), bf16(b, length, kv, hd), \
        bf16(b, length, kv, hd)
    s = torch.arange(length, device=dev, dtype=torch.int32)
    dense = torch.where(s <= pos, s, -1)
    ring_pos = 5000
    ring_slots = torch.where(s[:window] <= ring_pos,
                             ring_pos - (ring_pos - s[:window]) % window, -1)
    lse_rec = {}
    for case, kk, vv, slots, p_, w in (
            ("whole", k, v, dense, pos, None),
            ("a rank's block", k[:, blk:2 * blk], v[:, blk:2 * blk],
             dense[blk:2 * blk].contiguous(), pos, None),
            ("a block with no live slot", k[:, :blk], v[:, :blk],
             torch.full((blk,), -1, device=dev, dtype=torch.int32), pos,
             None),
            ("ring", k[:, :window], v[:, :window], ring_slots, ring_pos,
             window)):

        def lse_call(kernel, kk=kk, vv=vv, slots=slots, p_=p_, w=w):
            return da_ops.decode_attention(q, kk, vv, slots, p_, window=w,
                                           softcap=cap, return_lse=True,
                                           kernel=kernel)

        got, want = lse_call("on"), lse_call("off")
        err, ratio = attn_err(got, want)
        lse_d, lse_ratio = lse_err(got[1], want[1])
        record_gate("phase 6 row", ratio)
        record_gate("phase 6 2e-2", err / ATTN_TOL)
        record_gate("phase 6 lse", lse_ratio)
        shape = (f"{case} H={h} KV={kv} L={kk.shape[1]} pos={p_} "
                 f"window={w} softcap={cap}, return_lse")
        if not (err <= ATTN_TOL and ratio <= 1.0):
            msg = (f"decode_attention {shape} differs from its plain "
                   f"version: max abs err {err}, worst row (output and "
                   f"log-sum-exp) at {ratio} of its allowance")
            if raise_on_fail:
                raise AssertionError(msg)
            log(f"    gate failed: {msg}")
        da_err = max(da_err, err)
        log(f"[6] decode_attention {shape}: max abs err vs plain {err} "
            f"(output), {lse_d} (log-sum-exp, worst at {lse_ratio} of "
            f"2^-6 of max(1, |lse|)); live slots "
            f"{int(((slots >= 0) & (slots <= p_)).sum())}")
        if timed and case in ("whole", "a rank's block"):
            lse_rec[case] = dict(
                ms=cuda_ms(lambda: lse_call("on"), 50,
                           "decode_attention return_lse"),
                whole_ms=cuda_ms(lambda: da_ops.decode_attention(
                    q, k, v, dense, pos, softcap=cap, kernel="on"), 50,
                    "decode_attention whole"))
            log(f"[6] decode_attention {shape}: {lse_rec[case]['ms']} ms "
                f"against {lse_rec[case]['whole_ms']} ms for the whole "
                f"cache without the log-sum-exp")
    # ------------------------------------------------ 5, 6: the other models
    # the head shapes of phase 16's models, dense and causal, untimed but
    # command-r-35b's layer (S = 2048, a dense cache of 2056 slots)
    for arch, nh, nkv, hd_ in ZOO_HEADS:
        for qs in (1, 8):
            q, k, v = qs * bf16(b, ZOO_S, nh, hd_), bf16(b, ZOO_S, nkv, hd_), \
                bf16(b, ZOO_S, nkv, hd_)
            got, want = (fa_ops.flash_attention(q, k, v, kernel=mode)
                         for mode in ("on", "off"))
            shape = f"{arch} H={nh} KV={nkv} hd={hd_} S={ZOO_S}"
            err = check_attention(f"flash_attention {shape}", got, want,
                                  absolute=qs == 1, gate="phase 5",
                                  raise_on_fail=raise_on_fail)
            fa_err = max(fa_err, err) if qs == 1 else fa_err
            log(f"[5] flash_attention {shape} query scale {qs}: max abs err "
                f"vs plain {err}, worst row at {row_err(got, want)[1]} of its "
                f"allowance")
            q = qs * bf16(b, 1, nh, hd_)
            k, v = bf16(b, ZOO_L, nkv, hd_), bf16(b, ZOO_L, nkv, hd_)
            s = torch.arange(ZOO_L, device=dev, dtype=torch.int32)
            slots = torch.where(s <= ZOO_POS, s, -1)
            got, want = (da_ops.decode_attention(q, k, v, slots, ZOO_POS,
                                                 kernel=mode)
                         for mode in ("on", "off"))
            shape = f"{arch} dense H={nh} KV={nkv} hd={hd_} L={ZOO_L} " \
                    f"pos={ZOO_POS}"
            err = check_attention(f"decode_attention {shape}", got, want,
                                  absolute=qs == 1, gate="phase 6",
                                  raise_on_fail=raise_on_fail)
            da_err = max(da_err, err) if qs == 1 else da_err
            log(f"[6] decode_attention {shape} query scale {qs}: max abs err "
                f"vs plain {err}, worst row at {row_err(got, want)[1]} of its "
                f"allowance")
    if not timed:
        return {}
    nh, nkv, hd_ = 64, 8, 128  # command-r-35b's layer
    s = CR_PROMPT
    q, k, v = bf16(b, s, nh, hd_), bf16(b, s, nkv, hd_), bf16(b, s, nkv, hd_)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    cr_fa = dict(
        ms=cuda_ms(lambda: fa_ops.flash_attention(q, k, v, kernel="on"), 10,
                   "flash_attention"),
        plain_ms=cuda_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                        kernel="off"), 3,
                         "flash_attention plain"),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10, "sdpa"))
    pairs = s * (s + 1) // 2
    cr_fa["bound_ms"], cr_fa["bound_by"] = bound(
        2 * (2 * b * s * nh * hd_ + 2 * b * s * nkv * hd_),
        4 * hd_ * nh * b * pairs, BF16_OPS_PER_S)
    length, pos = CR_PROMPT + 8, CR_PROMPT + 7
    q = bf16(b, 1, nh, hd_)
    k, v = bf16(b, length, nkv, hd_), bf16(b, length, nkv, hd_)
    slots = torch.arange(length, device=dev, dtype=torch.int32)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    cr_da = dict(
        ms=cuda_ms(lambda: da_ops.decode_attention(q, k, v, slots, pos,
                                                   kernel="on"), 50,
                   "decode_attention"),
        plain_ms=cuda_ms(lambda: da_ops.decode_attention(
            q, k, v, slots, pos, kernel="off"), 20, "decode_attention plain"),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=(slots <= pos)[None, None, None, :],
            enable_gqa=True), 50, "sdpa"))
    cr_da["bound_ms"], cr_da["bound_by"] = bound(
        2 * 2 * length * b * nkv * hd_, 4 * hd_ * nh * b * length,
        BF16_OPS_PER_S)
    for name, rec in (("flash_attention", cr_fa), ("decode_attention", cr_da)):
        rec["library"] = ("torch.nn.functional.scaled_dot_product_attention "
                          "(causal or masked: the same function, no softcap)")
        log(f"[6] {name} at command-r-35b's layer (H=64 KV=8 hd=128, "
            f"{'S=2048' if name == 'flash_attention' else 'L=2056'}): "
            f"{json.dumps(rec)}")
    for key, rec in (("flash_attention recurrentgemma-9b local layer",
                      fa[(mq_h, mq_w)]),
                     ("decode_attention recurrentgemma-9b ring",
                      da[(mq_h, "ring")]),
                     ("flash_attention gemma2-2b local layer",
                      fa[(h, window)]),
                     ("decode_attention gemma2-2b ring", da[(h, "ring")])):
        log(f"[6] {key}: {json.dumps(rec)}")
    return {"flash_attention": dict(fa[(h, None)], max_abs_err=fa_err,
                                    command_r_35b=cr_fa,
                                    q_offset={str(w): r for w, r in
                                              off_rec.items()}),
            "decode_attention": dict(da[(h, "dense")], max_abs_err=da_err,
                                     command_r_35b=cr_da,
                                     return_lse=lse_rec)}


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
            "decode_attention": (da_ops, "decode_attention", attn_err),
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


@contextlib.contextmanager
def moe_routes(record: list, agree: list | None = None):
    """Every ``repro_torch.models.moe.route`` called inside records its
    top-k indices in ``record`` (``agree`` None) or replays them: it takes
    the next indices of ``record`` instead of its own choice (combine
    weights, queue positions and drops are still computed from this run's
    router logits) and appends (matching choices, choices) of its own
    against them to ``agree`` as device tensors. Replaying one run's
    choices in another keeps a near-tie that a bf16 ulp flips from routing
    a token elsewhere, while every other difference between the runs still
    reaches the logits."""
    from repro_torch.models import moe

    orig = moe.route
    replay = iter(record) if agree is not None else None

    def route(router_w, xt, cfg):
        out = orig(router_w, xt, cfg)
        if replay is None:
            record.append(out[0])
            return out
        idx = next(replay)
        agree.append(((out[0] == idx).sum(), idx.numel()))
        logits = moe.router_logits(router_w, xt, cfg)
        return (idx, *moe.combine(logits, idx, cfg))

    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


def agreement(pairs) -> float | None:
    """The share of matching choices over ``moe_routes``' pairs."""
    if not pairs:
        return None
    return float(sum(int(a) for a, _ in pairs)) / sum(n for _, n in pairs)


def lm_full(dev, arch: str = "gemma2-2b", phase: int = 7,
            prompt: int = PROMPT, steps: int = DECODE_STEPS, *, cfg=None,
            max_len: int | None = MAX_LEN,
            modes=("checked", "on", "off", "off32", "on"),
            trace: bool = True) -> dict:
    """Phases 7 and 16: ``arch`` at full width (``cfg`` where its depth is
    cut), random weights from the port's own init on the card, a
    ``prompt``-token prefill (a VLM's patches before it, an audio model's
    K codebooks a token) and ``steps`` teacher-forced decode steps (a
    dense cache of ``max_len`` slots; None: the positions the run fills),
    in ``modes``: ``checked`` with every attention kernel call also run
    through its plain version on the same inputs (the row gate of phases
    5-6 at every layer and step), ``on`` the kernels (timed; the last one's
    launches are the model's), ``off`` the plain versions, ``off32`` the
    plain versions with the attention ops in float32. The kernels' logits
    within twice the float32 path's distance from the plain path (the
    model's bf16 noise floor) at every step. MoE models replay the first
    plain run's expert choices in every other gated run (``moe_routes``)
    and gate the ``checked`` run's logits; the ``on`` run keeps its own
    choices, whose share agreeing with the plain run's is printed. The
    parameters ``param_count`` counts (``lm.counted_params``), init
    seconds, peak memory, prefill and decode times; for a model the engine
    serves (token prompts), its greedy tokens equal repeated-prefill argmax.
    Runs every check before it raises, listing each that failed; frees the
    model. Returns the ``on`` run's kernel launches and the timings."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import decode, lm

    tag = f"[{phase}]"
    cfg = cfg or get_config(arch)
    counters = {"flash_attention": fa_kernel.flash_attention_cuda,
                "decode_attention": da_kernel.decode_attention_cuda}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(torch.Generator(dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = lm.counted_params(model)
    failed = []
    log(f"{tag} {arch}: {cfg.n_layers} layers {cfg.layer_kinds[:4]}..., "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"KV of {cfg.head_dim}, vocab {cfg.vocab_size}, {n_params} counted "
        f"parameters (param_count {cfg.param_count}; "
        f"{sum(p.numel() for p in model.parameters())} in all), init "
        f"{t_init}s, {torch.cuda.memory_allocated() / 1e9} GB allocated")
    if n_params != cfg.param_count:
        failed.append(f"{n_params} counted parameters, not param_count "
                      f"{cfg.param_count}")
    rng = np.random.default_rng(17 if phase == 7 else 1600 + len(arch))
    audio = cfg.family == "audio"
    shape = (1, prompt + steps) + ((cfg.n_codebooks,) if audio else ())
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    patches, n_patch = None, 0
    if cfg.patch_stub is not None:
        n_patch = cfg.patch_stub.n_patches
        patches = torch.from_numpy(rng.standard_normal(
            (1, n_patch, cfg.patch_stub.embed_dim)).astype(np.float32)).to(dev)
    max_len = max_len or n_patch + prompt + steps
    is_moe = cfg.moe is not None
    runs, worst, launches, times = {}, {}, {}, {}
    record, on_record, agree = [], [], {}
    for mode in modes:
        kernel = "off" if mode.startswith("off") else "on"
        with contextlib.ExitStack() as stack:
            if mode == "off32":
                stack.enter_context(float32_attention())
            if mode == "checked":
                stack.enter_context(checked_against_plain(worst))
            if is_moe and not record:  # the first run, plain: its choices
                if mode != "off":
                    raise ValueError("an MoE model's first run is plain")
                stack.enter_context(moe_routes(record))
            elif is_moe and mode == "on":  # the timed run: its own choices
                on_record.clear()
                stack.enter_context(moe_routes(on_record))
            elif is_moe:  # the gated runs replay the plain run's
                agree[mode] = []
                stack.enter_context(moe_routes(record, agree[mode]))
            if mode == "on":
                for fn in counters.values():
                    fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode.prefill(model, toks[:, :prompt], max_len,
                                           patches=patches, kernel=kernel)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            out = [logits]
            t0 = time.perf_counter()
            for i in range(steps):
                logits, cache = decode.decode_step(
                    model, cache, toks[:, prompt + i:prompt + i + 1],
                    n_patch + prompt + i, kernel=kernel)
                out.append(logits)
            torch.cuda.synchronize()
            t_dec = (time.perf_counter() - t0) / steps
        if mode == "on":
            launches = {name: fn.launches for name, fn in counters.items()}
            times = {"prefill_ms": t_pre * 1e3, "decode_ms": t_dec * 1e3}
        runs[mode] = torch.stack(out)[:, 0]
        del cache
        log(f"{tag} {mode}: prefill of {n_patch + prompt} positions "
            f"{t_pre * 1e3} ms, decode {t_dec * 1e3} ms per token ({steps} "
            f"steps)")
    if is_moe:
        own = agreement([((a == b).sum(), a.numel())
                         for a, b in zip(on_record, record)])
        log(f"{tag} expert choices (token, slot) agreeing with the first "
            f"plain run's, of {sum(a.numel() for a in record)}: the timed "
            f"kernel run's own {own}; the replayed runs' own "
            f"{json.dumps({m: agreement(a) for m, a in agree.items()})}")
        del record, on_record, agree
    for name in counters:
        n, err, ratio = worst.get(name, (0, 0.0, 0.0))
        log(f"{tag} {name} at every layer and step of the kernel run ({n} "
            f"calls), against its plain version on the same inputs: max abs "
            f"err {err}, worst row at {ratio} of its allowance")
        record_gate(f"phase {phase} per-call {name}",
                    ratio if n else (0.0 if cfg.mla else math.inf))
        # MLA's attention is plain, as the JAX package serves it: deepseek
        # launches neither kernel
        if (n == 0 and cfg.mla is None) or not ratio <= 1.0:
            failed.append(f"{name} over the model: {n} calls, worst row at "
                          f"{ratio} of 2^-6 of its largest value")
    gated = runs["checked" if is_moe else "on"]
    off, off32 = runs["off"], runs["off32"]
    want = (steps + 1, *((cfg.n_codebooks,) if audio else ()), cfg.vocab_size)
    if tuple(gated.shape) != want or \
            not all(bool(torch.isfinite(x).all()) for x in runs.values()):
        record_gate(f"phase {phase} logits", math.inf)
        raise AssertionError(f"{arch}: logits of shape {tuple(gated.shape)} "
                             f"(not {want}) or not finite; "
                             + "; ".join(failed))
    diffs = (gated - off).abs().flatten(1).amax(dim=1).tolist()
    floor = (off32 - off).abs().flatten(1).amax(dim=1).tolist()
    # the kernels may differ from the plain path by no more than twice the
    # plain path's own bf16 noise floor (the rule of tests/test_torch_lm.py);
    # a model with no attention kernel (MLA) must equal it
    bound_ = 2 * max(floor)
    record_gate(f"phase {phase} logits",
                max(diffs) / bound_ if bound_ else
                (0.0 if max(diffs) == 0 else math.inf))
    log(f"{tag} max abs logit difference, prefill then each decode step: "
        f"kernels vs plain {json.dumps(diffs)}; plain with float32 attention "
        f"vs plain {json.dumps(floor)}; bound 2 x {max(floor)} = {bound_}; "
        f"largest |logit| {float(gated.abs().max())}, final softcap "
        f"{cfg.final_softcap}")
    if max(diffs) > bound_:
        failed.append(f"kernels' and plain path's logits differ by "
                      f"{max(diffs)} > {bound_}")
    for name, x in (("kernels", gated), ("float32 plain", off32)):
        agree_tok = float((x.argmax(-1) == off.argmax(-1)).float().mean())
        log(f"{tag} greedy tokens of the {name} path agree with the plain "
            f"path's at {agree_tok} of the {steps + 1} positions")
    del runs, gated, off, off32

    if trace:
        _, cache = decode.prefill(model, toks[:, :prompt], max_len)

        def decode_run():
            c = cache
            for i in range(steps):
                _, c = decode.decode_step(
                    model, c, toks[:, prompt + i:prompt + i + 1], prompt + i)

        tr = traced(decode_run)
        log(f"{tag} trace of {steps} decode steps (kernels): "
            f"{json.dumps(tr)}")
        del cache
    if not audio and patches is None:
        engine_check(model, cfg, dev, rng, failed, tag)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} {arch}: peak memory {peak} GB "
        f"(torch.cuda.max_memory_allocated); kernel launches of the timed "
        f"run {json.dumps(launches)}")
    del model
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase {phase} {arch}: " + "; ".join(failed))
    return dict(launches=launches, init_s=t_init, peak_gb=peak, **times)


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


def ssd_bound(n_chunks: int) -> dict:
    """Bounds of ``ssd_scan`` at ``n_chunks`` chunks of mamba2-370m's shape:
    bytes (x, B, C, dt, cum read and y, states written once) against the
    three products' flops, three times over (split TF32) at the dense TF32
    rate, plus the weights' and gates' elementwise operations at the
    float32 rate; beside it the bound of the same work in float32 on the
    CUDA cores."""
    bc_n, (q, h, p, n) = n_chunks, SSD_SHAPE
    pairs = q * (q + 1) // 2
    # C B^T once per chunk over the causal half, W X and the state product
    # per head
    products = (bc_n * pairs * n * 2 + bc_n * h * pairs * p * 2
                + bc_n * h * q * p * n * 2)
    # per (pair, head) the weight: a subtraction, exp and two products; per
    # (row, head) the gate (a subtraction, exp and a product) and X gate
    elementwise = bc_n * h * (pairs * 4 + q * (3 + p))
    n_bytes = 4 * (2 * bc_n * q * h * p + 2 * bc_n * q * n + 2 * bc_n * q * h
                   + bc_n * h * p * n)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 3 * products / TF32_OPS_PER_S + elementwise / F32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                f32_bound_ms=1e3 * max(t_bytes, (products + elementwise)
                                       / F32_OPS_PER_S),
                products=products, elementwise=elementwise, n_bytes=n_bytes)


def ssd_kernel(dev, timed: bool = True, raise_on_fail: bool = True) -> dict:
    """Phase 9: ``ssd_scan`` against its plain version at mamba2-370m's
    shape; times and bounds at the 4096-token prefill's 16 chunks and at a
    served prompt's one padded chunk. ``raise_on_fail`` False records each
    case's worst element in ``GATES`` and goes on (``--gates``)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    worst = 0.0
    for n_chunks, model_like, valid in ((1, False, None), (16, False, None),
                                        (1, True, None), (16, True, None),
                                        (1, True, 16)):
        args = ssd_inputs(dev, n_chunks, model_like, valid, 9 + n_chunks)
        got = ssd_ops.ssd_intra_chunk(*args, kernel="on")
        want = ssd_ops.ssd_intra_chunk(*args, kernel="off")
        err, ratio = ssd_err(got, want)
        case = (f"{n_chunks} chunk(s), "
                f"{'model-like' if model_like else 'standard normal'}"
                f"{f', {valid} valid rows' if valid else ''}")
        record_gate(f"phase 9 {case}", ratio)
        log(f"[9] ssd_scan {n_chunks} chunk(s) of Q={SSD_SHAPE[0]}, H="
            f"{SSD_SHAPE[1]}, P={SSD_SHAPE[2]}, N={SSD_SHAPE[3]}, inputs "
            f"{'as the model makes them' if model_like else 'standard normal'}"
            f"{f', {valid} valid rows (padded chunk)' if valid else ''}: max "
            f"abs err vs plain {err}, worst element at {ratio} of its "
            f"allowance {SSD_TOL} + {SSD_TOL}|plain| (largest |y| "
            f"{float(want[0].abs().max())}, |state| "
            f"{float(want[1].abs().max())})")
        if not ratio <= 1.0:
            msg = (f"ssd_scan differs from its plain version ({case}): worst "
                   f"element at {ratio} of its allowance")
            if raise_on_fail:
                raise AssertionError(msg)
            log(f"    gate failed: {msg}")
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
    if not timed:
        return {}
    shapes = []
    for n_chunks, valid in ((16, None), (1, 16)):
        args = ssd_inputs(dev, n_chunks, True, valid, 99)
        ms = cuda_ms(lambda: ssd_ops.ssd_intra_chunk(*args, kernel="on"), 20,
                     "ssd_scan")
        plain = cuda_ms(lambda: ssd_ops.ssd_intra_chunk(*args, kernel="off"),
                        5, "ssd_scan plain")
        b = ssd_bound(n_chunks)
        shapes.append(dict(shape=[1, n_chunks, *SSD_SHAPE], valid_rows=valid,
                           ms=ms, plain_ms=plain, bound_ms=b["bound_ms"],
                           bound_by=b["bound_by"]))
        log(f"[9] ssd_scan at {n_chunks} chunk(s)"
            f"{f' ({valid} valid rows: a served prompt)' if valid else ''}: "
            f"kernel {ms} ms, plain {plain} ms, bound {b['bound_ms']} ms "
            f"({b['bound_by']}; {b['products']} flops of products x 3 at "
            f"{TF32_OPS_PER_S} TF32, {b['elementwise']} elementwise at "
            f"{F32_OPS_PER_S}, {b['n_bytes']} bytes; the bound counts every "
            f"row of the chunk), float32 CUDA-core bound "
            f"{b['f32_bound_ms']} ms; no single PyTorch call computes it")
    table = shapes[0]
    return dict(ms=table["ms"], plain_ms=table["plain_ms"],
                bound_ms=table["bound_ms"], bound_by=table["bound_by"],
                library_ms=None, max_abs_err=worst, served=shapes[1])


def scan_kernel(dev, timed: bool = True, raise_on_fail: bool = True) -> dict:
    """Phase 11: ``rglru_scan`` against its plain version, bit for bit, at
    recurrentgemma-9b's width; times and bound at (1, 4096, 4096) (the
    table's shape), (1, 16, 4096) (a served prompt) and (1, 2560, 4096)
    (phase 12's prefill). ``raise_on_fail`` False records each shape's bit
    gate in ``GATES`` and goes on (``--gates``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rglru_scan import ops as scan_ops

    g = torch.Generator(dev).manual_seed(11)
    timed_shapes = ((1, 4096, SCAN_W), (1, 16, SCAN_W), (1, RG_PROMPT, SCAN_W))
    rec, shapes = {}, []
    for shape in ((1, 4096, SCAN_W), (1, 2573, SCAN_W), (2, 77, SCAN_W),
                  (1, 16, SCAN_W), (1, RG_PROMPT, SCAN_W)):
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
        bit_gate(f"phase 11 {shape}", ratio == 0.0,
                 f"rglru_scan {shape} is not bit-equal to its plain version "
                 f"(max abs diff {err})", raise_on_fail)
        if timed and shape in timed_shapes:
            ms = cuda_ms(lambda: scan_ops.linear_scan(a, b, kernel="on"), 20,
                         "rglru_scan")
            plain = cuda_ms(lambda: scan_ops.linear_scan(a, b, kernel="off"),
                            2, "rglru_scan plain")
            n = a.numel()
            bms, by = bound(3 * 4 * n, 2 * n, F32_OPS_PER_S)
            log(f"[11] rglru_scan {shape}: kernel {ms} ms, plain {plain} ms, "
                f"bound {bms} ms ({by}); no single PyTorch call computes it")
            shapes.append(dict(shape=list(shape), ms=ms, plain_ms=plain,
                               bound_ms=bms, bound_by=by))
    if timed:
        table = shapes[0]
        rec = dict(ms=table["ms"], plain_ms=table["plain_ms"],
                   bound_ms=table["bound_ms"], bound_by=table["bound_by"],
                   library_ms=None, max_abs_err=0.0, served=shapes[1],
                   prefill=shapes[2])
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
    equal repeated-prefill argmax. An MoE model runs the check with its
    capacity factor raised so that no token is dropped: decode never drops
    one (a slot an expert for each batch row, as in the JAX package), and
    the prefill of the grown prompt would drop the new token where an
    expert's queue is full, which is another function."""
    import dataclasses

    import torch

    from repro_torch.models import decode
    from repro_torch.serving.engine import InferenceEngine

    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k + 1))
    saved, model.cfg = model.cfg, cfg
    try:
        eng = InferenceEngine(cfg, model, max_len=128, name="check",
                              device=dev)
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
    finally:
        model.cfg = saved
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


# Phase 16: the other seven architectures at full width, one at a time
# (arch, prompt tokens; llava's prompt follows its 2,880 patches, musicgen's
# are frames of 4 codebooks), each with ZOO_STEPS teacher-forced steps.
# gemma3's 2048 tokens pass its window of 1024: its ring wraps.
ZOO_RUNS = (("gemma3-12b", CR_PROMPT),
            ("nemotron-4-15b", CR_PROMPT), ("command-r-35b", CR_PROMPT),
            ("musicgen-large", 1024), ("llava-next-34b", 16),
            ("granite-moe-3b-a800m", CR_PROMPT), ("deepseek-v3-671b", 1024))
ZOO_STEPS = 8
ZOO_SERVED = ("command-r-35b", "granite-moe-3b-a800m")


def zoo_config(arch: str):
    """``arch``'s full config; deepseek-v3-671b's cut to a depth of 3 (one
    dense MLA layer and two MLA-MoE layers, 50.9 GB at full width: the
    whole model's 1,342 GB does not fit one card)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, n_layers=3, prefix=("mla",),
                                  moe=dataclasses.replace(cfg.moe,
                                                          first_dense=1))
    return cfg


def zoo_models(dev, counters: dict | None,
               raise_on_fail: bool = True) -> dict:
    """Phase 16: each of ``ZOO_RUNS`` through ``lm_full`` (every model
    freed before the next is made), then ``launch.serve.main`` on each of
    ``ZOO_SERVED`` (``serve_path``; both attention kernels must launch);
    ``counters`` None skips the serving (``--gates``). Runs every model
    before it raises. Returns the models' and the served runs' kernel
    launches."""
    t_phase = time.perf_counter()
    failed, model_launches, served = [], {}, {}
    for arch, prompt in ZOO_RUNS:
        try:
            out = lm_full(dev, arch, 16, prompt, ZOO_STEPS,
                          cfg=zoo_config(arch), max_len=None,
                          modes=("off", "checked", "on", "off32"),
                          trace=False)
            model_launches[arch] = out["launches"]
        except AssertionError as exc:
            failed.append(str(exc))
            log(f"    gate failed: {exc}")
    for arch in ZOO_SERVED if counters is not None else ():
        served[arch] = {k: v for k, v in serve_path(arch, 16,
                                                    counters).items()
                        if k in ("flash_attention", "decode_attention")}
        if min(served[arch].values()) <= 0:
            failed.append(f"an attention kernel of {arch}'s served path "
                          f"never launched: {served[arch]}")
    log(f"[16] phase 16: {time.perf_counter() - t_phase}s (budget 200 s)")
    if failed and raise_on_fail:
        raise AssertionError("phase 16: " + "; ".join(failed))
    return {"model_launches": model_launches, "served_launches": served}


# Phase 17: training. (arch, sequence length, batch) of the full-width runs:
# the evaluation loss three ways, then TRAIN_STEPS steps through
# launch.train.main; then the port's train_100m example.
TRAIN_RUNS = (("gemma2-2b", PROMPT, 1), ("mamba2-370m", 1024, 2))
TRAIN_STEPS = 4
TRAIN_LR = 1e-3
TRAIN_SMOKE = False  # the smoke configs (the CPU rehearsal)
# the example: EXAMPLE_STEPS steps with a checkpoint every EXAMPLE_EVERY,
# a run that fails at EXAMPLE_FAIL and resumes, then EXAMPLE_TIMED steps
# with the deterministic algorithms off
EXAMPLE_ARGS = ["--seq-len", "256", "--batch", "8"]
EXAMPLE_STEPS, EXAMPLE_EVERY, EXAMPLE_FAIL, EXAMPLE_TIMED = 60, 20, 30, 12
EXAMPLE_LR, EXAMPLE_FALL = 3e-4, 0.3  # the example's lr; the JAX test's fall
# the evaluation loss gate's least allowance, relative to the plain loss,
# where twice the plain path's float32-vs-bf16 distance is smaller (a mean
# over thousands of tokens, whose rounding errors cancel): the CPU tests'
# loss tolerance, at the JAX package's own noise (tests/test_torch_train_
# lm.py). On an H100 the kernels' loss sat 4.6e-5 (gemma2-2b) and 3.2e-4
# (mamba2-370m) of the loss from the plain path's.
EVAL_LOSS_RTOL = 1e-3


def _kernel_layers(cfg) -> dict:
    """Per kernel, the layers whose forward launches it once."""
    kinds = cfg.layer_kinds
    return {"flash_attention": sum(k in ("global", "local", "global_moe")
                                   for k in kinds),
            "ssd_scan": sum(k == "ssd" for k in kinds),
            "rglru_scan": sum(k == "rec" for k in kinds)}


def _attention_flops(cfg, seq: int, batch: int) -> float:
    """The attention products a training step needs beyond 6 x params x
    tokens: Q K^T and P V over the causal pairs (a local layer's within
    its window), 4 flops a pair, head and head dim, times 3 for forward
    and backward."""
    pairs = {"global": seq * (seq + 1) / 2}
    w = min(cfg.window, seq)
    pairs["local"] = w * (w + 1) / 2 + (seq - w) * w
    n = sum(pairs.get("global" if k == "global_moe" else k, 0.0)
            for k in cfg.layer_kinds)
    return 3 * 4 * n * cfg.n_heads * cfg.head_dim * batch


def eval_loss(dev, arch: str, cfg, seq: int, batch: int, counters: dict,
              failed: list) -> dict:
    """Phase 17 (a)/(c): ``lm.loss_fn`` of a fresh model (seed 0) on a
    Markov batch, under ``torch.no_grad()``, with the kernels
    (``kernel="auto"``, launches counted), their plain versions
    (``"off"``) and the plain versions in float32 (the attention ops, or
    for a model without attention the whole model widened): the kernels'
    loss within twice the plain path's float32 distance, at least
    ``EVAL_LOSS_RTOL`` of it; each kernel of the model's layers launched
    once a layer."""
    import copy

    import torch

    from repro_torch.data.pipeline import DataConfig, MarkovSource
    from repro_torch.models import lm

    model = lm.init(torch.Generator(dev).manual_seed(0), cfg)
    src = MarkovSource(cfg, DataConfig(seq_len=seq, batch_size=batch))
    tb = {k: torch.from_numpy(v).to(dev) for k, v in src.batch_at(0).items()}
    want = {k: n for k, n in _kernel_layers(cfg).items() if n}
    attn = "flash_attention" in want
    losses, ms, launches = {}, {}, {}
    with torch.no_grad():
        for mode in ("auto", "off", "off32"):
            m, ctx = model, contextlib.nullcontext()
            if mode == "off32":
                if attn:
                    ctx = float32_attention()
                else:
                    m = copy.deepcopy(model).float()
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx:
                _, metrics = lm.loss_fn(m, tb, kernel="auto" if
                                        mode == "auto" else "off")
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) * 1e3
            losses[mode] = float(metrics["loss"])
            if mode == "auto":
                launches = {k: fn.launches for k, fn in counters.items()}
            del m
    diff = abs(losses["auto"] - losses["off"])
    floor = abs(losses["off32"] - losses["off"])
    bound_ = max(2 * floor, EVAL_LOSS_RTOL * abs(losses["off"]))
    record_gate(f"phase 17 {arch} eval loss", diff / bound_)
    log(f"[17] {arch} evaluation loss over {batch} x {seq} tokens "
        f"(no_grad): kernels {losses['auto']}, plain {losses['off']}, plain "
        f"in float32 {losses['off32']}; |kernels - plain| {diff}, bound "
        f"max(2 x {floor}, {EVAL_LOSS_RTOL} x |plain|) = {bound_}; ms "
        f"{json.dumps(ms)}; kernel launches {json.dumps(launches)} (one a "
        f"layer: {json.dumps(want)})")
    if not all(math.isfinite(x) for x in losses.values()) or diff > bound_:
        failed.append(f"{arch} evaluation loss: kernels {losses['auto']} vs "
                      f"plain {losses['off']}, bound {bound_}")
    for name, n in want.items():  # the CPU (a rehearsal) launches none
        if launches.get(name) != (n if dev.type == "cuda" else 0):
            failed.append(f"{arch} evaluation loss launched {name} "
                          f"{launches.get(name)} times, not {n}")
    del model
    torch.cuda.empty_cache()
    return {"loss": losses, "ms": ms, "launches": launches}


def first_step_check(dev, model, opt_state, lr: float, wd: float) -> dict:
    """After a run's first step (seed 0): every parameter's gradient is
    finite and not all zero, and AdamW moved each float32 master from the
    initial weights (drawn again from the seed) by at most lr (1 + wd |p|)
    plus rounding: the worst share of that allowance."""
    import torch

    from repro_torch.models import lm

    p0 = dict(lm.init(torch.Generator(dev).manual_seed(0),
                      model.cfg).named_parameters())
    bad, worst = [], 0.0
    with torch.no_grad():
        for name, p in model.named_parameters():
            g = p.grad
            if g is None or not bool(torch.isfinite(g).all()) or \
                    not bool((g != 0).any()):
                bad.append(name)
            w0 = p0.pop(name).float()
            allow = (lr * (1 + wd * w0.abs()) * (1 + 1e-5)
                     + w0.abs() * 2.0**-23)
            worst = max(worst, float(((opt_state["master"][name] - w0).abs()
                                      / allow).max()))
    return {"bad_grads": bad, "first_step_move": worst}


def train_run(dev, label: str, entry, argv: list[str], counters: dict,
              failed: list, lr: float, wd: float,
              check_first: bool = True) -> dict:
    """``entry(argv, on_step=...)`` (``launch.train.main`` or the
    example's ``main``) with the kernels' launch counts set to 0 just
    before and read just after (training launches none: its gradient
    takes the plain versions), each step timed on the host clock from its
    batch to its end (``synchronize``), the peak memory, and after step 0
    ``first_step_check``. Returns the trainer's result with ``step_s``
    and the checks."""
    import torch

    from repro_torch.training import train_loop

    marks: dict[int, list[float]] = {}
    checks: dict = {}
    peak = [0.0]
    orig_batch = train_loop.Trainer._batch

    def batch(self, step):
        torch.cuda.synchronize()
        marks[step] = [time.perf_counter()]
        return orig_batch(self, step)

    def on_step(step, model, opt_state, metrics):
        torch.cuda.synchronize()
        marks[step].append(time.perf_counter())
        if step == 0 and check_first:
            peak[0] = torch.cuda.max_memory_allocated()
            checks.update(first_step_check(dev, model, opt_state, lr, wd))
            torch.cuda.reset_peak_memory_stats()

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold, counted in the peak
    held_gb = torch.cuda.memory_allocated() / 1e9
    train_loop.Trainer._batch = batch
    try:
        out = entry(argv, on_step=on_step)
    finally:
        train_loop.Trainer._batch = orig_batch
    launches = {k: fn.launches for k, fn in counters.items()}
    peak_gb = max(peak[0], torch.cuda.max_memory_allocated()) / 1e9
    steps = sorted(marks)
    step_s = [marks[s][1] - marks[s][0] for s in steps]
    hist = out["history"]
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    log(f"[17] {label}: steps {steps[0]}-{steps[-1]}, step s "
        f"{json.dumps(step_s)} (host clock, batch to synchronize), peak "
        f"memory {peak_gb} GB ({held_gb} GB held before the run); losses "
        f"{json.dumps([h['loss'] for h in hist])}, grad norms "
        f"{json.dumps([h['grad_norm'] for h in hist])}; kernel launches "
        f"{json.dumps(launches)}; first step: {json.dumps(checks)}")
    if not finite:
        failed.append(f"{label}: a loss or grad norm is not finite")
    if any(launches.values()):
        failed.append(f"{label}: training launched a kernel: {launches}")
    if check_first:
        record_gate(f"phase 17 {label} first AdamW step",
                    checks["first_step_move"])
        if checks["bad_grads"] or not checks["first_step_move"] <= 1.0:
            failed.append(f"{label}: first step {checks}")
    out.update(step_s=step_s, peak_gb=peak_gb, held_gb=held_gb,
               checks=checks)
    return out


def train_arch(dev, arch: str, seq: int, batch: int, counters: dict,
               failed: list) -> dict:
    """Phase 17 (b)/(c): ``arch`` trains TRAIN_STEPS steps at full width
    and depth through ``launch.train.main`` (AdamW as its config says, lr
    TRAIN_LR, no checkpoint), timed (``train_run``), then one more step
    under ``torch.profiler`` for the device's idle share; tokens/s and the
    model FLOPs utilisation, (6 x params x tokens + the attention
    products) over 989 TFLOP/s."""
    import torch

    from repro_torch.data.pipeline import DataConfig, MarkovSource
    from repro_torch.launch import train
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.step import make_train_step

    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--seq-len",
            str(seq), "--batch", str(batch), "--lr", str(TRAIN_LR),
            "--ckpt-every", "0", "--log-every", "1", "--device", dev.type]
    out = train_run(dev, arch, train.main, argv + (["--smoke"] if
                                                   TRAIN_SMOKE else []),
                    counters, failed, TRAIN_LR, 0.1)
    model, cfg = out["model"], out["model"].cfg
    steady = sum(out["step_s"][1:]) / max(1, len(out["step_s"]) - 1)
    tokens = seq * batch
    flops = 6 * cfg.param_count * tokens + _attention_flops(cfg, seq, batch)
    step_fn = make_train_step(cfg, make_optimizer(cfg.optimizer,
                                                  lr=TRAIN_LR))
    nb = MarkovSource(cfg, DataConfig(seq_len=seq, batch_size=batch)
                      ).batch_at(TRAIN_STEPS)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
    tr = traced(lambda: step_fn(model, out["opt"], tb, TRAIN_STEPS), top=8)
    res = {"first_step_ms": out["step_s"][0] * 1e3,
           "step_ms": steady * 1e3, "tokens_per_s": tokens / steady,
           "peak_gb": out["peak_gb"], "held_gb": out["held_gb"],
           "idle_share": tr["idle_share"],
           "mfu": flops / steady / BF16_OPS_PER_S if BF16_OPS_PER_S else
           None, "model_tflop_per_step": flops / 1e12,
           "alloc_retries": torch.cuda.memory_stats().get(
               "num_alloc_retries") if dev.type == "cuda" else None}
    log(f"[17] {arch} training, {batch} x {seq} tokens a step: "
        f"{json.dumps(res)}; traced step {json.dumps(tr)}")
    del model, out, step_fn
    torch.cuda.empty_cache()
    return res


def example_runs(dev, counters: dict, failed: list) -> dict:
    """Phase 17 (d): the port's ``train_100m`` example under
    ``deterministic()``: EXAMPLE_STEPS steps with a checkpoint every
    EXAMPLE_EVERY (the loss must fall by EXAMPLE_FALL from the first
    logged value to the last); a second run that fails at EXAMPLE_FAIL
    by the injected hook, then resumes from its last checkpoint: its
    parameters and optimizer state equal the first run's bit for bit.
    Then EXAMPLE_TIMED steps with the deterministic algorithms off: what
    they cost a step. (e) the first run's model, trainable, refuses the
    kernels: ``lm.loss_fn(kernel="auto")`` under grad raises."""
    import shutil
    import tempfile

    import torch

    from repro_torch.data.pipeline import DataConfig, MarkovSource
    from repro_torch.examples import train_100m
    from repro_torch.models import lm
    from repro_torch.training.train_loop import deterministic

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    args = EXAMPLE_ARGS + ["--device", dev.type, "--ckpt-every",
                           str(EXAMPLE_EVERY), "--log-every", "10"]
    res = {}
    try:
        with deterministic():
            a = train_run(dev, "train_100m", train_100m.main,
                          args + ["--steps", str(EXAMPLE_STEPS),
                                  "--ckpt-dir", str(root / "a")],
                          counters, failed, EXAMPLE_LR, 0.1)
            t0 = time.perf_counter()
            try:
                train_100m.main(args + ["--steps", str(EXAMPLE_STEPS),
                                        "--ckpt-dir", str(root / "b"),
                                        "--fail-at-step",
                                        str(EXAMPLE_FAIL)])
                failed.append("train_100m: the injected failure did not "
                              "fire")
            except RuntimeError as exc:
                log(f"[17] train_100m crashed as injected: {exc}")
            b = train_run(dev, "train_100m resumed", train_100m.main,
                          args + ["--steps", str(EXAMPLE_STEPS),
                                  "--ckpt-dir", str(root / "b")],
                          counters, failed, EXAMPLE_LR, 0.1,
                          check_first=False)
            t_crash = time.perf_counter() - t0
        hist = a["history"]
        fall = hist[0]["loss"] - hist[-1]["loss"]
        record_gate("phase 17 train_100m loss fall",
                    EXAMPLE_FALL / fall if fall > 0 else math.inf)
        if not fall >= EXAMPLE_FALL:
            failed.append(f"train_100m: the loss fell by {fall}, not "
                          f"{EXAMPLE_FALL}")
        pa, pb = (dict(x["model"].named_parameters()) for x in (a, b))
        differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
        differ += [f"{part}.{k}" for part in a["opt"] for k in a["opt"][part]
                   if not torch.equal(a["opt"][part][k], b["opt"][part][k])]
        record_gate("phase 17 train_100m resume", 0.0 if not differ
                    else math.inf)
        if differ or b["history"][0]["step"] != EXAMPLE_FAIL // \
                EXAMPLE_EVERY * EXAMPLE_EVERY:
            failed.append(f"train_100m: the resumed run started at "
                          f"{b['history'][0]['step']}, differs in "
                          f"{differ[:5]} ({len(differ)})")
        t = train_run(dev, "train_100m, deterministic algorithms off",
                      train_100m.main,
                      EXAMPLE_ARGS + ["--device", dev.type, "--ckpt-every",
                                      "0", "--steps", str(EXAMPLE_TIMED)],
                      counters, failed, EXAMPLE_LR, 0.1)
        det, free = (sum(x["step_s"][2:EXAMPLE_TIMED]) / (EXAMPLE_TIMED - 2)
                     for x in (a, t))
        res = {"step_ms_deterministic": det * 1e3, "step_ms": free * 1e3,
               "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
               "resumed_bit_equal": not differ,
               "crash_and_resume_s": t_crash, "peak_gb": a["peak_gb"]}
        log(f"[17] train_100m: {json.dumps(res)} (steps 2-"
            f"{EXAMPLE_TIMED - 1} of each run; deterministic algorithms "
            f"cost {det / free - 1:+.3f} of a step)")
        if dev.type == "cuda":  # (e): the CPU has no kernel to refuse
            model = a["model"]
            nb = MarkovSource(model.cfg, DataConfig(seq_len=16, batch_size=1)
                              ).batch_at(0)
            tb = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
            for fn in counters.values():
                fn.launches = 0
            try:
                lm.loss_fn(model, tb, kernel="auto")
                failed.append("a kernel launched on grad-requiring inputs")
                refused = False
            except RuntimeError as exc:
                refused = "no backward" in str(exc)
                log(f"[17] (e) loss_fn(kernel='auto') on the trainable "
                    f"model raised: {exc}")
            launched = sum(fn.launches for fn in counters.values())
            record_gate("phase 17 (e) grad through a kernel refused",
                        0.0 if refused and not launched else math.inf)
            if not refused or launched:
                failed.append(f"(e) not refused ({launched} launches)")
            res["kernel_refused"] = refused
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def model_counters() -> dict:
    """The model kernels' wrappers, whose ``launches`` count their
    launches."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rglru_scan import kernel as scan_kernel_mod
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel_mod
    return {"flash_attention": fa_kernel.flash_attention_cuda,
            "decode_attention": da_kernel.decode_attention_cuda,
            "ssd_scan": ssd_kernel_mod.ssd_intra_chunk_cuda,
            "rglru_scan": scan_kernel_mod.linear_scan_cuda}


def training(dev, raise_on_fail: bool = True) -> dict:
    """Phase 17: (a)-(c) each of TRAIN_RUNS, its evaluation loss
    (``eval_loss``) and TRAIN_STEPS training steps (``train_arch``), each
    model freed before the next; (d)-(e) the train_100m example
    (``example_runs``). Runs every part before it raises. Returns the
    evaluation losses' kernel launches and the measurements."""
    from repro_torch.configs import get_config, get_smoke_config

    t_phase = time.perf_counter()
    counters = model_counters()
    failed: list[str] = []
    out = {"eval": {}, "train": {}}
    for arch, seq, batch in TRAIN_RUNS:
        cfg = (get_smoke_config if TRAIN_SMOKE else get_config)(arch)
        try:
            out["eval"][arch] = eval_loss(dev, arch, cfg, seq, batch,
                                          counters, failed)
            out["train"][arch] = train_arch(dev, arch, seq, batch, counters,
                                            failed)
        except (AssertionError, RuntimeError) as exc:
            failed.append(f"{arch}: {exc}")
            log(f"    gate failed: {exc}")
    out["example"] = example_runs(dev, counters, failed)
    secs = time.perf_counter() - t_phase
    log(f"[17] phase 17: {secs}s (budget 150 s)")
    if failed:
        if raise_on_fail:
            raise AssertionError("phase 17: " + "; ".join(failed))
        for f in failed:
            log(f"    gate failed: {f}")
    return out


def bit_gate(gate: str, equal: bool, msg: str, raise_on_fail: bool) -> None:
    """Record a bit gate as 0 (equal) or inf; a failure raises where
    ``raise_on_fail``, and is only printed otherwise (``--gates``)."""
    record_gate(gate, 0.0 if equal else math.inf)
    if not equal:
        if raise_on_fail:
            raise AssertionError(msg)
        log(f"    gate failed: {msg}")


def hist_accum_check(dev, raise_on_fail: bool = True) -> float:
    """Phase 2: ``hist_accum`` against its plain version, exact counts, on
    uniform indices and then on every input of
    ``interop.HIST_ACCUM_CASES`` (binned responses, one bin, all skipped,
    ragged T and C, several clusters along T, 1-8 cells a CTA, 100 bins to
    ``MAX_BINS``, a running histogram, unaligned indices), each added into
    its histogram by one launch; returns the max abs difference."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.kernels.hist_sketch import kernel as hist_kernel
    from repro_torch.kernels.hist_sketch import ops as hist_ops
    from repro_torch.kernels.hist_sketch.ref import hist_accum_ref

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
    for name in interop.HIST_ACCUM_CASES:
        idx, n_bins, out = interop.hist_accum_case(name, dev)
        want = out + hist_accum_ref(idx, n_bins=n_bins)
        plan = hist_kernel.device_plan(idx, n_bins)
        got = hist_kernel.hist_accum_cuda(idx, out)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        bit_gate("phase 2 hist_accum", err == 0.0,
                 f"hist_accum differs on {name} "
                 f"{interop.HIST_ACCUM_CASES[name]} ({plan}): "
                 f"max|diff|={err}", raise_on_fail)
        del idx, out, want, got
    log(f"[2] hist_accum kernel == plain (exact counts) on "
        f"{len(interop.HIST_ACCUM_CASES)} more inputs: "
        f"{', '.join(interop.HIST_ACCUM_CASES)}")
    return worst


def hist_responses(dev, t: int, c: int, n_bins: int, rng):
    """Bin indices (t, c) of M/M/1-like responses (mean 2), a tenth
    skipped, drawn from ``rng``."""
    import numpy as np
    import torch

    from repro_torch.kernels.hist_sketch import ops as hist_ops

    resp = torch.from_numpy(rng.exponential(2.0, (t, c)).astype(
        np.float32)).to(dev)
    keep = torch.from_numpy((rng.random((t, c)) > 0.1).astype(
        np.float32)).to(dev)
    return hist_ops.bin_indices(resp, keep, n_bins=n_bins)


def hist_timing(dev, idx, n_bins: int, reps: int = 20) -> dict:
    """``hist_accum`` at one shape: the kernel adding into a histogram
    allocated ahead (``ms``), an empty kernel on its plan's grid, clusters
    and shared memory (``empty_ms``, the launch's floor; None for a tree
    without one), the plain version, and two library calls: the plain
    version's one ``index_put_(..., accumulate=True)`` on indices prepared
    ahead (``library_ms``: nothing waits on the host) and
    ``torch.bincount`` over the flattened (cell, bin) indices
    (``bincount_ms``: it reads the largest index on the host before it
    allocates). The bound counts the indices read once and the histogram
    read and written once, one add per counted entry."""
    import torch

    from repro_torch.kernels.hist_sketch import kernel as hist_kernel
    from repro_torch.kernels.hist_sketch import ops as hist_ops

    t, c = idx.shape
    out = torch.zeros((c, n_bins), dtype=torch.float32, device=dev)
    rec = {"T": t, "C": c, "n_bins": n_bins,
           "ms": cuda_ms(lambda: hist_kernel.hist_accum_cuda(idx, out), reps,
                         "hist_accum")}
    empty = getattr(hist_kernel, "empty_launch", None)
    rec["empty_ms"] = None if empty is None else cuda_ms(
        lambda: empty(idx, n_bins), reps, "hist_accum empty launch")
    rec["plain_ms"] = cuda_ms(lambda: hist_ops.hist_accum(
        idx, n_bins=n_bins, kernel="off"), reps, "hist_accum plain")
    live = idx >= 0
    cols = torch.arange(c, device=dev).expand(t, c)
    safe = idx.clamp(0, n_bins - 1).to(torch.int64)
    ones = live.to(torch.float32)
    rec["library_ms"] = cuda_ms(lambda: out.index_put_(
        (cols, safe), ones, accumulate=True), reps, "index_put_")
    flat = (torch.arange(c, device=dev)[None, :] * n_bins
            + idx.clamp(max=n_bins - 1))[live]
    rec["bincount_ms"] = cuda_ms(lambda: torch.bincount(
        flat, minlength=c * n_bins), reps, "bincount")
    n_bytes = 4 * (t * c + 2 * c * n_bins)
    n_ops = int(live.sum())
    rec["bound_ms"] = 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                                n_ops / F32_OPS_PER_S)
    rec["bound_by"] = ("bytes" if n_bytes / HBM_BYTES_PER_S
                       >= n_ops / F32_OPS_PER_S else "operations")
    return rec


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


# Phase 13: the paper's figures through ``repro_torch.bench.run``. The
# engine figures run ``cell_update`` on every chunk; the others
# (fig14's slot loop, the TCP draws) run plain tensor operations.
ENGINE_FIGURES = ("fig1_queueing", "fig2_threshold", "fig3_random",
                  "fig4_overhead", "fig5_diskdb", "fig12_memcached",
                  "fig15_dns", "fig_cross_system")
# The engine figures held bit for bit against the plain version at full
# size: every launch configuration of phase 13 (the sketch past the
# 16-bit counters' range in fig1's 80k steps, the fitted-table grids of
# fig5, fig15 and the cross-system figure, fig2's 1,440 cells). fig3 and
# fig4 take fig2's template, flags and tile at 40k steps and are held at
# their smoke size: at full size their twelve plain chunks (480k steps;
# the plain version replays one captured CUDA graph a step, ~80 us) would
# add ~40 s.
FULL_SIZE_PARITY = ("fig1_queueing", "fig2_threshold", "fig5_diskdb",
                    "fig12_memcached", "fig15_dns", "fig_cross_system")
NETSIM_SLOTS = 1024  # slots of fig14's headline run timed for slots/s
# The benchmarks beside the figures (all run ``cell_update``); the first
# two are held against the plain version at their smoke size, as fig3 and
# fig4 are.
BENCH_MODULES = ("sweep_engine", "fig_policy_space", "fig_fault_masking",
                 "serving_hedge", "roofline")
SMOKE_PARITY = ("fig_policy_space", "fig_fault_masking")
# Depth cuts of phase 13, to hold the script within its time budget
# (PERF.md §4): sweep_engine runs at its smoke size (its old path steps 3
# families of 5,000 arrivals on the host; one family at full size took
# 30-47 s, ``python -m repro_torch.bench.sweep_engine``), and
# serving_hedge replays 100k virtual requests a policy instead of 1M
# (21.5 s for the three replays on the card's host).
MODULE_ARGS = {"sweep_engine": ["--smoke"]}
VIRTUAL_REQUESTS = 100_000


def parse_derived(derived: str) -> dict:
    """A row's ``derived`` field, ``key=value;...``, as a dict of strings
    (a field of prose, with no ``=``, gives an empty dict)."""
    return dict(part.split("=", 1) for part in derived.split(";")
                if "=" in part)


def same_bits(a, b) -> bool:
    """Whether two figure outputs are equal bit for bit: tensors and arrays
    elementwise, floats exactly, fitted tables knot for knot."""
    import numpy as np
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and torch.equal(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_bits, a, b))
    if hasattr(a, "table"):  # a fitted EmpiricalDist
        return a.table == b.table and a.scale == b.scale
    return a == b


def figure_gates(rows: list[dict]) -> list[str]:
    """The paper's claims and the JAX package's test assertions, read off
    the figures' rows; returns the failures."""
    from repro_torch.core.threshold import default_rhos

    d = {r["name"]: parse_derived(r["derived"]) for r in rows}
    failed: list[str] = []
    rho_min = float(default_rhos()[0])

    def need(ok: bool, msg: str) -> None:
        if not ok:
            failed.append(msg)

    def num(name: str, key: str) -> float:
        return float(d[name][key].lstrip(">=").rstrip("%x"))

    th = num("fig2/weibull/x=1", "threshold")
    need(abs(th - 1 / 3) <= 0.03,
         f"fig2 exponential (weibull k=1) threshold {th} not within 0.03 "
         f"of 1/3")
    for name in d:
        if name.startswith("fig4/exponential/c="):
            # the estimator reads the crossing off a grid from 0.05: a
            # closed form below it reads as 0.05 ("never helps on the grid")
            t, cf = num(name, "threshold"), num(name, "closed_form")
            need(abs(t - max(cf, rho_min)) <= 0.03, f"{name}: threshold "
                 f"{t} not within 0.03 of the closed form {cf} (at least "
                 f"{rho_min}, the grid's first load)")
    base = num("fig5-11/fig5_base", "threshold")
    need(0.25 <= base <= 0.45, f"fig5 base threshold {base} not in "
         f"[0.25, 0.45]")
    t400 = num("fig5-11/fig10_400kb", "threshold")
    need(t400 < base, f"fig10 threshold {t400} not below the base {base}")
    g = num("fig12/memcached/rho=0.3", "gain_ms")
    need(g < 0, f"memcached gains {g} ms at load 0.3")
    red = num("fig15/k=10", "frac500_reduction")
    need(red >= 3, f"fig15 k=10 frac500 reduction {red}x below 3x")
    means = [num(f"fig15/k={k}", "mean_reduction") for k in (2, 5, 10)]
    need(0 < means[0] <= means[1] <= means[2],
         f"fig15 mean reductions at k=2, 5, 10 do not rise: {means}")
    k2, k10 = (num("fig17/marginal", k) for k in ("k2_ms_per_kb",
                                                  "k10_ms_per_kb"))
    need(k2 > 16 and k2 > k10, f"fig17 k2 {k2} ms/KB not above 16 and k10 "
         f"{k10}")
    saving = num("tcp/handshake", "mean_saving_ms")
    first = num("tcp/handshake", "first_order_ms")
    need(abs(saving / first - 1) <= 0.25, f"tcp mean saving {saving} ms not "
         f"within 25% of the first-order {first}")
    gap = num("tcp/handshake", "p995_saving_ms")
    need(gap > 880, f"tcp p99.5 saving {gap} ms not above 880")
    short = num("fig14/load=0.25", "short_mean_gain")
    eleph = num("fig14/load=0.25", "elephant_delta")
    need(short > 0 and abs(eleph) < 5, f"fig14 at load 0.25: short-flow "
         f"gain {short}%, elephants moved {eleph}%")
    cross = d["fig_cross_system/crossover"]
    need(float(cross["memcached"]) < float(cross["disk"]),
         f"memcached does not cross before disk: {cross}")
    parity = d["fig_cross_system/kernel_parity"]
    need(parity["bit_identical"] == "True" and parity["kernel"] == "on",
         f"kernel parity row: {parity}")
    return failed


def bench_gates(rows: list[dict]) -> list[str]:
    """The JAX package's test assertions on the five benchmarks beside the
    figures, read off their rows; returns the failures."""
    d = {r["name"]: parse_derived(r["derived"]) for r in rows}
    failed: list[str] = []

    def need(ok: bool, msg: str) -> None:
        if not ok:
            failed.append(msg)

    def flags(name: str, *keys: str) -> None:
        for key in keys:
            need(d[name][key] == "True", f"{name}: {key}={d[name][key]}")

    flags("fig_policy_space/crossover", "crossover")
    # completed fractions at fault rate f: bare loses f/2 (blackholed
    # primaries), the delayed hedge (f/2)^2 (both copies), retry none;
    # within 5 binomial standard errors of the post-warmup requests (3
    # seeds of fig_fault_masking's count)
    from repro_torch.bench.fig_fault_masking import CFG
    count = 3 * (CFG.n_arrivals - int(CFG.n_arrivals * CFG.warmup_frac))
    for f in (0.0, 0.04, 0.08):
        for policy, loss in (("bare", f / 2), ("hedge", (f / 2) ** 2),
                             ("retry", 0.0)):
            name = f"fig_fault_masking/{policy}@f{f:g}"
            got = 1.0 - float(d[name]["completed_frac"])
            tol = 5 * math.sqrt(loss * (1 - loss) / count)
            need(abs(got - loss) <= tol + 5e-5,  # the row's 4 decimals
                 f"{name}: lost {got} of its requests, not {loss} within "
                 f"{tol}")
    flags("fig_fault_masking/engine", "retry_completes_all",
          "completion_order")
    flags("fig_fault_masking/chaos", "hedged_completes_all",
          "hedged_p99_within_2x", "retry_degrades_more", "masked")
    flags("serving/adaptive_vs_static", "no_worse", "strictly_better")
    delta = float(d["sweep_engine/total"]["max_threshold_delta"])
    need(delta <= 1e-3, f"sweep_engine old vs fused thresholds differ by "
         f"{delta}")
    for name in d:
        if name.startswith("sweep_engine/chunked/"):
            flags(name, "match")
    flags("sweep_engine/kernel_on_vs_off", "bit_identical")
    flags("sweep_engine/pipeline_on_vs_off", "bit_identical")
    need(d["sweep_engine/kernel_on_vs_off"]["kernel"] == "on",
         "sweep_engine's kernel leg did not run the kernel")
    for leg in ("scan", "kernel"):
        row = d[f"roofline/cell_update/{leg}"]
        for key in ("peak_frac", "hbm_frac"):
            need(float(row[key]) <= 1.0, f"roofline {leg}: {key} "
                 f"{row[key]} above 1")
    return failed


def paper_figures() -> int:
    """Phase 13: every figure and benchmark module through the user entry
    point ``repro_torch.bench.run.main`` (one call a module, ``--only``;
    ``kernel="auto"``; at full size but for ``MODULE_ARGS`` and
    ``VIRTUAL_REQUESTS``), its rows, walls and gates (``figure_gates``,
    ``bench_gates``), with the kernels' launches read around each call
    (``cell_update`` in every engine figure and benchmark and no other,
    ``hist_accum`` in none); fig5 once more
    under ``torch.profiler`` for the device's idle share; each engine
    figure again with ``kernel="off"``, bit-equal to ``kernel="on"`` (at
    full size those of ``FULL_SIZE_PARITY``, the others and
    ``SMOKE_PARITY`` at their smoke size); and ``netsim._simulate`` at
    fig14's headline configuration on the card and on the CPU, equal in
    every element, with its slots per second on the card. Returns
    ``cell_update``'s launches in the modules' runs."""
    import importlib

    import torch

    from repro_torch.bench import fig14_network, fig5_diskdb, serving_hedge
    from repro_torch.bench import run as bench_run
    from repro_torch.core import netsim
    from repro_torch.kernels.cell_update import kernel as cell_kernel
    from repro_torch.kernels.hist_sketch import kernel as hist_kernel

    rows, walls, launches = [], {}, {}
    serving_hedge.N_VIRTUAL = VIRTUAL_REQUESTS
    for mod in bench_run.MODULES:
        name = mod.__name__.split(".")[-1]
        cell_kernel.cell_update_cuda.launches = 0
        hist_kernel.hist_accum_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bench_run.main(["--only", name] + MODULE_ARGS.get(name, []))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = {"cell_update": cell_kernel.cell_update_cuda.launches,
                          "hist_accum": hist_kernel.hist_accum_cuda.launches}
        rows += out["rows"]
        for row in out["rows"]:
            log(f"[13] {row['name']}: {row['derived']} (kernel "
                f"{row['kernel']}, {row['us_per_call']} us)")
        log(f"[13] {name}: {walls[name]}s wall, kernel launches "
            f"{json.dumps(launches[name])}")
        engine = name in ENGINE_FIGURES + BENCH_MODULES
        if launches[name]["hist_accum"] != 0 or \
                engine != (launches[name]["cell_update"] > 0):
            raise AssertionError(f"{name} launched hist_accum, or "
                                 f"cell_update {launches[name]} where its "
                                 f"engine status is {engine}")
    total = sum(n["cell_update"] for n in launches.values())
    figures = [n for n in walls if n not in BENCH_MODULES]
    log(f"[13] figures: {sum(walls[n] for n in figures)}s wall; the "
        f"benchmarks {', '.join(BENCH_MODULES)}: "
        f"{sum(walls[n] for n in BENCH_MODULES)}s wall; {total} "
        f"cell_update launches; {rows[0]['gpu']}")
    failed = figure_gates(rows) + bench_gates(rows)
    if failed:
        raise AssertionError("phase 13: " + "; ".join(failed))

    tr = traced(lambda: fig5_diskdb.run(device="cuda"))
    log(f"[13] trace of fig5 (7 storage variants, one mixed grid): "
        f"{json.dumps(tr)}")

    t_cmp = time.perf_counter()
    for name in ENGINE_FIGURES + SMOKE_PARITY:
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        smoke = name not in FULL_SIZE_PARITY
        size = "its smoke size" if smoke else "full size"
        on, _ = mod.compute(smoke=smoke, kernel="on", device="cuda")
        t0 = time.perf_counter()
        off, _ = mod.compute(smoke=smoke, kernel="off", device="cuda")
        torch.cuda.synchronize()
        if not same_bits(on, off):
            raise AssertionError(f"{name} at {size}: kernel on and off "
                                 f"differ")
        log(f"[13] {name} at {size}: kernel on == off bit for bit (plain "
            f"{time.perf_counter() - t0}s)")
    log(f"[13] engine figures, kernel on == off bit for bit: "
        f"{time.perf_counter() - t_cmp}s")

    cfgs = fig14_network.configs(fig14_network.HEADLINE_LOAD)
    for cfg in cfgs:
        meta, paths, lens, sizes, starts = netsim.build_workload(cfg)
        kw = dict(n_slots=netsim.default_n_slots(cfg, sizes, starts),
                  buffer_pkts=cfg.buffer_pkts, rto_slots=cfg.rto_slots)
        card = netsim._simulate(meta, paths, lens, **kw, device="cuda")
        cpu = netsim._simulate(meta, paths, lens, **kw, device="cpu")
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"netsim at {cfg}: card and CPU deliver "
                                 f"in different slots")
        kw["n_slots"] = NETSIM_SLOTS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        netsim._simulate(meta, paths, lens, **kw, device="cuda")
        torch.cuda.synchronize()
        rate = NETSIM_SLOTS / (time.perf_counter() - t0)
        log(f"[13] netsim, {cfg.n_flows} flows at load {cfg.load}, "
            f"replicate_first {cfg.replicate_first} ({meta.shape[0]} packet "
            f"rows): delivered slots equal on the card and the CPU "
            f"({int((cpu >= 0).sum())} delivered); {rate} slots/s on the "
            f"card over its first {NETSIM_SLOTS} slots")
    return total


# Phase 14: the adaptive serving stack at full width, as the port's
# serve_hedged example drives it.
SERVE_REPLICAS = 4
SERVE_REQUESTS = 32  # each live replay: poisson_trace at rho 0.2
# gemma2-2b's depth behind the service: cut from 26 layers to 3 x (local,
# global) for the script's budget (the phase's time is the host-paced
# decode of its 3 x 32 requests, linear in the depth; PERF.md §4)
SERVE_STACK_DEPTH = 6


def controller_us(table, mean_s: float, n: int = 20_000) -> float:
    """Microseconds of one ``AdaptiveController.on_arrival`` (its decision
    amortized over the stride) on ``table``, host clock."""
    from repro_torch.serving.controller import AdaptiveController

    ctl = AdaptiveController(table, n_replicas=SERVE_REPLICAS,
                             mean_service_s=mean_s, hysteresis=0.1,
                             decision_stride=4)
    t0 = time.perf_counter()
    for i in range(n):
        ctl.on_arrival(i * mean_s)
    return (time.perf_counter() - t0) / n * 1e6


def serving_stack(dev) -> dict:
    """Phase 14: the port's ``serve_hedged`` through the adaptive stack at
    full width. (a) ``threshold.policy_table`` with serving_hedge's full-
    size arguments, ``cell_update`` launches read around exactly that
    call; (b) ``BatchedHedgedService`` over 4 ``InferenceEngine`` replicas
    of gemma2-2b (full width, SERVE_STACK_DEPTH layers, random weights from
    the port's init, seed 0, one shared model), an ``AdaptiveController``
    on (a)'s table with the
    mean service time of a warm request, ``Telemetry``, a Poisson trace
    of 32 requests (16-token prompts, 4 new tokens, rho 0.2) through
    ``replay_live``; (c) the same service at static k=2 over a second
    trace, replica r0 crashed by ``FaultInjector`` a third of the way in.
    Gates: every request completes (32 of 32, none failed), its tokens
    equal a lone engine's for its prompt, and ``flash_attention`` and
    ``decode_attention`` launch in (b) and (c). (b) runs once more under
    ``torch.profiler`` for the device's idle share. Returns the phase's
    launches of the three kernels."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.bench import serving_hedge
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_hedged
    from repro_torch.kernels.cell_update import kernel as cell_kernel
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import lm
    from repro_torch.serving.controller import PolicyTable
    from repro_torch.serving.engine import InferenceEngine

    t_phase = time.perf_counter()
    cell_kernel.cell_update_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab = serving_hedge.policy_table_sweep(smoke=False, device=dev)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    launches = {"cell_update": cell_kernel.cell_update_cuda.launches,
                "flash_attention": 0, "decode_attention": 0}
    table = PolicyTable.from_sweep(tab)
    log(f"[14] (a) policy_table (two-point(0.9), 8 replicas, "
        f"{serving_hedge.TABLE_ARRIVALS} arrivals, {len(table.rhos)} loads "
        f"x {table.n_variants} variants x 2 seeds): {t_table}s, "
        f"{launches['cell_update']} cell_update launches; best variant "
        f"(k, delay) at 0.1/0.3/0.75: "
        f"{[table.entry(table.best(r)) for r in (0.1, 0.3, 0.75)]}")
    if launches["cell_update"] <= 0:
        raise AssertionError("policy_table launched no cell_update")

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("gemma2-2b"),
                              n_layers=SERVE_STACK_DEPTH)
    model = lm.init(torch.Generator(dev).manual_seed(0), cfg)
    engines = [InferenceEngine(cfg, model, max_len=64, name=f"r{i}",
                               device=dev) for i in range(SERVE_REPLICAS)]
    lone = InferenceEngine(cfg, model, max_len=64, name="lone", device=dev)
    mean_s = serve_hedged.mean_service_s(lone)
    log(f"[14] gemma2-2b ({cfg.n_layers} layers), {SERVE_REPLICAS} replicas "
        f"over one model: {time.perf_counter() - t0}s to init and warm; a "
        f"request alone ({serve_hedged.PROMPT_LEN}-token prompt, "
        f"{serve_hedged.NEW_TOKENS} new tokens) takes {mean_s * 1e3} ms; "
        f"the controller's on_arrival {controller_us(table, mean_s)} us")

    runs = (("(b) adaptive", {"table": table}),
            ("(c) static k=2, r0 crashed at a third",
             {"k": 2, "crash": "r0", "seed": 1,
              "shed_watermark": serve_hedged.STATIC_NO_SHED}))
    failed = []
    for tag, kw in runs:
        fa_kernel.flash_attention_cuda.launches = 0
        da_kernel.decode_attention_cuda.launches = 0
        torch.cuda.synchronize()
        r = serve_hedged.live_replay(engines, n_requests=SERVE_REQUESTS,
                                     mean_s=mean_s, **kw)
        torch.cuda.synchronize()
        got = {"flash_attention": fa_kernel.flash_attention_cuda.launches,
               "decode_attention": da_kernel.decode_attention_cuda.launches}
        for k, v in got.items():
            launches[k] += v
        bad = serve_hedged.check_tokens(lone, r["requests"])
        lat, tel, st = r["latency_s"], r["telemetry"], r["stats"]
        ctl = r["controller"]
        log(f"[14] {tag}: {SERVE_REQUESTS} requests in {r['wall_s']}s wall; "
            f"completions {tel['completions']}, failed {st['failed']}; "
            f"latency mean {float(lat.mean()) * 1e3} ms, p50 "
            f"{float(np.percentile(lat, 50)) * 1e3} ms, p99 "
            f"{float(np.percentile(lat, 99)) * 1e3} ms; hedges "
            f"{st['hedged']}, cancels {st['cancelled_copies']}, duplicate "
            f"wins {st['duplicate_wins']}, shed {st['shed']}; controller "
            f"{json.dumps(ctl)}; decisions (rho_hat, k, delay, switched) "
            f"{json.dumps(r['decisions'])}; kernel launches "
            f"{json.dumps(got)}; tokens differing from a lone engine: {bad}")
        if tel["completions"] != SERVE_REQUESTS or st["failed"] or bad \
                or min(got.values()) <= 0:
            failed.append(f"{tag}: completions {tel['completions']}, "
                          f"failed {st['failed']}, tokens differ in {bad}, "
                          f"launches {got}")
    if failed:
        raise AssertionError("phase 14: " + "; ".join(failed))

    tr = traced(lambda: serve_hedged.live_replay(
        engines, n_requests=SERVE_REQUESTS, mean_s=mean_s, table=table))
    log(f"[14] trace of (b): {json.dumps(tr)}")
    del engines, lone, model
    torch.cuda.empty_cache()
    log(f"[14] phase 14: {time.perf_counter() - t_phase}s")
    return launches


# Phase 15: the sharded sweep executor (``repro_torch.distributed
# .sweep_shard``) on the card: phase 4's runs on several shards of one card,
# in one process and in two, held bit for bit against phase 4's unsharded
# kernel runs.
SHARDS = 4
PCT_SHARDS = 5  # the percentile run's 12 cells pad to 15: three pad cells
PCT_QUANTILES = (50.0, 99.0, 99.9)
SPAWN_LIMIT_S = 600.0


def fig2_sweep_setup():
    """Phase 4's Figure 2 sweep: (families, config, scenario) — 15
    families, N=20, 50k arrivals, k in {1, 2}."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import queueing
    from repro_torch.core.scenario import Scenario

    fams = ([dists.pareto(a) for a in (6.0, 3.0, 2.5, 2.2, 2.05)]
            + [dists.weibull(k) for k in (2.0, 1.0, 0.7, 0.5, 0.4)]
            + [dists.two_point(p) for p in (0.1, 0.5, 0.8, 0.95, 0.99)])
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=50_000)
    return fams, cfg, Scenario.paper_default(tuple(fams), ks=(1, 2))


def pct_run_setup():
    """Phase 4's 1M-arrival percentile run: (loads, config, scenario)."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import queueing
    from repro_torch.core.scenario import Scenario

    return ((0.2, 0.3, 0.4),
            queueing.SimConfig(n_servers=20, n_arrivals=1_000_000),
            Scenario.paper_default(dists.exponential(), ks=(1, 2)))


def sharded_rank(rank: int, src: str, store: str, out_dir: str) -> None:
    """One process of phase 15(c), spawned: two slots on cuda:0, joined
    over gloo through the file store ``store``; the fig2 sweep as a plain
    ``queueing.run`` with no ``mesh=`` (the default mesh spans both
    processes), twice — the second run timed and its ``cell_update``
    launches counted. Prints the rows it sampled against the whole block
    and saves its summaries to ``out_dir``."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.core import chunkflow, queueing, threshold
    from repro_torch.distributed import multihost
    from repro_torch.kernels.cell_update import kernel as cell_kernel

    multihost.initialize(f"file://{store}", 2, rank, local_device_count=2,
                         device="cuda:0", timeout_s=300.0)
    try:
        _, cfg, scn = fig2_sweep_setup()
        walls = []
        for _ in range(2):
            cell_kernel.cell_update_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = queueing.run(1, scn, threshold.default_rhos(), cfg,
                               n_seeds=2, percentiles=(), chunk_size=CHUNK,
                               device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        sampling = chunkflow.stats_provenance()
        launches = cell_kernel.cell_update_cuda.launches
        log(f"[15] (c) rank {rank} of 2, slots "
            f"{multihost.registered_slots()}: walls {json.dumps(walls)} s "
            f"(first run loads the library), cell_update launches "
            f"{launches}, sampled {json.dumps(sampling)}")
        torch.save({"mean": out["mean"].cpu(),
                    "completed": out["completed"].cpu(), "walls": walls,
                    "launches": launches, "sampling": sampling},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        multihost.shutdown()


def sharded_sweep(dev, src, ref: dict | None = None,
                  raise_on_fail: bool = True) -> int:
    """Phase 15: (a) the fig2 sweep on a 4-shard mesh of the card and the
    1M-arrival run on a 5-shard one (3 pad cells); (b)
    ``threshold_grid_batch`` under ``use_sweep_mesh``; (c) two spawned
    processes x two slots on cuda:0 through ``multihost.initialize`` and a
    plain ``queueing.run``; (d) sweep_engine's sharded part at its smoke
    size. Each must equal the unsharded kernel run bit for bit (``ref``,
    phase 4's outputs; ``--gates`` runs them here), with ``cell_update``
    launched shards x chunks times and no plain fallback. Returns the
    phase's launches (the spawned processes' included)."""
    import tempfile

    import torch

    from repro_torch.bench import sweep_engine
    from repro_torch.core import queueing, threshold
    from repro_torch.distributed import multihost, sweep_shard
    from repro_torch.kernels.cell_update import kernel as cell_kernel
    from repro_torch.launch.mesh import make_sweep_mesh, use_sweep_mesh

    t_phase = time.perf_counter()
    fams, cfg, scn = fig2_sweep_setup()
    p_rhos, p_cfg, p_scn = pct_run_setup()
    rhos = threshold.default_rhos()
    fig2_kw = dict(n_seeds=2, percentiles=(), chunk_size=CHUNK,
                   device="cuda")
    pct_kw = dict(n_seeds=2, percentiles=PCT_QUANTILES, chunk_size=CHUNK,
                  device="cuda")
    ths_kw = dict(n_seeds=2, chunk_size=CHUNK, device="cuda")
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}

    def counted(label: str, fn):
        cell_kernel.cell_update_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launches[label] = cell_kernel.cell_update_cuda.launches
        return out

    def same(label: str, got: dict, want: dict, fields) -> None:
        bad = [f for f in fields if not torch.equal(
            got[f], want[f].to(got[f].device))]
        bit_gate(f"phase 15 {label}", not bad,
                 f"phase 15 {label}: sharded != unsharded in {bad}",
                 raise_on_fail)

    if ref is None:  # --gates: phase 4's unsharded kernel runs
        ref = {"fig2": counted("unsharded fig2", lambda: queueing.run(
                   1, scn, rhos, cfg, **fig2_kw)),
               "pct": counted("unsharded pct", lambda: queueing.run(
                   100, p_scn, p_rhos, p_cfg, **pct_kw)),
               "ths": threshold.threshold_grid_batch(1, fams, cfg,
                                                     **ths_kw)}
        ref["walls"] = {key: [walls.pop(f"unsharded {key}")]
                        for key in ("fig2", "pct")}
        launches.clear()
    mesh = make_sweep_mesh(devices=(dev,) * SHARDS)
    pct_mesh = make_sweep_mesh(devices=(dev,) * PCT_SHARDS)
    pct_fields = ("mean", "completed") + tuple(f"p{q:g}"
                                               for q in PCT_QUANTILES)

    # (a) one process, the main path's two runs on shards of the card
    got = counted("(a) fig2", lambda: sweep_shard.sweep_dists_sharded(
        1, fams, rhos, cfg, ks=(1, 2), mesh=mesh, kernel="auto", **fig2_kw))
    same("(a) fig2 sweep", got, ref["fig2"], ("mean", "completed"))
    got = counted("(a) pct", lambda: queueing.run(
        100, p_scn, p_rhos, p_cfg, mesh=pct_mesh, kernel="auto", **pct_kw))
    same("(a) 1M-arrival run", got, ref["pct"], pct_fields)

    # (b) the estimators under the ambient mesh
    with use_sweep_mesh(mesh):
        ths = counted("(b)", lambda: threshold.threshold_grid_batch(
            1, fams, cfg, **ths_kw))
    bit_gate("phase 15 (b) thresholds", ths == ref["ths"],
             f"phase 15 (b): thresholds {ths} != {ref['ths']}",
             raise_on_fail)

    # (c) two processes x two slots on cuda:0, over gloo
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            multihost.spawn(sharded_rank, 2, (str(src), f"{tmp}/store", tmp),
                            SPAWN_LIMIT_S)
            ok, why = True, ""
        except RuntimeError as exc:
            ok, why = False, str(exc)
        walls["(c) spawn to exit"] = time.perf_counter() - t0
        bit_gate("phase 15 (c) processes", ok, f"phase 15 (c): {why}",
                 raise_on_fail)
        if ok:
            ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in (0, 1)]
            same("(c) rank 0", ranks[0], ref["fig2"], ("mean", "completed"))
            launches["(c)"] = sum(r["launches"] for r in ranks)
            walls["(c) rank 0 run"] = ranks[0]["walls"][-1]

    # (d) sweep_engine's sharded part at its smoke size
    rows = counted("(d)", lambda: sweep_engine._sharded_rows(
        sweep_engine._cfg(True), mesh, True, "auto", dev))
    for row in rows:
        bit_gate(f"phase 15 (d) {row[0]}",
                 parse_derived(row[2]).get("bit_identical") == "True",
                 f"phase 15 (d): {row[0]} {row[2]}", raise_on_fail)
        log(f"[15] (d) {row[0]}: {row[2]}")

    chunks = math.ceil(cfg.n_arrivals / CHUNK)
    smoke_chunks = math.ceil(sweep_engine._cfg(True).n_arrivals / CHUNK)
    want = {"(a) fig2": SHARDS * chunks,
            "(a) pct": PCT_SHARDS * math.ceil(p_cfg.n_arrivals / CHUNK),
            "(b)": SHARDS * chunks, "(c)": 2 * 2 * chunks,
            # each of the two rows: the unsharded run, then the sharded
            "(d)": 2 * (1 + SHARDS) * smoke_chunks}
    bit_gate("phase 15 launches", launches == want,
             f"phase 15: cell_update launched {launches}, not shards x "
             f"chunks {want}", raise_on_fail)
    log(f"[15] cell_update launches {json.dumps(launches)} (shards x "
        f"chunks: {json.dumps(want)}); walls {json.dumps(walls)} s beside "
        f"the unsharded runs' {json.dumps(ref['walls'])} s (phase 4, "
        f"pipeline off); sharded == unsharded bit for bit in (a)-(d)")
    log(f"[15] phase 15: {time.perf_counter() - t_phase}s")
    return sum(launches.values())


# Phase 18: the model-parallel layer (``repro_torch.distributed``). Four
# ranks spawned on the card form a (data 2, model 2) mesh over gloo and
# train granite-moe-3b-a800m at full width under its fsdp recipe (the
# batch over (data, model), experts over model: the tokens gathered over
# model), cut to MP_DEPTH of its 32 layers: the gathers and gradient
# reductions go through gloo on the host, about 8x more at full depth
# (PERF.md §4). The same steps run unsharded in this process first.
MP_ARCH = "granite-moe-3b-a800m"
MP_DEPTH = 4
MP_SEQ, MP_BATCH = 1024, 8       # the global batch; 2 rows a rank
MP_MESH = (2, 2)                 # (data, model)
MP_STEPS = 3
MP_LR = 1e-3
MP_SMOKE = False                 # the smoke config (the CPU rehearsal)
MP_LIMIT_S = 400.0
# the pipeline and hierarchical-reduce checks of (d): (stages, microbatches,
# rows, width) and the reduced gradient's shape
MP_PIPE = (2, 8, 16, 256)
MP_HIER_SHAPE = (1024, 1536)
# gates of (a), against the unsharded run on the same function (each EP
# group's rows, capacity and aux loss, as the sharded loss takes them):
# relative loss and grad-norm differences a step, about three times what
# a chip run read (1.65e-4 and 2.67e-4 on an NVIDIA H100 80GB HBM3 at
# 700.00 W), the grad norm's below the 1.08e-3 it read while the expert
# outputs were combined across ranks in bf16 (the loss then read
# 9.96e-5), and, for each parameter after the
# last step, the norm of
# (sharded - unsharded) over the unsharded one's norm within MP_PARAM_MULT
# times the same measure between the unsharded run and its float32 copy
# (the model's own bf16 floor, the rule of phases 7 and 16). A fixed
# share will not do: AdamW moves an element by about lr a step whatever
# its gradient, so where a gradient is near zero a bf16-level difference
# flips its sign (that first run read 0.64 of the largest value of the
# zero-initialised blocks.0.pre_norm.scale); the norm, not the largest
# element, so that one flipped element does not decide a leaf.
MP_LOSS_RTOL = 5e-4
MP_NORM_RTOL = 8e-4
MP_PARAM_MULT = 2.0
# the settings a spawned rank takes from the parent (a rehearsal sets some)
MP_SETTINGS = ("MP_DEPTH", "MP_SEQ", "MP_BATCH", "MP_STEPS", "MP_LR",
               "MP_SMOKE", "MP_PIPE", "MP_HIER_SHAPE", "SEQ_PHASE",
               "SEQ_LEN", "SEQ_BATCH", "SEQ_STEPS")

# Phase 20: training under the sequence-sharded layout, run inside phase
# 18's world (no second spawn or build): its four ranks form a (pod 2,
# data 1, model 2) mesh under make_layout(cfg, "train", multi_pod=True) —
# the batch over (data, model), the sequence over pod (each pod rank
# holds SEQ_LEN / 2 positions of its row; K and V gathered over pod with
# an autograd gather), experts over model — and train phase 18's config
# (granite-moe-3b-a800m at full width, depth MP_DEPTH, no token dropped)
# with the aux weight 0: the aux loss is each routing group's (a pod
# rank's block), which the unsharded run cannot take (the CPU tests
# hold it against each group's). The unsharded run on the same batches replays its
# choices. Gates at phase 18's allowances: each step's loss (MP_LOSS_RTOL)
# and grad norm (MP_NORM_RTOL, or twice the unsharded run's own distance
# from its float32 copy where that is larger: after the first update the
# grad norm of these random weights moves with bf16 rounding, 7.1e-2
# between the two at step 1 on an H100, where the sharded run read
# 2.9e-3), step 0's gathered gradients (each
# parameter's within MP_PARAM_MULT times its float32 floor) and the
# sharded evaluation loss with flash_attention (18(b)'s gate, one launch
# a layer on each rank, the second pod rank's at q_offset SEQ_LEN / 2).
SEQ_PHASE = True                 # model_parallel runs phase 20 too
SEQ_MESH = (2, 1, 2)             # (pod, data, model)
SEQ_LEN, SEQ_BATCH = 2048, 2     # the global batch: a row a (data, model)
SEQ_STEPS = 2


def mp_config():
    """Phase 18's config: granite-moe-3b-a800m at full width (or its smoke
    config), MP_DEPTH layers, the capacity raised so that no token drops
    (capacity = the tokens an expert sees)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if MP_SMOKE else get_config)(MP_ARCH)
    m = cfg.moe
    return dataclasses.replace(
        cfg, n_layers=MP_DEPTH, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))


def _route_key(xt) -> tuple:
    import hashlib

    import torch

    raw = xt.detach().contiguous().view(torch.int16).cpu().numpy()
    return tuple(xt.shape), hashlib.sha1(raw.tobytes()).hexdigest()


@contextlib.contextmanager
def moe_routes_by_input(record: list, queue: list | None = None,
                        agree: list | None = None):
    """``moe.route`` recording (``queue`` None: each new input's choice
    appended to ``record``, on the host) or replaying (each new input
    takes the next choice of ``queue``; ``agree`` collects (matching,
    total) of the run's own choices). An input seen before — the
    recompute of a rematerialised layer in backward — takes the choice
    it took."""
    import torch

    from repro_torch.models import moe

    orig, taken = moe.route, {}
    queue = list(queue) if queue is not None else None

    def route(router_w, xt, cfg):
        key = _route_key(xt)
        if key not in taken:
            with torch.no_grad():
                own = orig(router_w, xt, cfg)[0]
            if queue is None:
                taken[key] = own
                record.append(own.cpu())
            else:
                taken[key] = queue.pop(0).to(xt.device)
                agree.append((int((own == taken[key]).sum()), own.numel()))
        idx = taken[key]
        logits = moe.router_logits(router_w, xt, cfg)
        return (idx, *moe.combine(logits, idx, cfg))

    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


def _mp_batch(cfg, step: int) -> dict:
    """Step ``step``'s global Markov batch (seed 0), on the host."""
    import torch

    from repro_torch.data.pipeline import DataConfig, MarkovSource

    src = MarkovSource(cfg, DataConfig(seq_len=MP_SEQ, batch_size=MP_BATCH))
    return {k: torch.from_numpy(v) for k, v in src.batch_at(step).items()}


def mp_reference(dev, cfg, routes: list | None = None,
                 widen: bool = False) -> dict:
    """Phase 18's unsharded run: the model of seed 0, MP_STEPS AdamW steps
    on the function the sharded run computes — the mean over the EP
    groups (the mesh's data rows: MP_BATCH / MP_MESH[0] rows each) of
    ``lm.loss_fn`` on the group's rows — recording the expert choices per
    step and group (``routes`` None) or replaying ``routes``. ``widen``:
    the model in float32 (``.float()``), the yardstick of the parameter
    gate. Returns the final parameters (the model freed), the history,
    the choices, the plain full-batch loss at step 0 and the peak."""
    import torch

    from repro_torch.models import lm
    from repro_torch.training.optimizer import make_optimizer

    model = lm.init(torch.Generator(dev).manual_seed(0), cfg)
    if widen:
        model = model.float()
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    groups = lm.leaf_groups(model)
    opt = make_optimizer(cfg.optimizer, lr=MP_LR)
    state = opt.init(params, groups)
    rows = MP_BATCH // MP_MESH[0]
    with torch.no_grad():
        _, full = lm.loss_fn(model, {k: v.to(dev) for k, v in
                                     _mp_batch(cfg, 0).items()})
    hist, recorded = [], []
    for step in range(MP_STEPS):
        batch = {k: v.to(dev) for k, v in _mp_batch(cfg, step).items()}
        _sync(dev)
        t0 = time.perf_counter()
        for p in params.values():
            p.grad = None
        total, losses = 0.0, []
        record: list = []
        queue = None if routes is None else [r for g in routes[step]
                                             for r in g]
        with moe_routes_by_input(record, queue, []):
            for g in range(MP_MESH[0]):
                t, m = lm.loss_fn(model, {k: v[g * rows:(g + 1) * rows]
                                          for k, v in batch.items()})
                total = total + t / MP_MESH[0]
                losses.append(m["loss"])
            total.backward()
        n = len(record) // MP_MESH[0]
        recorded.append([record[g * n:(g + 1) * n]
                         for g in range(MP_MESH[0])])
        _, state, norm = opt.update(params, {k: p.grad for k, p in
                                             params.items()}, state, step,
                                    groups)
        _sync(dev)
        hist.append({"loss": float(sum(losses) / len(losses)),
                     "grad_norm": float(norm),
                     "ms": (time.perf_counter() - t0) * 1e3})
    out = {"params": {n: p.detach().clone() for n, p in params.items()},
           "history": hist, "routes": recorded,
           "full_batch_loss": float(full["loss"]),
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if dev.type == "cuda" else None)}
    del model, params, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def seq_config():
    """Phase 20's config: phase 18's with the aux weight 0."""
    import dataclasses

    cfg = mp_config()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, aux_loss_weight=0.0))


def _seq_batch(cfg, step: int) -> dict:
    """Phase 20's global Markov batch of step ``step``, on the host."""
    import torch

    from repro_torch.data.pipeline import DataConfig, MarkovSource

    src = MarkovSource(cfg, DataConfig(seq_len=SEQ_LEN,
                                       batch_size=SEQ_BATCH))
    return {k: torch.from_numpy(v) for k, v in src.batch_at(step).items()}


def seq_reference(dev, cfg, routes: list | None = None,
                  widen: bool = False) -> dict:
    """Phase 20's unsharded run: the model of seed 0, SEQ_STEPS AdamW
    steps on the whole batch, recording each step's expert choices
    (``routes`` None) or replaying ``routes``; ``widen``: in float32.
    Returns the history, the choices and step 0's gradients (float32)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.training.optimizer import make_optimizer

    model = lm.init(torch.Generator(dev).manual_seed(0), cfg)
    if widen:
        model = model.float()
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    groups = lm.leaf_groups(model)
    opt = make_optimizer(cfg.optimizer, lr=MP_LR)
    state = opt.init(params, groups)
    hist, recorded, grads0 = [], [], None
    for step in range(SEQ_STEPS):
        batch = {k: v.to(dev) for k, v in _seq_batch(cfg, step).items()}
        for p in params.values():
            p.grad = None
        record: list = []
        queue = None if routes is None else routes[step]
        with moe_routes_by_input(record, queue, []):
            total, m = lm.loss_fn(model, batch)
            total.backward()
        recorded.append(record)
        grads = {k: p.grad for k, p in params.items()}
        if grads0 is None:
            grads0 = {k: g.float().clone() for k, g in grads.items()}
        _, state, norm = opt.update(params, grads, state, step, groups)
        hist.append({"loss": float(m["loss"]), "grad_norm": float(norm)})
    del model, params, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"history": hist, "routes": recorded, "grads": grads0}


class _FirstGrads:
    """An optimizer that keeps its first update's gradients gathered
    whole (a sharded model's), then updates as ``opt``."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update(self, params, grads, state, step, groups=None, sharded=None):
        from repro_torch.distributed import sharding

        if self.grads is None:
            self.grads = {n: sharding.gather_full(
                g, sharded.specs[n], sharded.mesh).cpu()
                for n, g in grads.items()}
        return self.opt.update(params, grads, state, step, groups, sharded)


def _seq_rank(dev, rank: int, tmp: str) -> dict:
    """Phase 20 on one rank of phase 18's world: SEQ_STEPS sharded steps
    under the two-pod train layout, the pod rank's block of the recorded
    choices replayed; step 0's gradients gathered (rank 0 writes them);
    the sharded evaluation loss (``_mp_eval``)."""
    import torch

    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.step import make_train_step

    t_rank = time.perf_counter()
    cfg = seq_config()
    mesh = make_test_mesh(SEQ_MESH[1], SEQ_MESH[2], n_pod=SEQ_MESH[0])
    ctx = sharding.make_ctx(cfg, mesh, sharding.make_layout(
        cfg, "train", True, SEQ_BATCH))
    pod = collectives.mesh_coords(mesh)["pod"]
    half = SEQ_LEN // SEQ_MESH[0]
    routes = torch.load(Path(tmp) / "seq_routes.pt")
    queue = [r.reshape(SEQ_BATCH, SEQ_LEN, -1)[:, pod * half:(pod + 1)
                                               * half].reshape(-1,
                                                               r.shape[-1])
             for step in routes for r in step]
    sm = sharding.ShardedModel.init(cfg, ctx, 0, dev)
    opt = _FirstGrads(make_optimizer(cfg.optimizer, lr=MP_LR))
    state = opt.opt.init(sm.shards, sm.groups, sharded=sm)
    step_fn = make_train_step(cfg, opt, ctx=ctx)
    hist, agree = [], []
    with moe_routes_by_input([], queue, agree):
        for step in range(SEQ_STEPS):
            batch = {k: v.to(dev) for k, v in sharding.batch_rows(
                _seq_batch(cfg, step), ctx).items()}
            before = sum(collectives.BYTES.values())
            _sync(dev)
            t0 = time.perf_counter()
            sm, state, m = step_fn(sm, state, batch, step)
            _sync(dev)
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "bytes": sum(collectives.BYTES.values())
                         - before})
    if rank == 0:
        torch.save(opt.grads, Path(tmp) / "seq_grads.pt")
    ebatch = {k: v.to(dev) for k, v in sharding.batch_rows(
        _seq_batch(cfg, SEQ_STEPS), ctx).items()}
    ev = _mp_eval(dev, cfg, sm, ctx, ebatch, model_counters())
    del sm, state, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"history": hist, "eval": ev, "agree": agreement(agree),
            "layout": [ctx.batch, ctx.seq, tuple(ctx.ep_axes)],
            "s": time.perf_counter() - t_rank}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _mp_eval(dev, cfg, sm, ctx, batch, counters: dict) -> dict:
    """Phase 18 (b): the sharded evaluation loss under ``torch.no_grad()``
    with the kernels, their plain versions and the attention ops in
    float32; the kernels' launches read around the first."""
    import torch

    out, launches = {}, {}
    with torch.no_grad():
        for mode in ("auto", "off", "off32"):
            ctx32 = (float32_attention() if mode == "off32"
                     else contextlib.nullcontext())
            for fn in counters.values():
                fn.launches = 0
            _sync(dev)
            t0 = time.perf_counter()
            with ctx32:
                _, m = sm.loss(batch, "auto" if mode == "auto" else "off")
            _sync(dev)
            out[mode] = {"loss": float(m["loss"]),
                         "ms": (time.perf_counter() - t0) * 1e3}
            if mode == "auto":
                launches = {k: fn.launches for k, fn in counters.items()}
    return {"loss": out, "launches": launches}


def _mp_collectives(dev) -> dict:
    """Phase 18 (d): ``hierarchical_grad_reduce`` on a (pod 2, data 2)
    mesh against the flat mean (rtol 1e-6, the JAX test's), and
    ``pipeline_apply`` with 2 stages over ``pod`` against the stages
    applied in turn (1e-5, the JAX test's), on ``dev``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import collectives, pipeline

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("pod", "data"))
    c = collectives.mesh_coords(mesh)
    gen = torch.Generator(dev).manual_seed(18)
    base = torch.randn(MP_HIER_SHAPE, generator=gen, device=dev)
    grads = {"w": base * (c["pod"] * 2 + c["data"] + 1),
             "b": torch.full((7,), float(c["pod"] * 10 + c["data"]),
                             device=dev)}
    got = collectives.hierarchical_grad_reduce(grads, mesh)
    want = {"w": base * 2.5, "b": torch.full((7,), 5.5, device=dev)}
    hier = max(float(((got[k] - want[k]).abs() / want[k].abs()).max())
               for k in want)
    stages, micro, rows, width = MP_PIPE
    w = torch.randn(stages, width, width, generator=gen, device=dev) \
        * width**-0.5
    x = torch.randn(micro, rows, width, generator=gen, device=dev)
    out = pipeline.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]),
                                  {"w": w}, x, mesh)
    ref = x
    for s in range(stages):
        ref = torch.tanh(ref @ w[s])
    return {"hier_rel_err": hier,
            "pipeline_err": float((out - ref).abs().max())}


def model_parallel_rank(rank: int, src: str, store: str, tmp: str,
                        device: str, settings: dict) -> None:
    """One rank of phase 18, spawned: (a) MP_STEPS sharded steps replaying
    the unsharded run's expert choices for its EP group; (b) the sharded
    evaluation loss; (d) the collectives; (c) the final state gathered and
    written by rank 0, restored through ``reshard_state`` onto the (1, 2)
    mesh that ``elastic.plan_for(2, model_degree=2)`` gives (ranks 0-1,
    made last) and onto one device (rank 0). Saves what it measured.
    ``settings``: the parent's values of ``MP_SETTINGS``."""
    globals().update(settings)
    sys.path.insert(0, src)
    import dataclasses

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import collectives, elastic, multihost
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cpu":  # four ranks share the host's cores
        torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", 4, rank, device=device,
                         set_default_mesh=False, timeout_s=300.0)
    try:
        out: dict = {}
        if dev.type == "cuda":
            out["gloo_cuda"] = collectives.gloo_takes_cuda()
        cfg = mp_config()
        mesh = make_test_mesh(*MP_MESH)
        ctx = sharding.make_ctx(cfg, mesh, sharding.make_layout(
            cfg, "train", False, MP_BATCH))
        d = collectives.mesh_coords(mesh)["data"]
        routes = torch.load(Path(tmp) / "routes.pt")
        queue = [r for step in routes for r in step[d]]
        _sync(dev)
        t0 = time.perf_counter()
        sm = sharding.ShardedModel.init(cfg, ctx, 0, dev)
        opt = make_optimizer(cfg.optimizer, lr=MP_LR)
        state = opt.init(sm.shards, sm.groups, sharded=sm)
        _sync(dev)
        out["init_s"] = time.perf_counter() - t0
        step_fn = make_train_step(cfg, opt, ctx=ctx)
        hist, agree = [], []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with moe_routes_by_input([], queue, agree):
            for step in range(MP_STEPS):
                batch = {k: v.to(dev) for k, v in sharding.batch_rows(
                    _mp_batch(cfg, step), ctx).items()}
                before = sum(collectives.BYTES.values())
                _sync(dev)
                t0 = time.perf_counter()
                sm, state, m = step_fn(sm, state, batch, step)
                _sync(dev)
                hist.append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "bytes": sum(collectives.BYTES.values())
                             - before})
        out.update(history=hist, agree=agreement(agree),
                   bytes_by_op=dict(collectives.BYTES),
                   peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                            if dev.type == "cuda" else None))
        ebatch = {k: v.to(dev) for k, v in sharding.batch_rows(
            _mp_batch(cfg, MP_STEPS), ctx).items()}
        out["eval"] = _mp_eval(dev, cfg, sm, ctx, ebatch, model_counters())
        out["collectives"] = _mp_collectives(dev)
        if SEQ_PHASE:  # before (c): its mesh leaves ranks out
            out["seq"] = _seq_rank(dev, rank, tmp)
        # (c) the state gathered (the checkpoint's one-device layout)
        full = sm.full_params()
        ckdir = Path(tmp) / "ckpt"
        if rank == 0:
            ckpt.save(ckdir, MP_STEPS, full)
        collectives.all_reduce(torch.zeros(1), mesh, ("data", "model"))
        plan = elastic.plan_for(2, model_degree=2)
        sub = DeviceMesh("cpu", torch.arange(2).reshape(plan.mesh_shape),
                         mesh_dim_names=plan.axis_names)
        like = {n: torch.empty(0, dtype=t.dtype, device=dev)
                for n, t in full.items()}
        if rank < 2:
            blocks = elastic.reshard_state(cfg, str(ckdir), MP_STEPS, like,
                                           sub)
            specs = sharding.port_param_specs(sm.meta, cfg)
            out["reshard_equal"] = all(torch.equal(
                sharding.gather_full(blocks[n], specs[n], sub), full[n])
                for n in full)
            out["reshard_blocks"] = sum(blocks[n].numel() < full[n].numel()
                                        for n in full)
        if rank == 0:
            whole = elastic.reshard_state(cfg, str(ckdir), MP_STEPS, like,
                                          None)
            out["one_device_equal"] = all(torch.equal(whole[n], full[n])
                                          for n in full)
            out["plan"] = dataclasses.asdict(plan)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        multihost.shutdown()


def seq_gates(dev, seq: dict, seq32: dict, ranks: list,
              t_seq: float) -> dict:
    """Phase 20's gates on what its ranks measured inside phase 18's
    world (``_seq_rank``) against the unsharded run (``seq_reference``)
    and its float32 copy; returns the measurements and ``failed``."""
    import torch

    failed: list[str] = []
    if not ranks:
        record_gate("phase 20 ranks", math.inf)
        return {"failed": ["(20) no rank finished"]}
    runs = [r["seq"] for r in ranks]
    r0 = runs[0]
    worst = {"loss": 0.0, "grad_norm": 0.0}
    norm_gate, finite = 0.0, True
    for h, w, w32 in zip(r0["history"], seq["history"], seq32["history"],
                         strict=True):
        for key in worst:
            finite &= math.isfinite(h[key])
            worst[key] = max(worst[key], abs(h[key] - w[key]) / abs(w[key]))
        # the grad norm after an update: MP_NORM_RTOL, or twice the
        # unsharded run's own distance from its float32 copy where that
        # is larger (7.1e-2 at step 1 on an H100)
        allow = max(MP_NORM_RTOL, 2 * abs(w32["grad_norm"] - w["grad_norm"])
                    / abs(w["grad_norm"]))
        norm_gate = max(norm_gate, abs(h["grad_norm"] - w["grad_norm"])
                        / abs(w["grad_norm"]) / allow)

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.float() - b.float())
                     ) / max(float(torch.linalg.vector_norm(b.float())),
                             1e-30)

    want = seq["grads"]
    got = seq["sharded_grads"]
    per_leaf = {n: (rel(got[n].to(w.device), w),
                    rel(seq32["grads"][n], w)) for n, w in want.items()}
    gworst = max(((e / (MP_PARAM_MULT * f) if f else
                   (0.0 if e == 0 else math.inf)), n, e, f)
                 for n, (e, f) in per_leaf.items())
    record_gate("phase 20 loss", worst["loss"] / MP_LOSS_RTOL)
    record_gate("phase 20 grad norm", norm_gate)
    record_gate("phase 20 gradients", gworst[0])
    if not finite or worst["loss"] > MP_LOSS_RTOL or not norm_gate <= 1.0:
        failed.append(f"(20) steps {r0['history']} vs unsharded "
                      f"{seq['history']}: worst {worst}")
    if not gworst[0] <= 1.0:
        failed.append(f"(20) gradient of {gworst[1]}: {gworst[2]} of its "
                      f"norm, floor {gworst[3]}")
    if not all([h["loss"] for h in r["history"]]
               == [h["loss"] for h in r0["history"]] for r in runs):
        failed.append("(20) the ranks' global losses differ")
    log(f"[20] sharded on a {' x '.join(map(str, SEQ_MESH))} (pod, data, "
        f"model) mesh, layout (batch, seq, experts) "
        f"{json.dumps(r0['layout'])}: rank 0 steps "
        f"{json.dumps(r0['history'])}; worst relative loss / grad-norm "
        f"difference {json.dumps(worst)} (the grad norm's gate read "
        f"{norm_gate} of its allowance); step 0's gradients: the worst "
        f"leaf against {MP_PARAM_MULT} x its float32 floor {gworst[0]} "
        f"({gworst[1]}: {gworst[2]} of its norm, floor {gworst[3]}); "
        f"collective bytes a step per rank "
        f"{json.dumps([[h['bytes'] for h in r['history']] for r in runs])}; "
        f"routing agreement without replay "
        f"{json.dumps([r['agree'] for r in runs])}; rank seconds "
        f"{json.dumps([r['s'] for r in runs])}")
    ev = r0["eval"]["loss"]
    diff = abs(ev["auto"]["loss"] - ev["off"]["loss"])
    floor = abs(ev["off32"]["loss"] - ev["off"]["loss"])
    bound_ = max(2 * floor, EVAL_LOSS_RTOL * abs(ev["off"]["loss"]))
    record_gate("phase 20 eval loss", diff / bound_)
    launches = [r["eval"]["launches"].get("flash_attention") for r in runs]
    want_n = MP_DEPTH if dev.type == "cuda" else 0
    log(f"[20] sharded evaluation loss (no_grad, the second pod rank's "
        f"flash_attention at q_offset {SEQ_LEN // SEQ_MESH[0]}): kernels "
        f"{ev['auto']['loss']}, plain {ev['off']['loss']}, plain in float32 "
        f"{ev['off32']['loss']}; |kernels - plain| {diff}, bound {bound_}; "
        f"ms {json.dumps({k: v['ms'] for k, v in ev.items()})}; "
        f"flash_attention launches per rank {launches} (one a layer: "
        f"{want_n})")
    if not diff <= bound_:
        failed.append(f"(20) evaluation loss {ev}")
    if launches != [want_n] * len(runs):
        failed.append(f"(20) flash_attention launched {launches}")
    secs = seq["ref_s"] + max(r["s"] for r in runs)
    log(f"[20] phase 20: {secs}s (budget 45 s; the unsharded runs "
        f"{seq['ref_s']}s, the ranks' part {max(r['s'] for r in runs)}s, "
        f"inside phase 18's spawn; {time.perf_counter() - t_seq}s from its "
        f"start to its gates, phase 18's ranks included)")
    return {"failed": failed, "eval_launches": sum(launches), "worst": worst,
            "grad_worst": gworst[0], "history": r0["history"],
            "reference": seq["history"], "s": secs}


def model_parallel(dev, src, raise_on_fail: bool = True) -> dict:
    """Phase 18: the unsharded reference (``mp_reference``), then four
    ranks on ``dev`` (``model_parallel_rank``, spawned, joined within
    MP_LIMIT_S) and the gates: (a) each step's loss and grad norm
    within MP_LOSS_RTOL / MP_NORM_RTOL of the unsharded run's, every
    parameter after the last step within MP_PARAM_MULT times its float32
    floor of the unsharded one, all finite; (b) the sharded evaluation loss with the kernels
    within twice the plain path's float32 distance (at least
    EVAL_LOSS_RTOL of it), ``flash_attention`` launched once a layer on
    each rank; (c) the resharded states bit-equal to the gathered one;
    (d) the collectives at the JAX tests' tolerances. Returns the
    evaluation's kernel launches (summed over the ranks) and the
    measurements."""
    import tempfile

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import multihost

    t_phase = time.perf_counter()
    cfg = mp_config()
    failed: list[str] = []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ref = mp_reference(dev, cfg)
    t_ref = time.perf_counter() - t_phase
    ref32 = mp_reference(dev, cfg, ref["routes"], widen=True)
    log(f"[18] {cfg.name} at depth {MP_DEPTH} "
        f"({sum(p.numel() for p in ref['params'].values())} parameters), "
        f"{MP_BATCH} x {MP_SEQ} tokens a step, unsharded: "
        f"{json.dumps(ref['history'])}; plain full-batch loss at step 0 "
        f"{ref['full_batch_loss']} (the global aux loss); peak "
        f"{ref['peak_gb']} GB; {t_ref}s; in float32 "
        f"{json.dumps(ref32['history'])}, "
        f"{time.perf_counter() - t_phase - t_ref}s")
    seq = seq32 = None
    if SEQ_PHASE:
        t_seq = time.perf_counter()
        scfg = seq_config()
        seq = seq_reference(dev, scfg)
        seq32 = seq_reference(dev, scfg, seq["routes"], widen=True)
        seq["ref_s"] = time.perf_counter() - t_seq
        log(f"[20] {scfg.name} at depth {MP_DEPTH}, {SEQ_BATCH} x {SEQ_LEN} "
            f"tokens a step, unsharded: {json.dumps(seq['history'])}; in "
            f"float32 {json.dumps(seq32['history'])}; {seq['ref_s']}s")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(ref["routes"], Path(tmp) / "routes.pt")
        if SEQ_PHASE:
            torch.save(seq["routes"], Path(tmp) / "seq_routes.pt")
        t0 = time.perf_counter()
        try:
            secs = multihost.spawn(model_parallel_rank, 4,
                                   (str(src), f"{tmp}/store", tmp,
                                    "cuda:0" if dev.type == "cuda" else
                                    "cpu",
                                    {k: globals()[k] for k in MP_SETTINGS}),
                                   MP_LIMIT_S)
        except RuntimeError as exc:
            record_gate("phase 18 ranks", math.inf)
            failed.append(str(exc))
            secs, ranks = time.perf_counter() - t0, []
        else:
            ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(4)]
        if ranks:
            saved = ckpt.restore(Path(tmp) / "ckpt", MP_STEPS,
                                 ref["params"])
            if SEQ_PHASE:
                seq["sharded_grads"] = torch.load(Path(tmp) / "seq_grads.pt")
    res: dict = {"spawn_s": secs, "eval_launches": 0,
                 "seq_eval_launches": 0}
    if ranks:
        r0 = ranks[0]
        # (a) the steps
        worst = {"loss": 0.0, "grad_norm": 0.0}
        finite = True
        for h, w in zip(r0["history"], ref["history"]):
            for key in worst:
                finite &= math.isfinite(h[key])
                worst[key] = max(worst[key], abs(h[key] - w[key])
                                 / abs(w[key]))
        def rel(a, b):
            return float(torch.linalg.vector_norm(a.float() - b.float())
                         ) / max(float(torch.linalg.vector_norm(b.float())),
                                 1e-30)

        per_leaf = {n: (rel(saved[n], p), rel(ref32["params"][n], p))
                    for n, p in ref["params"].items()}
        pworst = max(((e / (MP_PARAM_MULT * f) if f else
                       (0.0 if e == 0 else math.inf)), n, e, f)
                     for n, (e, f) in per_leaf.items())
        record_gate("phase 18 (a) loss", worst["loss"] / MP_LOSS_RTOL)
        record_gate("phase 18 (a) grad norm",
                    worst["grad_norm"] / MP_NORM_RTOL)
        record_gate("phase 18 (a) parameters", pworst[0])
        if not finite or worst["loss"] > MP_LOSS_RTOL or \
                worst["grad_norm"] > MP_NORM_RTOL:
            failed.append(f"(a) steps {r0['history']} vs unsharded "
                          f"{ref['history']}: worst {worst}")
        if not pworst[0] <= 1.0:
            failed.append(f"(a) parameter {pworst[1]}: {pworst[2]} of its "
                          f"norm, floor {pworst[3]}")
        same = all(r["history"][i][k] == r0["history"][i][k]
                   for r in ranks for i in range(MP_STEPS)
                   for k in ("loss", "grad_norm"))
        if not same:
            failed.append("(a) the ranks' global losses differ")
        steady = [h["ms"] for h in r0["history"][1:]]
        wsteady = [h["ms"] for h in ref["history"][1:]]
        log(f"[18] (a) sharded on a {MP_MESH[0]} x {MP_MESH[1]} (data, "
            f"model) mesh of ranks on {dev}: rank 0 steps "
            f"{json.dumps(r0['history'])}; step ms (host clock, "
            f"synchronized) first {r0['history'][0]['ms']} then "
            f"{json.dumps(steady)}, unsharded first "
            f"{ref['history'][0]['ms']} then {json.dumps(wsteady)}; worst "
            f"relative loss / grad-norm difference {json.dumps(worst)}; "
            f"parameters: the worst leaf against {MP_PARAM_MULT} x its "
            f"float32 floor {pworst[0]} ({pworst[1]}: {pworst[2]} of its "
            f"norm, floor {pworst[3]}), the largest difference "
            f"{max(e for e, _ in per_leaf.values())} of a norm; peak memory "
            f"per rank GB "
            f"{json.dumps([r['peak_gb'] for r in ranks])}; collective "
            f"bytes a step per rank {json.dumps([[h['bytes'] for h in r['history']] for r in ranks])}, "
            f"by op (rank 0, whole phase) {json.dumps(r0['bytes_by_op'])}; "
            f"routing agreement without replay {json.dumps([r['agree'] for r in ranks])}; "
            f"sharded init s {json.dumps([r['init_s'] for r in ranks])}")
        if "gloo_cuda" in r0:
            took = [k for k, v in r0["gloo_cuda"].items() if v]
            staged = [k for k, v in r0["gloo_cuda"].items() if not v]
            log(f"[18] gloo on CUDA tensors took {took}; staged through "
                f"pinned host buffers: {staged}")
        # (b) the evaluation loss
        ev = r0["eval"]["loss"]
        diff = abs(ev["auto"]["loss"] - ev["off"]["loss"])
        floor = abs(ev["off32"]["loss"] - ev["off"]["loss"])
        bound_ = max(2 * floor, EVAL_LOSS_RTOL * abs(ev["off"]["loss"]))
        record_gate("phase 18 (b) eval loss", diff / bound_)
        launches = [r["eval"]["launches"].get("flash_attention")
                    for r in ranks]
        want = MP_DEPTH if dev.type == "cuda" else 0
        res["eval_launches"] = sum(launches)
        log(f"[18] (b) sharded evaluation loss (no_grad): kernels "
            f"{ev['auto']['loss']}, plain {ev['off']['loss']}, plain in "
            f"float32 {ev['off32']['loss']}; |kernels - plain| {diff}, bound "
            f"{bound_}; ms {json.dumps({k: v['ms'] for k, v in ev.items()})}; "
            f"flash_attention launches per rank {launches} (one a layer: "
            f"{want})")
        if not diff <= bound_:
            failed.append(f"(b) evaluation loss {ev}")
        if launches != [want] * 4:
            failed.append(f"(b) flash_attention launched {launches}")
        # (c) elastic
        eq = [r.get("reshard_equal") for r in ranks[:2]]
        record_gate("phase 18 (c) reshard", 0.0 if all(eq) and
                    r0["one_device_equal"] else math.inf)
        log(f"[18] (c) plan_for(2, model_degree=2): {json.dumps(r0['plan'])}; "
            f"reshard onto it bit-equal {eq} ({r0['reshard_blocks']} leaves "
            f"split), onto one device {r0['one_device_equal']}")
        if not all(eq) or not r0["one_device_equal"]:
            failed.append(f"(c) reshard {eq}, one device "
                          f"{r0['one_device_equal']}")
        # (d) collectives
        hier = max(r["collectives"]["hier_rel_err"] for r in ranks)
        pipe = max(r["collectives"]["pipeline_err"] for r in ranks)
        record_gate("phase 18 (d) hierarchical reduce", hier / 1e-6)
        record_gate("phase 18 (d) pipeline", pipe / 1e-5)
        log(f"[18] (d) hierarchical_grad_reduce on (pod 2, data 2) of "
            f"{MP_HIER_SHAPE}: worst relative error {hier}; pipeline_apply "
            f"{MP_PIPE[0]} stages x {MP_PIPE[1]} microbatches: max error "
            f"{pipe}")
        if not hier <= 1e-6 or not pipe <= 1e-5:
            failed.append(f"(d) hierarchical {hier}, pipeline {pipe}")
        res.update(ranks=[{k: r[k] for k in ("history", "peak_gb", "agree")}
                          for r in ranks], reference=ref["history"],
                   worst=worst, param_worst=pworst[0])
    if SEQ_PHASE:
        res["seq"] = seq_gates(dev, seq, seq32, ranks, t_seq)
        res["seq_eval_launches"] = res["seq"].get("eval_launches", 0)
        failed += res["seq"]["failed"]
    del ref, ref32, seq, seq32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"[18] phase 18: {secs}s (budget 120 s; spawn to exit {res['spawn_s']}s)")
    if failed:
        if raise_on_fail:
            raise AssertionError("phase 18: " + "; ".join(failed))
        for f in failed:
            log(f"    gate failed: {f}")
    return res


# Phase 21: the dry run (``repro_torch.launch.dryrun``), each cell a
# subprocess (the cells and the one-device step in parallel, on the
# host's cores: the dry run traces fake tensors and never touches the
# card): gemma2-2b train_4k on the multi-pod mesh (512 fake ranks, the
# sequence over pod) and mamba2-370m decode_32k on the single mesh (the
# JAX test's cell), each record ok with FLOPs, and their roofline rows on
# the H100's peaks; ungated, the dry run's temp bytes of phase 17's
# one-device gemma2-2b step beside the peak phase 17 measured.
DRY_CELLS = (("gemma2-2b", "train_4k", "multi"),
             ("mamba2-370m", "decode_32k", "single"))
DRY_ONE = ("gemma2-2b", PROMPT, 1)   # phase 17's first TRAIN_RUNS entry
DRY_SMOKE = False                    # the one-device step's smoke config
DRY_LIMIT_S = 150.0


def dry_run(dev, src, peak17_gb: float | None = None,
            raise_on_fail: bool = True) -> dict:
    """Phase 21: ``python -m repro_torch.launch.dryrun`` on DRY_CELLS and
    on DRY_ONE's one-device step, subprocesses started together and
    joined within DRY_LIMIT_S (killed past it); every record ok with
    ``scaled_flops > 0``. Prints the records, their roofline rows and
    the one-device step's temp bytes beside ``peak17_gb``."""
    import tempfile

    from repro_torch.bench import roofline

    t_phase = time.perf_counter()
    failed: list[str] = []
    env = dict(os.environ, PYTHONPATH=str(src))
    out: dict = {"cells": {}}
    with tempfile.TemporaryDirectory() as tmp:
        cells_dir, one_dir = Path(tmp) / "cells", Path(tmp) / "one"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        arch, seq, batch = DRY_ONE
        argvs = [cmd + ["--arch", a, "--shape", sh, "--mesh", m, "--out",
                        str(cells_dir)] for a, sh, m in DRY_CELLS]
        argvs.append(cmd + ["--arch", arch, "--one-device", str(seq),
                            str(batch), "--out", str(one_dir)]
                     + (["--smoke"] if DRY_SMOKE else []))
        procs = [subprocess.Popen(a, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for a in argvs]
        for p in procs:
            left = max(1.0, t_phase + DRY_LIMIT_S - time.perf_counter())
            try:
                stdout, stderr = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, stderr = p.communicate()
                failed.append(f"{p.args[3:9]} ran past {DRY_LIMIT_S} s")
            if p.returncode != 0:
                failed.append(f"{p.args[3:9]} exited {p.returncode}: "
                              f"{stderr[-1500:]}")
        for a, sh, m in DRY_CELLS:
            f = cells_dir / f"{a}_{sh}_{m}.json"
            rec = json.loads(f.read_text()) if f.exists() else {"ok": False}
            out["cells"][f.stem] = rec
            ok = bool(rec.get("ok")) and rec.get("scaled_flops", 0) > 0
            record_gate(f"phase 21 {f.stem}", 0.0 if ok else math.inf)
            log(f"[21] {f.stem}: " + json.dumps(
                {k: v for k, v in rec.items() if k != "traceback"}))
            if not ok:
                failed.append(f"{f.stem}: {rec.get('error', 'no record')}")
        for row in roofline.dryrun_rows(cells_dir):
            log(f"[21] {row[0]}: {row[2]} (trace {row[1] / 1e6}s)")
        f = one_dir / f"{arch}_one_device_{seq}x{batch}.json"
        one = json.loads(f.read_text()) if f.exists() else {"ok": False}
        out["one_device"] = one
        log(f"[21] {arch}'s one-device train step, {batch} x {seq} tokens "
            f"(phase 17's; ungated): dry-run temp bytes "
            f"{one.get('temp_size_in_bytes')} and arguments "
            f"{one.get('argument_size_in_bytes')} (peak "
            f"{(one['temp_size_in_bytes'] + one['argument_size_in_bytes']) / 1e9 if one.get('ok') else None}"
            f" GB) beside phase 17's torch.cuda.max_memory_allocated "
            f"{peak17_gb} GB; trace {one.get('trace_s')}s")
    secs = time.perf_counter() - t_phase
    out["s"] = secs
    log(f"[21] phase 21: {secs}s (budget 40 s)")
    if failed:
        if raise_on_fail:
            raise AssertionError("phase 21: " + "; ".join(failed))
        for f in failed:
            log(f"    gate failed: {f}")
    return out


SERVE_MP_ARCH = "gemma2-2b"
SERVE_MP_DEPTH = 26              # an even depth: local and global layers
SERVE_MP_MESH = (2, 2)           # (data, model)
SERVE_MP_LEN = PROMPT + 16       # the dense cache: 4,624 slots
SERVE_MP_STEPS = 8
SERVE_MP_B1 = (512, 4)           # (b): the prompt and the decode steps
SERVE_MP_SMOKE = False           # the smoke config (the CPU rehearsal)
SERVE_MP_PROMPT = PROMPT
SERVE_MP_LIMIT_S = 400.0
SERVE_MP_SETTINGS = ("SERVE_MP_DEPTH", "SERVE_MP_LEN", "SERVE_MP_STEPS",
                     "SERVE_MP_B1", "SERVE_MP_SMOKE", "SERVE_MP_PROMPT")


def serve_mp_config():
    """Phase 19's config: gemma2-2b at full width (or its smoke config),
    SERVE_MP_DEPTH layers."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if SERVE_MP_SMOKE else get_config)(SERVE_MP_ARCH)
    return dataclasses.replace(cfg, n_layers=SERVE_MP_DEPTH)


def _serve_tokens(cfg, batch: int, length: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(19 + batch)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, length)))


def lse_err(got, want) -> tuple[float, float]:
    """(max abs error, worst ratio to ``ATTN_REL * max(1, |lse|)``) of a
    log-sum-exp (B, H) against its plain version; -inf (no live slot)
    must meet -inf."""
    import torch

    g, w = got.float(), want.float()
    if not torch.equal(torch.isneginf(g), torch.isneginf(w)):
        return math.inf, math.inf
    live = ~torch.isneginf(w)
    if not bool(live.any()):
        return 0.0, 0.0
    err = (g[live] - w[live]).abs()
    allow = ATTN_REL * w[live].abs().clamp(min=1.0)
    return float(err.max()), float((err / allow).max())


def attn_err(got, want) -> tuple[float, float]:
    """``row_err`` of an attention output; with a log-sum-exp beside it
    (``return_lse``), the worse of the output's and ``lse_err``'s
    ratios."""
    if not isinstance(got, tuple):
        return row_err(got, want)
    err, ratio = row_err(got[0], want[0])
    return err, max(ratio, lse_err(got[1], want[1])[1])


def serve_reference(dev, cfg, tmp: Path) -> dict:
    """Phase 19's unsharded runs in this process: ``lm.init`` from seed 0
    (the weights ``ShardedModel.init`` draws shard by shard), (a) B = 2
    over SERVE_MP_PROMPT tokens and SERVE_MP_STEPS steps, (b) B = 1 over
    SERVE_MP_B1; each with the kernels, their plain versions and the
    attention ops in float32 (the bf16 floor). (b)'s prefill cache with
    the kernels is saved for the ranks' decode. Frees the model."""
    import torch

    from repro_torch.models import decode, lm

    model = lm.init(torch.Generator(dev).manual_seed(0), cfg)
    out = {}
    for case, (b, prompt, steps) in (("a", (2, SERVE_MP_PROMPT,
                                            SERVE_MP_STEPS)),
                                     ("b", (1, *SERVE_MP_B1))):
        toks = _serve_tokens(cfg, b, prompt + steps).to(dev)
        runs, times = {}, {}
        for mode in ("on", "off", "off32"):
            kernel = "off" if mode.startswith("off") else "auto"
            with (float32_attention() if mode == "off32"
                  else contextlib.nullcontext()):
                _sync(dev)
                t0 = time.perf_counter()
                logits, cache = decode.prefill(model, toks[:, :prompt],
                                               SERVE_MP_LEN, kernel=kernel)
                _sync(dev)
                t_pre = time.perf_counter() - t0
                if case == "b" and mode == "on":
                    torch.save(cache, tmp / "b1_cache.pt")
                lg = [logits]
                t0 = time.perf_counter()
                for i in range(steps):
                    logits, cache = decode.decode_step(
                        model, cache, toks[:, prompt + i:prompt + i + 1],
                        prompt + i, kernel=kernel)
                    lg.append(logits)
                _sync(dev)
            runs[mode] = torch.stack(lg).float().cpu()
            times[mode] = {"prefill_ms": t_pre * 1e3,
                           "decode_ms": (time.perf_counter() - t0) * 1e3
                           / steps}
            del cache
        out[case] = {"runs": runs, "times": times}
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def serving_rank(rank: int, src: str, store: str, tmp: str, device: str,
                 settings: dict) -> None:
    """One rank of phase 19, spawned: the weights drawn shard by shard
    under the prefill layout's training specs; (a) the sharded prefill of
    B = 2 (the sequence over ``model``), the shards moved to the decode
    layout's inference blocks, SERVE_MP_STEPS decode steps (KV over
    ``model``); (b) SERVE_MP_B1's decode of B = 1 (KV over (data, model))
    from the unsharded prefill's cache; every attention call also run
    through its plain version. Saves what it measured."""
    globals().update(settings)
    sys.path.insert(0, src)
    import torch

    from repro_torch.distributed import collectives, multihost, sharding, tp
    from repro_torch.distributed.ctx import batch_axes
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import decode

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cpu":  # four ranks share the host's cores
        torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", 4, rank, device=device,
                         set_default_mesh=False, timeout_s=300.0)
    try:
        cfg = serve_mp_config()
        mesh = make_test_mesh(*SERVE_MP_MESH)
        counters = model_counters()
        kernel = "on" if dev.type == "cuda" else "off"
        out: dict = {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        def ctx_of(kind, b):
            return sharding.make_ctx(cfg, mesh, sharding.make_layout(
                cfg, kind, False, b))

        def gathered(x, ctx):
            return collectives.all_gather(x, mesh, batch_axes(ctx), 0)

        def decode_run(dsm, cache, toks, prompt, steps, dctx, rec):
            lg, per_step = [], []
            for i in range(steps):
                b0 = sum(collectives.BYTES.values())
                c0 = sum(collectives.CALLS.values())
                _sync(dev)
                t0 = time.perf_counter()
                logits, cache = decode.decode_step(
                    dsm, cache, toks[:, prompt + i:prompt + i + 1],
                    prompt + i, kernel=kernel, ctx=dctx)
                _sync(dev)
                per_step.append({
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "bytes": sum(collectives.BYTES.values()) - b0,
                    "calls": sum(collectives.CALLS.values()) - c0})
                lg.append(gathered(logits, dctx).float().cpu())
            rec["decode"], rec["steps"] = lg, per_step

        pctx, dctx = ctx_of("prefill", 2), ctx_of("decode", 2)
        _sync(dev)
        t0 = time.perf_counter()
        sm = sharding.ShardedModel.init(cfg, pctx, 0, dev)
        _sync(dev)
        out["init_s"] = time.perf_counter() - t0
        # (a) B = 2: the sequence over model, then KV over model
        a: dict = {}
        worst: dict = {}
        for fn in counters.values():
            fn.launches = 0
        toks = sharding.batch_rows({"t": _serve_tokens(
            cfg, 2, SERVE_MP_PROMPT + SERVE_MP_STEPS)}, pctx)["t"].to(dev)
        with checked_against_plain(worst):
            b0 = sum(collectives.BYTES.values())
            _sync(dev)
            t0 = time.perf_counter()
            logits, cache = decode.prefill(sm, toks[:, :SERVE_MP_PROMPT],
                                           SERVE_MP_LEN, kernel=kernel,
                                           ctx=pctx)
            _sync(dev)
            a["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            a["prefill_bytes"] = sum(collectives.BYTES.values()) - b0
            a["prefill"] = gathered(logits, pctx).float().cpu()
            b0 = sum(collectives.BYTES.values())
            t0 = time.perf_counter()
            dsm = sm.reshard(dctx, inference=True)
            _sync(dev)
            a["reshard_s"] = time.perf_counter() - t0
            a["reshard_bytes"] = sum(collectives.BYTES.values()) - b0
            del sm
            dtoks = sharding.batch_rows({"t": _serve_tokens(
                cfg, 2, SERVE_MP_PROMPT + SERVE_MP_STEPS)},
                dctx)["t"].to(dev)
            decode_run(dsm, cache, dtoks, SERVE_MP_PROMPT, SERVE_MP_STEPS,
                       dctx, a)
        del cache
        a["launches"] = {k: fn.launches for k, fn in counters.items()}
        a["checked"] = worst
        # (b) B = 1: KV over (data, model), from the unsharded prefill's
        # cache; the inference rules' blocks do not depend on the batch
        b: dict = {}
        worst = {}
        for fn in counters.values():
            fn.launches = 0
        dctx1 = ctx_of("decode", 1)
        whole = torch.load(Path(tmp) / "b1_cache.pt", map_location=dev)
        specs = sharding.cache_specs(cfg, mesh, sharding.make_layout(
            cfg, "decode", False, 1), whole)
        cache = sharding.cache_blocks(whole, specs, mesh)
        del whole
        prompt, steps = SERVE_MP_B1
        with checked_against_plain(worst):
            decode_run(dsm, cache, _serve_tokens(cfg, 1, prompt + steps).to(
                dev), prompt, steps, dctx1, b)
        b["launches"] = {k: fn.launches for k, fn in counters.items()}
        b["checked"] = worst
        blk = cache[1]["k"].shape[1]   # layer 1: a global layer
        lo = tp.axes_index(mesh, dctx1.kv_seq) * blk
        b["live_slots"] = int((cache[1]["pos"][lo:lo + blk] >= 0).sum())
        out.update(a=a, b=b, gathered_at_use=sorted(dsm.gathered_at_use),
                   bytes_by_op=dict(collectives.BYTES),
                   calls_by_op=dict(collectives.CALLS),
                   peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                            if dev.type == "cuda" else None))
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        multihost.shutdown()


def sharded_serving(dev, src, raise_on_fail: bool = True) -> dict:
    """Phase 19: the unsharded references (``serve_reference``), then four
    ranks on ``dev`` (``serving_rank``, spawned, joined within
    SERVE_MP_LIMIT_S) and the gates: every attention call of every rank
    within the row gate of phases 5-6 against its plain version (output
    and log-sum-exp); the sharded logits of the prefill and of each decode
    step, (a) and (b), within twice the model's bf16 floor of the
    unsharded logits with the kernels (phase 7's measure: the plain
    path's distance from the float32 attention ops); both attention
    kernels launched on every rank. Returns the four ranks' launches."""
    import tempfile

    import torch

    from repro_torch.distributed import multihost

    t_phase = time.perf_counter()
    cfg = serve_mp_config()
    failed: list[str] = []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ref = serve_reference(dev, cfg, Path(tmp))
        t_ref = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        try:
            secs = multihost.spawn(
                serving_rank, 4, (str(src), f"{tmp}/store", tmp,
                                  "cuda:0" if dev.type == "cuda" else "cpu",
                                  {k: globals()[k]
                                   for k in SERVE_MP_SETTINGS}),
                SERVE_MP_LIMIT_S)
        except RuntimeError as exc:
            record_gate("phase 19 ranks", math.inf)
            failed.append(str(exc))
            secs, ranks = time.perf_counter() - t0, []
        else:
            ranks = [torch.load(Path(tmp) / f"rank{r}.pt")
                     for r in range(4)]
    res: dict = {"spawn_s": secs, "launches": {}}
    log(f"[19] {cfg.name} at depth {SERVE_MP_DEPTH}, unsharded in this "
        f"process ({t_ref:.1f}s): {json.dumps({c: r['times'] for c, r in ref.items()})}")
    want_launch = dev.type == "cuda"
    for case in ("a", "b") if ranks else ():
        runs = ref[case]["runs"]
        floor = float((runs["off32"] - runs["off"]).abs().max())
        bound_ = 2 * floor
        got = torch.stack(([ranks[0][case]["prefill"]] if case == "a"
                           else []) + ranks[0][case]["decode"])
        want = runs["on"] if case == "a" else runs["on"][1:]
        diffs = (got - want).abs().flatten(1).amax(dim=1).tolist()
        record_gate(f"phase 19 ({case}) logits",
                    max(diffs) / bound_ if bound_ else math.inf)
        if not max(diffs) <= bound_:
            failed.append(f"({case}) sharded logits differ from unsharded "
                          f"by {max(diffs)} > {bound_}")
        same = all(torch.equal(torch.stack(r[case]["decode"]),
                               torch.stack(ranks[0][case]["decode"]))
                   for r in ranks)
        if not same:
            failed.append(f"({case}) the ranks' logits differ")
        checked = {}
        for name in ("flash_attention", "decode_attention"):
            if case == "b" and name == "flash_attention":
                continue
            per = [r[case]["checked"].get(name, (0, 0.0, 0.0))
                   for r in ranks]
            n = [c for c, _, _ in per]
            ratio = max(x for _, _, x in per)
            record_gate(f"phase 19 ({case}) per-call {name}",
                        ratio if min(n) else math.inf)
            checked[name] = {"calls": n, "max_abs_err": max(
                e for _, e, _ in per), "worst_row": ratio}
            if (want_launch and min(n) == 0) or not ratio <= 1.0:
                failed.append(f"({case}) {name}: calls {n}, worst row at "
                              f"{ratio} of its allowance")
        launches = {k: [r[case]["launches"][k] for r in ranks]
                    for k in ("flash_attention", "decode_attention")}
        for k, n in launches.items():
            res["launches"][k] = res["launches"].get(k, 0) + sum(n)
            if want_launch and (case == "a" or k == "decode_attention") \
                    and min(n) <= 0:
                failed.append(f"({case}) {k} launched {n} times a rank")
        steps = ranks[0][case]["steps"]
        log(f"[19] ({case}) {'B=2, sequence then KV over model' if case == 'a' else 'B=1, KV over (data, model), from the unsharded prefill'}: "
            f"max abs logit difference sharded vs unsharded (kernels) "
            f"{json.dumps(diffs)}; bound 2 x {floor} = {bound_}; largest "
            f"|logit| {float(want.abs().max())}; per-call checks "
            f"{json.dumps(checked)}; launches per rank "
            f"{json.dumps(launches)}; decode steps (rank 0: ms, collective "
            f"bytes, collectives) {json.dumps(steps)}"
            + (f"; prefill {ranks[0]['a']['prefill_ms']} ms "
               f"({ranks[0]['a']['prefill_bytes']} collective bytes), "
               f"moved to the inference blocks in "
               f"{ranks[0]['a']['reshard_s']} s "
               f"({ranks[0]['a']['reshard_bytes']} bytes)"
               if case == "a" else
               f"; live slots of the ranks' first global layer "
               f"{[r['b']['live_slots'] for r in ranks]}"))
    if ranks:
        r0 = ranks[0]
        if r0["gathered_at_use"]:
            log(f"[19] weights gathered at their use in decode: "
                f"{r0['gathered_at_use']}")
        log(f"[19] peak memory per rank GB "
            f"{json.dumps([r['peak_gb'] for r in ranks])}; sharded init s "
            f"{json.dumps([r['init_s'] for r in ranks])}; collective bytes "
            f"by op (rank 0, whole phase) {json.dumps(r0['bytes_by_op'])}, "
            f"calls {json.dumps(r0['calls_by_op'])}")
        res.update(ranks=[{k: r[k] for k in ("peak_gb", "init_s")}
                          for r in ranks],
                   decode_ms=[s["ms"] for s in r0["a"]["steps"]],
                   prefill_ms=r0["a"]["prefill_ms"],
                   reference=ref["a"]["times"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"[19] phase 19: {secs}s (budget 90 s; spawn to exit "
        f"{res['spawn_s']}s)")
    if failed:
        if raise_on_fail:
            raise AssertionError("phase 19: " + "; ".join(failed))
        for f in failed:
            log(f"    gate failed: {f}")
    return res


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
    # the recurrent kernels' split-TF32 products and staged ring
    "F15": ("ssd_scan",
            "    if (i < live) mma(d[i], al, bh[i]);\n#pragma unroll\n"
            "  for (int i = 0; i < n; ++i)\n"
            "    if (i < live) mma(d[i], ah, bl[i]);\n",
            "    if (i < live) {}\n",
            "the split's correction products are dropped: single-pass TF32"),
    "F16": ("ssd_scan",
            "if (kt == qt && 8 * j > warp * 16 + 15) break;",
            "if (kt == qt) break;",
            "W X skips the diagonal key tile"),
    "F17": ("rglru_scan",
            "      mbar_wait(full + s, (k / S) & 1);\n",
            "      if (k + 1 < n_tiles) mbar_wait(full + s, (k / S) & 1);\n",
            "the consumer does not wait for the last tile's copies to land"),
    # the stronger form of F17, for a race that the timing may hide; a
    # consumer that never waited could lap the producer by two phases of a
    # stage, and its parity wait would then hang
    "F17b": ("rglru_scan",
             "      mbar_wait(full + s, (k / S) & 1);\n",
             "      if (k >= S) mbar_wait(full + s, (k / S) & 1);\n",
             "the consumer reads each stage's first tile without waiting for "
             "its copies"),
    "F18": ("rglru_scan",
            "const int n_tiles = (L + kTile - 1) / kTile;",
            "const int n_tiles = L / kTile;",
            "the ragged last time tile is dropped"),
    # sharded serving's interfaces
    "F19": ("flash_attention",
            "          const int row = rows[(i >> 1) & 1];",
            "          const int row = rows[(i >> 1) & 1] - q_off;",
            "the mask reads each query's local row, not its global one "
            "(q_offset ignored)"),
    "F20": ("decode_attention",
            "lsum == 0.f ? -INFINITY : M + logf(lsum);",
            "lsum == 0.f ? 0.f : M;",
            "the log-sum-exp is written as the scores' max (0 where no slot "
            "is live)"),
    # hist_accum's cluster combine
    "F21": ("hist_sketch",
            "  count_slab<V>(idx, hist, C, n_bins, G, g, c0, t0, n);\n"
            "  cluster.sync();\n",
            "  if (rank != 0) {  // ~100 us before counting\n"
            "    const long long t = clock64();\n"
            "    while (clock64() - t < 200000) {\n    }\n  }\n"
            "  count_slab<V>(idx, hist, C, n_bins, G, g, c0, t0, n);\n",
            "no cluster barrier before the combine, and every CTA but rank 0 "
            "waits ~100 us before it counts: rank 0 reads its peers' "
            "histograms before they are filled"),
    "F22": ("hist_sketch",
            "const int hi = min(total, lo + per);",
            "const int hi = min(total, lo + 2 * per);",
            "each CTA's share of the bins reaches into the next rank's, so "
            "those bins are written twice"),
}
# phases of --gates that hold each source's kernel (the attention
# kernels': 5-7), and of the faults of one interface
FAULT_PHASES = {"cell_update": [2, 3], "hist_sketch": [2], "ssd_scan": [9],
                "rglru_scan": [11]}
FAULT_PHASES_OF = {"F19": [5, 19], "F20": [6, 19]}
GATE_PHASES = [2, 3, 5, 6, 7, 9, 11, 15]


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


def planted_tree(name: str, source: str, edits,
                 src: Path = ROOT / "src") -> Path:
    """A copy of ``src``'s package with ``edits`` (pairs of a text found
    once and its replacement) made in ``csrc/<source>.cu``, under that
    package's git-ignored build directory, with its built libraries copied
    over (the sources left alone load as built). Raises where a text is
    not found once."""
    import shutil
    built = src / "repro_torch" / "build"
    tree = built / "faults" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(src / "repro_torch", tree / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    if built.is_dir():
        shutil.copytree(built, tree / "repro_torch" / "build",
                        ignore=shutil.ignore_patterns("faults"))
    cu = tree / "repro_torch" / "csrc" / f"{source}.cu"
    text = cu.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} is not found once in "
                                 f"{source}.cu")
        text = text.replace(old, new)
    cu.write_text(text)
    return tree


def run_faults(names: list[str]) -> int:
    """Plant each fault of ``FAULTS`` (or of ``names``) in a copy of the
    package (under the git-ignored build directory, with the built
    libraries of the sources it leaves alone), run this script on the copy
    with ``--gates`` over the phases that hold its kernel
    (``FAULT_PHASES``; 5-7 for the attention kernels), and print which
    gates rejected it: the worst multiple of each gate's allowance (> 1
    rejects; a bit gate reads 0 or inf). The unedited package runs first,
    as the control, over the phases of every fault named."""
    from repro_torch.kernels import build

    unknown = sorted(set(names) - set(FAULTS))
    if unknown:
        raise SystemExit(f"unknown faults {unknown}; FAULTS has "
                         f"{sorted(FAULTS)}")
    names = names or list(FAULTS)

    def phases(fault):
        return FAULT_PHASES_OF.get(fault) or FAULT_PHASES.get(
            FAULTS[fault][0], [5, 6, 7])

    build.build_all()
    results = {}
    for name in ("control", *names):
        tree = ROOT / "src"
        gate_phases = (sorted({p for f in names for p in phases(f)})
                       if name == "control" else phases(name))
        if name != "control":
            source, old, new, what = FAULTS[name]
            tree = planted_tree(name, source, [(old, new)])
            log(f"[faults] {name}: {what} ({source}.cu)")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--gates",
             *map(str, gate_phases), "--src", str(tree)],
            capture_output=True, text=True, timeout=1500)
        lines = proc.stdout.strip().splitlines()
        for ln in lines[:-1]:
            if "gate failed" in ln or "build" in ln or ln.startswith(
                    ("[7]", "[9]", "[11]", "[19]")):
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
                    help="run phase 1 and the gates of phases 2, 3, 5, 6, "
                         "7, 9, 11 and 15 (or of the phases named, 16-21 "
                         "among them), recording "
                         "every gate instead of stopping at the first that "
                         "fails; the last line is the gates' worst "
                         "multiples")
    ap.add_argument("--faults", nargs="*", metavar="FAULT",
                    help="run --gates on copies of the package with each "
                         "planted fault of FAULTS (or of those named)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding repro_torch (default: "
                         "src/ beside this script)")
    args = ap.parse_args(argv)
    # before CUDA initialises: phase 17's resume check runs with
    # deterministic algorithms, which ask cuBLAS for this workspace (the
    # one PyTorch gives an sm_90 card anyway)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    load_peaks()
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
    for name in ("flash_attention", "decode_attention", "cell_update",
                 "ssd_scan", "rglru_scan"):
        log(f"[1] SASS of {name}: "
            f"{json.dumps(sass_counts(build.library_path(name)))}")
    card = gpu_line()
    log(f"[1] gpu: {card}")
    if args.gates is not None:
        phases = set(args.gates or GATE_PHASES)
        if 2 in phases:
            try:
                hist_accum_check(dev, raise_on_fail=False)
            except RuntimeError as exc:  # a launch that died
                record_gate("phase 2 launch", math.inf)
                log(f"    gate failed: {exc}")
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
        for phase, check in ((9, ssd_kernel), (11, scan_kernel)):
            if phase in phases:
                try:
                    check(dev, timed=False, raise_on_fail=False)
                except RuntimeError as exc:  # a launch that died
                    record_gate(f"phase {phase} launch", math.inf)
                    log(f"    gate failed: {exc}")
        if 15 in phases:
            try:
                sharded_sweep(dev, src, raise_on_fail=False)
            except RuntimeError as exc:  # a launch that died
                record_gate("phase 15 launch", math.inf)
                log(f"    gate failed: {exc}")
        if 16 in phases:
            zoo_models(dev, None, raise_on_fail=False)
        if 17 in phases:
            training(dev, raise_on_fail=False)
        if phases & {18, 20}:
            model_parallel(dev, src, raise_on_fail=False)
        if 19 in phases:
            sharded_serving(dev, src, raise_on_fail=False)
        if 21 in phases:
            dry_run(dev, src, raise_on_fail=False)
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
    fams, fig2_cfg, fig2_scn = fig2_sweep_setup()
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
    p_rhos, p_cfg, p_scn = pct_run_setup()
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
    idx = hist_responses(dev, CHUNK, hc, nb, rng)
    hist_rec = hist_timing(dev, idx, nb)
    wide_idx, _, _ = interop.hist_accum_case("responses_wide", dev)
    hist_wide = hist_timing(dev, wide_idx, nb)
    del wide_idx
    for r in (hist_rec, hist_wide):
        log(f"[3] hist_accum at (T={r['T']}, C={r['C']}, n_bins={nb}, "
            f"binned responses): kernel {r['ms']:.4f} ms, empty launch of "
            f"its plan {r['empty_ms']} ms, plain {r['plain_ms']:.4f} ms, "
            f"index_put_ {r['library_ms']:.4f} ms, torch.bincount "
            f"{r['bincount_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")

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
                       p_rhos, p_cfg, n_seeds=2, percentiles=PCT_QUANTILES,
                       chunk_size=CHUNK, device="cuda")
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
                            percentiles=PCT_QUANTILES, chunk_size=CHUNK,
                            pipeline=pipeline, device="cuda")

    # phase 15 holds its sharded runs against these unsharded kernel runs
    phase4 = {"ths": ths, "walls": {}}
    for run, label, fn in (("fig2", "fig2 sweep (1440 cells)", fig2_sweep),
                           ("pct", "1M-arrival run (12 cells)", pct_run)):
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
        phase4[run], phase4["walls"][run] = outs["off"], walls["off"]
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

    # --------------------------------------------------------------- 13
    t0 = time.perf_counter()
    figure_launches = paper_figures()
    log(f"[13] phase 13: {time.perf_counter() - t0:.1f}s")

    # --------------------------------------------------------------- 14
    serving_launches = serving_stack(dev)

    # --------------------------------------------------------------- 15
    sharded_launches = sharded_sweep(dev, src, phase4)

    # --------------------------------------------------------------- 16
    zoo = zoo_models(dev, counters)

    # --------------------------------------------------------------- 17
    trained = training(dev)

    # --------------------------------------------------------------- 18
    parallel = model_parallel(dev, src)

    # --------------------------------------------------------------- 19
    served_mp = sharded_serving(dev, src)

    # --------------------------------------------------------------- 21
    dry_run(dev, src, trained["train"]["gemma2-2b"]["peak_gb"])
    check_imports()

    # ----------------------------------------------------------- output
    log(f"total {time.perf_counter() - t_all:.1f}s")
    log(card)
    record = {"kernels": [
        {"name": "cell_update", "route": "cuda",
         "source": "src/repro_torch/csrc/cell_update.cu",
         "replaces": "src/repro/kernels/cell_update/kernel.py:378",
         "launches": launches["cell_update"],
         "figure_launches": figure_launches,
         "serving_launches": serving_launches["cell_update"],
         "sharded_launches": sharded_launches,
         "max_abs_err": errs["cell_update"], "ms": ms_cell,
         "plain_ms": plain_cell, "bound_ms": cell_bound,
         "bound_by": cell_by, "library_ms": None},
        {"name": "hist_accum", "route": "cuda",
         "source": "src/repro_torch/csrc/hist_sketch.cu",
         "replaces": "src/repro/kernels/hist_sketch/kernel.py:81",
         "launches": launches["hist_accum"],
         "check_launches": hist_check_launches,
         "max_abs_err": errs["hist_accum"],
         **{k: hist_rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "bincount_ms",
                                     "empty_ms")},
         "wide": hist_wide}]}
    sources = {"flash_attention": ("flash_attention", 109),
               "decode_attention": ("decode_attention", 88)}
    for name, (pkg, line) in sources.items():
        a = attn[name]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{pkg}/kernel.py:{line}",
            "launches": launches[name],
            "serving_launches": serving_launches[name],
            "model_launches": {arch: n[name] for arch, n in
                               zoo["model_launches"].items()},
            "model_served_launches": {arch: n[name] for arch, n in
                                      zoo["served_launches"].items()},
            "training_eval_launches": {
                arch: e["launches"][name]
                for arch, e in trained["eval"].items()},
            **({"sharded_eval_launches": parallel["eval_launches"],
                "sharded_seq_eval_launches": parallel["seq_eval_launches"]}
               if name == "flash_attention" else {}),
            "sharded_serve_launches": served_mp["launches"][name],
            **a})
    for name, line in (("ssd_scan", 62), ("rglru_scan", 46)):
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}/kernel.py:{line}",
            "launches": launches[name],
            "training_eval_launches": {
                arch: e["launches"][name]
                for arch, e in trained["eval"].items()},
            **recs[name]})
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
