"""Sharded cell-plan execution layer for the chunked sweep engine.

``run_sharded`` (the mesh path of ``repro_torch.core.queueing.run``) and
the shims ``sweep_sharded`` / ``sweep_dists_sharded`` are drop-in,
BIT-IDENTICAL replacements for the unsharded engine that run its
per-chunk body on every slot of a 1-D ``"cells"`` mesh
(``repro_torch.launch.mesh.make_sweep_mesh``). The (seed x load x
variant) grid — dist-stacked along the seed axis, each variant's policy
and model codes riding the plan as per-cell coordinates, so MIXED-policy
and heterogeneous grids shard like any other — is flattened by
``repro_torch.core.cellplan`` into one cell axis padded to a multiple of
the mesh size, and slot ``i`` owns cells ``[i*C/D, (i+1)*C/D)`` end to
end:

  * Per-cell state is SLOT-LOCAL for the whole stream: server free-time
    grids, Kahan mean state and sketch rows live in the slot's own carry,
    and ``cell_update`` runs once a chunk on each slot's cells (the
    ``queueing._sweep_chunk_cells`` of the unsharded engine, on a
    per-shard ``EngineGrid``). Nothing is communicated between chunks.
  * Cell randomness derives from cell COORDINATES, never placement:
    chunk ``c``, seed row ``s`` draws from the generator streams of
    ``(seed, c, s)`` through the exact unsharded sampler.
  * The ONLY gather of results is at finalization, after the last
    chunk: pad cells are sliced away there, so they never reach a mean
    or a histogram summary.

Multi-process execution — design note
-------------------------------------

The same executor serves ONE process with D slots and a multi-process
run (``repro_torch.distributed.multihost.initialize``) where the mesh
spans every process's slots. Four pieces make that path correct and
cheap:

**Placement, declared once.** ``CellPlan.sharding_rule(mesh)`` returns
the plan's ``repro_torch.launch.mesh.SweepShardingRules``: everything
keyed by the cell axis (carry, per-cell plan parameters) is split into
the slots' contiguous blocks, and each process materializes only its
own slots' blocks, each on its slot's device.

**Per-process sampling reduction.** Every draw is per ``(seed, chunk,
row, purpose, j)`` stream: row ``r`` of a chunk's input block is a pure
function of those ints (and, for service rows, of the row's
distribution), NOT of which other rows are drawn beside it. So each
process draws ONLY the sorted union of the rows its own slots' cells
gather (``queueing.ChunkSampler.rows``) instead of the whole block.
Rows are drawn on the run's ``device``, as the unsharded run draws them
— CUDA's Philox and the CPU generator give different values, so the
device type is part of the bits — and each slot's rows are then copied
to its device. ``cellplan.device_row_maps`` turns the plan's global row
indices into per-slot row lists plus SLOT-LOCAL gather indices with
``x[rows[d]][local[c]] == x[idx[c]]``; the chunk body reads inputs only
through per-cell row gathers (and rebases ``free`` through the same
local ``seed_idx``), so the remap is exact.

**Sampling/compute pipeline.** With ``pipeline="on"`` the chunk loop
runs through ``repro_torch.core.chunkflow.iter_staged``: a producer
thread draws chunk ``c+1``'s rows and stages each slot's block while the
main thread launches chunk ``c`` on every slot. The pipeline moves WHEN
sampling happens, never what is sampled: on/off are bit-identical.

**The single gather.** Per-cell state never crosses slots or processes
during the stream. After the last chunk, and only then, ``ssum``,
``cnt`` and ``hist`` of every slot are brought together: within one
process by concatenation; across processes by
``multihost.fetch_replicated``, an all-gather of host copies over gloo
(the one collective of the whole engine; why gloo and not NCCL is said
there). The gathered state goes back to the run's device before
``queueing._finalize_summary``, so the percentiles come from the same
operations on the same device as in the unsharded run, and every
process returns the whole grid's summaries on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cellplan, chunkflow, queueing
from repro_torch.core.distributions import ServiceDist
from repro_torch.distributed import multihost
from repro_torch.launch.mesh import make_sweep_mesh


def _sweep_cells_sharded(sampler, n_seeds_total: int, rhos,
                         cfg: queueing.SimConfig, *, variants,
                         warmup_frac: float, percentiles: tuple[float, ...],
                         n_bins: int, chunk_size: int | None, mesh,
                         kernel: str = "auto", pipeline: str = "off",
                         device) -> dict:
    """Drive ``queueing._sweep_chunk_cells`` on every slot of ``mesh``
    over the whole arrival stream (see the module design note).

    ``sampler`` is the SAME ``queueing.ChunkSampler`` the unsharded
    ``_run_engine`` consumes (or an ``interop.NumpySampler``); its
    ``rows`` entry point draws only this process's input rows. ``kernel``
    is ``cell_update``'s mode on each slot's tensors: under ``"auto"`` a
    CUDA slot launches the kernel, and a kernel that does not build or
    launch fails the run. ``device`` is the run's resolved device: the
    rows are drawn and the summaries returned there.
    """
    if tuple(getattr(mesh, "axis_names", ())) != ("cells",):
        raise ValueError(f"expected a 1-D ('cells',) mesh (make_sweep_mesh), "
                         f"got {mesh!r}")
    if not callable(getattr(sampler, "rows", None)):
        raise TypeError(
            "the sharded executor needs a queueing.ChunkSampler (its .rows "
            "drives the per-process sampling reduction); got a bare "
            "sampler callable")
    if {d.type for d in mesh.devices} != {device.type}:
        raise ValueError(
            f"a run drawn on {device} cannot be sharded over slots on "
            f"{sorted({str(d) for d in mesh.devices})}: another device "
            f"type draws other bits")
    if multihost.spans_processes(mesh) and {r for r, _ in mesh.slots} != \
            set(range(multihost.process_count())):
        raise ValueError("a mesh that spans processes must hold a slot of "
                         "every process: each takes part in the gather")
    m = cfg.n_arrivals
    grid = queueing._engine_grid(n_seeds_total, rhos, cfg, variants, device,
                                 pad_to=mesh.size)
    plan = grid.plan
    rules = plan.sharding_rule(mesh)
    local_pos = rules.local_positions()
    if not local_pos:
        raise ValueError(f"process {multihost.process_index()} owns no slot "
                         f"of the mesh")

    # global input-row index per cell -> per-slot row lists + local gather
    # indices (exact remap; service rows are the seed rows unless the grid
    # is heterogeneous, where services stack one table per dist)
    n_dev, per = rules.n_devices, plan.n_padded // rules.n_devices
    seed_rows, seed_local = cellplan.device_row_maps(
        plan.seed_idx.cpu().numpy(), n_dev)
    if grid.has_dists:
        svc_rows, svc_local = cellplan.device_row_maps(
            grid.svc_idx.cpu().numpy(), n_dev)
    else:
        svc_rows, svc_local = seed_rows, seed_local
    grids = [grid.shard(p * per, (p + 1) * per, seed_local, svc_local, d)
             for p, d in zip(local_pos, rules.local_devices())]

    # THIS process's sampling set: the sorted union over its slots (rows
    # shared by several slots are drawn once), and each slot's rows in it
    proc_seed = np.unique(seed_rows[local_pos])
    proc_svc = np.unique(svc_rows[local_pos])

    def takes(union, rows):
        return [torch.as_tensor(np.searchsorted(union, rows[p]),
                                device=device) for p in local_pos]

    seed_take, svc_take = takes(proc_seed, seed_rows), takes(proc_svc,
                                                             svc_rows)

    warmup_start = int(m * warmup_frac)
    need_hist = len(percentiles) > 0
    t_chunk, n_chunks, block, pad = queueing._chunk_layout(cfg, chunk_size,
                                                           need_hist)
    states = list(zip(*(rules.put_cells(x) for x in queueing._init_cell_state(
        plan, cfg, n_bins, need_hist))))

    def produce(c: int):
        """Draw THIS process's rows of chunk ``c`` and stage each slot's
        block on its device."""
        g, sv, svc = queueing._pad_chunk_inputs(
            *sampler.rows(c, t_chunk, proc_seed, proc_svc), pad)
        return list(zip(rules.put_blocks([g[i] for i in seed_take]),
                        rules.put_blocks([sv[i] for i in seed_take]),
                        rules.put_blocks([svc[i] for i in svc_take])))

    use_pipe = pipeline == "on" and n_chunks > 1
    for c, blocks in enumerate(chunkflow.iter_staged(produce, n_chunks,
                                                     enabled=use_pipe)):
        start = c * t_chunk
        states = [queueing._sweep_chunk_cells(
            *st, *blk, start, min(t_chunk, m - start), warmup_start, g,
            n_bins=n_bins, block=block, kernel=kernel)
            for st, blk, g in zip(states, blocks, grids)]
    queueing._record_pipeline_stats(
        sampler, enabled=use_pipe, n_chunks=n_chunks, t_pad=t_chunk + pad,
        seed_rows=int(proc_seed.size), svc_rows=int(proc_svc.size))

    # THE single gather (design note): this process's slots in order,
    # then every process's over gloo
    fields = (1, 3, 4) if need_hist else (1, 3)
    local = [torch.cat([st[i].to(device) for st in states]) for i in fields]
    if multihost.spans_processes(mesh):
        local = [x.to(device)
                 for x in multihost.fetch_replicated(mesh, *local)]
    ssum, cnt = local[0], local[1]
    hist = local[2] if need_hist else torch.zeros((0, 0), device=device)
    return queueing._finalize_summary(plan, ssum, cnt, hist, m - warmup_start,
                                      percentiles)


def run_sharded(seed: int, scenario, rhos, cfg: queueing.SimConfig, *,
                n_seeds: int = 2,
                percentiles: tuple[float, ...] = queueing.DEFAULT_PERCENTILES,
                n_bins: int = queueing.DEFAULT_BINS,
                chunk_size: int | None = None, mesh=None,
                kernel: str = "auto", pipeline: str = "off",
                device="cuda") -> dict:
    """``queueing.run`` across a sweep mesh (``mesh=None`` uses the
    default mesh, ``make_sweep_mesh()``): same scenario semantics, same
    summary shapes, the same bits for the same ``(seed, chunk_size)``
    whatever the number of slots and processes. Equivalent to
    ``queueing.run(..., mesh=mesh)``."""
    return queueing.run(seed, scenario, rhos, cfg, n_seeds=n_seeds,
                        percentiles=percentiles, n_bins=n_bins,
                        chunk_size=chunk_size,
                        mesh=make_sweep_mesh() if mesh is None else mesh,
                        kernel=kernel, pipeline=pipeline, device=device)


def sweep_sharded(seed: int, dist: ServiceDist, rhos,
                  cfg: queueing.SimConfig, *, ks: tuple[int, ...] = (1, 2),
                  n_seeds: int = 2,
                  percentiles: tuple[float, ...]
                  = queueing.DEFAULT_PERCENTILES,
                  n_bins: int = queueing.DEFAULT_BINS,
                  chunk_size: int | None = None, mesh=None,
                  kernel: str = "auto", device="cuda") -> dict:
    """``queueing.sweep`` across a sweep mesh: summaries ``(n_seeds,
    len(rhos), len(ks))``, the unsharded bits.

    .. deprecated:: Thin shim over ``run_sharded`` (paper-default
       scenario); prefer ``queueing.run(..., mesh=...)``."""
    scn = queueing._paper_default(dist, ks, cfg)
    return run_sharded(seed, scn, rhos, cfg, n_seeds=n_seeds,
                       percentiles=percentiles, n_bins=n_bins,
                       chunk_size=chunk_size, mesh=mesh, kernel=kernel,
                       device=device)


def sweep_dists_sharded(seed: int, dist_list, rhos, cfg: queueing.SimConfig,
                        *, ks: tuple[int, ...] = (1, 2), n_seeds: int = 2,
                        percentiles: tuple[float, ...]
                        = queueing.DEFAULT_PERCENTILES,
                        n_bins: int = queueing.DEFAULT_BINS,
                        chunk_size: int | None = None, mesh=None,
                        kernel: str = "auto", device="cuda") -> dict:
    """``queueing.sweep_dists`` across a sweep mesh: distributions stack
    along the plan's seed axis (every dist shares the per-seed streams —
    CRN across dists), summaries ``(len(dist_list), n_seeds, len(rhos),
    len(ks))``, the unsharded bits.

    .. deprecated:: Thin shim over ``run_sharded`` (multi-``dists``
       paper-default scenario); prefer ``queueing.run(..., mesh=...)``."""
    dist_list = tuple(dist_list)
    out = run_sharded(seed, queueing._paper_default(dist_list, ks, cfg),
                      rhos, cfg, n_seeds=n_seeds, percentiles=percentiles,
                      n_bins=n_bins, chunk_size=chunk_size, mesh=mesh,
                      kernel=kernel, device=device)
    if len(dist_list) == 1:  # run() adds the dist axis only for d > 1
        out = {k: (v[None] if isinstance(v, torch.Tensor) else v)
               for k, v in out.items()}
    return out
