"""Public cell-update op: kernel dispatch and the FLOPs/bytes count.

``cell_update`` takes the arguments of ``ref.cell_update_ref`` plus a
``kernel=`` mode (see ``repro_torch.kernels.dispatch``): a CUDA tensor
launches the CUDA kernel under ``"auto"``/``"on"``, a CPU tensor takes
the plain version, ``"off"`` asks for the plain version on any device.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.cell_update import kernel as cell_kernel
from repro_torch.kernels.cell_update.ref import cell_update_ref


def cell_update(free, ssum, comp, cnt, hist, cum, warm, valid, servers,
                services, seed_idx, rates, k_mask, ovh, policy_code,
                model_code, mix, p_slow, slow_factor, p_fail, delay,
                svc_idx=None, *, n_bins: int, block: int,
                has_shared: bool = False, has_timed: bool = False,
                has_dists: bool = False, kernel: str = "auto",
                k_count=None):
    """One chunk of the cell update; returns ``(free, ssum, comp, cnt,
    hist)`` with ``free`` not yet rebased. ``block`` is the plain
    version's sketch staging (the kernel bins every step as it goes);
    ``has_timed`` gates the plain version's timed arm (the kernel
    selects it per cell). ``k_count`` (C,) int32, the copy counts of
    ``k_mask``'s prefix rows, spares the kernel path the check that
    reads the device back (``kernel.prefix_counts``)."""
    if dispatch.use_kernel(kernel, free, cum, services):
        return cell_kernel.cell_update_cuda(
            free, ssum, comp, cnt, hist, cum, warm, valid, servers,
            services, seed_idx, rates, k_mask, ovh, policy_code,
            model_code, mix, p_slow, slow_factor, p_fail, delay, svc_idx,
            n_bins=n_bins, has_shared=has_shared, has_dists=has_dists,
            k_count=k_count)
    return cell_update_ref(
        free, ssum, comp, cnt, hist, cum, warm, valid, servers, services,
        seed_idx, rates, k_mask, ovh, policy_code, model_code, mix, p_slow,
        slow_factor, p_fail, delay, svc_idx, n_bins=n_bins, block=block,
        has_shared=has_shared, has_timed=has_timed, has_dists=has_dists)


def cell_update_costs(*, n_cells: int, n_servers: int, k_max: int,
                      n_arrivals: int, n_bins: int, n_seeds: int,
                      n_svc: int | None = None, chunk: int | None = None,
                      need_hist: bool = True) -> dict[str, float]:
    """Analytic FLOPs / device-memory-byte count of the cell update over
    a whole stream (the JAX package's count, kept for its benchmarks'
    port).

    Per arrival per cell the step costs ~``k_max * (3 * n_servers + 12)
    + 10`` flops in the JAX package's one-hot formulation, plus ``2 *
    n_bins`` per histogrammed arrival for its indicator products. Bytes
    count one read+write of the per-cell carry per chunk plus one pass
    over the seed-level sampled inputs.
    """
    n_svc = k_max if n_svc is None else n_svc
    chunk = n_arrivals if chunk is None else min(chunk, n_arrivals)
    n_chunks = -(-n_arrivals // chunk)
    step_flops = k_max * (3 * n_servers + 12) + 10
    hist_flops = 2 * n_bins if need_hist else 0
    flops = float(n_cells) * n_arrivals * (step_flops + hist_flops)
    carry_floats = n_servers + 2 + (n_bins if need_hist else 0)
    carry_bytes = 2 * n_cells * carry_floats * 4          # r+w per chunk
    input_bytes = n_seeds * chunk * (1 + k_max + n_svc) * 4
    hbm_bytes = float(n_chunks) * (carry_bytes + input_bytes)
    return {"flops": flops, "hbm_bytes": hbm_bytes,
            "intensity": flops / hbm_bytes}
