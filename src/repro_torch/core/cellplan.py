"""Cell-plan construction for the sweep engine.

The engine's summaries are stacked over three axes — seeds ``S``
(dist-stacked for multi-dist scenarios), loads ``B``, variants ``K`` —
but every (s, b, k) grid cell is an independent simulation: per-cell
server free-times, Kahan mean state and histogram rows never interact.
A ``CellPlan`` makes that independence explicit by flattening the
stacked axes into ONE cell axis of length ``S * B * K`` (C-order: seed
slowest, k fastest, matching ``reshape(S, B, K)``), padded up to a
multiple of ``pad_to``.

Each cell carries its coordinates (``seed_idx`` / ``load_idx`` /
``k_idx``), a validity mask, and its variant's replication-policy,
service-model and dist-union codes (``policy_code`` / ``model_code`` /
``dist_id``, see ``repro_torch.core.scenario``): a mixed grid is a plan
whose cells disagree on those columns, and the chunk body selects the
arm per cell. Pad cells alias cell 0's coordinates, so they simulate
real, finite work, and ``unflatten`` slices them away before any
summary is read.

Cell RANDOMNESS is keyed by the seed coordinate alone (each seed row of
the sampled inputs comes from that seed's generator streams), never by
position on the cell axis, so sharding the axis over a ``"cells"`` mesh
(``sharding_rule``; ``device_row_maps`` for each shard's input rows)
cannot change a cell's bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """Flattened (seed, load, variant) sweep grid with padding."""

    n_seeds: int
    n_loads: int
    n_ks: int
    n_cells: int       # S * B * K real cells
    n_padded: int      # n_cells rounded up to a multiple of pad_to
    seed_idx: torch.Tensor     # (n_padded,) int64 — seed coordinate per cell
    load_idx: torch.Tensor     # (n_padded,) int64 — load coordinate per cell
    k_idx: torch.Tensor        # (n_padded,) int64 — variant coordinate per cell
    valid: torch.Tensor        # (n_padded,) bool  — False for pad cells
    policy_code: torch.Tensor  # (n_padded,) int32 — scenario.Policy per cell
    model_code: torch.Tensor   # (n_padded,) int32 — scenario.ServiceModel
    dist_id: torch.Tensor      # (n_padded,) int64 — dist-union index per cell

    @property
    def stacked_shape(self) -> tuple[int, int, int]:
        return (self.n_seeds, self.n_loads, self.n_ks)

    def sharding_rule(self, mesh):
        """This plan's placement on a ``"cells"`` mesh: the
        ``repro_torch.launch.mesh.SweepShardingRules`` the sharded
        executor reads (each slot a contiguous block of cells). Requires
        ``n_padded`` to be a multiple of the mesh size
        (``make_cell_plan(pad_to=mesh.size)``)."""
        from repro_torch.launch.mesh import SweepShardingRules

        rules = SweepShardingRules(mesh)
        if self.n_padded % rules.n_devices:
            raise ValueError(
                f"plan has {self.n_padded} padded cells, not a multiple "
                f"of the {rules.n_devices}-slot mesh; build it with "
                f"pad_to=mesh.size")
        return rules


def make_cell_plan(n_seeds: int, n_loads: int, n_ks: int, *,
                   pad_to: int = 1, policies=None, models=None,
                   dist_ids=None, device="cuda") -> CellPlan:
    """Flatten an (S, B, K) grid into a padded cell axis.

    Cell ``c`` maps to coordinates ``(c // (B*K), (c // K) % B, c % K)``
    — C-order, so ``unflatten`` is a plain ``reshape(S, B, K)`` of the
    first ``n_cells`` entries. Pad cells copy cell 0's coordinates and
    are flagged ``valid=False``.

    ``policies`` / ``models`` / ``dist_ids`` are per-VARIANT code
    sequences of length ``n_ks``; each cell inherits the codes of its
    variant slot. ``None`` means all cells run the paper default (code
    0: replicate-all, i.i.d. service, dist-union slot 0). The plan's
    tensors live on ``device`` (CUDA unless the CPU is asked for).
    """
    device = resolve_device(device)
    if min(n_seeds, n_loads, n_ks, pad_to) < 1:
        raise ValueError(
            f"all plan axes must be >= 1, got {(n_seeds, n_loads, n_ks)} "
            f"pad_to={pad_to}")
    for name, codes in (("policies", policies), ("models", models),
                        ("dist_ids", dist_ids)):
        if codes is not None and len(codes) != n_ks:
            raise ValueError(f"{name} must have one code per variant "
                             f"({n_ks}), got {len(codes)}")
    n_cells = n_seeds * n_loads * n_ks
    n_padded = -(-n_cells // pad_to) * pad_to
    c = np.arange(n_padded)
    k_idx = c % n_ks
    load_idx = (c // n_ks) % n_loads
    seed_idx = c // (n_ks * n_loads)
    pad = slice(n_cells, n_padded)
    seed_idx[pad] = load_idx[pad] = k_idx[pad] = 0

    def codes(seq):
        return (np.zeros(n_ks, np.int64) if seq is None
                else np.asarray([int(x) for x in seq], np.int64))[k_idx]

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return CellPlan(
        n_seeds=n_seeds, n_loads=n_loads, n_ks=n_ks,
        n_cells=n_cells, n_padded=n_padded,
        seed_idx=t(seed_idx), load_idx=t(load_idx), k_idx=t(k_idx),
        valid=t(c < n_cells, torch.bool),
        policy_code=t(codes(policies), torch.int32),
        model_code=t(codes(models), torch.int32),
        dist_id=t(codes(dist_ids)))


def unflatten(plan: CellPlan, x: torch.Tensor) -> torch.Tensor:
    """Per-cell values ``(n_padded, ...)`` -> stacked ``(S, B, K, ...)``,
    dropping pad cells. The inverse of ``flatten`` on valid cells."""
    return x[:plan.n_cells].reshape(plan.stacked_shape + tuple(x.shape[1:]))


def flatten(plan: CellPlan, x: torch.Tensor) -> torch.Tensor:
    """Stacked ``(S, B, K, ...)`` -> per-cell ``(n_padded, ...)``. Pad
    cells receive copies of cell 0's row (finite, mask-dropped later)."""
    flat = x.reshape((plan.n_cells,) + tuple(x.shape[3:]))
    n_pad = plan.n_padded - plan.n_cells
    if n_pad:
        flat = torch.cat(
            [flat, flat[:1].expand((n_pad,) + tuple(flat.shape[1:]))])
    return flat


def device_row_maps(idx, n_devices: int):
    """Per-shard input-row sets + shard-local remap for a global
    ``(n_padded,)`` input-row index array (the plan's ``seed_idx``, or
    the heterogeneous grid's service-row index ``dist_id * n_seeds +
    seed_idx``).

    Returns numpy ``(rows, local)``: ``rows[d]`` lists the global input
    rows shard ``d``'s cells gather — unique, sorted, padded to the
    common width ``R = max_d |unique(d)|`` by repeating the last entry —
    and ``local[c]`` is the position of cell ``c``'s row inside its OWN
    shard's list. For any global input block ``x``, shard ``d``'s block
    ``x[rows[d]]`` then satisfies

        x[rows[d]][local[c]] == x[idx[c]]   for every cell c on d,

    so the chunk body, which reads inputs only through per-cell row
    gathers, reads the same values from the shard's block: the remap
    changes WHICH rows each process draws, never a bit.
    """
    idx = np.asarray(idx)
    n_padded = idx.shape[0]
    if n_padded % n_devices:
        raise ValueError(f"{n_padded} cells do not tile {n_devices} "
                         f"devices")
    per = n_padded // n_devices
    uniq = [np.unique(idx[d * per:(d + 1) * per])
            for d in range(n_devices)]
    width = max(u.size for u in uniq)
    rows = np.stack([np.pad(u, (0, width - u.size), mode="edge")
                     for u in uniq]).astype(np.int32)
    local = np.empty((n_padded,), np.int32)
    for d, u in enumerate(uniq):
        local[d * per:(d + 1) * per] = np.searchsorted(
            u, idx[d * per:(d + 1) * per])
    return rows, local
