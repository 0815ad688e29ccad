"""The sweep engine's 1-D ``"cells"`` mesh and its placement rules.

The port's counterpart of the sweep half of ``repro.launch.mesh``.
JAX's ``Mesh``, ``shard_map`` and ``NamedSharding`` have no PyTorch
counterpart, and the port does not emulate them: a ``SweepMesh`` is a
tuple of shard SLOTS, each a ``(rank, torch.device)`` pair, in global
order — rank 0's slots first, then rank 1's. A slot's device may repeat:
``devices=("cpu",) * 8`` is the port's counterpart of XLA's forced host
device count, ``(cuda:0,) * 4`` puts four shards on one card, and on a
machine with several cards each shard may have its own. Shard ``i`` of
a plan padded to ``C`` cells owns cells ``[i*C/D, (i+1)*C/D)``
(``repro_torch.distributed.sweep_shard``). On a multi-process run
(``repro_torch.distributed.multihost.initialize``) the default mesh
spans every process's slots.

Mesh resolution — ONE point, every entry point rides it
-------------------------------------------------------

``resolve_mesh`` is where ``queueing.run`` (and therefore
``threshold.*``, the benchmarks and the shims) decides what mesh a sweep
runs on: an explicit ``mesh=`` argument wins, else the innermost
``use_sweep_mesh`` context, else the process default that
``multihost.initialize`` installs on multi-process runs, else no mesh
(the one-device engine).

``SweepShardingRules`` (``CellPlan.sharding_rule(mesh)``) is the one
place cell placement is declared: everything keyed by the cell axis is
split into the slots' contiguous blocks, and the ``put_*`` constructors
return, for each slot of THIS process, its block on its device.

``make_production_mesh`` / ``make_test_mesh`` belong to the LM
substrate's model-parallel layer (sharded training and expert
parallelism), which is not ported yet (ROADMAP queue 1 item 14e); the
port trains on one device (``repro_torch.launch.train``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import multihost


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """A 1-D ``("cells",)`` axis of shard slots ``(rank, device)``."""

    slots: tuple[tuple[int, torch.device], ...]
    axis_names: tuple[str, ...] = ("cells",)

    def __post_init__(self):
        slots = tuple((int(r), torch.device(d)) for r, d in self.slots)
        if not slots:
            raise ValueError("a sweep mesh needs at least one slot")
        ranks = [r for r, _ in slots]
        if ranks != sorted(ranks):
            raise ValueError(f"slots must come in rank order (rank 0's "
                             f"first), got ranks {ranks}")
        object.__setattr__(self, "slots", slots)

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def shape(self) -> tuple[int]:
        return (self.size,)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(d for _, d in self.slots)


def _visible_cards() -> tuple[tuple[int, torch.device], ...]:
    resolve_device("cuda")  # raises where there is no card
    return tuple((0, torch.device("cuda", i))
                 for i in range(torch.cuda.device_count()))


def _slot(d) -> tuple[int, torch.device]:
    """A ``(rank, device)`` pair, or a device of this process."""
    if isinstance(d, tuple):
        rank, dev = d
        return int(rank), torch.device(dev)
    return multihost.process_index(), resolve_device(d)


def make_sweep_mesh(n_cells_axis: int | None = None, *,
                    devices=None) -> SweepMesh:
    """1-D mesh over the sweep engine's flattened cell axis.

    ``devices`` lists the slots: devices of this process (``"cpu"``,
    ``"cuda:0"``, repeated for several shards on one) or ``(rank,
    device)`` pairs. ``None`` takes every registered slot of a
    multi-process run, else every visible CUDA card (raising where
    there is none: the CPU is asked for explicitly, e.g.
    ``devices=("cpu",) * 4``). ``n_cells_axis=None`` uses them all; a
    requested ``n_cells_axis`` takes the first ``n`` and must divide
    their count: anything else raises ``ValueError`` here, as in the
    JAX package.
    """
    if devices is None:
        slots = multihost.registered_slots() or _visible_cards()
    else:
        slots = tuple(_slot(d) for d in devices)
    n = len(slots) if n_cells_axis is None else int(n_cells_axis)
    if n < 1 or n > len(slots) or len(slots) % n != 0:
        raise ValueError(
            f"n_cells_axis={n} cannot tile the {len(slots)} available "
            f"slot(s): it must be >= 1 and divide the slot count evenly. "
            f"On the CPU, pass devices=('cpu',) * {max(n, 1)} to get "
            f"that many slots.")
    return SweepMesh(slots[:n])


# --- ambient mesh resolution (THE single resolution point) --------------

_MESH_STACK: list[SweepMesh] = []
_DEFAULT_MESH: list[SweepMesh | None] = [None]


def set_default_sweep_mesh(mesh: SweepMesh | None) -> None:
    """Install (or clear) the process-wide default sweep mesh.
    ``multihost.initialize`` calls this on multi-process runs so plain
    ``queueing.run(...)`` calls — no ``mesh=`` anywhere — run sharded
    across all processes."""
    _DEFAULT_MESH[0] = mesh


@contextlib.contextmanager
def use_sweep_mesh(mesh: SweepMesh | None = None):
    """Scope an ambient sweep mesh: every ``queueing.run`` (and everything
    built on it) inside the block runs on ``mesh`` without a ``mesh=``
    argument. ``None`` builds the default mesh (``make_sweep_mesh()``)."""
    mesh = make_sweep_mesh() if mesh is None else mesh
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def resolve_mesh(mesh: SweepMesh | None = None) -> SweepMesh | None:
    """The mesh a sweep runs on: explicit argument > innermost
    ``use_sweep_mesh`` > multi-process default > ``None`` (one device)."""
    if mesh is not None:
        return mesh
    if _MESH_STACK:
        return _MESH_STACK[-1]
    return _DEFAULT_MESH[0]


# --- placement rules for the sweep engine's tensors ---------------------

@dataclasses.dataclass(frozen=True)
class SweepShardingRules:
    """Placement rules for a cell plan on a ``"cells"`` mesh
    (``CellPlan.sharding_rule(mesh)``): per-cell tensors split into the
    slots' contiguous blocks along axis 0, and each ``put_*`` returns one
    tensor per slot of THIS process (``local_positions()`` order) on that
    slot's device."""

    mesh: SweepMesh

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def local_positions(self) -> list[int]:
        """Slot positions owned by THIS process (the shard indices of the
        cell axis it runs)."""
        me = multihost.process_index()
        return [i for i, (rank, _) in enumerate(self.mesh.slots)
                if rank == me]

    def local_devices(self) -> list[torch.device]:
        return [self.mesh.devices[i] for i in self.local_positions()]

    def put_cells(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A tensor whose axis 0 divides by the mesh size -> this
        process's slots' blocks."""
        per = x.shape[0] // self.n_devices
        return [x[i * per:(i + 1) * per].to(self.mesh.devices[i])
                for i in self.local_positions()]

    def put_blocks(self, blocks) -> list[torch.Tensor]:
        """Per-local-slot blocks (``local_positions()`` order) -> each on
        its slot's device."""
        return [b.to(d) for b, d in zip(blocks, self.local_devices(),
                                        strict=True)]

    def put_replicated(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The same tensor on every local slot's device."""
        return [x.to(d) for d in self.local_devices()]


def requested_mesh(n: int, device="cuda") -> SweepMesh:
    """The mesh of a command line's ``--devices N``: with ``device="cpu"``
    N CPU slots (the counterpart of XLA's forced host devices); on the
    card N clamped, as the JAX package clamps to its visible devices, to
    the largest divisor of the visible cards, with a note on standard
    error."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_sweep_mesh(devices=("cpu",) * int(n))
    avail = torch.cuda.device_count()
    m = next(d for d in range(min(int(n), avail), 0, -1) if avail % d == 0)
    if m < n:
        print(f"# --devices {n} clamped to {m} (largest divisor of the "
              f"{avail} visible cards; --device cpu builds {n} CPU slots)",
              file=sys.stderr)
    return make_sweep_mesh(m)
