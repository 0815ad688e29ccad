"""Multi-process launch layer for the sweep engine.

``initialize`` joins one process of a multi-process run to a
``torch.distributed`` process group over gloo, registers the shard slots
this rank adds on its device, and installs the all-processes ``"cells"``
sweep mesh as the ambient default (``repro_torch.launch.mesh
.set_default_sweep_mesh``) — so a worker's plain ``queueing.run(...)``,
with no ``mesh=`` anywhere, runs sharded across every process. On the
CPU each process adds ``local_device_count`` slots on ``"cpu"``; on one
card several processes may each add slots on ``cuda:0``. Tests run 2
spawned processes x 2 CPU slots against one process unsharded, bit for
bit (``tests/test_torch_multihost.py``).

The other half of this module is the single cross-process gather of the
sweep: ``fetch_replicated`` all-gathers host copies of every process's
cells, so that each process holds the whole grid (the one collective of
the engine; see the design note in ``repro_torch.distributed
.sweep_shard``).

Why gloo, on the card too: the gather runs once a run, over C x (2 +
n_bins) floats (about 3 MB at the Figure 2 sweep's 1,440 cells), and
NCCL refuses two ranks on one card ("Duplicate GPU detected"), which is
how a machine with one card runs several processes.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# Seconds a rendezvous (and any collective) may wait before it raises.
DEFAULT_TIMEOUT_S = 120.0

# (rank, device) shard slots of every process, in rank order, as
# ``initialize`` gathered them.
_SLOTS: list[tuple[int, torch.device]] = []


def _init_method(address: str) -> str:
    """``host:port`` as a TCP rendezvous; a URL (``tcp://``, ``file://``)
    as given."""
    return address if "://" in address else f"tcp://{address}"


def _rank_device(device, process_id: int) -> torch.device:
    """This rank's device: ``"cuda"`` without an index is card
    ``process_id`` modulo the visible cards."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_count: int | None = None, *,
               set_default_mesh: bool = True, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a multi-process run; returns True if one was joined.

    No-op (returns False) when ``num_processes`` is None or <= 1, so a
    launcher can call this unconditionally and fall through to one
    process. Otherwise ``torch.distributed.init_process_group("gloo")``
    at ``coordinator_address`` (``host:port`` or an init URL such as
    ``file:///tmp/store``) as rank ``process_id``; a rendezvous that
    does not complete within ``timeout_s`` raises — the process never
    carries on alone.

    ``local_device_count`` (default 1) is the number of shard slots this
    rank adds on ``device`` (``"cuda"``: card ``process_id`` modulo the
    visible cards; ``"cpu"`` for the plain path). With
    ``set_default_mesh`` the all-processes sweep mesh becomes the
    process-wide default, so every later ``queueing.run`` resolves to it
    (``launch.mesh.resolve_mesh``). ``shutdown`` leaves the group.
    """
    if num_processes is None or int(num_processes) <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address "
                         "and process_id")
    n, pid = int(num_processes), int(process_id)
    count = 1 if local_device_count is None else int(local_device_count)
    if count < 1:
        raise ValueError(f"local_device_count must be >= 1, got {count}")
    dev = _rank_device(device, pid)
    dist.init_process_group(
        "gloo", init_method=_init_method(coordinator_address),
        world_size=n, rank=pid,
        timeout=datetime.timedelta(seconds=timeout_s))
    every: list = [None] * n
    dist.all_gather_object(every, [str(dev)] * count)
    _SLOTS[:] = [(rank, torch.device(d)) for rank, devs in enumerate(every)
                 for d in devs]
    if set_default_mesh:
        from repro_torch.launch import mesh as mesh_mod

        mesh_mod.set_default_sweep_mesh(mesh_mod.make_sweep_mesh())
    return True


def shutdown() -> None:
    """Leave the process group and clear the registered slots and the
    default sweep mesh ``initialize`` installed."""
    from repro_torch.launch import mesh as mesh_mod

    _SLOTS.clear()
    mesh_mod.set_default_sweep_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def registered_slots() -> tuple[tuple[int, torch.device], ...]:
    """Every process's shard slots, as ``initialize`` gathered them;
    empty outside a multi-process run."""
    return tuple(_SLOTS) if is_initialized() else ()


def spans_processes(mesh) -> bool:
    """True when the mesh's slots belong to more than one process — i.e.
    when finalization needs the cross-process gather."""
    return len({rank for rank, _ in mesh.slots}) > 1


def fetch_replicated(mesh, *xs) -> tuple[torch.Tensor, ...]:
    """Gather cell-sharded state to full host copies on EVERY process
    (the sweep's single collective). Each of ``xs`` holds this process's
    cells, its slots' shards concatenated in slot order; each result
    holds every slot's cells in the mesh's order, on the CPU. Gloo's
    all-gather takes equal shapes, so each process's cells travel padded
    to the largest process's count."""
    xs = tuple(x.detach().cpu() for x in xs)
    if not spans_processes(mesh):
        return xs
    counts = [0] * process_count()
    for rank, _ in mesh.slots:
        counts[rank] += 1
    mine = counts[process_index()]
    out = []
    for x in xs:
        per = x.shape[0] // mine
        buf = x.new_zeros((max(counts) * per,) + tuple(x.shape[1:]))
        buf[:x.shape[0]] = x
        parts = [torch.empty_like(buf) for _ in counts]
        dist.all_gather(parts, buf)
        out.append(torch.cat([p[:n * per] for p, n in zip(parts, counts)]))
    return tuple(out)
