"""Per-rank cost of a step, counted from the ATen operations it runs:
FLOPs, memory traffic, collective bytes.

The port of ``repro.launch.hlo_analysis``, under its name so that a
reader finds the counterpart. The port has no HLO: it runs a step
eagerly, op by op, so this module counts the ATen operations that the
step dispatches (``analyze(fn, *args)``), on real tensors or on fake
ones (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes
only, which is how ``repro_torch.launch.dryrun`` runs a rank of a
512-rank mesh in one process). The keys are the JAX module's:

  * ``flops``: 2·M·N·K for every product (``torch.utils.flop_counter
    .FlopCounterMode``: mm, bmm, addmm, baddbmm, convolutions, SDPA; an
    einsum reaches one of them), forward and backward. A Python loop or
    a rematerialised block counts each time it runs, which is what the
    JAX module's trip-count scaling restores from the HLO.
  * ``io_bytes``: for every dispatched operation that is not a view, the
    bytes of its tensor inputs plus its tensor outputs. An approximation
    of device-memory traffic, as the JAX module says of its own: an
    eager step materialises every intermediate (no fusion), an in-place
    update counts the whole tensor it writes, and caches are not seen.
  * ``collective_bytes``: the RESULT bytes of each collective per kind,
    under the JAX module's kind names (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``collective-permute`` for a send to the next
    rank; ``broadcast``, which the JAX package's programs do not emit),
    counted at the port's one choke point, ``collectives._run``. A group
    of one rank runs no collective and counts nothing, as XLA emits none.

All values are per rank.
"""
from __future__ import annotations

import collections
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import collectives

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the port's collective ops (``collectives.OPS``) under the JAX kinds
KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
        "reduce_scatter": "reduce-scatter",
        "send_recv": "collective-permute", "broadcast": "broadcast"}


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (a tensor, or nested lists,
    tuples and dicts of them): numel times the element size."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Traffic(TorchDispatchMode):
    """Sums the bytes in and out of every operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            self.bytes += tensor_bytes((args, kwargs)) + tensor_bytes(out)
        return out


class Counts:
    """What ``counting`` saw: ``totals()`` is the ``analyze`` record."""

    def __init__(self):
        self.flops = FlopCounterMode(display=False)
        self.traffic = _Traffic()
        self.collective_bytes: collections.Counter = collections.Counter()

    def totals(self) -> dict:
        return {"flops": float(self.flops.get_total_flops()),
                "io_bytes": float(self.traffic.bytes),
                "collective_bytes": {k: int(v) for k, v in
                                     self.collective_bytes.items()}}


@contextlib.contextmanager
def counting():
    """Count the operations run inside (``Counts``). Enter it inside a
    ``FakeTensorMode`` where one is used, so that it sees each operation
    before the fake mode does."""
    counts = Counts()
    run = collectives._run

    def counted_run(op, fn, out, *inputs):
        counts.collective_bytes[KIND[op]] += tensor_bytes(out)
        return run(op, fn, out, *inputs)

    collectives._run = counted_run
    try:
        with counts.flops, counts.traffic:
            yield counts
    finally:
        collectives._run = run


def analyze(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once, counted: ``{"flops", "io_bytes",
    "collective_bytes": {kind: bytes}}`` of this rank."""
    with counting() as counts:
        fn(*args, **kwargs)
    return counts.totals()
