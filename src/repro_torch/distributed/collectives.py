"""Collectives of the model-parallel layer, over ``torch.distributed``.

The port of ``repro.distributed.collectives`` and of the collectives that
JAX's ``shard_map`` issues for the model: every one runs over the
sub-group of the ranks of a ``DeviceMesh`` that differ only along some of
its axes (``axes_group``), and orders its chunks by the rank's index over
those axes, major to minor, as a tiled ``all_gather`` / ``psum_scatter``
over a tuple of axes does in JAX.

``hierarchical_grad_reduce``: the pod axis is the data-center-network
tier (slow links), so gradients reduce in two stages — reduce-scatter
over the in-pod ``data`` axis, all-reduce the shards over ``pod``, then
all-gather back over ``data``: cross-pod traffic per rank drops from the
full gradient to gradient/|data|.

Gloo and CUDA tensors. The port's process groups are gloo's: NCCL
refuses two ranks on one card ("Duplicate GPU detected"), which is how a
machine with one card runs several ranks (``multihost``). Gloo takes
some collectives on CUDA tensors and refuses others. ``gloo_takes_cuda``
asks it once a process, on tiny tensors, for each of ``OPS`` but
``send_recv``, and every collective here stages the ones it refuses
through pinned host buffers: the tensor is copied to the host, the
collective runs there, the result is copied back. ``send_recv`` is
staged without asking: gloo's send hands the tensor's address to its
socket without looking at the device, so a CUDA tensor aborts the
process (``writev ... Bad address``, torch 2.11 on an H100) instead of
raising. That is the one place the port stages anything; the compute
stays on the card.

Gradient convention of the autograd collectives (``gather``,
``scatter_sum``, ``sum_over``): each rank's loss is its share of the
global loss, and the global loss is the sum of the shares over every rank
of the mesh (``repro_torch.models.lm.loss_fn`` under a ctx). So an
all-gather's transpose is a reduce-scatter, a reduce-scatter's an
all-gather, and a sum over ranks transposes to a sum over ranks.

``BYTES`` counts, per collective, the bytes this rank sent over the
group's links as a ring algorithm moves them: (n-1)/n of the gathered
or scattered tensor, twice that for an all-reduce, the whole tensor for
a send or a broadcast; ``CALLS`` counts the collectives themselves (a
group of one rank moves nothing and is not counted).
"""
from __future__ import annotations

import collections
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

OPS = ("all_gather", "reduce_scatter", "all_reduce", "send_recv",
       "broadcast")

BYTES: collections.Counter = collections.Counter()
CALLS: collections.Counter = collections.Counter()

# the tiled collectives under their current names (older releases have
# only the ``*_tensor`` names, which newer ones deprecate)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

# op -> whether gloo took it on CUDA tensors (``gloo_takes_cuda``)
_GLOO_CUDA: dict[str, bool] = {}
# (mesh layout, axes) -> (group or None, member global ranks, order)
_GROUPS: dict = {}
# member global ranks -> their group: one group per set of ranks, however
# many meshes and axes name it (gloo names a locally synchronised group
# by its ranks, so a second group of the same ranks would not rendezvous)
_BY_MEMBERS: dict = {}
# id(mesh) -> (mesh, its ranks as a numpy array): ``mesh_grid``
_GRIDS: dict = {}


# ---------------------------------------------------------------------------
# Mesh geometry
# ---------------------------------------------------------------------------


def mesh_sizes(mesh: DeviceMesh | Mapping[str, int]) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, or the mapping as given."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coords(mesh: DeviceMesh) -> dict[str, int]:
    """This rank's ``{axis: coordinate}`` on the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh "
                         f"{mesh.mesh.tolist()}")
    return dict(zip(mesh.mesh_dim_names, coord))


def flat_index(coords: Mapping[str, int], sizes: Mapping[str, int],
               axes) -> int:
    """The index over ``axes``, major to minor, of the coordinates."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def mesh_grid(mesh: DeviceMesh) -> np.ndarray:
    """The mesh's global ranks as a numpy array of its shape, read once a
    mesh (a ``DeviceMesh`` builds ``.mesh`` anew, under a
    ``FakeTensorMode`` as a fake tensor, which holds no values)."""
    hit = _GRIDS.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = _GRIDS[id(mesh)] = (mesh, np.asarray(mesh.mesh.tolist()))
    return hit[1]


def axes_group(mesh: DeviceMesh, axes) -> tuple[Any, list[int],
                                                 list[int]]:
    """(group, members, order) of the ranks that share this rank's
    coordinates off ``axes``: ``members`` their global ranks in the
    group's order (ascending), ``order[f]`` the position in ``members``
    of the rank whose index over ``axes`` is ``f``. The group is None
    where it holds this rank alone. Groups are made at first use with
    ``use_local_synchronization``: only their members take part. A mesh
    over some of the ranks (a ``DeviceMesh`` that leaves ranks out) is
    made after every group over more ranks: gloo's rendezvous of a wider
    group made after it hangs (torch 2.13). The mesh's geometry is read
    on the host (numpy), with no tensor operation, so that it runs under
    a ``FakeTensorMode`` too (``repro_torch.launch.dryrun``)."""
    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    grid = mesh_grid(mesh)
    key = (names, grid.shape, tuple(grid.reshape(-1).tolist()), axes)
    if key in _GROUPS:
        return _GROUPS[key]
    coords = mesh_coords(mesh)
    index = tuple(slice(None) if a in axes else coords[a] for a in names)
    sub = grid[index]                       # the axes' dims, mesh order
    kept = [a for a in names if a in axes]
    sub = sub.transpose([kept.index(a) for a in axes]).reshape(-1)
    by_flat = [int(r) for r in sub.tolist()]   # rank at flat index f
    members = sorted(by_flat)
    order = [members.index(r) for r in by_flat]
    group = None
    if len(members) > 1:
        group = _BY_MEMBERS.get(tuple(members))
        if group is None:
            group = (mesh.get_group(axes[0]) if len(axes) == 1 else
                     dist.new_group(members, use_local_synchronization=True))
            _BY_MEMBERS[tuple(members)] = group
    _GROUPS[key] = (group, members, order)
    return _GROUPS[key]


def forget_groups() -> None:
    """Drop the groups made so far and the gloo probe (the process group
    they belong to is being destroyed)."""
    _GROUPS.clear()
    _BY_MEMBERS.clear()
    _GRIDS.clear()
    _GLOO_CUDA.clear()


# ---------------------------------------------------------------------------
# Gloo on CUDA tensors
# ---------------------------------------------------------------------------


def gloo_takes_cuda() -> dict[str, bool]:
    """Per op of ``OPS``, whether gloo takes it on CUDA tensors, asked
    once a process over the world group (a collective: every rank calls
    it at its first collective on a CUDA tensor) and agreed by a MIN over
    the ranks; ``send_recv`` is never tried (module docstring) and reads
    False."""
    if _GLOO_CUDA:
        return dict(_GLOO_CUDA)
    n = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(2, device=dev)
    tries = {
        "all_gather": lambda: _ALL_GATHER(torch.empty(2 * n, device=dev),
                                          x),
        "reduce_scatter": lambda: _REDUCE_SCATTER(
            torch.empty(2, device=dev), torch.ones(2 * n, device=dev)),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
    }
    flags = []
    for op in OPS:
        ok = op in tries
        try:
            if ok:
                tries[op]()
                torch.cuda.synchronize(dev)
        except (RuntimeError, ValueError):
            ok = False
        flags.append(int(ok))
    agreed = torch.tensor(flags, dtype=torch.int32)
    dist.all_reduce(agreed, op=dist.ReduceOp.MIN)
    _GLOO_CUDA.update({op: bool(f) for op, f in zip(OPS, agreed.tolist())})
    return dict(_GLOO_CUDA)


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _run(op: str, fn, out: torch.Tensor, *inputs: torch.Tensor) -> None:
    """``fn(out, *inputs)``, through pinned host copies where ``out`` is
    on the card and gloo refuses ``op`` there."""
    if not out.is_cuda or gloo_takes_cuda()[op]:
        fn(out, *inputs)
        return
    host_out = _host(out)
    fn(host_out, *(_host(t) for t in inputs))
    out.copy_(host_out)


# ---------------------------------------------------------------------------
# Plain collectives (no autograd)
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axes,
               dim: int = 0) -> torch.Tensor:
    """The tiled all-gather of ``x`` along ``dim`` over ``axes``."""
    group, members, order = axes_group(mesh, axes)
    n = len(members)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    _run("all_gather", lambda o, i: _ALL_GATHER(o, i, group=group), out, xt)
    BYTES["all_gather"] += (n - 1) * xt.numel() * xt.element_size()
    CALLS["all_gather"] += 1
    out = out.view(n, *xt.shape)[order].reshape(out.shape)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh: DeviceMesh, axes,
                   dim: int = 0) -> torch.Tensor:
    """The tiled sum-scatter (``psum_scatter``) of ``x`` along ``dim``
    over ``axes``: this rank's chunk of the sum."""
    group, members, order = axes_group(mesh, axes)
    n = len(members)
    if n == 1:
        return x
    xt = x.movedim(dim, 0)
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axes}")
    chunks = xt.reshape(n, xt.shape[0] // n, *xt.shape[1:])
    # member j receives the chunk of its own index over the axes
    by_member = [0] * n
    for f, j in enumerate(order):
        by_member[j] = f
    inp = chunks[by_member].reshape(xt.shape).contiguous()
    out = inp.new_empty(chunks.shape[1:])
    _run("reduce_scatter", lambda o, i: _REDUCE_SCATTER(o, i, group=group),
         out, inp)
    BYTES["reduce_scatter"] += (n - 1) * out.numel() * out.element_size()
    CALLS["reduce_scatter"] += 1
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``x`` over ``axes``, a new tensor."""
    group, members, _ = axes_group(mesh, axes)
    n = len(members)
    out = x.contiguous().clone()
    if n == 1:
        return out
    _run("all_reduce", lambda o: dist.all_reduce(o, op=op, group=group), out)
    BYTES["all_reduce"] += 2 * (n - 1) * out.numel() * out.element_size() \
        // n
    CALLS["all_reduce"] += 1
    return out


def broadcast(x: torch.Tensor, mesh: DeviceMesh, axes,
              src_index: int) -> torch.Tensor:
    """The tensor of the rank whose index over ``axes`` is
    ``src_index``, on every rank of the group (a new tensor)."""
    group, members, order = axes_group(mesh, axes)
    out = x.contiguous().clone()
    if len(members) == 1:
        return out
    src = members[order[src_index]]
    _run("broadcast", lambda o: dist.broadcast(o, src=src, group=group), out)
    BYTES["broadcast"] += out.numel() * out.element_size()
    CALLS["broadcast"] += 1
    return out


def shift(y: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``ppermute`` along ``axis`` by one: the rank at index i sends
    ``y`` to index i+1 and returns what index i-1 sent (zeros at index
    0). Every send is posted before its receive, so no stage waits on
    another that waits too."""
    group, members, order = axes_group(mesh, (axis,))
    n = len(members)
    me = order.index(members.index(dist.get_rank()))
    out = torch.zeros_like(y)
    if n == 1:
        return out

    def exchange(o, i):
        reqs = []
        if me + 1 < n:
            reqs.append(dist.isend(i, members[order[me + 1]], group=group))
        if me > 0:
            dist.irecv(o, members[order[me - 1]], group=group).wait()
        for r in reqs:
            r.wait()

    _run("send_recv", exchange, out, y.contiguous())
    if me + 1 < n:
        BYTES["send_recv"] += y.numel() * y.element_size()
    CALLS["send_recv"] += 1
    return out


# ---------------------------------------------------------------------------
# Autograd collectives (the expert-parallel MoE)
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, *ctx.args), None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None


def gather(x: torch.Tensor, mesh: DeviceMesh, axes, dim: int = 0):
    """All-gather with a reduce-scatter backward."""
    return _Gather.apply(x, mesh, tuple(axes), dim)


def scatter_sum(x: torch.Tensor, mesh: DeviceMesh, axes, dim: int = 0):
    """Reduce-scatter (sum) with an all-gather backward."""
    return _ScatterSum.apply(x, mesh, tuple(axes), dim)


def sum_over(x: torch.Tensor, mesh: DeviceMesh, axes):
    """All-reduce (sum) with an all-reduce backward."""
    return _SumOver.apply(x, mesh, tuple(axes))


# ---------------------------------------------------------------------------
# Gradient reduction across pods
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def hierarchical_grad_reduce(grads, mesh: DeviceMesh,
                             data_axis: str = "data",
                             pod_axis: str = "pod"):
    """Mean-reduce gradients over (data x pod) hierarchically.

    Gradients enter distinct per (data, pod) rank (each rank computed its
    microbatch) and leave identical on every rank; ``grads`` is a tensor
    or nested dicts/lists of them:
      1. reduce-scatter over data of the flattened, padded gradient;
      2. all-reduce over pod (only the local shard);
      3. all-gather over data;
    then divided by |data| |pod|. Without a pod axis, a mean over data.
    """
    sizes = mesh_sizes(mesh)
    if pod_axis not in sizes:
        n = sizes[data_axis]
        return tree_map(lambda g: all_reduce(g, mesh, (data_axis,)) / n,
                         grads)
    n_data = sizes[data_axis]
    n_total = n_data * sizes[pod_axis]

    def one(x):
        flat = x.reshape(-1)
        pad = (-flat.shape[0]) % n_data
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        shard = reduce_scatter(flat, mesh, (data_axis,))
        shard = all_reduce(shard, mesh, (pod_axis,))
        full = all_gather(shard, mesh, (data_axis,))
        if pad:
            full = full[:-pad]
        return (full / n_total).reshape(x.shape).to(x.dtype)

    return tree_map(one, grads)
