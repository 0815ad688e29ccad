"""Weights read in place across ranks, and the cross-rank softmax combine:
the compute of a KV-sequence-sharded decode (sharded serving).

Decode reads every weight once a token, so its weights stay in the
inference rules' blocks (``sharding._inference_base_spec``: a matrix
split over ``model`` on its largest dimension, the experts over the EP
axes) and only activations move. ``Split`` is this rank's block of one
weight, split along one dimension; ``ShardedModel.use`` puts it where
the model reads the weight (``sharding.ShardedModel(in_place=True)``).
The model's products take it through ``einsum`` / ``linear``:

  * the split dimension contracted: this rank takes its slice of the
    activation, multiplies in float32, and the ranks sum over the split's
    axes; the sum is rounded once to the activation's dtype, as the
    one-device product rounds once;
  * the split dimension kept in the output (an output split, or a
    dimension both operands share, as a block-diagonal gate's blocks):
    this rank's part of the output, all-gathered along it;
  * the embedding split over its vocabulary rows: a lookup of this
    rank's rows, zero elsewhere, summed over the ranks (``rows``); the
    head split so gives this rank's logit columns, gathered (``logits``).

Flash-decoding across ranks (``softmax_combine``): each rank attends over
its own cache slots and returns its output normalised over them with the
log-sum-exp of its scores; the ranks gather both and each combines them
in float32, weighting rank r by ``exp(lse_r - max lse)`` (0 for a rank
with no live slot), rounding once.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import collectives

# what the inference rules split and the model reads in place: every
# Linear's weight (``layers.linear``, the attention and MLA output
# projections, MLA's absorbed up-projections, the untied head), the
# embedding table (lookup and tied head) and RG-LRU's block-diagonal
# gates; any other split weight is gathered whole at its use
# (``ShardedModel.use``)
IN_PLACE_SUFFIXES = (".w", "embed.table", "mixer.wa", "mixer.wx")
NOT_IN_PLACE = ("router.w",)


def reads_in_place(name: str) -> bool:
    """Whether the model reads parameter ``name`` through ``Split``."""
    return (name.endswith(IN_PLACE_SUFFIXES)
            and not name.endswith(NOT_IN_PLACE)
            and not name.startswith("mtp."))


def axes_size(mesh: DeviceMesh, axes) -> int:
    sizes = collectives.mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def axes_index(mesh: DeviceMesh, axes) -> int:
    """This rank's index over ``axes``, major to minor."""
    return collectives.flat_index(collectives.mesh_coords(mesh),
                                  collectives.mesh_sizes(mesh), axes)


class Split:
    """This rank's block ``local`` of a weight of ``shape`` split along
    ``dim`` over the mesh ``axes`` (the rank at index i over them holds
    the i-th block). Not a tensor: a use the module does not know raises
    instead of reading a block as the whole."""

    def __init__(self, local: torch.Tensor, dim: int, axes, mesh: DeviceMesh,
                 shape: tuple[int, ...]):
        self.local, self.axes, self.mesh = local, tuple(axes), mesh
        self.dim = dim % local.dim()
        self.shape = tuple(shape)
        self.start = axes_index(mesh, self.axes) * local.shape[self.dim]

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def transpose(self, a: int, b: int) -> "Split":
        nd = self.local.dim()
        a, b = a % nd, b % nd
        dim = {a: b, b: a}.get(self.dim, self.dim)
        shape = list(self.shape)
        shape[a], shape[b] = shape[b], shape[a]
        return Split(self.local.transpose(a, b), dim, self.axes, self.mesh,
                     tuple(shape))

    def __getitem__(self, i: int) -> "Split":
        """One entry of a leading dimension the split leaves whole (an
        audio model's codebook tables)."""
        if not isinstance(i, int) or self.dim == 0:
            raise TypeError("a Split is indexed only by an int on a leading "
                            "dimension it does not split")
        return Split(self.local[i], self.dim - 1, self.axes, self.mesh,
                     self.shape[1:])


def einsum(eq: str, x: torch.Tensor, w: Split) -> torch.Tensor:
    """``torch.einsum(eq, x, W)`` of the whole weight ``W`` from this
    rank's block (module docstring): ``eq`` names every dimension (no
    ellipsis), ``x`` first. The output is in ``x``'s dtype."""
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    c = ws[w.dim]
    n = w.local.shape[w.dim]
    if c in xs:
        x = x.narrow(xs.index(c), w.start, n)
    if c in out:
        y = torch.einsum(eq, x, w.local.to(x.dtype))
        return collectives.all_gather(y, w.mesh, w.axes, out.index(c))
    f32 = torch.float32
    y = torch.einsum(eq, x.to(f32), w.local.to(f32))
    return collectives.all_reduce(y, w.mesh, w.axes).to(x.dtype)


def linear(x: torch.Tensor, w: Split) -> torch.Tensor:
    """x (..., d_in) @ W (d_in, *out) -> (..., *out), no bias."""
    names = "abcdefgh"[:len(w.shape) - 1]
    y = einsum(f"ti,i{names}->t{names}", x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def rows(table: Split, ids: torch.Tensor) -> torch.Tensor:
    """``W[ids]`` of a (V, D) table split over its rows (each rank looks
    up the ids it holds, zero for the others, and the ranks sum: exact)
    or over its columns (gathered)."""
    if table.dim == 1:
        return collectives.all_gather(table.local[ids], table.mesh,
                                      table.axes, -1)
    n = table.local.shape[0]
    local = ids - table.start
    hit = (local >= 0) & (local < n)
    x = table.local[local.clamp(0, n - 1)] * hit[..., None]
    return collectives.all_reduce(x.to(torch.float32), table.mesh,
                                  table.axes).to(table.dtype)


def logits(table: Split, h: torch.Tensor,
           final_cap: float | None) -> torch.Tensor:
    """``layers.logits_from_hidden`` of a (V, D) head split over its rows
    (this rank's logit columns, gathered; the softcap is elementwise) or
    over D (contracted in float32, summed, then soft-capped)."""
    from repro_torch.models import layers

    if table.dim == 0:
        y = layers.logits_from_hidden(table.local, h, final_cap)
        return collectives.all_gather(y, table.mesh, table.axes, -1)
    n = table.local.shape[1]
    part = torch.matmul(h.narrow(-1, table.start, n).to(torch.float32),
                        table.local.to(torch.float32).t())
    return layers.softcap(collectives.all_reduce(part, table.mesh,
                                                 table.axes), final_cap)


# ---------------------------------------------------------------------------
# State and attention across ranks
# ---------------------------------------------------------------------------

STATE_AXES = ("model",)  # ``cache_spec`` splits recurrent states over it


def whole_state(t: torch.Tensor, size: int, dim: int,
                mesh: DeviceMesh) -> torch.Tensor:
    """A recurrent state whole along ``dim`` (``size`` entries) from this
    rank's block of it (``cache_spec``: heads or width over ``model``)."""
    if t.shape[dim] == size:
        return t
    out = collectives.all_gather(t, mesh, STATE_AXES, dim)
    if out.shape[dim] != size:
        raise ValueError(f"a state block of {t.shape[dim]} along dim {dim} "
                         f"does not gather to {size}")
    return out


def state_block(t: torch.Tensor, like: torch.Tensor, dim: int,
                mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the whole new state ``t``, shaped as the
    block ``like`` it replaces."""
    n = like.shape[dim]
    if t.shape[dim] == n:
        return t
    return t.narrow(dim, axes_index(mesh, STATE_AXES) * n, n).contiguous()


def softmax_combine(out: torch.Tensor, lse: torch.Tensor, mesh: DeviceMesh,
                    axes, dtype: torch.dtype) -> torch.Tensor:
    """Flash-decoding's combine over the ranks of ``axes``: ``out`` (B, 1,
    H, d) float32 is this rank's attention output normalised over its own
    slots, ``lse`` (B, H) the log-sum-exp of its scores (-inf: no live
    slot). Every rank gathers every rank's pair and ``combine``s them:
    the same bits on every rank."""
    f32 = torch.float32
    packed = torch.cat([out.to(f32).reshape(-1), lse.to(f32).reshape(-1)])
    every = collectives.all_gather(packed[None], mesh, tuple(axes), 0)
    n_out = out.numel()
    return combine(every[:, :n_out].reshape(-1, *out.shape),
                   every[:, n_out:].reshape(-1, *lse.shape), dtype)


def combine(outs: torch.Tensor, lses: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``sum_r w_r outs[r] / sum_r w_r`` with ``w_r = exp(lses[r] - max_r
    lses[r])`` (0 where ``lses[r]`` is -inf), in float32 in the order of
    r, rounded once to ``dtype``; 0 where no part has a live slot. outs
    (R, B, 1, H, d), lses (R, B, H)."""
    top = lses.amax(dim=0)
    live = lses > -torch.inf
    w = torch.where(live, torch.exp(lses - torch.where(live, top, 0.0)),
                    torch.zeros_like(lses))
    w = w[:, :, None, :, None]                       # (R, B, 1, H, 1)
    den = w.sum(dim=0)
    num = (outs.to(torch.float32) * w).sum(dim=0)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(num)).to(dtype)
