"""Sharding rules: map (param/cache path, shape) -> spec, and build
activation layouts per (recipe x step kind); then the port's execution
of the rules (``NamedSharding``, ``ShardedModel``).

The port of ``repro.distributed.sharding``. Two recipes (chosen per arch
in its config):
  * ``tp``   — Megatron-style: attention heads / d_ff / experts / vocab over
    the 16-way ``model`` axis; batch over ``data`` (and ``pod``); large
    params additionally ZeRO-sharded over ``data`` on a free dimension.
  * ``fsdp`` — for archs whose head count does not divide 16 (gemma2 8H,
    granite 24H, llava 56H): batch over ``data x model``; every large param
    sharded over ("data","model") on its largest divisible dim and gathered
    at use (ZeRO-3); MoE experts still EP over ``model``.

Decode always shards the KV-cache SEQUENCE over ``model`` (plus ``data`` and
``pod`` for long_500k) — divisibility-free w.r.t. head counts, and the
natural layout for flash-decoding-style distributed attention.

The rules are the JAX package's, line for line: functions of the JAX
leaf path (``"blocks/pos0/mixer/wq/w"``, a repeated block's leaf stacked
along a leading repeats axis) and shape, with the production mesh's sizes
(16 x 16, 2 x 16 x 16) where JAX hard-codes them. A spec is a tuple with
one entry per dim: ``None``, an axis name or a tuple of axis names (major
to minor), as a ``PartitionSpec``. ``port_param_specs`` reads them for
the port's parameters through ``lm.leaf_groups``: a repeated block's
tensor takes its stacked leaf's spec without the leading ``None``. Where
JAX reads a mesh's axis sizes (``cache_spec``, ``batch_shardings``) the
port takes a ``DeviceMesh`` or a ``{axis: size}`` mapping, so the rules
can be checked at the production sizes without 256 processes.

Execution. ``ShardedModel`` holds each parameter's shard on its rank
(``local_shard``: a dim split over axes (a, b) gives the rank at index
i_a |b| + i_b the i-th block), gathers each part of the model at its use
(a block inside its forward and its recompute) and reduce-scatters its
gradient back as backward reaches it: the ZeRO-3 reading of both
recipes' rules, which is what GSPMD does for the sharded weights it
reads. Expert
weights are not gathered over the EP axes: each rank computes with its
own experts (``lm._run_moe``). Head- and ff-parallel compute on the
model axis (Megatron) is not done: under the tp recipe's train layout
the ranks along ``model`` hold the same rows and compute the same thing,
so they reach the same weights; splitting that compute is work on the
port's speed (ROADMAP).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import mesh_coords, mesh_sizes
from repro_torch.distributed.ctx import ShardCtx

ZERO_MIN_SIZE = 1 << 20  # leaves smaller than 1 MiB-ish stay replicated

Spec = tuple  # one entry per dim: None | axis | tuple of axes


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _tp_base_spec(path: str, shape: tuple[int, ...],
                  cfg: ModelConfig) -> list:
    """Base spec (no stacking, no ZeRO) for the tp recipe."""
    m = "model"
    heads_ok = cfg.n_heads % 16 == 0
    kv_ok = cfg.n_kv_heads % 16 == 0
    spec: list = [None] * len(shape)
    if "embed/table" in path:
        # vocab-sharded: local logits + tiny logsumexp psum in the CE;
        # fall back to d_model sharding when the vocab is not divisible
        # (mamba2's 50280).
        if shape[-2] % 16 == 0:
            spec[-2] = m
        elif shape[-1] % 16 == 0:
            spec[-1] = m
        return spec
    if "lm_head/w" in path:
        if shape[-1] % 16 == 0:
            spec[-1] = m
        elif shape[-2] % 16 == 0:
            spec[-2] = m
        return spec
    if path.endswith("mixer/wq/w") or path.endswith("mixer/wq/b"):
        if heads_ok:
            spec[-2] = m
        return spec
    if any(path.endswith(s) for s in ("mixer/wk/w", "mixer/wv/w",
                                      "mixer/wk/b", "mixer/wv/b")):
        if kv_ok:
            spec[-2] = m
        return spec
    if path.endswith("mixer/wo/w"):
        if heads_ok:
            spec[-3] = m
        return spec
    # MLA
    if any(s in path for s in ("wuq/w", "wuk/w", "wuv/w")):
        spec[-2] = m  # head dim (deepseek: 128 heads)
        return spec
    if "mixer/wo/w" in path:
        spec[-3] = m
        return spec
    # dense MLP (gate/up column-parallel, out row-parallel)
    if any(path.endswith(s) for s in ("mlp/gate/w", "mlp/up/w",
                                      "shared/gate/w", "shared/up/w")):
        spec[-1] = m
        return spec
    if any(path.endswith(s) for s in ("mlp/gate/b", "mlp/up/b",
                                      "shared/gate/b", "shared/up/b")):
        spec[-1] = m
        return spec
    if path.endswith("mlp/out/w") or path.endswith("shared/out/w"):
        spec[-2] = m
        return spec
    # MoE experts (E leading dim)
    if any(s in path for s in ("mlp/w_up", "mlp/w_gate", "mlp/w_out")):
        spec[-3] = m
        return spec
    # SSD
    if any(path.endswith(s) for s in ("z_proj/w", "x_proj/w", "dt_proj/w")):
        spec[-1] = m
        return spec
    if path.endswith("conv_x_w"):
        spec[-1] = m
        return spec
    if any(path.endswith(s) for s in ("conv_x_b", "dt_bias", "a_log",
                                      "d_skip")):
        spec[-1] = m
        return spec
    if "mixer/norm/scale" in path:  # SSD gated-norm over d_inner
        spec[-1] = m
        return spec
    if path.endswith("out_proj/w"):
        spec[-2] = m
        return spec
    # RG-LRU
    if any(path.endswith(s) for s in ("in_gate/w", "in_rec/w")):
        spec[-1] = m
        return spec
    if path.endswith("conv_w"):
        spec[-1] = m
        return spec
    if path.endswith("conv_b") or path.endswith("lam"):
        spec[-1] = m
        return spec
    if path.endswith("wa") or path.endswith("wx"):
        spec[-3] = m
        return spec
    if path.endswith("ba") or path.endswith("bx"):
        spec[-2] = m
        return spec
    if path.endswith("mixer/out/w"):
        spec[-2] = m
        return spec
    return spec  # norms, router, biases, small projections: replicated


def _fsdp_base_spec(path: str, shape: tuple[int, ...],
                    cfg: ModelConfig) -> list:
    """fsdp recipe: largest divisible dim over ('data','model')."""
    spec: list = [None] * len(shape)
    if any(s in path for s in ("mlp/w_up", "mlp/w_gate", "mlp/w_out")):
        spec[-3] = "model"  # EP for experts
        if shape[-2] % 16 == 0 and _size(shape) >= ZERO_MIN_SIZE:
            spec[-2] = "data"
        return spec
    if "router" in path or _size(shape) < ZERO_MIN_SIZE:
        return spec
    # pick the largest dim divisible by |data|*|model| = 256, else by 16
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % 256 == 0:
            spec[i] = ("data", "model")
            return spec
    for i in order:
        if shape[i] % 16 == 0:
            spec[i] = "data"
            return spec
    return spec


def _size(shape: tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _zero_over_data(spec: list, shape: tuple[int, ...],
                    path: str = "") -> list:
    """tp recipe: additionally shard one free dim of large params over
    ``data`` (ZeRO-style; gathered at use). Embedding tables are exempt:
    ZeRO-sharding the gather's embedding dim forces SPMD into an
    "involuntary full rematerialization" of the gathered activations
    (observed in the nemotron dry-run) — far costlier than the memory it
    saves."""
    if _size(shape) < ZERO_MIN_SIZE:
        return spec
    if "embed/table" in path or "lm_head" in path:
        return spec
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and shape[i] % 16 == 0:
            spec[i] = "data"
            return spec
    return spec


def _inference_base_spec(path: str, shape: tuple[int, ...],
                         cfg: ModelConfig,
                         ep_axes: tuple[str, ...]) -> list:
    """Decode-time rule: weights are read once per TOKEN, so ZeRO-style
    gather-at-use is catastrophic (it re-gathers the model every step).
    Instead: experts sharded over all EP axes (tokens move, not weights);
    every other matrix sharded on its largest model-divisible dim (the
    per-layer psum of a (B, 1, D) activation is tiny); no data-axis
    sharding (replicas of the non-expert weights across `data` serve the
    batch in parallel)."""
    spec: list = [None] * len(shape)
    if any(s in path for s in ("mlp/w_up", "mlp/w_gate", "mlp/w_out")):
        # fall back to model-only EP if the expert count doesn't divide
        ep = ep_axes
        size = 1
        for a in ep:
            size *= {"pod": 2, "data": 16, "model": 16}[a]
        if shape[-3] % size != 0:
            ep = ("model",)
        spec[-3] = ep[0] if len(ep) == 1 else ep
        return spec
    if "embed/table" in path:
        if shape[-2] % 16 == 0:
            spec[-2] = "model"
        elif shape[-1] % 16 == 0:
            spec[-1] = "model"
        return spec
    if "lm_head/w" in path:
        if shape[-1] % 16 == 0:
            spec[-1] = "model"
        elif shape[-2] % 16 == 0:
            spec[-2] = "model"
        return spec
    if "router" in path or _size(shape) < (1 << 16):
        return spec
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % 16 == 0:
            spec[i] = "model"
            return spec
    return spec


def param_spec(path: str, shape: tuple[int, ...], cfg: ModelConfig, *,
               inference: bool = False,
               ep_axes: tuple[str, ...] = ("model",)) -> Spec:
    stacked = path.startswith("blocks/")
    base_shape = shape[1:] if stacked else shape
    if inference:
        spec = _inference_base_spec(path, base_shape, cfg, ep_axes)
    elif cfg.recipe == "fsdp":
        spec = _fsdp_base_spec(path, base_shape, cfg)
    else:
        spec = _tp_base_spec(path, base_shape, cfg)
        spec = _zero_over_data(spec, base_shape, path)
    if stacked:
        spec = [None] + spec
    return tuple(spec)


# ---------------------------------------------------------------------------
# The rules on the port's parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A JAX leaf: its path (``/``-joined), the port parameters that hold
    it (several where it stacks a repeated block's tensors) and its
    shape as JAX has it."""

    path: str
    names: tuple[str, ...]
    stacked: bool
    shape: tuple[int, ...]


def jax_leaves(model) -> dict[str, Leaf]:
    """``lm.leaf_groups`` with shapes: JAX leaf key (dotted) -> ``Leaf``.
    ``model`` may be built on the meta device (``launch.specs``)."""
    from repro_torch.models import lm

    params = dict(model.named_parameters())
    out = {}
    for key, names in lm.leaf_groups(model).items():
        stacked = not isinstance(names, str)
        names = tuple(names) if stacked else (names,)
        shape = tuple(params[names[0]].shape)
        out[key] = Leaf(key.replace(".", "/"), names, stacked,
                        (len(names), *shape) if stacked else shape)
    return out


def port_param_specs(model, cfg: ModelConfig, *, inference: bool = False,
                     ep_axes: tuple[str, ...] = ("model",)
                     ) -> dict[str, Spec]:
    """Every parameter's spec: its JAX leaf's, a stacked leaf's without
    the leading repeats entry."""
    out = {}
    for leaf in jax_leaves(model).values():
        spec = param_spec(leaf.path, leaf.shape, cfg, inference=inference,
                          ep_axes=ep_axes)
        for name in leaf.names:
            out[name] = spec[1:] if leaf.stacked else spec
    return out


def opt_specs(cfg: ModelConfig, opt_state: dict, model,
              specs: dict[str, Spec] | None = None) -> dict:
    """The optimizer state's specs, in its structure: AdamW's ``m``,
    ``v`` and ``master`` (keyed by parameter) take their parameter's;
    Adafactor's ``v_row`` / ``v_col`` (keyed by JAX leaf) drop the
    factored dim of their leaf's spec, as the JAX package's
    ``opt_shardings`` does."""
    leaves = jax_leaves(model)
    params = specs or port_param_specs(model, cfg)
    out: dict = {}
    for head, sub in opt_state.items():
        out[head] = {}
        for key, leaf in sub.items():
            if key in params:
                base = list(params[key])
            else:
                jl = leaves[key]
                spec = params[jl.names[0]]
                base = [None, *spec] if jl.stacked else list(spec)
            nd = leaf.dim()
            if head == "v_row" and len(base) == nd + 1:
                spec = base[:-1]
            elif head == "v_col" and len(base) == nd + 1:
                spec = base[:-2] + base[-1:]
            elif len(base) == nd:
                spec = base
            else:                       # unfactored v_row placeholder (1,)
                spec = [None] * nd
            out[head][key] = tuple(spec)
    return out


def param_shardings(cfg: ModelConfig, mesh: DeviceMesh, model, *,
                    inference: bool = False,
                    ep_axes: tuple[str, ...] = ("model",)) -> dict:
    return {name: NamedSharding(mesh, spec) for name, spec in
            port_param_specs(model, cfg, inference=inference,
                             ep_axes=ep_axes).items()}


def opt_shardings(cfg: ModelConfig, mesh: DeviceMesh, opt_state: dict,
                  model) -> dict:
    return to_shardings(opt_specs(cfg, opt_state, model), mesh)


def to_shardings(specs: dict, mesh: DeviceMesh) -> dict:
    """A tree (nested dicts) of specs as ``NamedSharding``s on ``mesh``."""
    return {k: (to_shardings(v, mesh) if isinstance(v, dict)
                else NamedSharding(mesh, v)) for k, v in specs.items()}


# ---------------------------------------------------------------------------
# Activation layouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    batch: tuple[str, ...] | None
    seq: tuple[str, ...] | None
    kv_seq: tuple[str, ...] | None
    ep_axes: tuple[str, ...] = ("model",)
    inference: bool = False


def _decode_ep_axes(cfg: ModelConfig, multi_pod: bool) -> tuple[str, ...]:
    """Decode EP: spread experts over every axis that divides them —
    deepseek's 256 experts cover the full (model x data) 256 chips."""
    if cfg.moe is None:
        return ("model",)
    e = cfg.moe.padded_experts
    axes: tuple[str, ...] = ("model",)
    if e % 256 == 0:
        axes = ("model", "data")
    if multi_pod and e % 512 == 0:
        axes = ("model", "data", "pod")
    return axes


def make_layout(cfg: ModelConfig, kind: str, multi_pod: bool,
                global_batch: int) -> Layout:
    pod = ("pod",) if multi_pod else ()
    if cfg.recipe == "fsdp":
        if kind == "train":
            return Layout(batch=("data", "model"), seq=pod or None,
                          kv_seq=None)
        if kind == "prefill":
            return Layout(batch=("data",), seq=(*pod, "model"), kv_seq=None)
        # decode
        ep = _decode_ep_axes(cfg, multi_pod)
        if global_batch == 1:
            return Layout(batch=None, seq=None,
                          kv_seq=(*pod, "data", "model"), ep_axes=ep,
                          inference=True)
        return Layout(batch=(*pod, "data"), seq=None, kv_seq=("model",),
                      ep_axes=ep, inference=True)
    # tp
    if kind in ("train", "prefill"):
        batch = (*pod, "data")
        if global_batch % _axes_size_guess(batch) != 0:
            batch = ("data",)
        return Layout(batch=batch, seq=None, kv_seq=None)
    ep = _decode_ep_axes(cfg, multi_pod)
    if global_batch == 1:
        return Layout(batch=None, seq=None, kv_seq=(*pod, "data", "model"),
                      ep_axes=ep, inference=True)
    return Layout(batch=(*pod, "data"), seq=None, kv_seq=("model",),
                  ep_axes=ep, inference=True)


def _axes_size_guess(axes: tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= {"pod": 2, "data": 16, "model": 16}[a]
    return size


def make_ctx(cfg: ModelConfig, mesh: DeviceMesh, layout: Layout) -> ShardCtx:
    return ShardCtx(mesh=mesh, batch=layout.batch, seq=layout.seq,
                    kv_seq=layout.kv_seq, model_axis="model",
                    ep_axes=layout.ep_axes, recipe=cfg.recipe)


# ---------------------------------------------------------------------------
# Cache + batch specs
# ---------------------------------------------------------------------------


def _divides(axes: tuple[str, ...] | None, sizes: Mapping[str, int],
             dim: int) -> bool:
    if not axes:
        return False
    size = 1
    for a in axes:
        size *= sizes[a]
    return dim % size == 0


def kv_split_axes(kv: tuple[str, ...] | None,
                  mesh: DeviceMesh | Mapping[str, int],
                  length: int) -> tuple[str, ...] | None:
    """The axes that split a KV cache of ``length`` slots under a layout
    whose KV sequence is over ``kv``: ``kv`` where it divides the length,
    else ``model`` where that does, else none (the cache whole)."""
    sizes = mesh_sizes(mesh)
    if _divides(kv, sizes, length):
        return tuple(kv)
    if kv and length % sizes["model"] == 0:
        return ("model",)
    return None


def cache_spec(path: str, shape: tuple[int, ...], cfg: ModelConfig,
               mesh: DeviceMesh | Mapping[str, int], layout: Layout) -> Spec:
    sizes = mesh_sizes(mesh)
    stacked = path.startswith("blocks/")
    base = shape[1:] if stacked else shape
    spec: list = [None] * len(base)
    b_axes = layout.batch if _divides(layout.batch, sizes, base[0]) else None
    kv = layout.kv_seq
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("k", "v", "c_kv", "k_rope"):
        spec[0] = b_axes
        spec[1] = kv_split_axes(kv, sizes, base[1])
    elif leaf == "pos":
        pass  # replicated slot-position vectors
    elif leaf == "h" and len(base) == 4:   # ssd state (B, H, P, N)
        spec[0] = b_axes
        if base[1] % sizes["model"] == 0:
            spec[1] = ("model",)
    elif leaf == "h":                       # rglru state (B, W)
        spec[0] = b_axes
        if base[-1] % sizes["model"] == 0:
            spec[-1] = ("model",)
    elif leaf in ("x", "conv"):             # conv states (B, cw-1, C)
        spec[0] = b_axes
        if base[-1] % sizes["model"] == 0:
            spec[-1] = ("model",)
    elif leaf == "bc":
        spec[0] = b_axes
    if stacked:
        spec = [None] + spec
    return tuple(spec)


def cache_layer_paths(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """Per layer of the port's cache (``models.decode.init_cache``: one
    dict a layer), the JAX cache's path prefix of that layer's leaves
    and whether JAX stacks it along a leading repeats axis."""
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    n_rep = n_pre + cfg.repeats * n_pat
    out = []
    for layer in range(len(cfg.layer_kinds)):
        if layer < n_pre:
            out.append((f"prefix/{layer}", False))
        elif layer < n_rep:
            out.append((f"blocks/pos{(layer - n_pre) % n_pat}", True))
        else:
            out.append((f"suffix/{layer - n_rep}", False))
    return out


def cache_specs(cfg: ModelConfig, mesh, layout: Layout,
                cache: list[dict]) -> list[dict]:
    """The port's cache (a dict of tensors a layer) -> its specs: each
    leaf's JAX spec (on the stacked shape for a repeated block), without
    the leading repeats entry."""
    def walk(tree: dict, prefix: str, stacked: bool) -> dict:
        specs = {}
        for leaf, t in tree.items():
            path = f"{prefix}/{leaf}"
            if isinstance(t, dict):     # ssd's conv states {"x", "bc"}
                specs[leaf] = walk(t, path, stacked)
                continue
            shape = ((cfg.repeats, *t.shape) if stacked else tuple(t.shape))
            spec = cache_spec(path, shape, cfg, mesh, layout)
            specs[leaf] = spec[1:] if stacked else spec
        return specs

    return [walk(layer, prefix, stacked) for (prefix, stacked), layer
            in zip(cache_layer_paths(cfg), cache)]


def cache_blocks(cache: list[dict], specs: list[dict], mesh: DeviceMesh,
                 row_axes: tuple[str, ...] = ()) -> list[dict]:
    """This rank's block of every leaf of ``cache`` under ``specs``
    (``cache_specs``), each its own contiguous tensor. ``row_axes``: the
    cache holds this rank's rows over those axes (a prefill's batch
    split), not all of them; a leaf whose spec splits the rows otherwise
    is gathered over them first. The slot-position vectors are whole."""
    def walk(tree: dict, spec: dict) -> dict:
        out = {}
        for leaf, t in tree.items():
            if isinstance(t, dict):
                out[leaf] = walk(t, spec[leaf])
                continue
            s = spec[leaf]
            if leaf != "pos" and row_axes and _axes_of(s[0]) != row_axes:
                t = collectives.all_gather(t, mesh, row_axes, 0)
            elif leaf != "pos" and row_axes:
                s = (None, *s[1:])
            out[leaf] = local_shard(t, s, mesh).clone()
        return out

    return [walk(layer, spec) for layer, spec in zip(cache, specs)]


def gather_cache(blocks: list[dict], specs: list[dict],
                 mesh: DeviceMesh) -> list[dict]:
    """The whole cache from every rank's ``cache_blocks``."""
    return [gather_tree(layer, spec, mesh)
            for layer, spec in zip(blocks, specs)]


def batch_shardings(cfg: ModelConfig, mesh, layout: Layout,
                    batch_shapes: dict) -> dict[str, Spec]:
    """The batch's specs (a dict of tensors or shapes): the rows over
    ``layout.batch`` where they divide, a token grid's sequence over
    ``layout.seq`` where it divides."""
    sizes = mesh_sizes(mesh)
    out = {}
    for path, leaf in batch_shapes.items():
        shape = tuple(leaf.shape)
        dims: list = [None] * len(shape)
        if _divides(layout.batch, sizes, shape[0]):
            dims[0] = layout.batch
        if "tokens" in path and len(shape) >= 2 and \
                _divides(layout.seq, sizes, shape[1]):
            dims[1] = layout.seq
        out[path] = tuple(dims)
    return out


# ---------------------------------------------------------------------------
# Execution: shards on ranks
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """Every mesh axis the spec shards over."""
    return tuple(a for e in spec for a in _axes_of(e))


def to_placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """The spec as DTensor placements, one per mesh dim: ``Shard(d)``
    where the dim's axis shards tensor dim ``d``, else ``Replicate()``.
    A dim split over several axes is ``Shard(d)`` on each, which DTensor
    reads major to minor in the mesh's order; a spec that splits a dim
    in another order has no such placements and raises."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, "
                             f"not in the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shard(full: torch.Tensor, spec: Spec,
                mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view)."""
    sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
    out = full
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        n = 1
        for a in axes:
            n *= sizes[a]
        if full.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not "
                             f"split over {axes} ({n} ranks)")
        per = full.shape[d] // n
        out = out.narrow(d, collectives.flat_index(coords, sizes, axes)
                         * per, per)
    return out


def gather_full(local: torch.Tensor, spec: Spec, mesh: DeviceMesh,
                keep: tuple[int, ...] = ()) -> torch.Tensor:
    """The whole tensor from every rank's block (an all-gather over each
    sharded dim), but the dims in ``keep``, which stay this rank's."""
    out = local
    for d, entry in enumerate(spec):
        if d in keep or not _axes_of(entry):
            continue
        out = collectives.all_gather(out, mesh, _axes_of(entry), d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each rank's block of a tensor lies."""

    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        return local_shard(full, self.spec, self.mesh)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return gather_full(local, self.spec, self.mesh)


def _expert(name: str) -> bool:
    return name.endswith(("mlp.w_up", "mlp.w_gate", "mlp.w_out"))


def _part(name: str) -> str:
    """The model part a parameter belongs to, as ``lm.init_parts`` names
    it: ``blocks.3.mixer.wq.w`` -> ``blocks.3``, ``embed.table`` ->
    ``embed``."""
    head, _, rest = name.partition(".")
    return f"{head}.{rest.split('.', 1)[0]}" if head == "blocks" else head


class _AtUse(torch.autograd.Function):
    """A parameter gathered from this rank's shard for one use; in
    backward, the whole parameter's gradient taken back to the shard's
    placement (``ShardedModel.reduce_one``)."""

    @staticmethod
    def forward(ctx, shard, owner, name):
        ctx.owner, ctx.name = owner, name
        return owner.gather_one(name, shard)

    @staticmethod
    def backward(ctx, g):
        return ctx.owner.reduce_one(ctx.name, g), None, None


class ShardedModel:
    """A model's parameters sharded over a ``ShardCtx``'s mesh.

    ``shards`` holds this rank's block of every parameter (the optimizer
    updates these); ``model`` is the ``LM`` the forward runs, whose
    parameters are plain attributes on the meta device but for the parts
    that ``use`` gathers for the length of their use: each parameter
    whole, gathered from every rank's block, but an expert weight, which
    keeps this rank's experts (its dim -3 split over ``ctx.ep_axes``, as
    both recipes' rules split it) and is gathered over its other axes
    only. ``loss`` runs ``lm.loss_fn`` so: the parts outside the block
    stack for the whole loss, each block (each repeat of the pattern,
    which ``lm.forward_hidden`` recomputes in backward) only inside its
    forward and again inside its recompute, so a rank holds one repeat's
    whole weights at a time beside its shards and the embedding, head
    and norms. A gathered parameter's gradient is reduced to its shard's
    placement as soon as backward has it (``_AtUse``), so no whole
    gradient outlives its block either; ``take_grads`` returns them.

    Serving. Prefill runs on the training rules' shards, each part
    gathered at its use as above (``repro_torch.models.decode.prefill``
    takes the ``ShardedModel``). Decode reads every weight once a token,
    so its model keeps the inference rules' blocks in place
    (``in_place``; ``reshard(ctx, inference=True)`` moves the prefill
    model's shards there one parameter at a time): ``use`` puts a
    ``repro_torch.distributed.tp.Split`` of each block where the model
    reads it and the model's products take it across the ranks, and
    gathers whole only a split weight that nothing reads in place
    (``tp.reads_in_place``; ``gathered_at_use`` names them).

    Gradients. Every rank's loss is its share of the global loss
    (``lm.loss_fn`` under a ctx), so a parameter's gradient is the sum
    over every rank of the mesh of its rank's gradient: a reduce-scatter
    over the axes that shard it, then a sum over the other axes. That is
    the same as reducing over the layout's batch axes where the ranks off
    them compute the same thing, the reading of the tp recipe's train
    layout. The reduction runs in float32.
    """

    def __init__(self, cfg: ModelConfig, ctx: ShardCtx, device,
                 specs: dict[str, Spec] | None = None,
                 in_place: bool = False):
        from repro_torch.models import layers, lm

        self.cfg, self.ctx, self.device = cfg, ctx, torch.device(device)
        self.in_place = in_place
        self.gathered_at_use: set[str] = set()
        self.mesh = ctx.mesh
        # the whole model's shapes (the rules read them) and the model the
        # forward runs, both on the meta device
        self.meta = lm.init(layers.MetaGenerator(), cfg)
        self.model = lm.init(layers.MetaGenerator(), cfg)
        self.specs = specs or port_param_specs(self.meta, cfg)
        self.leaves = jax_leaves(self.meta)
        self.groups = lm.leaf_groups(self.meta)
        self.shards: dict[str, torch.Tensor] = {}
        self.keep: dict[str, tuple[int, ...]] = {}
        self.placeholders: dict[str, torch.Tensor] = {}
        self.parts: dict[str, list[str]] = {}
        ep = tuple(ctx.ep_axes)
        for name, p in self.meta.named_parameters():
            spec = self.specs[name]
            if _expert(name):
                if _axes_of(spec[-3]) != ep:
                    raise ValueError(f"{name}: spec {spec} does not split "
                                     f"its experts over {ep}")
                self.keep[name] = (p.dim() - 3,)
            self.parts.setdefault(_part(name), []).append(name)
        # the forward's model holds plain tensors, so that a gathered
        # (non-leaf) tensor can stand in for a parameter
        for name, p in list(self.model.named_parameters()):
            mod_name, _, attr = name.rpartition(".")
            delattr(self.model.get_submodule(mod_name), attr)
            self.placeholders[name] = p.detach()
            _set_param(self.model, name, self.placeholders[name])
        self.all_axes = tuple(self.mesh.mesh_dim_names)
        self.coords = mesh_coords(self.mesh)

    # -- construction ---------------------------------------------------

    @classmethod
    def init(cls, cfg: ModelConfig, ctx: ShardCtx, seed: int, device,
             specs: dict[str, Spec] | None = None) -> "ShardedModel":
        """Every rank draws the one-device model's weights from ``seed``
        (``lm.init_parts`` on ``device``), one part at a time, and keeps
        its block of each: the shards of ``lm.init``'s model, bit for
        bit, and no rank ever holds the whole model."""
        from repro_torch.models import lm

        self = cls(cfg, ctx, device, specs)
        gen = torch.Generator(self.device).manual_seed(seed)
        for prefix, part in lm.init_parts(gen, cfg):
            for pname, p in part.named_parameters():
                name = f"{prefix}.{pname}"
                self.shards[name] = local_shard(
                    p.detach(), self.specs[name], self.mesh).clone()
            del part
        return self

    @classmethod
    def from_full(cls, cfg: ModelConfig, ctx: ShardCtx,
                  params: dict[str, torch.Tensor], device,
                  specs: dict[str, Spec] | None = None,
                  in_place: bool = False) -> "ShardedModel":
        """Shards of whole parameters (``named_parameters`` of a model)."""
        self = cls(cfg, ctx, device, specs, in_place)
        for name, p in params.items():
            self.shards[name] = local_shard(
                p.detach().to(self.device), self.specs[name],
                self.mesh).clone()
        return self

    def reshard(self, ctx: ShardCtx, *, inference: bool = False
                ) -> "ShardedModel":
        """The same weights under ``ctx``'s layout on the same mesh: the
        rules' specs (``inference``: the decode rules, experts over
        ``ctx.ep_axes``, read in place), moved one parameter at a time —
        each gathered whole, its new block kept, the whole dropped — so
        no rank holds the whole model."""
        specs = port_param_specs(self.meta, self.cfg, inference=inference,
                                 ep_axes=tuple(ctx.ep_axes))
        new = ShardedModel(self.cfg, ctx, self.device, specs, inference)
        for name, shard in self.shards.items():
            full = gather_full(shard, self.specs[name], self.mesh)
            new.shards[name] = local_shard(full, specs[name],
                                           new.mesh).clone()
            del full
        return new

    def shardings(self) -> dict[str, NamedSharding]:
        return {n: NamedSharding(self.mesh, s) for n, s in self.specs.items()}

    def opt_specs(self, opt_state: dict) -> dict:
        """The specs of an optimizer state over these shards."""
        return opt_specs(self.cfg, opt_state, self.meta, self.specs)

    # -- the step -------------------------------------------------------

    def placed(self, name: str):
        """What an ``in_place`` model reads for ``name``: its block as a
        ``tp.Split`` where the model reads it in place, the shard itself
        where it is whole or an expert weight's block, else the weight
        gathered whole (recorded in ``gathered_at_use``)."""
        from repro_torch.distributed import tp

        shard, spec = self.shards[name], self.specs[name]
        dims = [d for d, e in enumerate(spec)
                if _axes_of(e) and d not in self.keep.get(name, ())]
        if not dims:
            return shard
        if len(dims) == 1 and tp.reads_in_place(name):
            return tp.Split(shard, dims[0], _axes_of(spec[dims[0]]),
                            self.mesh, self.meta.get_parameter(name).shape)
        self.gathered_at_use.add(name)
        return self.gather_one(name, shard)

    def gather_one(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The parameter ``name`` whole (an expert weight: this rank's
        experts) from this rank's ``shard``, a new tensor."""
        local = shard.detach()
        full = gather_full(local, self.specs[name], self.mesh,
                           self.keep.get(name, ()))
        return full.clone() if full is local else full

    def reduce_one(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """The gradient of the whole parameter ``name`` on this rank ->
        this rank's block of the global gradient (class docstring), in
        the shard's dtype."""
        g = g.to(torch.float32)
        spec, keep = self.specs[name], self.keep.get(name, ())
        for d in reversed(range(len(spec))):
            axes = _axes_of(spec[d])
            if axes and d not in keep:
                g = collectives.reduce_scatter(g, self.mesh, axes, d)
        rest = tuple(a for a in self.all_axes if a not in spec_axes(spec))
        if rest:
            g = collectives.all_reduce(g, self.mesh, rest)
        return g.to(self.shards[name].dtype)

    @contextlib.contextmanager
    def use(self, parts):
        """``model``'s parameters of ``parts`` (``lm.init_parts``'s names)
        gathered for the length of the ``with`` (``in_place``: as
        ``placed`` reads them); with grad enabled, their gradients flow
        back to the shards (``_AtUse``). Every rank of the mesh enters the
        same ``use``s in the same order."""
        names = [n for part in parts for n in self.parts.get(part, ())]
        grad = torch.is_grad_enabled()
        try:
            for name in names:
                shard = self.shards[name]
                if self.in_place:
                    full = self.placed(name)
                elif grad:
                    shard.requires_grad_(True)
                    full = _AtUse.apply(shard, self, name)
                else:
                    full = self.gather_one(name, shard)
                _set_param(self.model, name, full)
            yield
        finally:
            for name in names:
                _set_param(self.model, name, self.placeholders[name])

    def loss(self, batch: dict[str, torch.Tensor], kernel: str = "off"):
        """``lm.loss_fn`` on this rank's rows ``batch`` (``batch_rows``),
        each part gathered at its use: (this rank's share of the total,
        the global metrics)."""
        from repro_torch.models import lm

        return lm.loss_fn(self.model, batch, kernel=kernel, ctx=self.ctx,
                          use=self.use)

    def take_grads(self) -> dict[str, torch.Tensor]:
        """The shards of the global gradient from the last backward (zeros
        for a parameter it did not reach), cleared from the shards."""
        out = {}
        for name, shard in self.shards.items():
            g = shard.grad
            out[name] = torch.zeros_like(shard) if g is None else g
            shard.grad = None
        return out

    # -- what the optimizer needs ---------------------------------------

    def owns(self, spec: Spec) -> bool:
        """True on the one rank of each block's replicas that counts it:
        coordinate 0 on every axis off the spec."""
        return all(self.coords[a] == 0 for a in self.all_axes
                   if a not in spec_axes(spec))

    def sq_sum(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global sum of squares of sharded gradients, each block
        counted once."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for name, g in grads.items():
            if g is not None and self.owns(self.specs[name]):
                total = total + torch.sum(torch.square(g.to(torch.float32)))
        return collectives.all_reduce(total, self.mesh, self.all_axes)

    def leaf_spec(self, key: str) -> Spec:
        """A JAX leaf's spec (stacked: with the leading ``None``)."""
        leaf = self.leaves[key]
        spec = self.specs[leaf.names[0]]
        return (None, *spec) if leaf.stacked else spec

    def leaf_mean(self, x: torch.Tensor, key: str, x_dims, leaf_dims,
                  keepdim: bool = False) -> torch.Tensor:
        """The mean of a JAX leaf's block ``x`` over ``x_dims``, which are
        the leaf's ``leaf_dims``: local sums, summed over the axes that
        shard those dims, over the whole extent. ``x_dims=None``: every
        dim."""
        spec, shape = self.leaf_spec(key), self.leaves[key].shape
        nd = len(shape)
        if x_dims is None:
            x_dims, leaf_dims = tuple(range(x.dim())), tuple(range(nd))
        elif isinstance(x_dims, int):
            x_dims = (x_dims,)
        total = torch.sum(x, dim=x_dims, keepdim=keepdim)
        axes = tuple(a for d in leaf_dims for a in _axes_of(spec[d % nd]))
        if axes:
            total = collectives.all_reduce(total, self.mesh, axes)
        n = 1
        for d in leaf_dims:
            n *= shape[d % nd]
        return total / n

    def leaf_shape(self, key: str) -> tuple[int, ...]:
        return self.leaves[key].shape

    # -- whole state ----------------------------------------------------

    def full_params(self) -> dict[str, torch.Tensor]:
        """Every parameter whole, on every rank (a checkpoint's layout)."""
        return {n: gather_full(s.detach(), self.specs[n], self.mesh)
                for n, s in self.shards.items()}


def _set_param(model, name: str, value) -> None:
    mod_name, _, attr = name.rpartition(".")
    setattr(model.get_submodule(mod_name), attr, value)


def gather_tree(tree: dict, specs: dict, mesh: DeviceMesh) -> dict:
    """A tree of blocks (nested dicts) made whole by the specs of the
    same structure."""
    return {k: (gather_tree(v, specs[k], mesh) if isinstance(v, dict)
                else gather_full(v, specs[k], mesh))
            for k, v in tree.items()}


def batch_rows(batch: dict[str, torch.Tensor], ctx: ShardCtx
               ) -> dict[str, torch.Tensor]:
    """This rank's rows of a global batch: dim 0 split over
    ``ctx.batch`` (major to minor)."""
    from repro_torch.distributed.ctx import batch_axes

    spec = (batch_axes(ctx) or None,)
    return {k: local_shard(v, spec + (None,) * (v.dim() - 1), ctx.mesh)
            for k, v in batch.items()}

